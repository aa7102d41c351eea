// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 accumulate.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// _flash_fwd_kernel (Pallas; driven by flash_attention_fwd). Same
// function -- causal attention with a kv-length mask, scale 1/sqrt(hd),
// online softmax in fp32, output acc / max(l, 1e-20) -- plus one input,
// q_offset[b], the absolute position of q[b, 0]: with all zeros it is
// the TPU kernel, with the paged serve path's per-row positions it is
// the JAX package's chunked_causal_attention(..., q_offset=[B]).
//
//   out[b,i,h] = softmax_j(scale * q[b,i,h] . k[b,j,h/(H/Hk)])
//                             . v[b,j,h/(H/Hk)]
//   over j < Skv and (not causal or j <= q_offset[b] + i)
//
// Layout: q/out [B,Sq,H,hd], k/v [B,Skv,Hk,hd], all contiguous bf16;
// q_offset int32 [B]. GQA is read by index (q head h reads kv head
// h / (H/Hk)), so the caller never materializes expanded K/V.
//
// What bounds it on this card: a prefill chunk (Sq 128 over a 512-token
// window, hd 128) does ~64 flops per byte it must move, jamba's prompt
// (Sq 512 over 544 keys, GQA 4) ~200, both under the H100's ~295 bf16
// flops/byte ridge, so the bound is memory; decode (Sq 1) is far below
// it. Two variants, chosen by the wrapper from the shapes:
//   - prefill, hd 128 and Sq >= 64 with H / Hk dividing 64
//     (``flash_attention_fwd_bf16_tma``): one CTA per (2T query tokens,
//     kv head, batch row) serves all G = H / Hk query heads of the kv
//     head, T = 64 / G tokens x G heads per consumer warpgroup, so each
//     K/V tile is read once per GQA group (the old kernel read it once
//     per q head: 4x for jamba, 8x for qwen2.5-3b). A producer warp
//     loads Q once and K/V tiles of 64 keys through a 2-stage mbarrier
//     ring by TMA (4-D maps over [B, S, H, hd]; 128-byte swizzle; keys
//     past Skv and tokens past Sq read as zero). Two consumer
//     warpgroups: S = Q K^T by wgmma m64n64k16 (both K-major in shared
//     memory), the online softmax in fp32 registers (exp2 with the scale
//     folded into log2 units), P rounded to bf16 in registers and O +=
//     P V by wgmma m64n128k16 with A from registers and V MN-major (the
//     transpose bit). Causal q tiles launch heaviest first, and kv tiles
//     above the diagonal are never loaded. ~99 KB of shared memory, one
//     CTA of 288 threads per SM;
//   - everything else (decode, short queries, hd 16/32/64): one thread
//     block per (q tile, head, batch row), a loop inside the block walks
//     the kv tiles (the TPU grid's sequential minor axis); Q/K/V tiles in
//     padded shared memory, m/l/acc in fp32 registers; both products on
//     mma.sync m16n8k16; four warps per block, 16 query rows each;
//     decode (Sq 1) runs the same block with one live row.
// Both: masked scores are -1e30 as in the JAX code, and their p is set
// to exactly 0, so stale or scratch KV rows (finite) contribute nothing;
// P is rounded to bf16 for the P.V product, the one place these kernels
// round where the TPU kernel does not. Not yet done: split-kv for
// decode, other head dims and dtypes in the prefill variant.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BK = 64;               // keys per kv tile
constexpr int NW = 4;                // warps per block
constexpr int BQ = 16 * NW;          // query rows per block, 16 per warp
constexpr float NEG_INF = -1e30f;    // the JAX code's mask value

__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16 (lo in the low half)
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int HD>
__global__ void __launch_bounds__(NW * 32)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ q_offset,
                 __nv_bfloat16* __restrict__ out,
                 int Sq, int Skv, int H, int Hk, int causal, float scale) {
  constexpr int LD = HD + 8;         // shared-memory row stride (elements)
  constexpr int NT_S = BK / 8;       // n8 tiles of a warp's S block
  constexpr int NT_O = HD / 8;       // n8 tiles of a warp's O block
  constexpr int KS = HD / 16;        // k16 steps over hd
  constexpr int VPR = HD / 8;        // 16-byte vectors per row
  constexpr int NTHR = NW * 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LD;
  __nv_bfloat16* Vs = Ks + BK * LD;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;   // mma group / thread in group
  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Hk);
  const int off = q_offset[b];
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  static_assert((BQ * VPR) % NTHR == 0 && (BK * VPR) % NTHR == 0,
                "tile vectors must divide evenly over the threads");

  // Q tile -> shared memory; rows past Sq are zero and never stored
#pragma unroll
  for (int it = 0; it < BQ * VPR / NTHR; ++it) {
    const int i = tid + it * NTHR;
    const int r = i / VPR, c = (i % VPR) * 8;
    const int qi = q_start + r;
    uint4 val = zero4;
    if (qi < Sq)
      val = *reinterpret_cast<const uint4*>(
          q + ((static_cast<size_t>(b) * Sq + qi) * H + h) * HD + c);
    *reinterpret_cast<uint4*>(Qs + r * LD + c) = val;
  }
  __syncthreads();

  // this warp's 16 query rows as mma A fragments, held for the whole loop
  const int r0 = warp * 16 + g;             // rows r0 and r0 + 8
  const bool live = q_start + warp * 16 < Sq;   // warp-uniform
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const __nv_bfloat16* p0 = Qs + r0 * LD + ks * 16 + t4 * 2;
    const __nv_bfloat16* p1 = p0 + 8 * LD;
    qf[ks][0] = ld32(p0);
    qf[ks][1] = ld32(p1);
    qf[ks][2] = ld32(p0 + 8);
    qf[ks][3] = ld32(p1 + 8);
  }

  float o[NT_O][4];
#pragma unroll
  for (int dt = 0; dt < NT_O; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};                  // this thread's partial sums
  const int qpos0 = off + q_start + r0;     // absolute position of row r0

  int n_tiles = (Skv + BK - 1) / BK;
  if (causal) {
    // the last key any row of this tile may see
    const int last_key = off + min(q_start + BQ - 1, Sq - 1);
    n_tiles = min(n_tiles, last_key / BK + 1);
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int k_start = j * BK;
    __syncthreads();                        // previous tile consumed
#pragma unroll
    for (int it = 0; it < BK * VPR / NTHR; ++it) {
      const int i = tid + it * NTHR;
      const int r = i / VPR, c = (i % VPR) * 8;
      const int kj = k_start + r;
      uint4 kv4 = zero4, vv4 = zero4;
      if (kj < Skv) {
        const size_t base =
            ((static_cast<size_t>(b) * Skv + kj) * Hk + kvh) * HD + c;
        kv4 = *reinterpret_cast<const uint4*>(k + base);
        vv4 = *reinterpret_cast<const uint4*>(v + base);
      }
      *reinterpret_cast<uint4*>(Ks + r * LD + c) = kv4;
      *reinterpret_cast<uint4*>(Vs + r * LD + c) = vv4;
    }
    __syncthreads();
    if (!live) continue;                    // still meets every barrier

    // S = Q K^T for this warp's 16 rows x BK keys
    float s[NT_S][4];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const __nv_bfloat16* kr = Ks + (nt * 8 + g) * LD + ks * 16 + t4 * 2;
        mma_16816(s[nt], qf[ks], ld32(kr), ld32(kr + 8));
      }
    }

    // scale, mask, running max (element e: row r0 + 8*(e>>1))
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k_start + nt * 8 + t4 * 2 + (e & 1);
        const bool ok = kpos < Skv &&
                        (!causal || kpos <= qpos0 + ((e >> 1) << 3));
        const float val = ok ? s[nt][e] * scale : NEG_INF;
        s[nt][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[nt][e] == NEG_INF ? 0.f
                                            : expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        ls[e >> 1] += p;
      }
    }
    l[0] = l[0] * corr[0] + ls[0];
    l[1] = l[1] * corr[1] + ls[1];
#pragma unroll
    for (int dt = 0; dt < NT_O; ++dt) {
      o[dt][0] *= corr[0];
      o[dt][1] *= corr[0];
      o[dt][2] *= corr[1];
      o[dt][3] *= corr[1];
    }

    // O += P V: the S accumulators of two adjacent n8 tiles are the A
    // fragment of one k16 step
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_f32(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_f32(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < NT_O; ++dt) {
        const __nv_bfloat16* vr = Vs + (kk * 16 + t4 * 2) * LD + dt * 8 + g;
        mma_16816(o[dt], a, pack_bf16(vr[0], vr[LD]),
                  pack_bf16(vr[8 * LD], vr[9 * LD]));
      }
    }
  }

  // row sums across the four threads of each mma group, then store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-20f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q_start + r0 + 8 * r;
    if (qi >= Sq) continue;
    __nv_bfloat16* orow =
        out + ((static_cast<size_t>(b) * Sq + qi) * H + h) * HD + t4 * 2;
#pragma unroll
    for (int dt = 0; dt < NT_O; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8) =
          pack_f32(o[dt][2 * r] * l[r], o[dt][2 * r + 1] * l[r]);
  }
}

// -- the prefill variant: wgmma + TMA, hd 128, Sq >= 64 -----------------------
//
// A CTA serves the G = H / Hk query heads of one kv head over 2T query
// tokens (T = 64 / G): two consumer warpgroups of 64 rows each, row r of
// warpgroup w being token q0 + w T + r / G, head kvh G + r % G (a 4-D TMA
// box {64 of hd, G heads, T tokens, 1 batch row} of q lands in exactly that
// order), and one producer warp. Each K/V tile is loaded once for the whole
// GQA group.
constexpr int P_HD = 128;                    // head dim of this variant
constexpr int P_BKV = 64;                    // keys per kv tile
constexpr int P_WG = 2;                      // consumer warpgroups
constexpr int P_THREADS = P_WG * 128 + 32;   // + the producer warp
constexpr int P_BOX = 64 * 64 * 2;           // one 64 x 64 bf16 box
constexpr int P_Q_BYTES = P_WG * 2 * P_BOX;  // 2 hd halves per warpgroup
constexpr int P_KV_BYTES = 4 * P_BOX;        // K and V, 2 hd halves each
constexpr int P_STAGES = 2;
constexpr int P_SMEM = P_Q_BYTES + P_STAGES * P_KV_BYTES + 1024 + 64;

__global__ void __launch_bounds__(P_THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const int* __restrict__ q_offset,
                       __nv_bfloat16* __restrict__ out, int Sq, int Skv,
                       int H, int Hk, int causal, float scale_log2) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = sm;                          // [wg][half] boxes
  unsigned char* kvs = sm + P_Q_BYTES;             // [stage][K0 K1 V0 V1]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kvs + P_STAGES * P_KV_BYTES);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + P_STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = H / Hk, T = 64 / G;
  const int kvh = blockIdx.y, b = blockIdx.z;
  // causal: the heaviest q tiles (the last) first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * P_WG * T;                    // first token of the CTA
  const int off = q_offset[b];
  int n_tiles = (Skv + P_BKV - 1) / P_BKV;
  if (causal)
    n_tiles = min(n_tiles, (off + min(q0 + P_WG * T, Sq) - 1) / P_BKV + 1);

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < P_STAGES; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], P_WG * 4);           // every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == P_WG * 4) {
    // producer
    if (lane == 0) {
      tma_prefetch_desc(&map_q);
      tma_prefetch_desc(&map_k);
      tma_prefetch_desc(&map_v);
      mbar_expect_tx(q_full, P_Q_BYTES);
      for (int w = 0; w < P_WG; ++w)
        for (int h = 0; h < 2; ++h)
          tma_load_4d(qs + (2 * w + h) * P_BOX, &map_q, q_full, 64 * h,
                      kvh * G, q0 + w * T, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % P_STAGES;
        if (j >= P_STAGES)
          mbar_wait(&kv_empty[s], ((j / P_STAGES) - 1) & 1);
        mbar_expect_tx(&kv_full[s], P_KV_BYTES);
        unsigned char* st = kvs + s * P_KV_BYTES;
        for (int h = 0; h < 2; ++h) {
          tma_load_4d(st + h * P_BOX, &map_k, &kv_full[s], 64 * h, kvh,
                      j * P_BKV, b);
          tma_load_4d(st + (2 + h) * P_BOX, &map_v, &kv_full[s], 64 * h, kvh,
                      j * P_BKV, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg, warp w of it
  const int wg = warp >> 2, w = warp & 3;
  int tok[2], head[2], qpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * w + (lane >> 2) + 8 * r;
    tok[r] = q0 + wg * T + row / G;
    head[r] = kvh * G + row % G;
    qpos[r] = off + tok[r];
  }
  const uint32_t q_addr = smem_u32(qs + 2 * wg * P_BOX);
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};                         // this thread's partials
  mbar_wait(q_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % P_STAGES;
    const int k_start = j * P_BKV;
    mbar_wait(&kv_full[s], (j / P_STAGES) & 1);
    const uint32_t k_addr = smem_u32(kvs + s * P_KV_BYTES);
    const uint32_t v_addr = k_addr + 2 * P_BOX;

    // S = Q K^T: both K-major; hd in 8 k16 steps over the two boxes
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < P_HD / 16; ++kk) {
      const uint32_t step = (kk >> 2) * P_BOX + (kk & 3) * 32;
      wgmma_m64n64k16_ss(sc, desc_sw128(q_addr + step, 16, 1024),
                         desc_sw128(k_addr + step, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // scale (in log2 units), mask, running max; element 4j + e: row
    // r = e >> 1 of the thread's two, key k_start + 8j + 2 (lane % 4) +
    // (e & 1)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k_start + 8 * jj + 2 * (lane & 3) + (e & 1);
        const bool ok = kpos < Skv && (!causal || kpos <= qpos[e >> 1]);
        const float val = ok ? sc[4 * jj + e] * scale_log2 : NEG_INF;
        sc[4 * jj + e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = sc[i] == NEG_INF ? 0.f
                                       : exp2f(sc[i] - m[(i >> 1) & 1]);
      sc[i] = p;
      ls[(i >> 1) & 1] += p;
    }
    l[0] = l[0] * corr[0] + ls[0];
    l[1] = l[1] * corr[1] + ls[1];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] *= corr[(i >> 1) & 1];

    // O += P V: P (bf16) from registers, the S accumulators of keys
    // 16kk .. 16kk + 15 being the A fragment of k16 step kk; V MN-major
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kk][i] = pack_f32(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n128k16_rs_tb(o, pa[kk],
                             desc_sw128(v_addr + kk * 2048, P_BOX, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(&kv_empty[s]);
  }

  // row sums across the four threads of each row, then store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-20f);
  }
  const int B_idx = b;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (tok[r] >= Sq) continue;
    __nv_bfloat16* orow =
        out + ((static_cast<size_t>(B_idx) * Sq + tok[r]) * H + head[r]) *
                  P_HD + 2 * (lane & 3);
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
      *reinterpret_cast<uint32_t*>(orow + 8 * jj) =
          pack_f32(o[4 * jj + 2 * r] * l[r], o[4 * jj + 2 * r + 1] * l[r]);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* q_offset, void* out, int B, int Sq, int Skv,
                   int H, int Hk, int causal, float scale,
                   cudaStream_t stream) {
  const int smem = (BQ + 2 * BK) * (HD + 8) * static_cast<int>(
      sizeof(__nv_bfloat16));
  auto kern = flash_fwd_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NW * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const int*>(q_offset),
      static_cast<__nv_bfloat16*>(out), Sq, Skv, H, Hk, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns cudaGetLastError()
// after the launch: 0 on success.
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, const void* q_offset,
                                        void* out, int B, int Sq, int Skv,
                                        int H, int Hk, int hd, int causal,
                                        float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch<16>(q, k, v, q_offset, out, B, Sq, Skv, H, Hk, causal,
                         scale, s);
    case 32:
      return launch<32>(q, k, v, q_offset, out, B, Sq, Skv, H, Hk, causal,
                         scale, s);
    case 64:
      return launch<64>(q, k, v, q_offset, out, B, Sq, Skv, H, Hk, causal,
                         scale, s);
    case 128:
      return launch<128>(q, k, v, q_offset, out, B, Sq, Skv, H, Hk, causal,
                          scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The prefill variant (hd 128; the wrapper sends Sq >= 64 and H / Hk
// dividing 64). Same arguments as flash_attention_fwd_bf16 but hd.
// Returns cudaErrorInvalidValue for what it does not take, else
// cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd_bf16_tma(const void* q, const void* k,
                                            const void* v,
                                            const void* q_offset, void* out,
                                            int B, int Sq, int Skv, int H,
                                            int Hk, int causal, float scale,
                                            void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hk <= 0 || H % Hk != 0 ||
      64 % (H / Hk) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / Hk, T = 64 / G;
  const cuuint64_t hd_b = P_HD * 2;
  CUtensorMap mq, mk, mv;
  {
    const cuuint64_t dims[4] = {P_HD, static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(Sq),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {hd_b, hd_b * H, hd_b * H * Sq};
    const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(G),
                               static_cast<cuuint32_t>(T), 1};
    if (!hopper::encode_bf16(&mq, q, 4, dims, strides, box))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  {
    const cuuint64_t dims[4] = {P_HD, static_cast<cuuint64_t>(Hk),
                                static_cast<cuuint64_t>(Skv),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {hd_b, hd_b * Hk, hd_b * Hk * Skv};
    const cuuint32_t box[4] = {64, 1, P_BKV, 1};
    if (!hopper::encode_bf16(&mk, k, 4, dims, strides, box) ||
        !hopper::encode_bf16(&mv, v, 4, dims, strides, box))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        P_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((Sq + P_WG * T - 1) / (P_WG * T), Hk, B);
  flash_fwd_wgmma_kernel<<<grid, P_THREADS, P_SMEM,
                           static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, static_cast<const int*>(q_offset),
      static_cast<__nv_bfloat16*>(out), Sq, Skv, H, Hk, causal,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}
