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
// it. Three variants, chosen by the wrapper from the shapes:
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
//   - decode, Sq 1 with hd 64 or 128 and H / Hk <= 16
//     (``flash_attention_decode_bf16``): split-KV. A decode step reads
//     each K/V byte once and does ~2 flops per byte, so bytes bind, but
//     at the serve shapes (2-9 MB) the bound is under a microsecond and
//     latency sets the time. One CTA per (key split, kv head, batch row)
//     serves the whole GQA group, so each K/V byte is read once per group
//     (the mma.sync kernel below read it once per q head, in 4-warp
//     blocks with one live row, walking its tiles one load after
//     another); the split's K and V are all in flight at once (cp.async),
//     splits wholly past the causal offset load nothing, and the last CTA
//     of each (b, kv head) merges the splits' (m, l, acc) in the same
//     launch (see the section below);
//   - everything else (short queries, hd 16/32/112/256, larger GQA
//     groups; decode at hd 112 and 256 with one live row of 64): one
//     thread block per (q tile, head, batch row), a loop inside the block
//     walks the kv tiles (the TPU grid's sequential minor axis); Q/K/V
//     tiles in padded shared memory, m/l/acc in fp32 registers; both
//     products on mma.sync m16n8k16; four warps per block, 16 query rows
//     each. At hd 256 (gemma) a warp's O alone would take 128 registers
//     a thread, so eight warps share the 64 rows, two to each 16, each
//     with half of O's columns (both compute the rows' S), and the Q
//     fragments are read from shared memory at each k16 step instead of
//     being held (101,376 B of shared memory, opted in).
// All: masked scores are -1e30 as in the JAX code, and their p is set
// to exactly 0, so stale or scratch KV rows (finite) contribute nothing;
// P is rounded to bf16 for the P.V product, the one place these kernels
// round where the TPU kernel does not. Not yet done: other head dims
// (112, 256) and dtypes in the prefill and decode variants.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BK = 64;               // keys per kv tile
constexpr int NW = 4;                // 16-row groups per block
constexpr int BQ = 16 * NW;          // query rows per block
// warps per 16-row group: past hd 128 two warps share a group's rows,
// each holding half of O's columns (at hd 256 a whole row of O would take
// 128 registers a thread and spill); both compute the group's S
__host__ __device__ constexpr int mma_wpr(int hd) {
  return hd > 128 ? 2 : 1;
}
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

// the m16n8k16 A fragment of rows r0 and r0 + 8, k16 step ks, of a Q tile
// in shared memory with row stride LD
template <int LD>
__device__ __forceinline__ void q_frag(const __nv_bfloat16* Qs, int r0,
                                       int ks, int t4, uint32_t (&f)[4]) {
  const __nv_bfloat16* p0 = Qs + r0 * LD + ks * 16 + t4 * 2;
  const __nv_bfloat16* p1 = p0 + 8 * LD;
  f[0] = ld32(p0);
  f[1] = ld32(p1);
  f[2] = ld32(p0 + 8);
  f[3] = ld32(p1 + 8);
}

// One block an SM is all the launch bound promises: without it ptxas
// aims at more and spills at hd 16 and 112 (nvcc -Xptxas -v).
template <int HD>
__global__ void __launch_bounds__(NW * 32 * mma_wpr(HD), 1)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ q_offset,
                 __nv_bfloat16* __restrict__ out,
                 int Sq, int Skv, int H, int Hk, int causal, float scale) {
  constexpr int LD = HD + 8;         // shared-memory row stride (elements)
  constexpr int WPR = mma_wpr(HD);
  constexpr int NT_S = BK / 8;       // n8 tiles of a warp's S block
  constexpr int NT_O = HD / 8 / WPR; // n8 tiles of a warp's O block
  constexpr int KS = HD / 16;        // k16 steps over hd
  constexpr int VPR = HD / 8;        // 16-byte vectors per row
  constexpr int NTHR = NW * WPR * 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LD;
  __nv_bfloat16* Vs = Ks + BK * LD;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;   // mma group / thread in group
  const int rg = warp / WPR;                // this warp's 16-row group
  const int col0 = (warp % WPR) * NT_O * 8; // its first column of O
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

  // this warp's 16 query rows as mma A fragments: held in registers for
  // the whole loop up to hd 128; at hd 256 they would take 64 registers
  // beside O's and S's, so each k16 step reads its fragment from the Q
  // tile in shared memory again (8 KB a warp a kv tile, against the 32 KB
  // of K it reads there)
  const int r0 = rg * 16 + g;               // rows r0 and r0 + 8
  const bool live = q_start + rg * 16 < Sq; // warp-uniform
  constexpr bool Q_IN_REGS = HD <= 128;
  [[maybe_unused]] uint32_t qf[Q_IN_REGS ? KS : 1][4];
  if constexpr (Q_IN_REGS) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) q_frag<LD>(Qs, r0, ks, t4, qf[ks]);
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

    // S = Q K^T for this warp's 16 rows x BK keys, k16 steps outermost
    // (one Q fragment at a time when it is read from shared memory)
    float s[NT_S][4];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      if constexpr (Q_IN_REGS) {
        a[0] = qf[ks][0];
        a[1] = qf[ks][1];
        a[2] = qf[ks][2];
        a[3] = qf[ks][3];
      } else {
        q_frag<LD>(Qs, r0, ks, t4, a);
      }
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        const __nv_bfloat16* kr = Ks + (nt * 8 + g) * LD + ks * 16 + t4 * 2;
        mma_16816(s[nt], a, ld32(kr), ld32(kr + 8));
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
        const __nv_bfloat16* vr =
            Vs + (kk * 16 + t4 * 2) * LD + col0 + dt * 8 + g;
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
        out + ((static_cast<size_t>(b) * Sq + qi) * H + h) * HD + col0 +
        t4 * 2;
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

// -- the decode variant: split-KV, one K/V read per GQA group -----------------
//
// Sq == 1, hd 64 or 128, G = H / Hk <= 16. Grid (key split, kv head, batch
// row); a CTA of four warps serves the G query heads of its kv head over
// the keys [split * L, split * L + L):
//   1. cp.async issues the group's Q rows, then the split's visible K rows
//      and V rows (two commit groups) into padded shared memory; rows past
//      the last visible key are zero-filled, a split wholly past it loads
//      nothing;
//   2. S = Q K^T on mma.sync m16n8k16 with the G query rows as the M side
//      (rows G..15 zero), warp w taking the key tiles w, w + 4, ...; scaled
//      into log2 units and masked (-1e30) into shared memory;
//   3. a softmax pass, eight threads a row: the row max m, p = 2^(s - m)
//      (exactly 0 where masked) rounded to bf16 for P V, l = the sum of
//      the fp32 p;
//   4. O = P V on mma.sync, warp w taking the head-dim columns [w hd / 4,
//      (w + 1) hd / 4) over every key of the split (V's B fragments by
//      ldmatrix.trans);
//   5. one split: out = O / max(l, 1e-20). Several: (m, l, O) go to the
//      fp32 workspace, and the CTA that finishes last for its (b, kv head),
//      found by an atomic counter that it resets to 0 (the wrapper keeps
//      one counter buffer a stream, so the launches sharing one run in
//      order), merges them:
//      m* = max m_s, out = sum 2^(m_s - m*) O_s / max(sum 2^(m_s - m*) l_s,
//      1e-20) (the TPU kernel's _finish, over the splits).
// wgmma would need 64 query rows: at G <= 16 three quarters or more of
// every tile would be padding, so both products stay on mma.sync.
constexpr int D_THREADS = 128;               // four warps
constexpr int D_ROWS = 16;                   // the m16 tile: G <= 16 rows
constexpr int D_MAX_KEYS = 128;              // keys per split, at most

__host__ __device__ constexpr int d_ld(int keys) { return keys + 8; }
__host__ __device__ constexpr int d_smem(int hd, int keys) {
  return (D_ROWS + 2 * keys) * (hd + 8) * 2     // Q, K, V (bf16, padded)
         + D_ROWS * d_ld(keys) * 4              // S (fp32)
         + D_ROWS * d_ld(keys) * 2              // P (bf16)
         + 2 * D_ROWS * 4;                      // row m, l
}

// four 8x8 b16 matrices, transposed: lane l gives the address of row l % 8
// of matrix l / 8 and receives elements (2 (l % 4) .. +1, l / 4) of each
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r,
                                              const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_u32(p)));
}

template <int HD>
__global__ void __launch_bounds__(D_THREADS)
flash_decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const int* __restrict__ q_offset,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ part, int* __restrict__ counters,
                          int Skv, int H, int Hk, int keys, int causal,
                          float scale_log2) {
  using namespace hopper;
  constexpr int LD = HD + 8;                 // Q/K/V row stride (elements)
  constexpr int KS = HD / 16;                // k16 steps over hd
  constexpr int VPR = HD / 8;                // 16-byte vectors per row
  constexpr int NT_O = HD / 32;              // n8 tiles of a warp's O slice
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last_flag;
  const int SLD = d_ld(keys);                // S and P row stride
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + D_ROWS * LD;
  __nv_bfloat16* Vs = Ks + keys * LD;
  float* Ss = reinterpret_cast<float*>(Vs + keys * LD);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(Ss + D_ROWS * SLD);
  float* row_m = reinterpret_cast<float*>(Ps + D_ROWS * SLD);
  float* row_l = row_m + D_ROWS;

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int G = H / Hk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int pair = b * Hk + kvh;
  const __nv_bfloat16* qg = q + (static_cast<size_t>(b) * H + kvh * G) * HD;
  __nv_bfloat16* og = out + (static_cast<size_t>(b) * H + kvh * G) * HD;

  // the group's query rows (rows G..15 zero), then the split's K and V
  for (int i = tid; i < D_ROWS * VPR; i += D_THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    cp_async16(Qs + r * LD + c, qg + (r < G ? r : 0) * HD + c, r < G);
  }
  const int k0 = split * keys;
  int k1 = min(k0 + keys, Skv);
  if (causal) k1 = min(k1, q_offset[b] + 1);
  const int n = k1 - k0;                       // visible keys of the split
  const int n16 = n > 0 ? (n + 15) & ~15 : 0;  // rounded up to a k16 step
  const size_t kv_row = static_cast<size_t>(Hk) * HD;
  const size_t kv0 = (static_cast<size_t>(b) * Skv + k0) * kv_row + kvh * HD;
  for (int i = tid; i < n16 * VPR; i += D_THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    cp_async16(Ks + r * LD + c, k + kv0 + (r < n ? r : 0) * kv_row + c,
               r < n);
  }
  cp_async_commit();
  for (int i = tid; i < n16 * VPR; i += D_THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    cp_async16(Vs + r * LD + c, v + kv0 + (r < n ? r : 0) * kv_row + c,
               r < n);
  }
  cp_async_commit();

  // this split's partial: acc [G][HD], then (m, l) [G] after all the accs
  const size_t slot = static_cast<size_t>(pair) * nsplit + split;
  float* pacc = part + slot * G * HD;
  float2* pml = reinterpret_cast<float2*>(
      part + static_cast<size_t>(gridDim.z) * Hk * nsplit * G * HD);

  if (n <= 0) {                                // nothing visible
    cp_async_wait<0>();
    if (nsplit > 1) {
      if (tid < G) pml[slot * G + tid] = make_float2(NEG_INF, 0.f);
    } else {
      for (int i = tid; i < G * HD / 2; i += D_THREADS)
        reinterpret_cast<uint32_t*>(og)[i] = 0u;
      return;
    }
  } else {
    cp_async_wait<1>();                        // Q and K have landed
    __syncthreads();
    const int n_tiles = n16 / 8;
    if (warp < n_tiles) {
      uint32_t qf[KS][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const __nv_bfloat16* p0 = Qs + g * LD + ks * 16 + t4 * 2;
        qf[ks][0] = ld32(p0);
        qf[ks][1] = ld32(p0 + 8 * LD);
        qf[ks][2] = ld32(p0 + 8);
        qf[ks][3] = ld32(p0 + 8 * LD + 8);
      }
      for (int nt = warp; nt < n_tiles; nt += 4) {
        float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const __nv_bfloat16* kr = Ks + (nt * 8 + g) * LD + ks * 16 + t4 * 2;
          mma_16816(s, qf[ks], ld32(kr), ld32(kr + 8));
        }
        const int c = nt * 8 + t4 * 2;         // keys k0 + c, k0 + c + 1
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[e] = c + (e & 1) < n ? s[e] * scale_log2 : NEG_INF;
        *reinterpret_cast<float2*>(Ss + g * SLD + c) = make_float2(s[0], s[1]);
        *reinterpret_cast<float2*>(Ss + (g + 8) * SLD + c) =
            make_float2(s[2], s[3]);
      }
    }
    cp_async_wait<0>();                        // V has landed
    __syncthreads();

    // softmax: row tid / 8 over columns tid % 8, + 8, ...; rows past G are
    // computed (their Q is zero) and never stored
    {
      const int r = tid >> 3, c0 = tid & 7;
      float mx = NEG_INF;
      for (int c = c0; c < n16; c += 8) mx = fmaxf(mx, Ss[r * SLD + c]);
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float ls = 0.f;
      for (int c = c0; c < n16; c += 8) {
        const float sv = Ss[r * SLD + c];
        const float p = sv == NEG_INF ? 0.f : exp2f(sv - mx);
        ls += p;
        Ps[r * SLD + c] = __float2bfloat16_rn(p);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        ls += __shfl_xor_sync(0xffffffffu, ls, o);
      if (c0 == 0) {
        row_m[r] = mx;
        row_l[r] = ls;
      }
    }
    __syncthreads();

    // O = P V over this warp's head-dim columns
    float o[NT_O][4];
#pragma unroll
    for (int dt = 0; dt < NT_O; ++dt)
      o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
    const int col0 = warp * (HD / 4);
    // lane l reads row (l / 8 % 2) * 8 + l % 8 of the k16 step, columns
    // + (l / 16) * 8: matrices (k 0-7, n), (k 8-15, n), (k 0-7, n + 8), ...
    const __nv_bfloat16* vr = Vs + (((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                              col0 + (lane >> 4) * 8;
    for (int kk = 0; kk < n16 / 16; ++kk) {
      uint32_t a[4];
      const __nv_bfloat16* p0 = Ps + g * SLD + kk * 16 + t4 * 2;
      a[0] = ld32(p0);
      a[1] = ld32(p0 + 8 * SLD);
      a[2] = ld32(p0 + 8);
      a[3] = ld32(p0 + 8 * SLD + 8);
#pragma unroll
      for (int dp = 0; dp < NT_O; dp += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vr + kk * 16 * LD + dp * 8);
        mma_16816(o[dp], a, bv[0], bv[1]);
        mma_16816(o[dp + 1], a, bv[2], bv[3]);
      }
    }

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = g + 8 * hr;
      if (r >= G) continue;
      if (nsplit == 1) {
        const float inv = 1.f / fmaxf(row_l[r], 1e-20f);
        __nv_bfloat16* orow = og + r * HD + col0 + t4 * 2;
#pragma unroll
        for (int dt = 0; dt < NT_O; ++dt)
          *reinterpret_cast<uint32_t*>(orow + dt * 8) =
              pack_f32(o[dt][2 * hr] * inv, o[dt][2 * hr + 1] * inv);
      } else {
        float* prow = pacc + r * HD + col0 + t4 * 2;
#pragma unroll
        for (int dt = 0; dt < NT_O; ++dt)
          *reinterpret_cast<float2*>(prow + dt * 8) =
              make_float2(o[dt][2 * hr], o[dt][2 * hr + 1]);
      }
    }
    if (nsplit == 1) return;
    if (tid < G) pml[slot * G + tid] = make_float2(row_m[tid], row_l[tid]);
  }

  // the last CTA of this (b, kv head) to finish merges the splits
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last_flag = atomicAdd(&counters[pair], 1) == nsplit - 1;
  __syncthreads();
  if (!last_flag) return;
  __threadfence();
  const float2* ml = pml + static_cast<size_t>(pair) * nsplit * G;
  const float* acc0 = part + static_cast<size_t>(pair) * nsplit * G * HD;
  // per row r = tid / 8 (< G): m* and 1 / max(sum 2^(m_s - m*) l_s,
  // 1e-20), the eight lanes of a row taking every eighth split with a
  // running rescale, then combined by shuffles; no branch on a loaded
  // value, so the loads of several splits are in flight at once
  {
    const int r = tid >> 3, sub = tid & 7;
    float mx = NEG_INF, den = 0.f;
    if (r < G) {
#pragma unroll 4
      for (int s = sub; s < nsplit; s += 8) {
        const float2 e = __ldcg(&ml[s * G + r]);
        const float m_new = e.y > 0.f ? fmaxf(mx, e.x) : mx;
        den = den * exp2f(mx - m_new) +
              (e.y > 0.f ? e.y * exp2f(e.x - m_new) : 0.f);
        mx = m_new;
      }
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, mx, o);
      const float od = __shfl_xor_sync(0xffffffffu, den, o);
      const float m_new = fmaxf(mx, om);
      den = den * exp2f(mx - m_new) + od * exp2f(om - m_new);
      mx = m_new;
    }
    if (sub == 0 && r < G) {
      row_m[r] = mx;
      row_l[r] = 1.f / fmaxf(den, 1e-20f);
    }
  }
  __syncthreads();
  for (int i = tid; i < G * HD / 4; i += D_THREADS) {
    const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
    const float mx = row_m[r];
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    // an empty split's acc was never written: its loaded value is
    // selected away, never multiplied
#pragma unroll 4
    for (int s = 0; s < nsplit; ++s) {
      const float2 e = __ldcg(&ml[s * G + r]);
      const float4 a = __ldcg(reinterpret_cast<const float4*>(
          acc0 + (static_cast<size_t>(s) * G + r) * HD + c));
      const bool live = e.y > 0.f;
      const float w = live ? exp2f(e.x - mx) : 0.f;
      acc.x = fmaf(w, live ? a.x : 0.f, acc.x);
      acc.y = fmaf(w, live ? a.y : 0.f, acc.y);
      acc.z = fmaf(w, live ? a.z : 0.f, acc.z);
      acc.w = fmaf(w, live ? a.w : 0.f, acc.w);
    }
    const float inv = row_l[r];
    *reinterpret_cast<uint2*>(og + r * HD + c) =
        make_uint2(pack_f32(acc.x * inv, acc.y * inv),
                   pack_f32(acc.z * inv, acc.w * inv));
  }
  if (tid == 0) counters[pair] = 0;            // ready for the next launch
}

template <int HD>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const void* q_offset, void* out, void* part,
                          void* counters, int B, int Skv, int H, int Hk,
                          int keys, int causal, float scale,
                          cudaStream_t stream) {
  auto kern = flash_decode_split_kernel<HD>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        d_smem(HD, D_MAX_KEYS));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((Skv + keys - 1) / keys, Hk, B);
  kern<<<grid, D_THREADS, d_smem(HD, keys), stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const int*>(q_offset), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part), static_cast<int*>(counters), Skv, H, Hk,
      keys, causal, scale * 1.4426950408889634f);
  return cudaGetLastError();
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
  kern<<<grid, NW * 32 * mma_wpr(HD), smem, stream>>>(
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
    case 112:
      return launch<112>(q, k, v, q_offset, out, B, Sq, Skv, H, Hk, causal,
                          scale, s);
    case 128:
      return launch<128>(q, k, v, q_offset, out, B, Sq, Skv, H, Hk, causal,
                          scale, s);
    case 256:
      return launch<256>(q, k, v, q_offset, out, B, Sq, Skv, H, Hk, causal,
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

// The decode variant (Sq 1, hd 64 or 128, H / Hk <= 16): split-KV with
// `keys` keys a split (a multiple of 16, at most 128). part: the fp32
// workspace of ceil(Skv / keys) * B * H * (hd + 2) floats, counters: B * Hk
// ints, zero before the first launch and left zero by every launch (both
// unused, and may be null, when one split covers Skv). Same other
// arguments as flash_attention_fwd_bf16 but Sq. Returns
// cudaErrorInvalidValue for what it does not take, else cudaGetLastError()
// after the launch.
extern "C" int flash_attention_decode_bf16(const void* q, const void* k,
                                           const void* v,
                                           const void* q_offset, void* out,
                                           void* part, void* counters, int B,
                                           int Skv, int H, int Hk, int hd,
                                           int keys, int causal, float scale,
                                           void* stream) {
  if (B <= 0 || Skv <= 0 || Hk <= 0 || H % Hk != 0 || H / Hk > D_ROWS ||
      keys < 16 || keys > D_MAX_KEYS || keys % 16 != 0 ||
      (Skv > keys && (part == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch_decode<64>(q, k, v, q_offset, out, part, counters, B, Skv,
                               H, Hk, keys, causal, scale, s);
    case 128:
      return launch_decode<128>(q, k, v, q_offset, out, part, counters, B,
                                Skv, H, Hk, keys, causal, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
