// Per-chunk matmul of the gather-fused collective matmul, for Hopper
// (sm_90a): out[M,N] = x[M,K] @ w[K,N], fp32 accumulation, output in the
// input dtype.
//
// Replaces the TPU kernel src/repro/kernels/collective_matmul.py:
// _matmul_kernel (Pallas; driven by matmul_chunk). The rings around it
// (kernels/collective_matmul.py) call it once per chunk: the forward's
// x @ w_chunk, and under mode 'both' the backward's g_cols @ chunk.T and
// x2.T @ g_cols.
//
// The contract it keeps (the TPU kernel's): every output element is ONE
// dot over the whole contraction, its k-steps taken in a fixed order
// (k = 0, 16, 32, ... on the tensor cores; k = 0, 1, 2, ... on the CUDA
// cores) that depends on nothing but K. There is no split-K, and a tile's
// position, the tile grid and M and N never change the order. So the
// column block j of x @ w_full equals x @ w_chunk_j bit for bit: the
// column-concat identity the ring rests on.
//
// What bounds it on this card: at the train path's shapes (M = 1,024
// tokens, K and N 1,024 to 11,008) it does 200-1,000 flops per byte it
// must move, above the H100's ~295 bf16 flops/byte ridge, so the bound is
// the tensor cores' 989 TFLOP/s. Two bf16 variants and one f32 kernel:
//   - bf16, wgmma + TMA (``matmul_chunk_bf16_tma``), for every pair of
//     operands TMA can read in place: each one row-major or column-major
//     with a leading dimension of a multiple of 8 elements, a K-major one
//     (x row-major, w column-major) 16-byte aligned. An MN-major one (x
//     column-major, w row-major) may start anywhere: its map starts at
//     the base rounded down to 16 bytes, widened by the elements before
//     it, and the tile grid moves with it (a box must start on a 16-byte
//     boundary; the products of the elements before the operand are not
//     stored), so a column chunk of a row-major weight takes this variant
//     whenever the full weight does.
//     Every output tile is 64 x 128, computed by one consumer warpgroup
//     that issues wgmma m64n128k16 from shared memory (four per 64-wide k
//     slab, ascending, one group in flight; fp32 accumulators in
//     registers). One producer warp per CTA keeps a ring of TMA loads in
//     flight (full/empty mbarriers; 128-byte swizzle; A one 64 x 64 box a
//     tile, B two). Operand layouts map to the wgmma transpose bits, so
//     mode 'both''s chunk.T and x2.T are read in place. What the card
//     showed (PERF.md) and what the design does about it:
//       * split-K is not allowed and a 128 x 128 tile would leave half
//         the card idle at the w_out and wo chunks (64 tiles), so tiles
//         stay 64 x 128 (128 of them there);
//       * the operand feed binds: each SM receives 24 KB a slab per
//         64 x 128 tile (43 flops a byte). CTA pairs along M form a
//         cluster and each multicasts half of the shared B slab into
//         both (the L2 reads of a 128 x 128 tile); where the tiles
//         outnumber the SMs a CTA holds two M-adjacent tiles that share
//         the B slab (64 flops a byte), with a 5-stage ring, else one
//         tile and 8 stages; either way one CTA per SM, persistent over
//         its tile groups, so the producer loads the next tile during an
//         epilogue (larger clusters, two CTAs per SM and shallower rings
//         were slower on the card);
//       * a cross-CTA arrive with .release.cluster tripled the time: the
//         remote arrives use the default semantics;
//       * writing a 22.5 MB output with the accumulators' scattered
//         4-byte stores cost a third of the time at mode 'both''s
//         shapes: each tile goes through shared memory (128-byte swizzle,
//         bank-conflict free) and out by one TMA bulk store that runs on
//         under the next tile's mainloop (16-byte stores where TMA cannot
//         take the output);
//       * the consumer needs 90 registers, so no register is moved
//         between the roles (no setmaxnreg); a second accumulator that
//         would overlap the epilogue with the next tile's first slab
//         made ptxas serialize the wgmma (C7518) and was dropped.
//   - bf16, mma.sync (``matmul_chunk_bf16``), for what TMA cannot take
//     (a leading dimension not a multiple of 8, a misaligned K-major
//     base): both operands row-major (the wrapper copies a column-major
//     one first); one 64 x 128 tile per block of 4 warps (a 32 x 64 warp
//     tile of mma.sync m16n8k16, fp32), K in 32-wide slabs through padded
//     shared memory by ldmatrix; with 16-byte loads (``vec``) the slabs
//     stream through a 3-stage cp.async ring, otherwise one slab at a
//     time. Both bf16 variants sum each output over ascending k16 steps
//     on the tensor cores, and chip_smoke.py holds them equal bit for bit
//     (a full weight of one variant against its contiguous column chunks
//     of the other), so the variant a shape takes never changes its bits;
//   - f32: never TF32. A 64 x 64 tile per block of 256 threads, 4 x 4
//     outputs a thread, one __fmaf_rn per (output, k) in ascending k;
//   - ragged M, N and K: zero-filled past the edges in shared memory (by
//     TMA's out-of-bounds fill or by the loads; a zero adds nothing to a
//     sum), stores are masked;
//   - leading dimensions are arguments, so a column slice is read in
//     place.
// Not yet done: an epilogue overlapped with the tensor cores (the ~10 %
// left at mode 'both''s shapes), tiles past 64 x 128 (the contract fixes
// the tile).
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// bf16 tensor-core path
constexpr int BM = 64, BN = 128, BK = 32;      // block tile, k slab
constexpr int WM = 32, WN = 64;                // warp tile
constexpr int MT = WM / 16, NT = WN / 8;       // m16 / n8 tiles per warp
constexpr int WARPS_M = BM / WM;
constexpr int NTHR = (BM / WM) * (BN / WN) * 32;   // 128
constexpr int LDA_S = BK + 8;                  // shared row pitch (elements)
constexpr int LDB_S = BN + 8;
constexpr int STAGES = 3;                      // cp.async ring depth
constexpr int A_TILE = BM * LDA_S, B_TILE = BK * LDB_S;

// f32 CUDA-core path
constexpr int FBM = 64, FBN = 64, FBK = 16, FTHR = 256, FPAD = 4;

__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and receives element (l / 4, 2 (l % 4) .. +1) of each
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// the same, transposed: lane l receives elements (2 (l % 4) .. +1, l / 4)
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;

// issue the cp.async loads of the slab at k0 into one ring stage
__device__ __forceinline__ void load_slab_async(
    bf16* As, bf16* Bs, const bf16* __restrict__ x,
    const bf16* __restrict__ w, int M, int N, int K, long long lda,
    long long ldb, int m0, int n0, int k0, int tid) {
#pragma unroll
  for (int it = 0; it < BM * BK / 8 / NTHR; ++it) {
    const int i = tid + it * NTHR;
    const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
    const bool ok = m0 + r < M && k0 + c < K;
    cp_async16(As + r * LDA_S + c,
               ok ? x + static_cast<size_t>(m0 + r) * lda + k0 + c : x, ok);
  }
#pragma unroll
  for (int it = 0; it < BK * BN / 8 / NTHR; ++it) {
    const int i = tid + it * NTHR;
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    const bool ok = k0 + r < K && n0 + c < N;
    cp_async16(Bs + r * LDB_S + c,
               ok ? w + static_cast<size_t>(k0 + r) * ldb + n0 + c : w, ok);
  }
}

// acc += the slab's [BM, BK] x [BK, BN] for this warp's 32 x 64 tile, k
// in ascending 16-steps
__device__ __forceinline__ void mma_slab(const bf16* As, const bf16* Bs,
                                         float (&acc)[MT][NT][4], int wm,
                                         int wn, int lane) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldsm_x4(a[mt], As + (wm * WM + mt * 16 + (lane & 15)) * LDA_S +
                         kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      // b[0], b[1]: n8 tile 2np (k 0-7, 8-15); b[2], b[3]: tile 2np+1
      uint32_t b[4];
      ldsm_x4_trans(b, Bs + (kk * 16 + (lane & 15)) * LDB_S + wn * WN +
                           np * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_16816(acc[mt][2 * np], a[mt], b[0], b[1]);
        mma_16816(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(NTHR)
mm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               bf16* __restrict__ out, int M, int N, int K, long long lda,
               long long ldb, long long ldc) {
  __shared__ __align__(16) bf16 As[STAGES * A_TILE];
  __shared__ __align__(16) bf16 Bs[STAGES * B_TILE];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;        // mma group / thread in it
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bf16 zero = __ushort_as_bfloat16(0);
  const int nk = (K + BK - 1) / BK;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  if (VEC) {
    // ring of STAGES slabs: slab t lives in stage t % STAGES; one commit
    // group per slab (empty past the end) keeps the wait count uniform
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk)
        load_slab_async(As + s * A_TILE, Bs + s * B_TILE, x, w, M, N, K, lda,
                        ldb, m0, n0, s * BK, tid);
      cp_async_commit();
    }
    for (int t = 0; t < nk; ++t) {
      cp_async_wait<STAGES - 2>();              // slab t has landed
      __syncthreads();                          // ... for every thread, and
                                                // slab t - 1 is consumed
      const int nxt = t + STAGES - 1;
      if (nxt < nk) {
        const int s = nxt % STAGES;
        load_slab_async(As + s * A_TILE, Bs + s * B_TILE, x, w, M, N, K,
                        lda, ldb, m0, n0, nxt * BK, tid);
      }
      cp_async_commit();
      const int s = t % STAGES;
      mma_slab(As + s * A_TILE, Bs + s * B_TILE, acc, wm, wn, lane);
    }
  } else {
    for (int k0 = 0; k0 < K; k0 += BK) {
      // the x slab [BM, BK] and the w slab [BK, BN], zero past the edges
      for (int i = tid; i < BM * BK; i += NTHR) {
        const int r = i / BK, c = i % BK;
        As[r * LDA_S + c] =
            (m0 + r < M && k0 + c < K)
                ? x[static_cast<size_t>(m0 + r) * lda + k0 + c] : zero;
      }
      for (int i = tid; i < BK * BN; i += NTHR) {
        const int r = i / BN, c = i % BN;
        Bs[r * LDB_S + c] =
            (k0 + r < K && n0 + c < N)
                ? w[static_cast<size_t>(k0 + r) * ldb + n0 + c] : zero;
      }
      __syncthreads();
      mma_slab(As, Bs, acc, wm, wn, lane);
      __syncthreads();                          // slab consumed
    }
  }

  // accumulator element e of tile (mt, nt): row g + 8 (e >> 1), column
  // 2 t4 + (e & 1)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * WM + mt * 16 + g + 8 * h;
      if (row >= M) continue;
      bf16* orow = out + static_cast<size_t>(row) * ldc;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = n0 + wn * WN + nt * 8 + 2 * t4;
        if (col < N) orow[col] = __float2bfloat16_rn(acc[mt][nt][2 * h]);
        if (col + 1 < N)
          orow[col + 1] = __float2bfloat16_rn(acc[mt][nt][2 * h + 1]);
      }
    }
  }
}

// bf16 wgmma + TMA path: 64 x 128 output tiles, each computed by one
// consumer warpgroup; a CTA holds WGS M-adjacent tiles (warps 0 .. 4 WGS -
// 1, sharing the B slab) and one producer warp (warp 4 WGS); CTA pairs
// along M form a cluster, share the B slab, and walk their tile groups
// persistently
constexpr int TBM = 64, TBN = 128, TBK = 64;    // tile, k slab
constexpr int T_A_BYTES = TBM * TBK * 2;        // 8 KB a tile: one box
constexpr int T_B_BYTES = TBK * TBN * 2;        // 16 KB: two boxes
constexpr int T_BOX_BYTES = 64 * 64 * 2;
constexpr int T_CLUSTER = 2;                    // CTAs sharing a B slab
constexpr uint16_t T_MASK = (1u << T_CLUSTER) - 1;

constexpr int T_OUT_LD = TBN + 8;               // padded staging pitch
constexpr int T_OUT_BYTES = 18 * 1024;          // a tile's staging (both
                                                // layouts), 1 KB aligned

__host__ __device__ constexpr int t_threads(int wgs) { return 128 * wgs + 32; }
__host__ __device__ constexpr int t_stage_bytes(int wgs) {
  return wgs * T_A_BYTES + T_B_BYTES;
}
// the ring, its barriers (2 x 8 bytes a stage, at most 8 stages), then
// one output tile's staging per warpgroup
__host__ __device__ constexpr int t_out_offset(int stages, int wgs) {
  return stages * t_stage_bytes(wgs) + 1024;    // 1 KB aligned (swizzle)
}
__host__ __device__ constexpr int t_smem(int stages, int wgs) {
  return 1024 + t_out_offset(stages, wgs) + wgs * T_OUT_BYTES;
}

// bar.sync on a named barrier of one warpgroup (ids 1 + wg; 0 is
// __syncthreads')
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// TA / TB: 0 = the operand is K-major (x row-major, or w column-major),
// 1 = MN-major (x column-major, or w row-major); sa / sb: the elements the
// MN-major map's base lies before the operand (its base rounded down to
// 16 bytes; 0 for K-major). Tiles lie on the maps' coordinates, which
// every box starts on a 16-byte boundary of: output row = map row - sa,
// output column = map column - sb; outputs before 0 are not stored.
// A cluster's tile group is T_CLUSTER x WGS M-adjacent tiles of one n
// block; cluster c walks the groups c, c + n_clusters, ... (group p: n
// block p / m_groups, CTA rank r's first m block (T_CLUSTER (p % m_groups)
// + r) WGS). Each CTA loads 1/T_CLUSTER of the group's B slab into all of
// them (a K-major B by n rows, an MN-major one by k rows, so every piece
// is whole 1,024-byte swizzle atoms); slab g (counted across the CTA's
// tiles) lives in stage g % STAGES.
template <int TA, int TB, int STAGES, int WGS>
__global__ void __cluster_dims__(T_CLUSTER, 1, 1)
__launch_bounds__(t_threads(WGS), 1)
mm_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const __grid_constant__ CUtensorMap map_out,
                     bf16* __restrict__ out, int M, int N, int K,
                     long long ldc, int sa, int sb, int tma_out) {
  using namespace hopper;
  static_assert(STAGES <= 8 && t_smem(STAGES, WGS) <= 232448,
                "ring barriers or shared memory do not fit");
  constexpr int STAGE_BYTES = t_stage_bytes(WGS);
  constexpr int A_BYTES = WGS * T_A_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* tiles = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t rank = cluster_ctarank();
  const int nk = (K + TBK - 1) / TBK;
  const int per_group = T_CLUSTER * WGS;          // m blocks of a group
  const int m_groups = ((M + sa + TBM - 1) / TBM + per_group - 1) / per_group;
  const int n_groups = m_groups * ((N + sb + TBN - 1) / TBN);
  const int cluster = blockIdx.x / T_CLUSTER;
  const int n_clusters = gridDim.x / T_CLUSTER;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);                     // the producer's arrival
      mbar_init(&empty[s], T_CLUSTER * 4 * WGS);  // every consumer warp of
    }                                             // every CTA
    fence_barrier_init();
  }
  cluster_sync();   // the peer's barriers exist before any multicast

  if (warp == 4 * WGS) {
    // producer: slab g into stage g % STAGES once every CTA of the
    // cluster released it; this CTA's A tiles, its piece of B to all
    if (lane == 0) {
      tma_prefetch_desc(&map_a);
      tma_prefetch_desc(&map_b);
      const int r = static_cast<int>(rank);
      int g = 0;
      for (int p = cluster; p < n_groups; p += n_clusters) {
        const int m0 = ((p % m_groups) * T_CLUSTER + r) * WGS * TBM;
        const int n0 = (p / m_groups) * TBN;
        for (int t = 0; t < nk; ++t, ++g) {
          const int s = g % STAGES, k0 = t * TBK;
          if (g >= STAGES) mbar_wait(&empty[s], ((g / STAGES) - 1) & 1);
          mbar_expect_tx(&full[s], STAGE_BYTES);
          unsigned char* as = tiles + s * STAGE_BYTES;
          unsigned char* bs = as + A_BYTES;
          for (int w = 0; w < WGS; ++w) {
            if (TA == 0)
              tma_load_2d(as + w * T_A_BYTES, &map_a, &full[s], k0,
                          m0 + w * TBM);
            else
              tma_load_2d(as + w * T_A_BYTES, &map_a, &full[s],
                          m0 + w * TBM, k0);
          }
          if (TB == 0) {
            tma_load_2d_multicast(bs + r * (T_B_BYTES / T_CLUSTER), &map_b,
                                  &full[s], k0, n0 + r * (TBN / T_CLUSTER),
                                  T_MASK);
          } else {
            for (int h = 0; h < 2; ++h)
              tma_load_2d_multicast(
                  bs + h * T_BOX_BYTES + r * (T_BOX_BYTES / T_CLUSTER),
                  &map_b, &full[s], n0 + 64 * h, k0 + r * (TBK / T_CLUSTER),
                  T_MASK);
          }
        }
      }
    }
    __syncwarp();
  } else {
    // consumer warpgroup wg: four m64n128k16 per slab in ascending k, one
    // group in flight; a slab's stage is released once the next group is
    // issued and the slab's own group has completed (the tile's last slab
    // after the final wait), so the producer loads the next tile during
    // the epilogue
    const int wg = warp >> 2, wq = warp & 3;
    bf16* stage_out = reinterpret_cast<bf16*>(
        tiles + t_out_offset(STAGES, WGS) + wg * T_OUT_BYTES);
    // 16-byte stores need 16-byte aligned rows and chunk starts
    const bool vec_out = ldc % 8 == 0 && sb == 0 &&
                         reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const bool leader = (tid & 127) == 0;
    int g = 0;
    for (int p = cluster; p < n_groups; p += n_clusters) {
      const int m0 = (((p % m_groups) * T_CLUSTER + static_cast<int>(rank)) *
                          WGS + wg) * TBM;
      const int n0 = (p / m_groups) * TBN;
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int t = 0; t < nk; ++t, ++g) {
        const int s = g % STAGES;
        mbar_wait(&full[s], (g / STAGES) & 1);
        const uint32_t as = smem_u32(tiles + s * STAGE_BYTES) + wg * T_A_BYTES;
        const uint32_t bs = smem_u32(tiles + s * STAGE_BYTES) + A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TBK / 16; ++kk) {
          const uint64_t da = TA == 0 ? desc_sw128(as + 32 * kk, 16, 1024)
                                      : desc_sw128(as + 2048 * kk,
                                                   T_BOX_BYTES, 1024);
          const uint64_t db = TB == 0 ? desc_sw128(bs + 32 * kk, 16, 1024)
                                      : desc_sw128(bs + 2048 * kk,
                                                   T_BOX_BYTES, 1024);
          wgmma_m64n128k16_ss<TA, TB>(acc, da, db, 1);
        }
        wgmma_commit();
        wgmma_wait<1>();
        // lane c of each warp releases the stage in CTA c
        if (t > 0 && lane < T_CLUSTER)
          mbar_arrive_cluster(&empty[(g - 1) % STAGES], lane);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane < T_CLUSTER)
        mbar_arrive_cluster(&empty[(g - 1) % STAGES], lane);
      // epilogue: the tile in bf16 into this warpgroup's staging (element
      // 4j + e: row 16 wq + lane/4 + 8 (e >> 1), column 8j + 2 (lane % 4)
      // + (e & 1)), then out. With ``tma_out``: two 64 x 64 boxes in the
      // 128-byte swizzle (the eight rows of a store on distinct banks), one
      // thread's bulk store, which runs on under the next tile's
      // mainloop; else padded rows and 16-byte (or element) stores.
      if (tma_out) {
        if (leader) bulk_wait_read();  // the previous tile's store read it
        warpgroup_sync(wg);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * wq + (lane >> 2) + 8 * h;
#pragma unroll
          for (int j = 0; j < TBN / 8; ++j) {
            unsigned char* box = reinterpret_cast<unsigned char*>(stage_out) +
                                 (j / 8) * T_BOX_BYTES + r * 128;
            *reinterpret_cast<__nv_bfloat162*>(
                box + ((j % 8) ^ (r % 8)) * 16 + 4 * (lane & 3)) =
                __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                      acc[4 * j + 2 * h + 1]);
          }
        }
        fence_proxy_async();
        warpgroup_sync(wg);
        if (leader) {
          for (int b = 0; b < 2; ++b)
            tma_store_2d(&map_out, reinterpret_cast<unsigned char*>(
                             stage_out) + b * T_BOX_BYTES,
                         n0 + 64 * b, m0 - sa);
          bulk_commit();
        }
        continue;
      }
      warpgroup_sync(wg);            // the previous tile's chunks are out
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bf16* srow = stage_out + (16 * wq + (lane >> 2) + 8 * h) * T_OUT_LD;
#pragma unroll
        for (int j = 0; j < TBN / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(srow + 8 * j + 2 * (lane & 3)) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                    acc[4 * j + 2 * h + 1]);
      }
      warpgroup_sync(wg);
#pragma unroll
      for (int i = 0; i < TBM * TBN / 8 / 128; ++i) {
        const int c = (tid & 127) + 128 * i;
        const int r = c / (TBN / 8), c8 = (c % (TBN / 8)) * 8;
        const int row = m0 - sa + r, col = n0 - sb + c8;
        if (row < 0 || row >= M) continue;
        const bf16* src = stage_out + r * T_OUT_LD + c8;
        bf16* dst = out + static_cast<size_t>(row) * ldc + col;
        if (vec_out && col >= 0 && col + 8 <= N) {
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (col + e >= 0 && col + e < N) dst[e] = src[e];
        }
      }
    }
    if (tma_out && leader) bulk_wait();
  }
  // the peer may still arrive on this CTA's barriers
  __syncwarp();
  cluster_sync();
}

__global__ void __launch_bounds__(FTHR)
mm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
              float* __restrict__ out, int M, int N, int K, long long lda,
              long long ldb, long long ldc) {
  __shared__ float As[FBK][FBM + FPAD];         // x slab, k-major
  __shared__ float Bs[FBK][FBN + FPAD];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;       // columns tx + 16 j, rows ty + 16 i
  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FBK) {
#pragma unroll
    for (int it = 0; it < FBM * FBK / FTHR; ++it) {
      const int i = tid + it * FTHR;
      const int r = i / FBK, c = i % FBK;
      As[c][r] = (m0 + r < M && k0 + c < K)
                     ? x[static_cast<size_t>(m0 + r) * lda + k0 + c] : 0.f;
    }
#pragma unroll
    for (int it = 0; it < FBK * FBN / FTHR; ++it) {
      const int i = tid + it * FTHR;
      const int r = i / FBN, c = i % FBN;
      Bs[r][c] = (k0 + r < K && n0 + c < N)
                     ? w[static_cast<size_t>(k0 + r) * ldb + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) out[static_cast<size_t>(row) * ldc + col] = acc[i][j];
    }
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes). x [M, K] with row stride lda,
// w [K, N] with row stride ldb, out [M, N] with row stride ldc (elements).
// vec != 0 promises 16-byte aligned pointers and lda, ldb, K, N multiples
// of 8 (the wrapper decides). Return cudaGetLastError() after the launch.
extern "C" int matmul_chunk_bf16(const void* x, const void* w, void* out,
                                 int M, int N, int K, long long lda,
                                 long long ldb, long long ldc, int vec,
                                 void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(w);
  bf16* op = static_cast<bf16*>(out);
  if (vec)
    mm_bf16_kernel<true><<<grid, NTHR, 0, s>>>(xp, wp, op, M, N, K, lda, ldb,
                                               ldc);
  else
    mm_bf16_kernel<false><<<grid, NTHR, 0, s>>>(xp, wp, op, M, N, K, lda,
                                                ldb, ldc);
  return static_cast<int>(cudaGetLastError());
}

// The TMA map of one wgmma operand: a matrix with ``mn`` rows or columns
// of the output side and ``k`` of the contraction, stored K-major
// (element (i, kk) at p[i * ld + kk]) or MN-major (at p[kk * ld + i]), in
// boxes 64 wide (128 bytes) and ``box_outer`` deep. A K-major base must
// be 16-byte aligned; an MN-major base is rounded down to 16 bytes and
// the map widened by the elements before it (*shift; boxes start on
// 16-byte boundaries of the map, so the first tile also reads those
// elements, whose products are not stored).
// Returns false for what TMA cannot take.
static bool operand_map(CUtensorMap* map, const void* p, int mn_major,
                        int mn, int k, long long ld, int box_outer,
                        int* shift) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  if (ld <= 0 || (ld * 2) % 16 != 0 || ld * 2 >= (1ll << 40)) return false;
  *shift = mn_major ? static_cast<int>((addr % 16) / 2) : 0;
  if (!mn_major && addr % 16 != 0) return false;
  const void* base = reinterpret_cast<const void*>(addr - 2 * *shift);
  const cuuint64_t dims[2] = {
      static_cast<cuuint64_t>(mn_major ? mn + *shift : k),
      static_cast<cuuint64_t>(mn_major ? k : mn)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld * 2)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_outer)};
  return hopper::encode_bf16(map, base, 2, dims, strides, box);
}

template <int TA, int TB, int STAGES, int WGS>
static int launch_wgmma(const CUtensorMap& ma, const CUtensorMap& mb,
                        const CUtensorMap& mo, bf16* out, int M, int N, int K,
                        long long ldc, int sa, int sb, int tma_out, int sms,
                        cudaStream_t s) {
  static bool configured = false;
  auto kern = mm_bf16_wgmma_kernel<TA, TB, STAGES, WGS>;
  constexpr int smem = t_smem(STAGES, WGS);
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  // persistent: at most the clusters that fit the card at once
  const int per_group = T_CLUSTER * WGS;
  const int m_groups = ((M + sa + TBM - 1) / TBM + per_group - 1) / per_group;
  const int groups = m_groups * ((N + sb + TBN - 1) / TBN);
  const int most = (smem > 114 * 1024 ? 1 : 2) * sms / T_CLUSTER;
  const int clusters = groups < most ? groups : most;
  kern<<<clusters * T_CLUSTER, t_threads(WGS), smem, s>>>(
      ma, mb, mo, out, M, N, K, ldc, sa, sb, tma_out);
  return static_cast<int>(cudaGetLastError());
}

// Launch configurations (neither moves a bit: every tile is 64 x 128 and
// sums over k in the same order), one CTA per SM: up to one tile per SM,
// one tile a CTA and an 8-stage ring; beyond, two tiles a CTA sharing the
// B slab (64 flops per byte fed to the SM instead of 43) and 5 stages.
template <int TA, int TB>
static int launch_wgmma(const CUtensorMap& ma, const CUtensorMap& mb,
                        bf16* out, int M, int N, int K, long long ldc, int sa,
                        int sb, cudaStream_t s) {
  // the output by TMA where its rows are 16-byte aligned and the tiles
  // start on its rows and 16-byte column boundaries (no shift), else by
  // plain stores
  CUtensorMap mo = {};
  int tma_out = 0;
  if (ldc % 8 == 0 && sa == 0 && sb == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N),
                                static_cast<cuuint64_t>(M)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ldc * 2)};
    const cuuint32_t box[2] = {64, 64};
    tma_out = hopper::encode_bf16(&mo, out, 2, dims, strides, box) ? 1 : 0;
  }
  static int sm_count[64] = {0};                 // per device, read once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sm_count[dev] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int sms = sm_count[dev];
  const long long tiles = static_cast<long long>((M + sa + TBM - 1) / TBM) *
                          ((N + sb + TBN - 1) / TBN);
  if (tiles <= sms)
    return launch_wgmma<TA, TB, 8, 1>(ma, mb, mo, out, M, N, K, ldc, sa, sb,
                                      tma_out, sms, s);
  return launch_wgmma<TA, TB, 5, 2>(ma, mb, mo, out, M, N, K, ldc, sa, sb,
                                    tma_out, sms, s);
}

// The wgmma + TMA variant. x [M, K]: K-major (x_mn = 0, row stride lda)
// or MN-major (x_mn = 1, column stride lda); w [K, N]: MN-major (w_mn =
// 1, row stride ldb) or K-major (w_mn = 0, column stride ldb); out [M, N]
// row stride ldc. Returns cudaErrorInvalidValue for an operand TMA cannot
// take (the wrapper sends only what it can), else cudaGetLastError().
extern "C" int matmul_chunk_bf16_tma(const void* x, const void* w, void* out,
                                     int M, int N, int K, long long lda,
                                     long long ldb, long long ldc, int x_mn,
                                     int w_mn, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma, mb;
  int sa = 0, sb = 0;
  // A: 64 x 64 boxes; B: this CTA's piece of the shared 64 x 128 slab
  if (!operand_map(&ma, x, x_mn, M, K, lda, 64, &sa) ||
      !operand_map(&mb, w, w_mn, N, K, ldb,
                   w_mn ? TBK / T_CLUSTER : TBN / T_CLUSTER, &sb))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* op = static_cast<bf16*>(out);
  if (x_mn)
    return w_mn ? launch_wgmma<1, 1>(ma, mb, op, M, N, K, ldc, sa, sb, s)
                : launch_wgmma<1, 0>(ma, mb, op, M, N, K, ldc, sa, sb, s);
  return w_mn ? launch_wgmma<0, 1>(ma, mb, op, M, N, K, ldc, sa, sb, s)
              : launch_wgmma<0, 0>(ma, mb, op, M, N, K, ldc, sa, sb, s);
}

extern "C" int matmul_chunk_f32(const void* x, const void* w, void* out,
                                int M, int N, int K, long long lda,
                                long long ldb, long long ldc, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM);
  mm_f32_kernel<<<grid, FTHR, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), M, N, K, lda, ldb, ldc);
  return static_cast<int>(cudaGetLastError());
}
