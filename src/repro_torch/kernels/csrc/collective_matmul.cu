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
// the tensor cores' 989 TFLOP/s. The design is the simple one:
//   - bf16: one 64 x 128 output tile per block of 4 warps (a 32 x 64
//     warp tile, 2 x 8 mma.sync m16n8k16 accumulators of fp32); K walked
//     in 32-wide slabs through shared memory, rows padded by 8 elements
//     so the ldmatrix reads hit distinct banks; A fragments by
//     ldmatrix.x4, B fragments from the row-major [k][n] slab by
//     ldmatrix.x4.trans. With 16-byte loads (``vec``) the slabs stream
//     through a ring of STAGES buffers by cp.async, the loads of slab
//     t + STAGES - 1 in flight while slab t is multiplied (zero-filled
//     past the edges by the copy's source size); otherwise one slab at
//     a time (load, barrier, compute, barrier). Either way the k order
//     is the same, and so are the bits;
//   - f32: never TF32. A 64 x 64 tile per block of 256 threads, 4 x 4
//     outputs a thread, one __fmaf_rn per (output, k) in ascending k;
//   - ragged M, N and K: the slabs are zero-filled past the edges in
//     shared memory (a zero adds nothing to a sum), stores are masked;
//   - 16-byte vector loads when the leading dimensions, K, N and the
//     pointers allow them (``vec``), element loads otherwise;
//   - leading dimensions (lda, ldb, ldc) are arguments, so a column
//     slice of a row-major matrix is read in place.
// Not yet done (a later PR's work): wgmma and TMA, a persistent tile
// loop, more blocks for grids smaller than the card (no split-K allowed).
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// 16 bytes global -> shared, asynchronously; zero-filled when !pred (the
// source size is 0 and nothing is read)
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           bool pred) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N_PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N_PENDING));
}

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
