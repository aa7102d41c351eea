// Symmetric per-256-block int8 quantization for Hopper (sm_90a): the hot
// loops of the int8 stage-1 transports (qwZ weight gather, qgZ gradient
// reduce-scatter) and of the int8 tensor-parallel activation all-reduce.
//
// Replaces the JAX package's Pallas kernels in src/repro/kernels/quant.py:
//   int8_quantize_blocks_*    <- quantize_blocks     (_quantize_kernel)
//   int8_dequantize_blocks_*  <- dequantize_blocks   (_dequantize_kernel)
//   int8_dequant_accumulate_*, <- dequant_accumulate (_dequant_acc_kernel)
//   int8_dequant_requantize
//
// The chunked layout (quantize and dequantize). A dense tensor holds
// n_chunks chunks of chunk_elems elements each, back to back. Chunk c is
// quantized into blocks [c * bpc, (c + 1) * bpc) of the [n_chunks * bpc,
// 256] int8 grid, bpc >= ceil(chunk_elems / 256); elements past
// chunk_elems count as zeros. So a kernel reads (quantize) or writes
// (dequantize) the callers' ragged chunks in place, in the callers'
// dtype, and no caller pads, widens, slices or casts around it. One
// chunk of whole blocks is the plain [nb, 256] grid.
//
// dequant_accumulate writes the first chunk_elems elements of its fold
// (one chunk; the rest of the last block is not written) in f32 or bf16,
// or, for the int8 TP all-reduce, requantizes the fold in registers into
// int8 blocks and scales: what quantize would make of the f32 fold.
//
// Bound: bytes. Each kernel does a handful of flops per element, far below
// the card's ~295 flops per byte, so its least time is bytes / 3.35e12:
//   quantize            reads n_chunks * chunk_elems * 4 (f32) or * 2
//                       (bf16), writes nb*256 (int8) + nb*4 (scales)
//   dequantize          reads nb*256 + nb*4, writes n_chunks * chunk_elems
//                       * 4 (f32) or * 2 (bf16)
//   dequant_accumulate  reads n*(nb*256 + nb*4), writes chunk_elems * 4
//                       (f32) or * 2 (bf16), or nb*256 + nb*4 (requantized)
// A byte-bound elementwise pass needs coalesced 16-byte accesses and
// enough of them in flight, nothing more: no TMA (a tile staged through
// shared memory adds a trip and saves none) and no wgmma (no product).
//   * quantize: one warp per 256-element block, 8 elements a lane (f32:
//     two groups of 4, so each load instruction of the warp reads 512
//     contiguous bytes), a block's loads issued before any value is used.
//     kQRows blocks a warp: 1. Two and four, which give a lane two or
//     four blocks' loads in flight, were measured 1-14 % and 7-47 %
//     slower at every shape (H100, kernel_ab.py's int8 cases). Inferred,
//     not profiled: a lane's 8 correctly rounded divisions a block, not
//     the loads in flight, pace a warp, and fewer warps hide less. A block
//     reads 16-byte vectors when it lies whole inside its chunk and the
//     chunk starts 16-byte aligned (both tested per block, so uniform
//     across the warp); otherwise masked scalar loads, zeros past
//     chunk_elems.
//   * dequantize: 16 int8 values a thread in one 16-byte load, kDqRows
//     blocks a warp, staged through 512 bytes of shared memory a warp so
//     that each store instruction writes 4 contiguous values a lane and
//     the warp's stores are contiguous (16 values a lane written from
//     registers would leave a 64-byte stride between lanes: measured
//     2.9x slower than staging, for an f32 output). The values go to the
//     dense output in the caller's dtype, 4-value vector stores where
//     the 4 lie inside the chunk and the chunk starts aligned to the
//     vector, scalar stores otherwise; chunk padding is not written.
//   * dequant_accumulate: one warp per block, lane l holding elements
//     [4l, 4l + 4) and [128 + 4l, 128 + 4l + 4) (the f32 quantize's
//     lanes), so each of a source's two 4-byte loads of the warp reads
//     128 contiguous bytes and each store writes 512 (f32), 256 (bf16) or
//     128 (int8) contiguous bytes; the requantize takes the block's max
//     with shuffles, as quantize does. n = 2 (the `pod` and `model`
//     axes of the paths the smoke drives) has an instance with both
//     sources' loads issued before the first fold; any other n a loop,
//     a source at a time. (8 contiguous elements a lane would put 32
//     bytes between the lanes' f32 stores: a store instruction of the
//     warp covering 1 KB to write 512 bytes.) A block whole inside the
//     chunk stores vectors; the chunk's last block masked scalars.
//   * rows and blocks a chunk are 32-bit (a 64-bit division by the
//     blocks a chunk costs a subroutine call a block), one chunk divides
//     nothing, and a layout of whole blocks on an aligned tensor (the
//     plain [nb, 256] grid) launches the kernels without their chunk
//     logic (kChunked false).
// The TPU kernels' 8-row sublane tiles and sequential grid are not carried
// over; dequant_accumulate folds the n sources in registers instead of
// along a grid axis.
//
// Bit-exactness against the plain versions (kernels/ref.py) hangs on the
// rounding of every operation, so each is spelled out:
//   * round half to even: __float2int_rn, never roundf (half away from 0);
//   * x / s is __fdiv_rn, never a reciprocal multiply;
//   * s = max(__fmul_rn(amax, INV_QMAX), SCALE_EPS) with the shared
//     constant float32(1)/float32(127) (bits 0x3c010204), never amax / 127;
//   * the accumulate is __fadd_rn(acc, __fmul_rn(q, s)): written plainly,
//     nvcc contracts it into an FMA (--fmad=true is its default) and the
//     sum differs from the separately rounded multiply and add;
//   * q is clipped to [-127, 127], never -128; an all-zero block gives
//     s = 1e-12 and q = 0;
//   * a bf16 input widens exactly; a bf16 output is
//     __float2bfloat16_rn(__fmul_rn(q, s)), the fp32 product rounded once
//     to nearest even, as (q.float() * s).to(torch.bfloat16) rounds it.
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;               // elements sharing one scale
constexpr int kPerLane = 8;               // quantize: elements per lane
constexpr int kLanesPerBlock = kBlock / kPerLane;   // 32: one warp
constexpr int kWarp = 32;
constexpr int kQRows = 1;                 // quantize: blocks a warp takes
constexpr int kDqRows = 2;                // dequantize: blocks a warp takes
static_assert(kDqRows == 2, "dequantize_kernel maps 2 blocks onto a warp");
constexpr int kThreads = 256;
constexpr int kWarpsPerCta = kThreads / kWarp;
constexpr float kInvQmax = 0x1.020408p-7f;          // float32(1)/float32(127)
constexpr float kScaleEps = 1e-12f;

__device__ __forceinline__ bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// A block's scale from its max |x|, and one value's int8 code: the
// quantize kernel's arithmetic, shared by the requantizing accumulate.
__device__ __forceinline__ float block_scale(float amax) {
  return fmaxf(__fmul_rn(amax, kInvQmax), kScaleEps);
}

__device__ __forceinline__ int8_t quantize1(float v, float scale) {
  const int k = __float2int_rn(__fdiv_rn(v, scale));
  return static_cast<int8_t>(max(-127, min(127, k)));
}

// Where block `row` of the grid lies: its chunk's first element in the
// dense tensor (`base`) and its own first element within the chunk
// (`first`). Rows and blocks per chunk fit 31 bits (the wrapper checks);
// one chunk needs no division. Without kChunked (every chunk whole
// blocks, the tensor 16-byte aligned) the dense tensor is the grid.
struct BlockAt {
  long long base, first;
};

template <bool kChunked>
__device__ __forceinline__ BlockAt block_at(unsigned row, unsigned nb,
                                            unsigned bpc,
                                            long long chunk_elems) {
  if (!kChunked) return {0, static_cast<long long>(row) * kBlock};
  unsigned c = 0;
  if (bpc < nb) c = row / bpc;
  return {static_cast<long long>(c) * chunk_elems,
          static_cast<long long>(row - c * bpc) * kBlock};
}

// Quantize: which 8 elements of a block lane l holds. f32: [4l, 4l + 4)
// and [128 + 4l, 128 + 4l + 4), so each 16-byte load instruction of the
// warp reads 512 contiguous bytes; bf16: [8l, 8l + 8), one 16-byte load.
template <typename T>
__device__ __forceinline__ int lane_elem(int lane, int i) {
  if constexpr (sizeof(T) == 4) return (i < 4 ? 0 : 128) + 4 * lane + (i & 3);
  else return kPerLane * lane + i;
}

template <typename T>
struct Raw8 {                              // a lane's 8 elements as loaded
  uint4 w[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ void load_raw8(const T* block, int lane,
                                          Raw8<T>& r) {
  if constexpr (sizeof(T) == 4) {
    r.w[0] = reinterpret_cast<const uint4*>(block)[lane];
    r.w[1] = reinterpret_cast<const uint4*>(block + 128)[lane];
  } else {
    r.w[0] = reinterpret_cast<const uint4*>(block)[lane];
  }
}

__device__ __forceinline__ void widen8(const Raw8<float>& r,
                                       float v[kPerLane]) {
  const float* f = reinterpret_cast<const float*>(r.w);
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) v[i] = f[i];
}

__device__ __forceinline__ void widen8(const Raw8<__nv_bfloat16>& r,
                                       float v[kPerLane]) {
  // bf16 -> f32 widening is exact: the same values the f32 path sees
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(r.w);
#pragma unroll
  for (int i = 0; i < kPerLane / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// One warp per 256-element block, kQRows blocks a warp: each lane holds 8
// values of each block, a block's max |x| is a shuffle reduction, and
// every lane derives the same scale.
template <typename T, bool kChunked>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ s, unsigned nb, long long chunk_elems,
                unsigned bpc) {
  const unsigned warp = blockIdx.x * kWarpsPerCta + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const unsigned row0 = warp * kQRows;
  if (row0 >= nb) return;              // whole warps exit together
  BlockAt at[kQRows];
  // fast: every row of the warp whole inside its chunk, the chunk's start
  // 16-byte aligned (uniform across the warp: it depends on the row only)
  bool fast = true;
#pragma unroll
  for (int r = 0; r < kQRows; ++r) {
    at[r] = block_at<kChunked>(row0 + r, nb, bpc, chunk_elems);
    fast = fast && row0 + r < nb
           && (!kChunked || (at[r].first + kBlock <= chunk_elems
                             && aligned(x + at[r].base, 16)));
  }
  float v[kQRows][kPerLane];
  if (fast) {
    // every load issued before any value is used
    Raw8<T> raw[kQRows];
#pragma unroll
    for (int r = 0; r < kQRows; ++r)
      load_raw8(x + at[r].base + at[r].first, lane, raw[r]);
#pragma unroll
    for (int r = 0; r < kQRows; ++r) widen8(raw[r], v[r]);
  } else {
#pragma unroll
    for (int r = 0; r < kQRows; ++r) {
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const long long e = at[r].first + lane_elem<T>(lane, i);
        v[r][i] = (row0 + r < nb && e < chunk_elems)
                      ? to_float(x[at[r].base + e]) : 0.0f;
      }
    }
  }
  float amax[kQRows];
#pragma unroll
  for (int r = 0; r < kQRows; ++r) {
    amax[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i)
      amax[r] = fmaxf(amax[r], fabsf(v[r][i]));
  }
#pragma unroll
  for (int m = kLanesPerBlock / 2; m > 0; m >>= 1) {
#pragma unroll
    for (int r = 0; r < kQRows; ++r)
      amax[r] = fmaxf(amax[r], __shfl_xor_sync(0xffffffffu, amax[r], m));
  }
#pragma unroll
  for (int r = 0; r < kQRows; ++r) {
    const unsigned row = row0 + r;
    if (row >= nb) break;                // uniform across the warp
    const float scale = block_scale(amax[r]);
    union { int8_t b[kPerLane]; uint32_t u[2]; uint2 u2; } out;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) out.b[i] = quantize1(v[r][i], scale);
    int8_t* qb = q + static_cast<long long>(row) * kBlock;
    if constexpr (sizeof(T) == 4) {
      reinterpret_cast<uint32_t*>(qb)[lane] = out.u[0];
      reinterpret_cast<uint32_t*>(qb + 128)[lane] = out.u[1];
    } else {
      reinterpret_cast<uint2*>(qb)[lane] = out.u2;
    }
    if (lane == 0) s[row] = scale;
  }
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  union { __nv_bfloat162 h[2]; uint2 u; } out;
  out.h[0] = __halves2bfloat162(__float2bfloat16_rn(v[0]),
                                __float2bfloat16_rn(v[1]));
  out.h[1] = __halves2bfloat162(__float2bfloat16_rn(v[2]),
                                __float2bfloat16_rn(v[3]));
  *reinterpret_cast<uint2*>(p) = out.u;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// kDqRows blocks a warp. Each thread loads 16 int8 values in one 16-byte
// load (the warp's 512 contiguous bytes) into shared memory; the warp
// reads them back 4 a lane, so every store instruction of the warp
// writes 4 contiguous values a lane, 512 (f32) or 256 (bf16) contiguous
// bytes: word w of the warp's 128 holds elements [4w, 4w + 4) of its
// two blocks.
template <typename T, bool kChunked>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                  T* __restrict__ out, unsigned nb, long long chunk_elems,
                  unsigned bpc) {
  __shared__ uint4 stage[kThreads];
  const unsigned warp = blockIdx.x * kWarpsPerCta + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const unsigned row0 = warp * kDqRows;
  if (row0 >= nb) return;              // whole warps exit together
  // lanes 0-15 load block row0, lanes 16-31 block row0 + 1
  if (row0 + lane / 16 < nb)
    stage[threadIdx.x] =
        reinterpret_cast<const uint4*>(q)[static_cast<long long>(warp)
                                          * kWarp + lane];
  BlockAt at[kDqRows];
  float scale[kDqRows];
#pragma unroll
  for (int r = 0; r < kDqRows; ++r) {
    at[r] = block_at<kChunked>(row0 + r, nb, bpc, chunk_elems);
    scale[r] = row0 + r < nb ? s[row0 + r] : 0.0f;
  }
  __syncwarp();
  const uint32_t* words =
      reinterpret_cast<const uint32_t*>(&stage[threadIdx.x - lane]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = j / 2;                 // words 0-63 row0, 64-127 row0 + 1
    if (row0 + r >= nb) break;           // uniform across the warp
    const long long e0 = at[r].first + ((j % 2) * kWarp + lane) * 4;
    if (kChunked && e0 >= chunk_elems) continue;   // padding: not written
    const uint32_t w = words[j * kWarp + lane];
    const int8_t* b = reinterpret_cast<const int8_t*>(&w);
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = __fmul_rn(static_cast<float>(b[i]), scale[r]);
    T* base = out + at[r].base;
    if (!kChunked
        || (e0 + 4 <= chunk_elems && aligned(base, 4 * sizeof(T)))) {
      store4(base + e0, v);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (e0 + i < chunk_elems) store1(base + e0 + i, v[i]);
    }
  }
}

// The reduce-scatter inner loop. Source j's 4 int8 values `w` times its
// block's scale, added to the lane's sums: each product and each sum
// rounded on its own.
__device__ __forceinline__ void fold4(float acc[4], uint32_t w, float scale) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    acc[i] = __fadd_rn(acc[i], __fmul_rn(static_cast<float>(b[i]), scale));
}

// The n sources' values of block `row` folded in order 0..n-1 into the
// lane's 8 sums (elements [4l, 4l + 4) in acc[0..3], [128 + 4l, ...) in
// acc[4..7]). kN > 0: n == kN, every source's loads issued before the
// first fold; kN == 0: any n, a source at a time.
template <int kN>
__device__ __forceinline__ void fold_sources(const int8_t* __restrict__ q,
                                             const float* __restrict__ s,
                                             int n, unsigned nb,
                                             unsigned row, int lane,
                                             float acc[kPerLane]) {
  const long long stride = static_cast<long long>(nb) * kBlock;
  if constexpr (kN == 0) {
    for (int j = 0; j < n; ++j)
      fold_sources<1>(q + j * stride, s + static_cast<long long>(j) * nb, 1,
                      nb, row, lane, acc);
  } else {
    const int8_t* at = q + static_cast<long long>(row) * kBlock + 4 * lane;
    uint32_t lo[kN], hi[kN];
    float scale[kN];
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      lo[j] = *reinterpret_cast<const uint32_t*>(at + j * stride);
      hi[j] = *reinterpret_cast<const uint32_t*>(at + j * stride + 128);
      scale[j] = s[static_cast<long long>(j) * nb + row];
    }
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      fold4(acc, lo[j], scale[j]);
      fold4(acc + 4, hi[j], scale[j]);
    }
  }
}

// One warp per block. Out float / __nv_bfloat16: the fold's first
// chunk_elems elements, dense (kChunked false: all nb * 256 of them).
// Out int8_t: the fold requantized into q_out [nb, 256] and s_out [nb].
template <int kN, typename Out, bool kChunked>
__global__ void __launch_bounds__(kThreads)
dequant_accumulate_kernel(const int8_t* __restrict__ q,
                          const float* __restrict__ s, Out* __restrict__ out,
                          float* __restrict__ s_out, int n, unsigned nb,
                          long long chunk_elems) {
  const unsigned row = blockIdx.x * kWarpsPerCta + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= nb) return;               // whole warps exit together
  float acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc[i] = 0.0f;
  fold_sources<kN>(q, s, n, nb, row, lane, acc);
  const long long e0 = static_cast<long long>(row) * kBlock + 4 * lane;
  if constexpr (sizeof(Out) == 1) {
    float amax = 0.0f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) amax = fmaxf(amax, fabsf(acc[i]));
#pragma unroll
    for (int m = kWarp / 2; m > 0; m >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, m));
    const float scale = block_scale(amax);
    union { int8_t b[kPerLane]; uint32_t u[2]; } code;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) code.b[i] = quantize1(acc[i], scale);
    *reinterpret_cast<uint32_t*>(out + e0) = code.u[0];
    *reinterpret_cast<uint32_t*>(out + e0 + 128) = code.u[1];
    if (lane == 0) s_out[row] = scale;
  } else if (!kChunked
             || static_cast<long long>(row + 1) * kBlock <= chunk_elems) {
    store4(out + e0, acc);             // the block lies whole in the chunk
    store4(out + e0 + 128, acc + 4);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (e0 + i < chunk_elems) store1(out + e0 + i, acc[i]);
      if (e0 + 128 + i < chunk_elems) store1(out + e0 + 128 + i, acc[4 + i]);
    }
  }
}

// The chunk logic only where the layout needs it: every chunk whole
// blocks and the tensor 16-byte aligned make it the plain grid.
bool chunked(const void* dense, long long chunk_elems, long long bpc) {
  return chunk_elems != bpc * kBlock
         || (reinterpret_cast<uintptr_t>(dense) & 15) != 0;
}

unsigned ctas_for_rows(long long nb, int rows) {
  const long long warps = (nb + rows - 1) / rows;
  return static_cast<unsigned>((warps + kWarpsPerCta - 1) / kWarpsPerCta);
}

template <typename T>
int quantize(const void* x, void* q, void* s, long long n_chunks,
             long long chunk_elems, long long bpc, void* stream) {
  const long long nb = n_chunks * bpc;
  auto kernel = chunked(x, chunk_elems, bpc) ? quantize_kernel<T, true>
                                             : quantize_kernel<T, false>;
  kernel<<<ctas_for_rows(nb, kQRows), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(s), static_cast<unsigned>(nb), chunk_elems,
      static_cast<unsigned>(bpc));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dequantize(const void* q, const void* s, void* out, long long n_chunks,
               long long chunk_elems, long long bpc, void* stream) {
  const long long nb = n_chunks * bpc;
  auto kernel = chunked(out, chunk_elems, bpc) ? dequantize_kernel<T, true>
                                               : dequantize_kernel<T, false>;
  kernel<<<ctas_for_rows(nb, kDqRows), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<T*>(out), static_cast<unsigned>(nb), chunk_elems,
      static_cast<unsigned>(bpc));
  return static_cast<int>(cudaGetLastError());
}

// The instance for n sources (n = 2 unrolled, any other n the loop); the
// chunk logic only where the output is not the whole grid (never for the
// requantize, which writes whole blocks).
template <int kN, typename Out>
auto acc_kernel(bool part) {
  if constexpr (sizeof(Out) == 1)
    return dequant_accumulate_kernel<kN, Out, false>;
  else
    return part ? dequant_accumulate_kernel<kN, Out, true>
                : dequant_accumulate_kernel<kN, Out, false>;
}

// The fold of n sources of nb blocks; chunk_elems <= nb * 256 (the whole
// grid, or for the requantize, nb * 256).
template <typename Out>
int dequant_accumulate(const void* q, const void* s, void* out, void* s_out,
                       int n, long long nb, long long chunk_elems,
                       void* stream) {
  const bool part = chunk_elems != nb * kBlock;
  auto kernel = n == 2 ? acc_kernel<2, Out>(part) : acc_kernel<0, Out>(part);
  kernel<<<ctas_for_rows(nb, 1), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<Out*>(out), static_cast<float*>(s_out), n,
      static_cast<unsigned>(nb), chunk_elems);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: n_chunks * chunk_elems elements; q: [n_chunks * bpc, 256]; s:
// [n_chunks * bpc]. bpc >= ceil(chunk_elems / 256), checked by the caller.
int int8_quantize_blocks_f32(const void* x, void* q, void* s,
                             long long n_chunks, long long chunk_elems,
                             long long bpc, void* stream) {
  return quantize<float>(x, q, s, n_chunks, chunk_elems, bpc, stream);
}

int int8_quantize_blocks_bf16(const void* x, void* q, void* s,
                              long long n_chunks, long long chunk_elems,
                              long long bpc, void* stream) {
  return quantize<__nv_bfloat16>(x, q, s, n_chunks, chunk_elems, bpc,
                                 stream);
}

// q: [n_chunks * bpc, 256] (16-byte aligned); s: [n_chunks * bpc]; out:
// n_chunks * chunk_elems elements, chunk_elems <= bpc * 256.
int int8_dequantize_blocks_f32(const void* q, const void* s, void* out,
                               long long n_chunks, long long chunk_elems,
                               long long bpc, void* stream) {
  return dequantize<float>(q, s, out, n_chunks, chunk_elems, bpc, stream);
}

int int8_dequantize_blocks_bf16(const void* q, const void* s, void* out,
                                long long n_chunks, long long chunk_elems,
                                long long bpc, void* stream) {
  return dequantize<__nv_bfloat16>(q, s, out, n_chunks, chunk_elems, bpc,
                                   stream);
}

// q: [n, nb, 256] (4-byte aligned); s: [n, nb]; out: the first
// chunk_elems (<= nb * 256) elements of the fold, dense.
int int8_dequant_accumulate_f32(const void* q, const void* s, void* out,
                                int n, long long nb, long long chunk_elems,
                                void* stream) {
  return dequant_accumulate<float>(q, s, out, nullptr, n, nb, chunk_elems,
                                   stream);
}

int int8_dequant_accumulate_bf16(const void* q, const void* s, void* out,
                                 int n, long long nb, long long chunk_elems,
                                 void* stream) {
  return dequant_accumulate<__nv_bfloat16>(q, s, out, nullptr, n, nb,
                                           chunk_elems, stream);
}

// The fold requantized: q_out [nb, 256], s_out [nb].
int int8_dequant_requantize(const void* q, const void* s, void* q_out,
                            void* s_out, int n, long long nb, void* stream) {
  return dequant_accumulate<int8_t>(q, s, q_out, s_out, n, nb, nb * kBlock,
                                    stream);
}

}  // extern "C"
