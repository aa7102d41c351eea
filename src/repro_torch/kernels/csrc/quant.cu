// Symmetric per-256-block int8 quantization for Hopper (sm_90a): the hot
// loops of the int8 stage-1 transports (qwZ weight gather, qgZ gradient
// reduce-scatter).
//
// Replaces the JAX package's Pallas kernels in src/repro/kernels/quant.py:
//   int8_quantize_blocks_*   <- quantize_blocks     (_quantize_kernel)
//   int8_dequantize_blocks   <- dequantize_blocks   (_dequantize_kernel)
//   int8_dequant_accumulate  <- dequant_accumulate  (_dequant_acc_kernel)
//
// Bound: bytes. Each kernel does a handful of flops per element, far below
// the card's ~295 flops per byte, so its least time is bytes / 3.35e12:
//   quantize            reads nb*256*4 (f32) or nb*256*2 (bf16) bytes,
//                       writes nb*256 (int8) + nb*4 (scales)
//   dequantize          reads nb*256 + nb*4, writes nb*256*4
//   dequant_accumulate  reads n*(nb*256 + nb*4), writes nb*256*4
// The design moves each byte once: one pass, 16-byte vector loads and
// 8-byte int8 stores, neighbouring lanes on neighbouring addresses. The
// TPU kernels' 8-row sublane tiles and sequential grid are not carried
// over: a warp owns one 256-element block (quantize), and a thread owns
// 8 elements and folds the n sources in a register loop
// (dequant_accumulate) instead of a grid axis.
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
//     s = 1e-12 and q = 0.
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;               // elements sharing one scale
constexpr int kPerLane = 8;               // elements per thread
constexpr int kLanesPerBlock = kBlock / kPerLane;   // 32: one warp
constexpr int kThreads = 256;
constexpr float kInvQmax = 0x1.020408p-7f;          // float32(1)/float32(127)
constexpr float kScaleEps = 1e-12f;

__device__ __forceinline__ void load8(const float* p, float v[kPerLane]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float v[kPerLane]) {
  // bf16 -> f32 widening is exact: the same values the f32 path sees
  const uint4 raw = reinterpret_cast<const uint4*>(p)[0];
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float v[kPerLane]) {
  const uint2 raw = reinterpret_cast<const uint2*>(p)[0];
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) v[i] = static_cast<float>(b[i]);
}

__device__ __forceinline__ void store8(float* p, const float v[kPerLane]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// One warp per 256-element block: each lane holds 8 values, the block's
// max |x| is a shuffle reduction, and every lane derives the same scale.
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ s, long long nb) {
  const long long row = (static_cast<long long>(blockIdx.x) * kThreads
                         + threadIdx.x) / kLanesPerBlock;
  const int lane = threadIdx.x % kLanesPerBlock;
  if (row >= nb) return;               // whole warps exit together
  const long long off = row * kBlock + lane * kPerLane;
  float v[kPerLane];
  load8(x + off, v);
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) amax = fmaxf(amax, fabsf(v[i]));
#pragma unroll
  for (int m = kLanesPerBlock / 2; m > 0; m >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, m));
  const float scale = fmaxf(__fmul_rn(amax, kInvQmax), kScaleEps);
  union { int8_t b[kPerLane]; uint2 u; } out;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    int r = __float2int_rn(__fdiv_rn(v[i], scale));
    r = max(-127, min(127, r));
    out.b[i] = static_cast<int8_t>(r);
  }
  reinterpret_cast<uint2*>(q + off)[0] = out.u;
  if (lane == 0) s[row] = scale;
}

// Thread t owns elements [8t, 8t+8) of the flat [nb, 256] output.
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                  float* __restrict__ out, long long nb) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  const long long row = t / kLanesPerBlock;
  if (row >= nb) return;
  const long long off = t * kPerLane;
  const float scale = s[row];
  float v[kPerLane];
  load8(q + off, v);
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) v[i] = __fmul_rn(v[i], scale);
  store8(out + off, v);
}

// The reduce-scatter inner loop: fold the n sources in order, in registers.
__global__ void __launch_bounds__(kThreads)
dequant_accumulate_kernel(const int8_t* __restrict__ q,
                          const float* __restrict__ s,
                          float* __restrict__ out, int n, long long nb) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  const long long row = t / kLanesPerBlock;
  if (row >= nb) return;
  const long long off = t * kPerLane;
  const long long src_stride = nb * kBlock;
  float acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc[i] = 0.0f;
  for (int src = 0; src < n; ++src) {
    const float scale = s[src * nb + row];
    float v[kPerLane];
    load8(q + src * src_stride + off, v);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i)
      acc[i] = __fadd_rn(acc[i], __fmul_rn(v[i], scale));
  }
  store8(out + off, acc);
}

unsigned grid_for(long long nb) {
  const long long threads = nb * kLanesPerBlock;
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int int8_quantize_blocks_f32(const void* x, void* q, void* s, long long nb,
                             void* stream) {
  quantize_kernel<float><<<grid_for(nb), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(s), nb);
  return static_cast<int>(cudaGetLastError());
}

int int8_quantize_blocks_bf16(const void* x, void* q, void* s, long long nb,
                              void* stream) {
  quantize_kernel<__nv_bfloat16><<<grid_for(nb), kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(s), nb);
  return static_cast<int>(cudaGetLastError());
}

int int8_dequantize_blocks(const void* q, const void* s, void* out,
                           long long nb, void* stream) {
  dequantize_kernel<<<grid_for(nb), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<float*>(out), nb);
  return static_cast<int>(cudaGetLastError());
}

int int8_dequant_accumulate(const void* q, const void* s, void* out, int n,
                            long long nb, void* stream) {
  dequant_accumulate_kernel<<<grid_for(nb), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<float*>(out), n, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
