// Mamba diagonal-SSM scan for Hopper (sm_90a): the selective scan of the
// hybrid family's mamba sublayer, over a whole prompt (prefill) or one
// step from the carried state (decode).
//
// Replaces the JAX package's Pallas kernel src/repro/kernels/mamba_scan.py
// (mamba_scan, _scan_kernel), and computes the function of its oracle
// kernels/ref.py:mamba_scan_ref with the channels flattened: for a, b
// [B,S,C] (C = d_inner * d_state),
//   h_t = a_t * h_{t-1} + b_t,   h_{-1} = h0 (null means zeros),
// returning every h_t as hs [B,S,C] fp32. The Pallas kernel always
// starts from zeros; the model's decode step starts from the carried
// state, so this kernel takes an optional h0 (null is mamba_scan's
// function). Any S >= 1 and any C: the Pallas kernel's chunk and
// channel block are its TPU tiling, not part of the function.
//
// Design: not the Pallas kernel's log-step doubling scan, which exists
// because the TPU lays channels on VPU lanes and walks chunks of the
// sequence in order. On the card the channels are independent and
// plentiful (B * C = 8 * 131,072 at the serve shape), so each thread
// owns one (b, channel) and walks the sequence sequentially with h in a
// register: the recurrence has no cross-thread dependency at all.
// Consecutive threads take consecutive channels, so every step's loads
// of a and b and store of h are coalesced (a warp reads and writes 128
// contiguous bytes of each in fp32). The loop is unrolled by UNROLL
// steps and all of a chunk's loads are issued before its first FMA, so
// each thread keeps 2 * UNROLL independent loads in flight; with ~2,048
// resident threads an SM that hides the load latency.
//
// Bound: bytes. Per element and step one FMA against 8-12 bytes moved
// (a and b read, h written), far below the card's ~295 flops per byte:
// the kernel must read a and b once and write hs once (plus h0), e.g.
// prefill [8, 512, 131072] fp32: 6.44 GB, 1.92 ms at 3.35 TB/s; decode
// [8, 1, 131072] with h0: 16.8 MB, 5.0 us. wgmma, TMA and chunked forms
// have nothing to offer a pure streaming recurrence; a fused kernel that
// forms a and b from dt, A, x and B in registers (never writing them to
// device memory) and folds the C contraction in would cut the bytes 3x,
// and is later work.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mamba_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ hs,
                  int S, int C) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (c >= C) return;
  const int64_t bi = blockIdx.y;
  // element (bi, t, c) lies at (bi * S + t) * C + c
  const int64_t row0 = bi * static_cast<int64_t>(S) * C + c;
  float h = h0 == nullptr ? 0.f : h0[bi * C + c];
  int t = 0;
  for (; t + UNROLL <= S; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t off = row0 + static_cast<int64_t>(t + u) * C;
      av[u] = to_f32(a[off]);
      bv[u] = to_f32(b[off]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      h = fmaf(av[u], h, bv[u]);
      hs[row0 + static_cast<int64_t>(t + u) * C] = h;
    }
  }
  for (; t < S; ++t) {
    const int64_t off = row0 + static_cast<int64_t>(t) * C;
    h = fmaf(to_f32(a[off]), h, to_f32(b[off]));
    hs[off] = h;
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* h0, void* hs, int B,
           int S, int C, void* stream) {
  if (B < 1 || S < 1 || C < 1 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((C - 1) / THREADS + 1, B);
  mamba_scan_kernel<T><<<grid, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const float*>(h0), static_cast<float*>(hs), S, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mamba_scan_f32(const void* a, const void* b, const void* h0, void* hs,
                   int B, int S, int C, void* stream) {
  return launch<float>(a, b, h0, hs, B, S, C, stream);
}

int mamba_scan_bf16(const void* a, const void* b, const void* h0, void* hs,
                    int B, int S, int C, void* stream) {
  return launch<__nv_bfloat16>(a, b, h0, hs, B, S, C, stream);
}

}  // extern "C"
