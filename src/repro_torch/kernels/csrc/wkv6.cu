// RWKV-6 WKV forward for Hopper (sm_90a): the recurrence of the ssm
// family's time-mix, over a whole prompt (prefill) or one step from the
// carried state (decode).
//
// Replaces the JAX package's Pallas kernel src/repro/kernels/rwkv6_scan.py
// (wkv6_chunked, _wkv_kernel), and computes the function the JAX model
// computes with models/sublayers._wkv_chunked: for r, k, v, logw
// [B,S,H,hd] and u [H,hd],
//   o_t = r_t (S + u k_t v_t^T),   S <- diag(exp(logw_t)) S + k_t v_t^T,
// returning every o_t (in r's type) and the final S [B,H,hd,hd] fp32, with
// S indexed [key channel i][value channel j] (the bhkv layout). The
// Pallas kernel always starts from S = 0; the model's decode step starts
// from the carried state, so this kernel takes an optional s0 (null means
// zeros, which is wkv6_chunked's function).
//
// Design: the per-channel sequential recurrence (RWKV's own CUDA wkv6
// forward), not the Pallas kernel's chunked matmul form. One block per
// (b, h), hd threads; thread j keeps the state column S[:, j] in fp32
// registers for the whole sequence. Each step stages r_t, k_t and
// w_t = exp(logw_t) in shared memory (double-buffered, so one
// __syncthreads a step suffices), then thread j forms
//   o_t[j] = sum_i r[i] (S[i,j] + u[i] k[i] v[j]),
//   S[i,j] = w[i] S[i,j] + k[i] v[j]
// over its column. The next step's inputs are loaded into registers while
// the current step computes. All factors are formed from w <= 1 directly,
// so strong decay (logw = -20) and S = 1 need no special case; the
// chunk length of the chunked form does not exist here.
//
// Bound: bytes. Per (b, h, t) the kernel does ~4 hd flops per byte-light
// step, far below the card's ~295 flops per byte: it must read r, k, v,
// logw once and write out once (plus s0 and the final state), e.g.
// prefill B 8, S 512, H 40, hd 64 in bf16: ~131 MB, 0.039 ms at
// 3.35 TB/s; decode (S 1): ~10.7 MB, 0.0032 ms. This simple form is bound
// instead by the dependent chain of S steps inside a block (B*H blocks of
// hd threads, one sync per step): the chunked form on tensor cores is the
// faster design, left for later.
//
// Loads and stores are coalesced: threads j read and write neighbouring
// channels of one (b, t, h) row, and for a fixed i neighbouring columns of
// the state. Every entry point launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ logw,
            const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ out, float* __restrict__ s_out, int S, int H) {
  __shared__ __align__(16) float sr[2][HD];
  __shared__ __align__(16) float sk[2][HD];
  __shared__ __align__(16) float sw[2][HD];
  __shared__ __align__(16) float su[HD];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int j = threadIdx.x;
  const long long sbase = static_cast<long long>(bh) * HD * HD;

  float state[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i)
    state[i] = s0 == nullptr ? 0.f : s0[sbase + i * HD + j];
  su[j] = u[h * HD + j];

  const long long step = static_cast<long long>(H) * HD;
  long long off = (static_cast<long long>(b) * S * H + h) * HD + j;
  float rn = to_f32(r[off]), kn = to_f32(k[off]), vn = to_f32(v[off]);
  float wn = expf(logw[off]);

  for (int t = 0; t < S; ++t) {
    const int buf = t & 1;
    sr[buf][j] = rn;
    sk[buf][j] = kn;
    sw[buf][j] = wn;
    const float vj = vn;
    const long long cur = off;
    __syncthreads();
    if (t + 1 < S) {                  // next step's inputs, in flight
      off += step;
      rn = to_f32(r[off]);
      kn = to_f32(k[off]);
      vn = to_f32(v[off]);
      wn = expf(logw[off]);
    }
    float o = 0.f;
#pragma unroll
    for (int i = 0; i < HD; i += 4) {
      const float4 r4 = *reinterpret_cast<const float4*>(&sr[buf][i]);
      const float4 k4 = *reinterpret_cast<const float4*>(&sk[buf][i]);
      const float4 w4 = *reinterpret_cast<const float4*>(&sw[buf][i]);
      const float4 u4 = *reinterpret_cast<const float4*>(&su[i]);
      const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
      const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
      const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
      const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float kv = kk[q] * vj;
        o = fmaf(rr[q], fmaf(uu[q], kv, state[i + q]), o);
        state[i + q] = fmaf(ww[q], state[i + q], kv);
      }
    }
    store(out + cur, o);
  }
#pragma unroll
  for (int i = 0; i < HD; ++i) s_out[sbase + i * HD + j] = state[i];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, const void* s0, void* out, void* s_out, int B,
           int S, int H, int hd, void* stream) {
  const dim3 grid(static_cast<unsigned>(B) * static_cast<unsigned>(H));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* rp = static_cast<const T*>(r);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const float* wp = static_cast<const float*>(logw);
  const float* up = static_cast<const float*>(u);
  const float* sp = static_cast<const float*>(s0);
  T* op = static_cast<T*>(out);
  float* so = static_cast<float*>(s_out);
  switch (hd) {
    case 16:
      wkv6_kernel<T, 16><<<grid, 16, 0, st>>>(rp, kp, vp, wp, up, sp, op, so,
                                              S, H);
      break;
    case 32:
      wkv6_kernel<T, 32><<<grid, 32, 0, st>>>(rp, kp, vp, wp, up, sp, op, so,
                                              S, H);
      break;
    case 64:
      wkv6_kernel<T, 64><<<grid, 64, 0, st>>>(rp, kp, vp, wp, up, sp, op, so,
                                              S, H);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int wkv6_fwd_f32(const void* r, const void* k, const void* v,
                 const void* logw, const void* u, const void* s0, void* out,
                 void* s_out, int B, int S, int H, int hd, void* stream) {
  return launch<float>(r, k, v, logw, u, s0, out, s_out, B, S, H, hd,
                       stream);
}

int wkv6_fwd_bf16(const void* r, const void* k, const void* v,
                  const void* logw, const void* u, const void* s0, void* out,
                  void* s_out, int B, int S, int H, int hd, void* stream) {
  return launch<__nv_bfloat16>(r, k, v, logw, u, s0, out, s_out, B, S, H, hd,
                               stream);
}

}  // extern "C"
