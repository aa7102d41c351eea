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
// Bound: per (b, h, t) the recurrence does ~5 hd^2 fp32 operations (r.S,
// and S = w S + k v) against ~4 hd inputs, so operations on the CUDA
// cores bind, not bytes: prefill B 8, S 512, H 40, hd 64 in bf16 needs
// 0.050 ms at 67 TFLOP/s (its 131 MB take 0.039 ms at 3.35 TB/s); decode
// (S 1) moves the two states, ~10.7 MB, 0.0032 ms.
//
// Design: the exact sequential recurrence per state element (RWKV's own
// CUDA wkv6 forward), not the Pallas kernel's chunked matmul form on
// tensor cores, whose masked log-ratio would need 3xTF32 or fp32 to hold
// the fp32 tolerance: that form is the alternative if this one stays far
// from its bound. Every state element keeps the update of the
// one-thread-a-column kernel this replaced, S[i,j] = fmaf(w[i], S[i,j],
// k[i] v[j]) in step order, so the fp32 final state is bit-equal to that
// kernel's (checked on the card by kernel_ab.py); only o's sums are taken
// in another order. Two kernels, by S:
//   - S > 1 (prefill): one CTA of 2 hd threads per (b, h), 128 at hd 64
//     (the kernel this replaced ran hd threads, each walking a 64-long
//     FMA chain per step: 7.5 % of the card's thread slots at the serve
//     shape). Thread (cg, rg) holds a 4 x hd/8 block of S (4 rows x 8
//     columns at hd 64) in registers: the step's time is set by its
//     shared-memory reads (r, k, w of its rows, v of its columns) and the
//     column sums more than by its FMAs, and this block reads 20 floats
//     per 32 elements where four threads a column (16 rows each) read 49
//     per 16. The hd/4 threads of a column group sit in adjacent lanes
//     and sum o by a reduce-scatter of shuffles (column_sum). The bonus
//     term is factored out of the element loop: o_t[j] = sum_i r_i S[i,j]
//     + v_j ruk_t with ruk_t = sum_i r_i u_i k_i, one dot product a step.
//     Inputs are staged by chunks of T_CH steps: cp.async copies a
//     chunk's r, k, v and logw rows into a 2-stage ring in shared memory
//     while the previous chunk computes; when a chunk lands it is
//     converted once to fp32 (w = exp(logw) and ruk formed once per
//     element and step) into padded arrays, and the step loop reads only
//     shared memory and registers, with no barrier inside: two barriers
//     per chunk. A chunk's outputs are staged in shared memory and
//     written coalesced while the next chunk converts. Any S: a last
//     chunk shorter than T_CH is masked.
//   - S == 1 (decode): one state read, one step and one state write, no
//     staging (wkv6_step_kernel below).
// The state goes between registers and global memory directly: a
// prefill thread moves its rows' 32 contiguous bytes (hd 64) as vectors,
// once per call, and a decode warp 128 contiguous bytes of a row, so a
// pass through shared memory would add a barrier and buy no whole sector
// more.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int T_CH = 16;                    // steps per staged chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// the staged kernel's thread layout at head dim HD: a CTA of 2 HD threads,
// thread (cg, rg) = NL cg + rg holding the 4 x CPT block S[4 rg : 4 rg + 4,
// CPT cg : CPT cg + CPT] (4 x 8 at hd 64). A step reads 3 x 4 r, k, w and
// CPT v per thread from shared memory for 4 CPT elements: shared-memory
// reads, not FMAs, set the step's time, so the block is as wide as the
// column sum's shuffles allow
template <int HD>
struct WkvLayout {
  static constexpr int THREADS = 2 * HD;
  static constexpr int RPT = 4;                       // rows a thread
  static constexpr int CPT = HD / 8;                  // columns a thread
  static constexpr int NL = HD / RPT;                 // lanes a column
  // floats of padding after each row group's 4 in the fp32 arrays: a
  // stride of three 16-byte vectors puts the 16-byte reads of eight
  // consecutive row groups (a quarter warp) in distinct banks
  static constexpr int PAD = 8;
};

// the sum over a column group's NL lanes of each of its CPT columns'
// partials a (destroyed): a reduce-scatter, each exchange sending the half
// of the columns the lane does not keep, then plain sums over the lower
// lane bits; a lane with rg % (NL / CPT) == 0 ends with the total of
// column col0 + its offset, which it adds to col
template <int CPT, int NL>
__device__ __forceinline__ float column_sum(float (&a)[CPT], int rg,
                                            int& col) {
  constexpr unsigned FULL = 0xffffffffu;
  int n = CPT;
#pragma unroll
  for (int bit = NL / 2; bit >= 1; bit >>= 1) {
    if (n > 1) {
      const bool hi = rg & bit;
      n /= 2;
#pragma unroll
      for (int m = 0; m < CPT / 2; ++m) {
        if (m < n) {
          const float send = hi ? a[m] : a[m + n];
          a[m] = (hi ? a[m + n] : a[m]) + __shfl_xor_sync(FULL, send, bit);
        }
      }
      col += hi ? n : 0;
    } else {
      a[0] += __shfl_xor_sync(FULL, a[0], bit);
    }
  }
  return a[0];
}

// shared memory of one CTA, in bytes: the 2-stage ring of raw chunks (r,
// k, v in T, logw fp32), the fp32 arrays (r, k, w padded by 4 floats per
// row group, so the row groups' 16-byte reads fall in distinct banks; v),
// the per-step bonus sums, u, and the outputs
template <typename T, int HD>
struct WkvSmem {
  static constexpr int NL = WkvLayout<HD>::NL;
  static constexpr int HDP = HD + WkvLayout<HD>::PAD * NL;  // padded row
  static constexpr int RAW_T = T_CH * HD * static_cast<int>(sizeof(T));
  static constexpr int RAW_W = T_CH * HD * 4;
  static constexpr int STAGE = 3 * RAW_T + RAW_W;
  static constexpr int F = (3 * T_CH * HDP + T_CH * HD + T_CH + HD) * 4;
  static constexpr int OUT = T_CH * HD * 4;
  static constexpr int BYTES = 2 * STAGE + F + OUT;
};

// three CTAs resident per SM (shared memory allows no more at hd 64): the
// serve shape's 320 CTAs run in one wave
template <typename T, int HD>
__global__ void __launch_bounds__(2 * HD, 3)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ logw,
            const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ out, float* __restrict__ s_out, int S, int H) {
  using namespace hopper;
  using L = WkvSmem<T, HD>;
  constexpr int NTHR = WkvLayout<HD>::THREADS, NWARP = NTHR / 32;
  constexpr int HDP = L::HDP;
  constexpr int CPT = WkvLayout<HD>::CPT, RPT = WkvLayout<HD>::RPT;
  constexpr int NL = WkvLayout<HD>::NL, PAD = WkvLayout<HD>::PAD;
  constexpr int VT = 16 / static_cast<int>(sizeof(T));  // T per vector
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw;                        // 2 stages
  float* Fr = reinterpret_cast<float*>(smem_raw + 2 * L::STAGE);
  float* Fk = Fr + T_CH * HDP;
  float* Fw = Fk + T_CH * HDP;
  float* Fv = Fw + T_CH * HDP;
  float* Ruk = Fv + T_CH * HD;                           // sum_i r u k
  float* Us = Ruk + T_CH;
  float* Ob = reinterpret_cast<float*>(smem_raw + 2 * L::STAGE + L::F);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cg = tid / NL, rg = tid % NL;
  const int row0 = rg * RPT, col0 = cg * CPT;
  const long long sbase = static_cast<long long>(bh) * HD * HD;
  const long long row_step = static_cast<long long>(H) * HD;
  const long long base = (static_cast<long long>(b) * S * H + h) * HD;
  const int nc = (S + T_CH - 1) / T_CH;

  // the chunk c of r, k, v, logw into ring stage c % 2 (one commit group)
  auto issue = [&](int c) {
    if (c < nc) {
      const int t0 = c * T_CH, nt = min(T_CH, S - t0);
      unsigned char* st = ring + (c & 1) * L::STAGE;
      const long long g0 = base + t0 * row_step;
      for (int i = tid; i < nt * HD / VT; i += NTHR) {
        const int t = i / (HD / VT), c8 = (i % (HD / VT)) * VT;
        const long long g = g0 + t * row_step + c8;
        const int o = (t * HD + c8) * static_cast<int>(sizeof(T));
        cp_async16(st + o, r + g);
        cp_async16(st + L::RAW_T + o, k + g);
        cp_async16(st + 2 * L::RAW_T + o, v + g);
      }
      float* dw = reinterpret_cast<float*>(st + 3 * L::RAW_T);
      for (int i = tid; i < nt * HD / 4; i += NTHR) {
        const int t = i / (HD / 4), c4 = (i % (HD / 4)) * 4;
        cp_async16(dw + t * HD + c4, logw + g0 + t * row_step + c4);
      }
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);

  // the state block straight from global memory, each of its rows (CPT
  // contiguous floats: 32 bytes at hd 64) in one or two vectors
  float state[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; c += 2) {
      float2 x = make_float2(0.f, 0.f);
      if (s0 != nullptr)
        x = *reinterpret_cast<const float2*>(
            s0 + sbase + (row0 + i) * HD + col0 + c);
      state[i][c] = x.x;
      state[i][c + 1] = x.y;
    }
  for (int i = tid; i < HD; i += NTHR) Us[i] = u[h * HD + i];

  // the staged outputs of chunk c -> out, coalesced
  auto write_out = [&](int c) {
    const int t0 = c * T_CH, nt = min(T_CH, S - t0);
    for (int i = tid; i < nt * HD; i += NTHR) {
      const int t = i / HD, c1 = i % HD;
      store(out + base + (t0 + t) * row_step + c1, Ob[i]);
    }
  };

  for (int c = 0; c < nc; ++c) {
    const int nt = min(T_CH, S - c * T_CH);
    cp_async_wait<1>();                      // chunk c has landed
    __syncthreads();                         // ... for every thread; the
                                             // last chunk's steps are done
    if (c > 0) write_out(c - 1);
    {
      // a warp a step: the fp32 arrays, w = exp(logw), and the bonus sum
      // ruk_t = sum_i r_i u_i k_i (o_t[j] = sum_i r_i S[i,j] + v_j ruk_t)
      const unsigned char* st = ring + (c & 1) * L::STAGE;
      const T* rr = reinterpret_cast<const T*>(st);
      const T* kk = reinterpret_cast<const T*>(st + L::RAW_T);
      const T* vv = reinterpret_cast<const T*>(st + 2 * L::RAW_T);
      const float* ww = reinterpret_cast<const float*>(st + 3 * L::RAW_T);
      for (int t = warp; t < nt; t += NWARP) {
        float ruk = 0.f;
        for (int c1 = lane; c1 < HD; c1 += 32) {
          const int i = t * HD + c1, p = t * HDP + c1 + (c1 / RPT) * PAD;
          const float rv = to_f32(rr[i]), kv = to_f32(kk[i]);
          Fr[p] = rv;
          Fk[p] = kv;
          Fw[p] = expf(ww[i]);
          Fv[i] = to_f32(vv[i]);
          ruk = fmaf(rv * Us[c1], kv, ruk);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          ruk += __shfl_xor_sync(0xffffffffu, ruk, o);
        if (lane == 0) Ruk[t] = ruk;
      }
    }
    __syncthreads();                         // F ready, stage c % 2 free
    issue(c + 2);

    for (int t = 0; t < nt; ++t) {
      const float* fr = Fr + t * HDP + rg * (RPT + PAD);
      const float* fk = Fk + t * HDP + rg * (RPT + PAD);
      const float* fw = Fw + t * HDP + rg * (RPT + PAD);
      float vc[CPT], o[CPT];
#pragma unroll
      for (int c1 = 0; c1 < CPT; ++c1) {
        vc[c1] = Fv[t * HD + col0 + c1];
        o[c1] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < RPT; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(fr + i);
        const float4 k4 = *reinterpret_cast<const float4*>(fk + i);
        const float4 w4 = *reinterpret_cast<const float4*>(fw + i);
        const float rv[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kv4[4] = {k4.x, k4.y, k4.z, k4.w};
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int c1 = 0; c1 < CPT; ++c1) {
            const float kv = kv4[e] * vc[c1];
            o[c1] = fmaf(rv[e], state[i + e][c1], o[c1]);
            state[i + e][c1] = fmaf(wv[e], state[i + e][c1], kv);
          }
      }
      int col = col0;
      const float tot = column_sum<CPT, NL>(o, rg, col);
      if (rg % (NL / CPT) == 0)
        Ob[t * HD + col] = fmaf(Fv[t * HD + col], Ruk[t], tot);
    }
  }
  __syncthreads();                           // every step done
  write_out(nc - 1);
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; c += 2)
      *reinterpret_cast<float2*>(s_out + sbase + (row0 + i) * HD + col0 + c) =
          make_float2(state[i][c], state[i][c + 1]);
}

// decode (S 1): one state read, one step and one state write, without
// staging. Thread (q, j) = HD q + j holds S[q hd/4 : (q + 1) hd/4, j], so
// a warp's state reads and writes cover 32 consecutive columns of a row
// (128 bytes); the rows' r, k, w and u are the same address across a warp
// (one broadcast load each). o_j = sum_i r_i (S[i,j] + u_i k_i v_j) per
// element, as the one-thread-a-column kernel; the four quarters' partials
// meet in shared memory behind one barrier and are summed in order.
template <typename T, int HD>
__global__ void __launch_bounds__(4 * HD)
wkv6_step_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ logw,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 T* __restrict__ out, float* __restrict__ s_out, int H) {
  constexpr int R = HD / 4;
  __shared__ float part[4][HD];
  const int bh = blockIdx.x, h = bh % H;
  const int q = threadIdx.x / HD, j = threadIdx.x % HD;
  const long long sbase = static_cast<long long>(bh) * HD * HD + j;
  const long long x = static_cast<long long>(bh) * HD;  // [b, 0, h, :]
  float state[R];
#pragma unroll
  for (int i = 0; i < R; ++i)
    state[i] = s0 == nullptr ? 0.f : s0[sbase + (q * R + i) * HD];
  const float vj = to_f32(v[x + j]);
  float o = 0.f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q * R + i;
    const float kv = to_f32(k[x + row]) * vj;
    o = fmaf(to_f32(r[x + row]), fmaf(u[h * HD + row], kv, state[i]), o);
    state[i] = fmaf(expf(logw[x + row]), state[i], kv);
  }
  part[q][j] = o;
  __syncthreads();
  if (q == 0)
    store(out + x + j, ((part[0][j] + part[1][j]) + part[2][j]) + part[3][j]);
#pragma unroll
  for (int i = 0; i < R; ++i) s_out[sbase + (q * R + i) * HD] = state[i];
}

template <typename T, int HD>
int launch_hd(const void* r, const void* k, const void* v, const void* logw,
              const void* u, const void* s0, void* out, void* s_out, int B,
              int S, int H, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(B) * static_cast<unsigned>(H));
  if (S == 1) {
    wkv6_step_kernel<T, HD><<<grid, 4 * HD, 0, st>>>(
        static_cast<const T*>(r), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(logw),
        static_cast<const float*>(u), static_cast<const float*>(s0),
        static_cast<T*>(out), static_cast<float*>(s_out), H);
    return static_cast<int>(cudaGetLastError());
  }
  auto kern = wkv6_kernel<T, HD>;
  constexpr int smem = WkvSmem<T, HD>::BYTES;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  kern<<<grid, WkvLayout<HD>::THREADS, smem, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(out), static_cast<float*>(s_out), S, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, const void* s0, void* out, void* s_out, int B,
           int S, int H, int hd, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch_hd<T, 16>(r, k, v, logw, u, s0, out, s_out, B, S, H, st);
    case 32:
      return launch_hd<T, 32>(r, k, v, logw, u, s0, out, s_out, B, S, H, st);
    case 64:
      return launch_hd<T, 64>(r, k, v, logw, u, s0, out, s_out, B, S, H, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
