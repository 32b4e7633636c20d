// Mamba-1 selective scan for Hopper (sm_90a): the recurrence runs over time
// inside one CTA, the SSM state in registers.
//
// Replaces the TPU kernel `selective_scan` / `_ssm_kernel` of
// src/repro/kernels/ssm_scan.py (pallas_call at :109). Same function:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t,   h_0 = 0,
//   y_t = C_t . h_t + D * x_t,
// with x (B, S, Di) f32 or bf16, dt (B, S, Di) f32, A (Di, N) f32, B and C
// (B, S, N) in x's dtype (strided views allowed: the model slices them out
// of one (B, S, R + 2N) projection), D (Di,) f32; y (B, S, Di) in x's
// dtype. Optionally the final state h_S (B, Di, N) f32, which the prefill
// hands to decode (the reference computes it in a second scan).
//
// Bound: bytes, nearly level with operations. Each (b, t, channel) reads
// x and dt and writes y once; B and C are (B, S, N), small. At the
// falcon-mamba prefill (B 1, S 512, Di 8192, N 16, bf16) that is ~34 MB,
// ~10 us at 3.35 TB/s; the ~9 flops and one exponential per (b, t, channel,
// state) are ~0.6 GFLOP, ~9 us at the 67 TFLOP/s f32 rate (the
// exponentials go to the special-function units, at a quarter of that).
// What this first design does about it: nothing of size (B, S, Di, N)
// touches device memory; the state never leaves registers; each CTA stages
// a tile of time steps of x, dt, B and C through shared memory with
// coalesced loads (every channel of a batch row reads the same B_t and
// C_t) and writes its y tile back coalesced. N is split over G = N / 4
// lanes (4 states each) with a shuffle reduce for y, so that B 1 x Di 8192
// gives 256 CTAs of 128 threads for the 132 SMs rather than 64. The state
// update rounds as the plain PyTorch version does (no fused multiply-add),
// so the state tracks it closely over long sequences. Not done yet:
// overlapping the next tile's loads with the current tile's steps, and a
// chunked (parallel over time) form for small B x Di.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStates = 4;  // SSM states per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One CTA per (channel block blockIdx.x, batch row blockIdx.y). G lanes
// share a channel (N = 4 G states), so a CTA holds CB = 128 / G channels.
// Shared memory (f32) holds TS time steps of x, dt, y (TS x CB each) and
// of B and C (TS x N each).
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
    ssm_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const T* __restrict__ bm,
                    const T* __restrict__ cm, const float* __restrict__ dskip,
                    T* __restrict__ y, float* __restrict__ h_out, int S, int Di,
                    long long b_bstride, long long b_tstride,
                    long long c_bstride, long long c_tstride) {
  constexpr int N = kStates * G;
  constexpr int CB = kThreads / G;
  constexpr int TS = (2048 / CB) < 64 ? (2048 / CB) : 64;
  __shared__ float x_s[TS][CB];
  __shared__ float dt_s[TS][CB];
  __shared__ float y_s[TS][CB];
  __shared__ float b_s[TS][N];
  __shared__ float c_s[TS][N];

  const int tid = threadIdx.x;
  const int g = tid / G;     // channel within the CTA
  const int lane = tid % G;  // this thread's states: lane * 4 .. lane * 4 + 3
  const int c0 = blockIdx.x * CB;
  const int ch = c0 + g;
  const int bi = blockIdx.y;
  const bool live = ch < Di;

  float av[kStates], h[kStates];
#pragma unroll
  for (int k = 0; k < kStates; ++k) {
    av[k] = live ? a[(long long)ch * N + lane * kStates + k] : 0.f;
    h[k] = 0.f;
  }
  const float dv = live ? dskip[ch] : 0.f;
  const long long row0 = (long long)bi * S * Di;  // x, dt, y: contiguous
  const T* bb = bm + bi * b_bstride;
  const T* cc = cm + bi * c_bstride;

  for (int t0 = 0; t0 < S; t0 += TS) {
    const int steps = min(TS, S - t0);
    for (int i = tid; i < TS * CB; i += kThreads) {
      const int t = i / CB;
      const int j = i % CB;
      float xv = 0.f, dtv = 0.f;
      if (t < steps && c0 + j < Di) {
        const long long off = row0 + (long long)(t0 + t) * Di + c0 + j;
        xv = to_f32(x[off]);
        dtv = dt[off];
      }
      x_s[t][j] = xv;
      dt_s[t][j] = dtv;
    }
    for (int i = tid; i < TS * N; i += kThreads) {
      const int t = i / N;
      const int n = i % N;
      float bv = 0.f, cv = 0.f;
      if (t < steps) {
        bv = to_f32(bb[(long long)(t0 + t) * b_tstride + n]);
        cv = to_f32(cc[(long long)(t0 + t) * c_tstride + n]);
      }
      b_s[t][n] = bv;
      c_s[t][n] = cv;
    }
    __syncthreads();
    for (int t = 0; t < steps; ++t) {
      const float dtt = dt_s[t][g];
      const float xt = x_s[t][g];
      const float dx = __fmul_rn(dtt, xt);
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kStates; ++k) {
        const int n = lane * kStates + k;
        const float decay = expf(__fmul_rn(dtt, av[k]));
        h[k] = __fadd_rn(__fmul_rn(decay, h[k]), __fmul_rn(dx, b_s[t][n]));
        acc = fmaf(h[k], c_s[t][n], acc);
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) y_s[t][g] = acc + dv * xt;
    }
    __syncthreads();
    for (int i = tid; i < steps * CB; i += kThreads) {
      const int t = i / CB;
      const int j = i % CB;
      if (c0 + j < Di)
        y[row0 + (long long)(t0 + t) * Di + c0 + j] = from_f32<T>(y_s[t][j]);
    }
    // the next tile's staging writes x_s .. c_s, which every thread last
    // read before the barrier above; y_s is next written after the next
    // barrier, when every thread has stored this tile
  }
  if (h_out != nullptr && live) {
#pragma unroll
    for (int k = 0; k < kStates; ++k)
      h_out[((long long)bi * Di + ch) * N + lane * kStates + k] = h[k];
  }
}

template <typename T, int G>
int launch(const void* x, const float* dt, const float* a, const void* bm,
           const void* cm, const float* dskip, void* y, float* h_out, int B,
           int S, int Di, long long b_bstride, long long b_tstride,
           long long c_bstride, long long c_tstride, cudaStream_t stream) {
  constexpr int CB = kThreads / G;
  const dim3 grid((Di + CB - 1) / CB, B);
  ssm_scan_kernel<T, G><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), dskip, static_cast<T*>(y), h_out, S, Di,
      b_bstride, b_tstride, c_bstride, c_tstride);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int N, const void* x, const float* dt, const float* a,
             const void* bm, const void* cm, const float* dskip, void* y,
             float* h_out, int B, int S, int Di, long long b_bstride,
             long long b_tstride, long long c_bstride, long long c_tstride,
             cudaStream_t s) {
  switch (N) {
    case 4:
      return launch<T, 1>(x, dt, a, bm, cm, dskip, y, h_out, B, S, Di,
                          b_bstride, b_tstride, c_bstride, c_tstride, s);
    case 8:
      return launch<T, 2>(x, dt, a, bm, cm, dskip, y, h_out, B, S, Di,
                          b_bstride, b_tstride, c_bstride, c_tstride, s);
    case 16:
      return launch<T, 4>(x, dt, a, bm, cm, dskip, y, h_out, B, S, Di,
                          b_bstride, b_tstride, c_bstride, c_tstride, s);
    case 32:
      return launch<T, 8>(x, dt, a, bm, cm, dskip, y, h_out, B, S, Di,
                          b_bstride, b_tstride, c_bstride, c_tstride, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y share it; dt, A, D and
// h_out are float32). x, dt and y are contiguous (B, S, Di); A is (Di, N)
// and D (Di,) contiguous; B and C are read through their batch and time
// strides (in elements) with N contiguous. h_out (B, Di, N) may be null.
// N is 4, 8, 16 or 32. Returns cudaGetLastError() after the launch.
extern "C" int repro_ssm_scan(int dtype, const void* x, const float* dt,
                              const float* a, const void* bm, const void* cm,
                              const float* dskip, void* y, float* h_out, int B,
                              int S, int Di, int N, long long b_bstride,
                              long long b_tstride, long long c_bstride,
                              long long c_tstride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(N, x, dt, a, bm, cm, dskip, y, h_out, B, S, Di,
                           b_bstride, b_tstride, c_bstride, c_tstride, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(N, x, dt, a, bm, cm, dskip, y, h_out, B, S,
                                   Di, b_bstride, b_tstride, c_bstride,
                                   c_tstride, s);
  return (int)cudaErrorInvalidValue;
}
