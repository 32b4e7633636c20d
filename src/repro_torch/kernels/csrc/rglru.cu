// RG-LRU gated linear scan for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t.
//
// Replaces the TPU kernel `gated_linear_scan` / `_lru_kernel` of
// src/repro/kernels/rglru.py (pallas_call at :73). Same function: a and b
// (B, S, W) contiguous, f32 or bf16 (one dtype for both), h_0 = 0, every
// h_t written in b's dtype; f32 inside. recurrentgemma's `rec` blocks run
// it over the RG-LRU's gates in f32 at every prefill.
//
// Bound: bytes. Each element of a and b is read once and each h_t written
// once, with one multiply and one add per element: at recurrentgemma's
// prefill (B 1, S 2560, W 4096, f32) that is ~126 MB, ~38 us at 3.35 TB/s.
// What this first design does about it: one thread per (batch row,
// channel) walks time with the state in a register; a warp's loads and
// stores are 128 contiguous bytes along W; each thread loads U time steps
// of a and b before it uses them, so 2 U loads per thread are in flight
// while the dependent chain runs; warps of 32 threads spread B x W / 32
// CTAs over the SMs. The update rounds as the plain PyTorch version does
// (a multiply, then an add; no fused multiply-add), so f32 results equal
// it bit for bit. Not done yet: at B 1 only W threads exist (4,096 at
// recurrentgemma's width), too few loads in flight to reach the memory
// rate; a chunked form (each chunk scanned from 0 in parallel, then a
// carry pass) would add parallelism over time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;
constexpr int kUnroll = 16;  // time steps loaded ahead per thread

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

// One thread per (channel w, batch row blockIdx.y).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 T* __restrict__ y, int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const long long base = (long long)blockIdx.y * S * W + w;
  float h = 0.f;
  for (int t0 = 0; t0 < S; t0 += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < S) {
        const long long off = base + (long long)(t0 + u) * W;
        av[u] = to_f32(a[off]);
        bv[u] = to_f32(b[off]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < S) {
        h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
        y[base + (long long)(t0 + u) * W] = from_f32<T>(h);
      }
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* y, int B, int S, int W,
           cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(y),
      S, W);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (a, b and y share it). a, b and y are
// contiguous (B, S, W). Returns cudaGetLastError() after the launch.
extern "C" int repro_rglru_scan(int dtype, const void* a, const void* b,
                                void* y, int B, int S, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, y, B, S, W, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, y, B, S, W, s);
  return (int)cudaErrorInvalidValue;
}
