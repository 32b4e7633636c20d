// RG-LRU gated linear scan, backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference trains the RG-LRU through XLA's
// autodiff of its `lax.scan` oracle (src/repro/kernels/ref.py:352); the
// port's forward is the hand kernel csrc/rglru.cu, so its backward is one
// too. From the forward's saved output h and the cotangent dh (B, S, W),
// the reverse scan
//   g_t = dh_t + a_{t+1} g_{t+1},   g_{S-1} = dh_{S-1},
//   db_t = g_t,   da_t = g_t h_{t-1}   (h_{-1} = 0),
// a, h, dh and both outputs contiguous (B, S, W) of one dtype, f32 or bf16;
// f32 inside. The update rounds as ref.gated_linear_scan_bwd does (a
// multiply, then an add; no fused multiply-add), so f32 results equal the
// plain version bit for bit.
//
// Bound: bytes. a, h and dh are read once and da and db written once, two
// multiplies and an add an element: at recurrentgemma's training shape (B
// 1, S 4096, W 4096, f32) 335.5 MB, ~100 us at 3.35 TB/s. The chain (a
// multiply and an add, ~8 clocks a step) is ~17 us over 4,096 steps.
//
// Design (simple first): one thread a channel, a CTA one warp of 32
// channels of one batch row, so W / 32 x B CTAs spread over the SMs. A
// thread walks time backwards in blocks of kBlock steps: the block's a,
// dh and h_{t-1} come into registers first (3 x kBlock independent
// loads in flight, a warp's 32 channels one coalesced row each), then the
// chain runs in straight code and each step's da and db are stored.
// Steps past S load zeros (g stays 0 there) and are not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;  // channels a CTA
constexpr int kBlock = 32;    // steps loaded before they are used

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_bwd_kernel(const T* __restrict__ a, const T* __restrict__ h,
                     const T* __restrict__ dh, T* __restrict__ da,
                     T* __restrict__ db, int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const long long base = (long long)blockIdx.y * S * W + w;
  const int nb = (S + kBlock - 1) / kBlock;
  float g = 0.f, anext = 0.f;
  for (int blk = nb - 1; blk >= 0; --blk) {
    const int t0 = blk * kBlock;
    float av[kBlock], dv[kBlock], hv[kBlock];
#pragma unroll
    for (int u = 0; u < kBlock; ++u) {
      const int t = t0 + u;
      const long long i = base + (long long)t * W;
      const bool on = t < S;
      av[u] = on ? to_f32(a[i]) : 0.f;
      dv[u] = on ? to_f32(dh[i]) : 0.f;
      hv[u] = on && t > 0 ? to_f32(h[i - W]) : 0.f;
    }
#pragma unroll
    for (int u = kBlock - 1; u >= 0; --u) {
      const int t = t0 + u;
      g = __fadd_rn(dv[u], __fmul_rn(anext, g));
      if (t < S) {
        const long long i = base + (long long)t * W;
        db[i] = from_f32<T>(g);
        da[i] = from_f32<T>(__fmul_rn(g, hv[u]));
      }
      anext = av[u];
    }
  }
}

template <typename T>
int launch(const void* a, const void* h, const void* dh, void* da, void* db,
           int B, int S, int W, cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(h),
      static_cast<const T*>(dh), static_cast<T*>(da), static_cast<T*>(db), S,
      W);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every array shares it). All arrays are
// contiguous (B, S, W). Returns cudaGetLastError() after the launch.
extern "C" int repro_rglru_scan_bwd(int dtype, const void* a, const void* h,
                                    const void* dh, void* da, void* db, int B,
                                    int S, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, h, dh, da, db, B, S, W, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, h, dh, da, db, B, S, W, s);
  return (int)cudaErrorInvalidValue;
}
