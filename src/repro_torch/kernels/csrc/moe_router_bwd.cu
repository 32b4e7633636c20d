// MoE router, backward, for Hopper (sm_90a): the gradient of the routing
// weights in the logits.
//
// Replaces no TPU kernel: the reference's model routes through the plain
// `route_topk` (src/repro/kernels/ref.py:169), whose weights XLA
// differentiates; the port routes through the hand kernel
// csrc/moe_router.cu, so the weights' gradient is a hand kernel too. From
// the logits (T, E) f32, the chosen experts expert_idx (T, K) int32 (the
// forward's) and the weights' cotangent dw (T, K) f32:
//   p = softmax(logits) (recomputed),  s = sum_j p[e_j],
//   dp_j = dw_j / max(s, 1e-9) - [s >= 1e-9] (sum_i dw_i p[e_i]) / max(s, 1e-9)^2
//          with renormalisation (else dp_j = dw_j),
//   g = dp scattered onto the K chosen experts,
//   dlogits = p * (g - <p, g>)          (T, E) f32.
// ref.route_topk_bwd is the same function in plain torch.
//
// Bound: bytes. The logits are read once and dlogits written once (8 T E
// bytes) with 8 T K bytes of indices and cotangents: at kimi-k2's E 384,
// K 8 and T 8,192, 25.7 MB, ~7.7 us at 3.35 TB/s; a few operations a
// logit (an exponential among them).
//
// Design: a row-wise reduction, written in CUDA to share the forward's
// build and toolchain (Triton would serve as well). One warp a token,
// eight tokens a CTA. Lane l holds experts l, l + 32, ... of its row: a
// max butterfly, then a sum butterfly of exp(logit - max); lane j < K
// loads choice j's expert and cotangent and recomputes its p; two more
// butterflies give s and <p, g>; each lane writes p (-<p, g>) for its
// experts, and after __syncwarp lane j overwrites its chosen expert's
// entry with p (dp_j - <p, g>) (the K experts of a token are distinct).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;  // tokens a CTA
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o >= 1; o /= 2) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o >= 1; o /= 2) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void __launch_bounds__(32 * kWarps)
    moe_router_bwd_kernel(const float* __restrict__ logits,
                          const int* __restrict__ eidx,
                          const float* __restrict__ dw,
                          float* __restrict__ dlogits, int T, int E, int K,
                          bool renormalize) {
  const int lane = threadIdx.x % 32;
  const int tok = blockIdx.x * kWarps + threadIdx.x / 32;
  if (tok >= T) return;  // a whole warp leaves together
  const float* row = logits + (long long)tok * E;
  float* out = dlogits + (long long)tok * E;

  float m = -INFINITY;
  for (int e = lane; e < E; e += 32) m = fmaxf(m, row[e]);
  m = warp_max(m);
  float z = 0.f;
  for (int e = lane; e < E; e += 32) z += expf(row[e] - m);
  z = warp_sum(z);

  // lane j < K: choice j's expert, p and cotangent
  const bool mine = lane < K;
  const int ej = mine ? eidx[(long long)tok * K + lane] : 0;
  const float pj = mine ? expf(row[ej] - m) / z : 0.f;
  const float dwj = mine ? dw[(long long)tok * K + lane] : 0.f;
  float dp = dwj;
  if (renormalize) {
    const float s = warp_sum(pj);
    const float sc = fmaxf(s, 1e-9f);
    const float wdot = warp_sum(dwj * pj);
    dp = dwj / sc - (s >= 1e-9f ? wdot / (sc * sc) : 0.f);
  }
  const float pg = warp_sum(pj * dp);  // <p, g>

  for (int e = lane; e < E; e += 32) out[e] = expf(row[e] - m) / z * -pg;
  __syncwarp();
  if (mine) out[ej] = pj * (dp - pg);
}

}  // namespace

// logits (T, E) f32, expert_idx (T, K) int32, dw (T, K) f32 and dlogits
// (T, E) f32, all contiguous; K <= 32. Returns cudaGetLastError() after
// the launch.
extern "C" int repro_moe_router_bwd(const float* logits, const int* eidx,
                                    const float* dw, float* dlogits, int T,
                                    int E, int K, int renormalize,
                                    void* stream) {
  if (K < 1 || K > 32 || E < 1) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((T + kWarps - 1) / kWarps);
  moe_router_bwd_kernel<<<grid, 32 * kWarps, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      logits, eidx, dw, dlogits, T, E, K, renormalize != 0);
  return (int)cudaGetLastError();
}
