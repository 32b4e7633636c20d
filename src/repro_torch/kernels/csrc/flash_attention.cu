// Flash-attention forward with the row log-sum-exp, for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention` / `_fa_kernel` of
// src/repro/kernels/flash_attention.py (kernel :36, wrapper :117,
// pallas_call :167). Same function: q (B, Hq, Sq, D) against k, v
// (B, Hkv, Sk, D), q head h reading KV head h / (Hq / Hkv), scores
// (q * scale) . k in f32 under the causal / window mask of `_mask` with q and
// k positions both counted from 0, the online softmax with its running max m
// and sum l, and out = acc / l (out = 0 where a row sees no key) in q's
// dtype; lse = m + log(l) in f32 (-1e30 where a row sees no key).
//
// Bound: operations. At the training shape (B 2, Hq 32, Hkv 8, S 2048,
// D 128, causal) the two products take 4 * D flops per visible (q, k) pair,
// 68.7 GFLOP, against 84 MB of q, k, v, out and lse: about 820 flop per byte,
// far above the ~295 at which the H100's bf16 tensor cores stop waiting on
// memory. Least time 69 us at 989 TFLOP/s (bf16), 1.03 ms at 67 TFLOP/s
// (f32 outside the tensor cores).
// What this first design does about it: one CTA per (q block of 64, q head,
// batch) keeps its scaled q tile in shared memory and streams the KV blocks
// its rows can see, skipping blocks the mask hides whole (the TPU kernel
// computes and masks them), so causal attention does half the products. Each
// thread holds a 4 x 4 block of scores and a 4 x (D / 16) block of the
// accumulator in registers. The products are SIMT f32 FMAs, not tensor-core
// instructions: mma / wgmma tiles with TMA loads are the lever for a later
// change.

#include "flash_common.cuh"

namespace flash {
namespace {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ out,
               float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk,
               float scale, int causal, int window) {
  constexpr int DP = D + 1;
  constexpr int BP = kBlock + 1;
  constexpr int NJ = D / 16;
  const int q0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  extern __shared__ float smem[];
  float* q_s = smem;                 // (64, D + 1): q * scale
  float* k_s = q_s + kBlock * DP;    // (64, D + 1)
  float* v_s = k_s + kBlock * DP;    // (64, D + 1)
  float* p_s = v_s + kBlock * DP;    // (64, 64 + 1): this block's p

  const size_t qoff = ((size_t)b * Hq + h) * Sq * D;
  const size_t koff = ((size_t)b * Hkv + hk) * Sk * D;
  load_tile<T, D>(q_s, q + qoff, q0, Sq, scale);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int q1 = min(q0 + kBlock, Sq);
  const int nk = (Sk + kBlock - 1) / kBlock;
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * kBlock;
    if (block_hidden(q0, q1, k0, min(k0 + kBlock, Sk), causal, window))
      continue;
    __syncthreads();  // the previous block's readers are done with k, v, p
    load_tile<T, D>(k_s, k + koff, k0, Sk, 1.f);
    load_tile<T, D>(v_s, v + koff, k0, Sk, 1.f);
    __syncthreads();
    float s[4][4] = {};
    dot_nt<D>(q_s, k_s, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool vis[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        vis[j] = qpos < Sq && kpos < Sk && visible(qpos, kpos, causal, window);
        if (!vis[j]) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // rows with no visible key keep m == -1e30; exp() there must be 0
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[(ty + 16 * i) * BP + tx + 16 * j] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    acc_nn<D, false>(p_s, v_s, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      out[qoff + (size_t)r * D + tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
    if (tx == 0) lse[((size_t)b * Hq + h) * Sq + r] = m[i] + logf(denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int Hq, int Hkv, int Sq, int Sk, float scale, int causal,
           int window, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (3 * kBlock * (D + 1) + kBlock * (kBlock + 1));
  const cudaError_t e = cudaFuncSetAttribute(
      fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kBlock - 1) / kBlock, Hq, B);
  fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Hq, Hkv, Sq, Sk,
      scale, causal, window);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dtype(int dtype, const void* q, const void* k, const void* v,
                 void* out, float* lse, int B, int Hq, int Hkv, int Sq, int Sk,
                 float scale, int causal, int window, cudaStream_t s) {
  if (dtype == 0)
    return launch<float, D>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, scale,
                            causal, window, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, D>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk,
                                    scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace flash

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it); lse is f32.
// All tensors contiguous, (B, H, S, D) row-major; D is 16, 32, 64 or 128;
// window < 0 means none. Returns cudaGetLastError() after the launch.
extern "C" int repro_flash_attention_fwd(int dtype, const void* q,
                                         const void* k, const void* v,
                                         void* out, float* lse, int B, int Hq,
                                         int Hkv, int Sq, int Sk, int D,
                                         float scale, int causal, int window,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 16)
    return flash::launch_dtype<16>(dtype, q, k, v, out, lse, B, Hq, Hkv, Sq,
                                   Sk, scale, causal, window, s);
  if (D == 32)
    return flash::launch_dtype<32>(dtype, q, k, v, out, lse, B, Hq, Hkv, Sq,
                                   Sk, scale, causal, window, s);
  if (D == 64)
    return flash::launch_dtype<64>(dtype, q, k, v, out, lse, B, Hq, Hkv, Sq,
                                   Sk, scale, causal, window, s);
  if (D == 128)
    return flash::launch_dtype<128>(dtype, q, k, v, out, lse, B, Hq, Hkv, Sq,
                                    Sk, scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
