// Flash-attention backward for Hopper (sm_90a): the dK/dV kernel and the dQ
// kernel.
//
// Replace the TPU kernels `_dkv_kernel` (src/repro/kernels/
// flash_attention_bwd.py:58, pallas_call :233) and `_dq_kernel` (:129,
// pallas_call :270) that `flash_attention_vjp` (:186) runs. Same function:
// from q, k, v, dO, the forward's lse and delta = rowsum(dO * O) (computed
// in plain torch, as the reference does in jnp), recompute
//   p  = exp((q * scale) . k^T - lse) under the mask (0 where hidden),
//   dS = p * (dO . V^T - delta),
// and accumulate in f32
//   dV = p^T . dO and dK = dS^T . (q * scale), summed over the q heads of
//   the KV head's GQA group, in k's and v's dtype;
//   dQ = dS . K * scale, in q's dtype.
// Masks are those of `_mask` (:44-52), q and k positions counted from 0.
//
// Bound: operations. At the training shape (B 2, Hq 32, Hkv 8, S 2048,
// D 128, causal) the dK/dV kernel does 4 products of 2 * D flops per
// visible (q, k) pair (s recomputed, dO . V^T, p^T . dO, dS^T . q), 137.5
// GFLOP, least time 139 us at 989 TFLOP/s (bf16); the dQ kernel does 3
// (s, dO . V^T, dS . K), 103.1 GFLOP, 104 us. Their bytes (q, k, v, dO, lse,
// delta in; dK, dV or dQ out) are under 100 MB, 30 us at 3.35 TB/s.
// What this first design does about it: the dK/dV kernel runs one CTA per
// (KV block of 64, KV head, batch) that holds its K and V tiles and its
// dK and dV accumulators (4 x (D / 16) each per thread) for the whole loop
// over the group's q heads x q blocks, so dK and dV are written once and
// need no atomics; the dQ kernel runs one CTA per (q block, q head, batch)
// that holds q, dO and its dQ accumulator and loops over the KV blocks,
// reading K and V of head h / G in place (no repeated copy). Both skip the
// blocks the mask hides whole. Products are SIMT f32 FMAs; tensor-core
// tiles are for a later change.

#include "flash_common.cuh"

namespace flash {
namespace {

// Scores of one (q block, kv block) pair into p and dS (both (64, 64 + 1) in
// shared memory, [q row][kv row]): p = exp(s - lse) under the mask, and
// dS = p * (dO . V^T - delta). q_s holds q * scale.
template <int D>
__device__ __forceinline__ void p_and_ds(const float* q_s, const float* k_s,
                                         const float* do_s, const float* v_s,
                                         const float (&lse)[4],
                                         const float (&delta)[4], int q0,
                                         int k0, int Sq, int Sk, bool causal,
                                         int window, int ty, int tx,
                                         float* p_s, float* ds_s) {
  constexpr int BP = kBlock + 1;
  float s[4][4] = {};
  float dp[4][4] = {};
  dot_nt<D>(q_s, k_s, ty, tx, s);
  dot_nt<D>(do_s, v_s, ty, tx, dp);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kpos = k0 + tx + 16 * j;
      const bool vis =
          qpos < Sq && kpos < Sk && visible(qpos, kpos, causal, window);
      const float p = vis ? expf(s[i][j] - lse[i]) : 0.f;
      const int at = (ty + 16 * i) * BP + tx + 16 * j;
      if (p_s != nullptr) p_s[at] = p;
      ds_s[at] = p * (dp[i][j] - delta[i]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv, int Sq,
               int Sk, float scale, int causal, int window) {
  constexpr int DP = D + 1;
  constexpr int BP = kBlock + 1;
  constexpr int NJ = D / 16;
  const int k0 = blockIdx.x * kBlock;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  extern __shared__ float smem[];
  float* k_s = smem;                  // (64, D + 1)
  float* v_s = k_s + kBlock * DP;     // (64, D + 1)
  float* q_s = v_s + kBlock * DP;     // (64, D + 1): q * scale
  float* do_s = q_s + kBlock * DP;    // (64, D + 1)
  float* p_s = do_s + kBlock * DP;    // (64, 64 + 1): [q row][kv row]
  float* ds_s = p_s + kBlock * BP;    // (64, 64 + 1)

  const size_t koff = ((size_t)b * Hkv + hk) * Sk * D;
  load_tile<T, D>(k_s, k + koff, k0, Sk, 1.f);
  load_tile<T, D>(v_s, v + koff, k0, Sk, 1.f);

  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int k1 = min(k0 + kBlock, Sk);
  const int nq = (Sq + kBlock - 1) / kBlock;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const size_t qoff = ((size_t)b * Hq + h) * Sq * D;
    const float* lse_h = lse + ((size_t)b * Hq + h) * Sq;
    const float* delta_h = delta + ((size_t)b * Hq + h) * Sq;
    for (int qb = 0; qb < nq; ++qb) {
      const int q0 = qb * kBlock;
      if (block_hidden(q0, min(q0 + kBlock, Sq), k0, k1, causal, window))
        continue;
      __syncthreads();  // the previous block's readers are done
      load_tile<T, D>(q_s, q + qoff, q0, Sq, scale);
      load_tile<T, D>(do_s, dout + qoff, q0, Sq, 1.f);
      float lse_r[4], delta_r[4];
      load_rows(lse_r, lse_h, q0, Sq, ty);
      load_rows(delta_r, delta_h, q0, Sq, ty);
      __syncthreads();
      p_and_ds<D>(q_s, k_s, do_s, v_s, lse_r, delta_r, q0, k0, Sq, Sk, causal,
                  window, ty, tx, p_s, ds_s);
      __syncthreads();
      acc_nn<D, true>(p_s, do_s, ty, tx, dv_acc);   // dV += p^T . dO
      acc_nn<D, true>(ds_s, q_s, ty, tx, dk_acc);   // dK += dS^T . q * scale
    }
  }
  store_rows<T, D>(dk + koff, dk_acc, k0, Sk, ty, tx, 1.f);
  store_rows<T, D>(dv + koff, dv_acc, k0, Sk, ty, tx, 1.f);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int Hq, int Hkv, int Sq, int Sk, float scale,
              int causal, int window) {
  constexpr int DP = D + 1;
  constexpr int NJ = D / 16;
  const int q0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  extern __shared__ float smem[];
  float* q_s = smem;                  // (64, D + 1): q * scale
  float* do_s = q_s + kBlock * DP;    // (64, D + 1)
  float* k_s = do_s + kBlock * DP;    // (64, D + 1)
  float* v_s = k_s + kBlock * DP;     // (64, D + 1)
  float* ds_s = v_s + kBlock * DP;    // (64, 64 + 1): [q row][kv row]

  const size_t qoff = ((size_t)b * Hq + h) * Sq * D;
  const size_t koff = ((size_t)b * Hkv + hk) * Sk * D;
  load_tile<T, D>(q_s, q + qoff, q0, Sq, scale);
  load_tile<T, D>(do_s, dout + qoff, q0, Sq, 1.f);
  float lse_r[4], delta_r[4];
  load_rows(lse_r, lse + ((size_t)b * Hq + h) * Sq, q0, Sq, ty);
  load_rows(delta_r, delta + ((size_t)b * Hq + h) * Sq, q0, Sq, ty);

  float dq_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq_acc[i][j] = 0.f;

  const int q1 = min(q0 + kBlock, Sq);
  const int nk = (Sk + kBlock - 1) / kBlock;
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * kBlock;
    if (block_hidden(q0, q1, k0, min(k0 + kBlock, Sk), causal, window))
      continue;
    __syncthreads();  // the previous block's readers are done
    load_tile<T, D>(k_s, k + koff, k0, Sk, 1.f);
    load_tile<T, D>(v_s, v + koff, k0, Sk, 1.f);
    __syncthreads();
    p_and_ds<D>(q_s, k_s, do_s, v_s, lse_r, delta_r, q0, k0, Sq, Sk, causal,
                window, ty, tx, nullptr, ds_s);
    __syncthreads();
    acc_nn<D, false>(ds_s, k_s, ty, tx, dq_acc);  // dQ += dS . K
  }
  store_rows<T, D>(dq + qoff, dq_acc, q0, Sq, ty, tx, scale);
}

template <int D>
size_t dkv_smem() {
  return sizeof(float) * (4 * kBlock * (D + 1) + 2 * kBlock * (kBlock + 1));
}

template <int D>
size_t dq_smem() {
  return sizeof(float) * (4 * kBlock * (D + 1) + kBlock * (kBlock + 1));
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv, int B,
               int Hq, int Hkv, int Sq, int Sk, float scale, int causal,
               int window, cudaStream_t stream) {
  const size_t smem = dkv_smem<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sk + kBlock - 1) / kBlock, Hkv, B);
  dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), Hq, Hkv, Sq, Sk, scale, causal,
      window);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int Hq,
              int Hkv, int Sq, int Sk, float scale, int causal, int window,
              cudaStream_t stream) {
  const size_t smem = dq_smem<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kBlock - 1) / kBlock, Hq, B);
  dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), Hq, Hkv, Sq, Sk, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace flash

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout, dk, dv share it); lse and
// delta are f32 (B, Hq, Sq). All tensors contiguous; D is 16, 32, 64 or 128;
// window < 0 means none. Each returns cudaGetLastError() after its launch.
extern "C" int repro_flash_attention_dkv(int dtype, const void* q,
                                         const void* k, const void* v,
                                         const void* dout, const float* lse,
                                         const float* delta, void* dk,
                                         void* dv, int B, int Hq, int Hkv,
                                         int Sq, int Sk, int D, float scale,
                                         int causal, int window,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_DKV(T, DD)                                                     \
  return flash::launch_dkv<T, DD>(q, k, v, dout, lse, delta, dk, dv, B, Hq, \
                                  Hkv, Sq, Sk, scale, causal, window, s)
  if (dtype == 0 && D == 16) REPRO_DKV(float, 16);
  if (dtype == 0 && D == 32) REPRO_DKV(float, 32);
  if (dtype == 0 && D == 64) REPRO_DKV(float, 64);
  if (dtype == 0 && D == 128) REPRO_DKV(float, 128);
  if (dtype == 1 && D == 16) REPRO_DKV(__nv_bfloat16, 16);
  if (dtype == 1 && D == 32) REPRO_DKV(__nv_bfloat16, 32);
  if (dtype == 1 && D == 64) REPRO_DKV(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) REPRO_DKV(__nv_bfloat16, 128);
#undef REPRO_DKV
  return (int)cudaErrorInvalidValue;
}

extern "C" int repro_flash_attention_dq(int dtype, const void* q,
                                        const void* k, const void* v,
                                        const void* dout, const float* lse,
                                        const float* delta, void* dq, int B,
                                        int Hq, int Hkv, int Sq, int Sk, int D,
                                        float scale, int causal, int window,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_DQ(T, DD)                                                     \
  return flash::launch_dq<T, DD>(q, k, v, dout, lse, delta, dq, B, Hq, Hkv, \
                                 Sq, Sk, scale, causal, window, s)
  if (dtype == 0 && D == 16) REPRO_DQ(float, 16);
  if (dtype == 0 && D == 32) REPRO_DQ(float, 32);
  if (dtype == 0 && D == 64) REPRO_DQ(float, 64);
  if (dtype == 0 && D == 128) REPRO_DQ(float, 128);
  if (dtype == 1 && D == 16) REPRO_DQ(__nv_bfloat16, 16);
  if (dtype == 1 && D == 32) REPRO_DQ(__nv_bfloat16, 32);
  if (dtype == 1 && D == 64) REPRO_DQ(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) REPRO_DQ(__nv_bfloat16, 128);
#undef REPRO_DQ
  return (int)cudaErrorInvalidValue;
}
