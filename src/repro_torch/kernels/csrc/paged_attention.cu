// Paged decode attention for Hopper (sm_90a): K/V read through a page table.
//
// Replaces the TPU kernel `paged_attention` / `_pa_kernel` of
// src/repro/kernels/paged_attention.py (pallas_call at :253). Same
// function: q (B, Hq, D) against K/V pages (P, T, Hkv, D) through
// page_table (B, NP) int32, masked at lengths (B,), GQA group Hq / Hkv.
// Scores past the length get -1e30 before the running max and V is zeroed
// there, so pages past the length (or padded table slots) may hold NaN.
// The output is 0 where the length is 0. f32 accumulation; q's dtype out.
//
// Bound: bytes. A decode step reads every live K/V page once and does 4 flops
// per element read (q.k and p.v), far below the ~295 flop/byte the card needs
// before compute limits it. The least time is
//   live pages x T * Hkv * D * 2 (K and V) * sizeof(elem) / 3.35 TB/s.
// What this first design does about it: each CTA serves one (request, KV
// head) and all Hq / Hkv query heads of the group from ONE load of each
// page, so K/V bytes are read exactly once per step; it walks only the
// ceil(len / T) live pages of its request, never the padded width of the
// table; and it loads pages with 16-byte vector loads. It does not yet
// overlap the next page's load with the current page's math (no cp.async,
// TMA or wgmma), and B * Hkv CTAs may not fill 132 SMs: both are for a
// later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

// 16-byte vector of K/V elements, widened to f32.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void widen(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void widen(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

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

// One CTA per (KV head h = blockIdx.x, request b = blockIdx.y).
// Shared memory (f32): K and V tiles of one page (rows padded to D + 1 so
// threads reading different tokens hit different banks), the group's q
// rows, the (G, D) accumulator, the (G, T) scores and per-head m, l, alpha.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const int* __restrict__ table,
                           const int* __restrict__ lengths,
                           T* __restrict__ out, int Hq, int Hkv, int D,
                           int page_tokens, int NP, long long page_stride,
                           long long token_stride, long long head_stride,
                           float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int G = Hq / Hkv;
  const int Tp = page_tokens;
  const int Dp = D + 1;

  extern __shared__ float smem[];
  float* k_s = smem;            // (Tp, Dp)
  float* v_s = k_s + Tp * Dp;   // (Tp, Dp)
  float* q_s = v_s + Tp * Dp;   // (G, Dp)
  float* acc = q_s + G * Dp;    // (G, D)
  float* s_s = acc + G * D;     // (G, Tp)
  float* m_s = s_s + G * Tp;    // (G,)
  float* l_s = m_s + G;         // (G,)
  float* a_s = l_s + G;         // (G,)

  T* o = out + ((long long)b * Hq + (long long)h * G) * D;
  // positions past NP * T do not exist: the table ends there
  const int len = min(lengths[b], NP * Tp);
  if (len <= 0) {
    for (int i = tid; i < G * D; i += kThreads) o[i] = from_f32<T>(0.f);
    return;
  }

  const T* qb = q + ((long long)b * Hq + (long long)h * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[(i / D) * Dp + i % D] = to_f32(qb[i]) * scale;
    acc[i] = 0.f;
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  constexpr int VN = Vec<T>::N;
  const int chunks = D / VN;  // 16-byte chunks per token row
  const int n_live = (len + Tp - 1) / Tp;
  for (int p = 0; p < n_live; ++p) {
    const long long page = table[(long long)b * NP + p];
    const T* kp = k + page * page_stride + (long long)h * head_stride;
    const T* vp = v + page * page_stride + (long long)h * head_stride;
    __syncthreads();  // the previous page's readers are done with the tiles
    for (int c = tid; c < Tp * chunks; c += kThreads) {
      const int t = c / chunks;
      const int d0 = (c % chunks) * VN;
      float kf[VN], vf[VN];
      if (p * Tp + t < len) {
        Vec<T>::widen(
            *reinterpret_cast<const uint4*>(kp + t * token_stride + d0), kf);
        Vec<T>::widen(
            *reinterpret_cast<const uint4*>(vp + t * token_stride + d0), vf);
      } else {  // masked slot: never read, so garbage never enters
#pragma unroll
        for (int j = 0; j < VN; ++j) kf[j] = vf[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VN; ++j) {
        k_s[t * Dp + d0 + j] = kf[j];
        v_s[t * Dp + d0 + j] = vf[j];
      }
    }
    __syncthreads();
    for (int i = tid; i < G * Tp; i += kThreads) {
      const int g = i / Tp;
      const int t = i % Tp;
      float s = kNegInf;
      if (p * Tp + t < len) {
        const float* qr = q_s + g * Dp;
        const float* kr = k_s + t * Dp;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot;
      }
      s_s[i] = s;
    }
    __syncthreads();
    if (tid < G) {  // online softmax: the running max and sum of one head
      float* sr = s_s + tid * Tp;
      const float m_prev = m_s[tid];
      float m_new = m_prev;
      for (int t = 0; t < Tp; ++t) m_new = fmaxf(m_new, sr[t]);
      float sum = 0.f;
      for (int t = 0; t < Tp; ++t) {
        const float pe = (p * Tp + t < len) ? expf(sr[t] - m_new) : 0.f;
        sr[t] = pe;
        sum += pe;
      }
      const float alpha = expf(m_prev - m_new);
      l_s[tid] = alpha * l_s[tid] + sum;
      m_s[tid] = m_new;
      a_s[tid] = alpha;
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D;
      const int d = i % D;
      const float* pr = s_s + g * Tp;
      float a = acc[i] * a_s[g];
      for (int t = 0; t < Tp; ++t) a = fmaf(pr[t], v_s[t * Dp + d], a);
      acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const float l = l_s[i / D];
    o[i] = from_f32<T>(acc[i] / (l == 0.f ? 1.f : l));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* table,
           const int* lengths, void* out, int B, int Hq, int Hkv, int D,
           int page_tokens, int NP, long long page_stride,
           long long token_stride, long long head_stride, float scale,
           cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem =
      sizeof(float) * (2 * (size_t)page_tokens * (D + 1) + (size_t)G * (D + 1) +
                       (size_t)G * D + (size_t)G * page_tokens + 3 * (size_t)G);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(Hkv, B);
  paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), table, lengths, static_cast<T*>(out), Hq, Hkv,
      D, page_tokens, NP, page_stride, token_stride, head_stride, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, K, V and out share it). Strides are
// in elements; D is contiguous. Returns cudaGetLastError() after the launch.
extern "C" int repro_paged_attention(int dtype, const void* q, const void* k,
                                     const void* v, const int* table,
                                     const int* lengths, void* out, int B,
                                     int Hq, int Hkv, int D, int page_tokens,
                                     int NP, long long page_stride,
                                     long long token_stride,
                                     long long head_stride, float scale,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, table, lengths, out, B, Hq, Hkv, D,
                         page_tokens, NP, page_stride, token_stride,
                         head_stride, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, table, lengths, out, B, Hq, Hkv, D,
                                 page_tokens, NP, page_stride, token_stride,
                                 head_stride, scale, s);
  return (int)cudaErrorInvalidValue;
}
