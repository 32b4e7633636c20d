// Paged decode attention for Hopper (sm_90a): K/V read through a page
// table, each request's live pages split across CTAs ("flash-decoding").
//
// Replaces the TPU kernel `paged_attention` / `_pa_kernel` of
// src/repro/kernels/paged_attention.py (pallas_call at :253). Same
// function: q (B, Hq, D) against K/V pages (P, T, Hkv, D) through
// page_table (B, NP) int32, masked at lengths (B,), GQA group Hq / Hkv.
// K/V past the length is never loaded, so pages past the length (or padded
// table slots) may hold NaN. The output is 0 where the length is 0. f32
// accumulation; q's dtype out.
//
// Bound: bytes. A decode step reads the K and V rows of every live position
// once and does 4 flops per element read (q.k and p.v), far below the ~295
// flop/byte the card needs before compute limits it. The least time is
//   sum of lengths x Hkv * D * 2 (K and V) * sizeof(elem) / 3.35 TB/s
// (beside q, out, the lengths and the live table entries),
// a few microseconds at the served shapes, so in practice the kernel is
// bound by latency: the launch, and the chain of dependent steps of its
// slowest CTA.
//
// What the design does about it. The grid is (KV head, request, split):
// each CTA takes one run of `split_tokens` positions (whole pages; 64
// tokens, four pages of 16, by default) of one request for one KV head and
// all Hq / Hkv query heads of its group, so the K/V bytes are read once and
// a long request is spread over many SMs. The split is the slowest grid
// dimension, so the CTAs of live splits are dispatched first; a CTA whose
// split starts past its request's length returns at once. A CTA loads its
// request's length, its page numbers and q together, then has cp.async
// stage its whole split's K and V rows into shared memory (zeros past the
// length, where nothing is read), every copy in flight before the first is
// used and none held in registers. D / 8 lanes (bf16; D / 4 for f32) take
// one token's rows as 16-byte vectors, a warp a few tokens at a time, each
// lane reading back the slots it copied itself, so no barrier lies between
// the copies and their use. q.k: each lane takes the partial dot product of
// its 8 (or 4) elements with q, held in registers and scaled in f32, for
// up to 8 query heads at a time, and an xor-shuffle over the token's lanes
// finishes it. The softmax runs per warp in base 2 (max and sum by
// shuffles), p.v accumulates per lane on its elements, and the 4 warps
// merge through shared memory: m = max m_w, l = sum l_w 2^(m_w - m),
// acc = sum acc_w 2^(m_w - m). A request of one split writes out = acc / l
// directly. Otherwise each CTA writes its partial (m, l, acc) in f32 to a
// workspace, counts itself in its (request, KV head)'s arrival counter,
// and the last CTA to arrive merges the partials in split order (so the
// result does not depend on which CTA was last) with the same formula, 8
// splits at a time (each later 8 folded in with the running sums rescaled
// to their new max), all of a round's loads in flight together; it writes
// out and puts the counter back to 0 for the next launch. One launch does
// it all. No tensor cores: at 4 flops per element read there is nothing
// for them to do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPass = 64;  // positions staged in shared memory at once
constexpr int kSub = 4;    // a lane's tokens whose scores are held at once
constexpr int kMerge = 8;  // splits whose partials the merge loads at once
constexpr int kElems = 4;  // outputs a thread of the merge takes at once
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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

// 2^x by the special-function unit (relative error about 2^-22; 0 for
// results below 2^-126, so exp2(-1e30 - m) is 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes from global to shared memory by cp.async; zeros, and nothing
// read, where !valid.
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// One CTA per (KV head h = blockIdx.x, request b = blockIdx.y, split s =
// blockIdx.z). A pass stages PASS positions of the split: thread tid copies,
// and later reads, elements [li * VN, li * VN + VN) (li = tid % LT) of the
// K and V rows of positions p0 + tid / LT + j * ROW, j < NT, into its own
// 16-byte slots of shared memory, so no barrier lies between the copies
// and their use. Heads are taken GC at a time (4 when the group has at
// most 4, else 8: one round for the served groups of 4, 7 and 8; a larger
// group reuses a one-pass split's staged K/V for each 8 heads). Scores are
// kept in base 2 (q is scaled by scale * log2 e), so each exponential is
// one ex2. Workspace of (b, h): per split, m[G], l[G], then acc (G, D).
template <typename T, int D, int GC>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const int* __restrict__ table,
                           const int* __restrict__ lengths,
                           T* __restrict__ out, float* __restrict__ ws,
                           int* __restrict__ arrivals, int Hq, int Hkv,
                           int page_tokens, int NP, int split_tokens,
                           int n_splits, long long page_stride,
                           long long token_stride, long long head_stride,
                           float scale) {
  constexpr int VN = Vec<T>::N;  // elements per 16-byte vector
  constexpr int LT = D / VN;     // lanes per token row
  static_assert(LT >= 1 && LT <= 32 && (LT & (LT - 1)) == 0,
                "a token row must be 1 to 32 vectors, a power of two");
  constexpr int TW = 32 / LT;       // tokens a warp reads at once
  constexpr int ROW = kWarps * TW;  // tokens the CTA reads at once
  constexpr int PASS = ROW > kPass ? ROW : kPass;
  constexpr int NT = PASS / ROW;  // a thread's tokens per pass
  constexpr int SUB = NT < kSub ? NT : kSub;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int s = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int li = lane % LT;
  const int G = Hq / Hkv;
  const int Tp = page_tokens;
  const int t0 = s * split_tokens;
  const int* pages = table + (long long)b * NP;
  const T* kh = k + (long long)h * head_stride + li * VN;
  const T* vh = v + (long long)h * head_stride + li * VN;
  const T* qh = q + ((long long)b * Hq + (long long)h * G) * D + li * VN;
  T* o = out + ((long long)b * Hq + (long long)h * G) * D;

  // The length, the first pass's page numbers (read ahead of the length:
  // the table has NP entries, whatever they hold) and q are loaded at once.
  const int len = min(lengths[b], NP * Tp);  // the table ends at NP * T
  int page[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j)
    page[j] = NP > 0 ? pages[min((t0 + tid / LT + j * ROW) / Tp, NP - 1)] : 0;
  uint4 qv[GC];
#pragma unroll
  for (int g = 0; g < GC; ++g)
    if (g < G) qv[g] = *reinterpret_cast<const uint4*>(qh + g * D);

  if (len <= 0) {
    if (s == 0)
      for (int i = tid; i < G * D; i += kThreads) o[i] = from_f32<T>(0.f);
    return;
  }
  const int ns = (len + split_tokens - 1) / split_tokens;  // live splits
  if (s >= ns) return;
  const int t1 = min(t0 + split_tokens, len);
  const long long bh = (long long)b * Hkv + h;
  float* part = ws + (bh * n_splits + s) * G * (D + 2);

  extern __shared__ uint4 staged[];  // K then V: (NT, kThreads) slots each
  uint4* k_s = staged;
  uint4* v_s = staged + NT * kThreads;
  __shared__ float sm_m[kWarps][GC];
  __shared__ float sm_l[kWarps][GC];
  __shared__ float sm_acc[kWarps][GC][D];
  __shared__ int last;

  // the pass at p0: every copy in flight before the first is used
  auto stage = [&](int p0) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int pos = p0 + tid / LT + j * ROW;
      const bool valid = pos < t1;
      const long long off = valid ? (long long)page[j] * page_stride +
                                        (long long)(pos % Tp) * token_stride
                                  : 0;
      copy16(k_s + j * kThreads + tid, kh + off, valid);
      copy16(v_s + j * kThreads + tid, vh + off, valid);
    }
    copy_wait_all();
  };
  const bool one_pass = t1 - t0 <= PASS;
  const float qscale = scale * kLog2e;

  for (int g0 = 0; g0 < G; g0 += GC) {
    float qf[GC][VN];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (g0 > 0 && g0 + g < G)
        qv[g] = *reinterpret_cast<const uint4*>(qh + (g0 + g) * D);
      if (g0 + g < G) {
        Vec<T>::widen(qv[g], qf[g]);
#pragma unroll
        for (int j = 0; j < VN; ++j) qf[g][j] *= qscale;
      } else {
#pragma unroll
        for (int j = 0; j < VN; ++j) qf[g][j] = 0.f;
      }
    }
    float m[GC], l[GC], acc[GC][VN];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      m[g] = kNegInf;
      l[g] = 0.f;
#pragma unroll
      for (int j = 0; j < VN; ++j) acc[g][j] = 0.f;
    }

    for (int p0 = t0; p0 < t1; p0 += PASS) {
      if (g0 == 0 || !one_pass) {
        if (p0 > t0 || g0 > 0) {  // other passes read their pages now
#pragma unroll
          for (int j = 0; j < NT; ++j)
            page[j] = pages[min((p0 + tid / LT + j * ROW) / Tp, NP - 1)];
        }
        stage(p0);
      }
#pragma unroll
      for (int i0 = 0; i0 < NT; i0 += SUB) {
        // scores: each lane's partial dot products, then a shuffle over
        // the token's LT lanes; -1e30 past the length
        float sc[SUB][GC];
        bool valid[SUB];
#pragma unroll
        for (int u = 0; u < SUB; ++u) {
          float kf[VN];
          Vec<T>::widen(k_s[(i0 + u) * kThreads + tid], kf);
          valid[u] = p0 + tid / LT + (i0 + u) * ROW < t1;
#pragma unroll
          for (int g = 0; g < GC; ++g) {
            float dot = 0.f;
#pragma unroll
            for (int j = 0; j < VN; ++j) dot = fmaf(qf[g][j], kf[j], dot);
#pragma unroll
            for (int w = LT / 2; w >= 1; w /= 2)
              dot += __shfl_xor_sync(0xffffffffu, dot, w);
            sc[u][g] = valid[u] ? dot : kNegInf;
          }
        }
        // the warp's running max moves; old sums rescale
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          float mx = sc[0][g];
#pragma unroll
          for (int u = 1; u < SUB; ++u) mx = fmaxf(mx, sc[u][g]);
#pragma unroll
          for (int w = LT; w < 32; w *= 2)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
          const float mn = fmaxf(m[g], mx);
          const float alpha = exp2_approx(m[g] - mn);
          m[g] = mn;
          l[g] *= alpha;
#pragma unroll
          for (int j = 0; j < VN; ++j) acc[g][j] *= alpha;
        }
        // p = 2^(s - m) (0 past the length); l += p; acc += p v
#pragma unroll
        for (int u = 0; u < SUB; ++u) {
          float vf[VN];
          Vec<T>::widen(v_s[(i0 + u) * kThreads + tid], vf);
#pragma unroll
          for (int g = 0; g < GC; ++g) {
            const float p = valid[u] ? exp2_approx(sc[u][g] - m[g]) : 0.f;
            l[g] += p;
#pragma unroll
            for (int j = 0; j < VN; ++j) acc[g][j] = fmaf(p, vf[j], acc[g][j]);
          }
        }
      }
    }
    // the warp's token groups summed, then the warps merged
#pragma unroll
    for (int g = 0; g < GC; ++g) {
#pragma unroll
      for (int w = LT; w < 32; w *= 2) {
        l[g] += __shfl_xor_sync(0xffffffffu, l[g], w);
#pragma unroll
        for (int j = 0; j < VN; ++j)
          acc[g][j] += __shfl_xor_sync(0xffffffffu, acc[g][j], w);
      }
    }
    if (lane < LT) {
#pragma unroll
      for (int g = 0; g < GC; ++g) {
#pragma unroll
        for (int j = 0; j < VN; ++j) sm_acc[warp][g][li * VN + j] = acc[g][j];
        if (li == 0) {
          sm_m[warp][g] = m[g];
          sm_l[warp][g] = l[g];
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < GC * D; i += kThreads) {
      const int g = i / D;
      const int d = i % D;
      if (g0 + g >= G) break;
      float mm = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w][g]);
      float ll = 0.f, aa = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float e = exp2_approx(sm_m[w][g] - mm);
        ll = fmaf(sm_l[w][g], e, ll);
        aa = fmaf(sm_acc[w][g][d], e, aa);
      }
      if (ns == 1) {
        o[(g0 + g) * D + d] = from_f32<T>(ll == 0.f ? 0.f : aa / ll);
      } else {
        part[2 * G + (g0 + g) * D + d] = aa;
        if (d == 0) {
          part[g0 + g] = mm;
          part[G + g0 + g] = ll;
        }
      }
    }
    __syncthreads();  // the next heads reuse sm_*
  }
  if (ns == 1) return;

  // The last CTA of (b, h) to arrive merges the splits' partials in order,
  // kMerge splits of kElems outputs a thread at a time, all their loads in
  // flight together.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(&arrivals[bh], 1) == ns - 1;
    if (last) atomicExch(&arrivals[bh], 0);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* parts = ws + bh * n_splits * G * (D + 2);
  for (int i0 = 0; i0 < G * D; i0 += kElems * kThreads) {
    float mm[kElems], ll[kElems], aa[kElems];
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      mm[e] = kNegInf;
      ll[e] = aa[e] = 0.f;
    }
    for (int s0 = 0; s0 < ns; s0 += kMerge) {
      float mv[kMerge][kElems], lv[kMerge][kElems], av[kMerge][kElems];
#pragma unroll
      for (int u = 0; u < kMerge; ++u)
#pragma unroll
        for (int e = 0; e < kElems; ++e) {
          const int i = i0 + e * kThreads + tid;
          const bool in = s0 + u < ns && i < G * D;
          const float* ps = parts + (s0 + u) * G * (D + 2);
          mv[u][e] = in ? __ldcg(ps + i / D) : kNegInf;
          lv[u][e] = in ? __ldcg(ps + G + i / D) : 0.f;
          av[u][e] = in ? __ldcg(ps + 2 * G + i) : 0.f;
        }
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        float cm = mm[e];
#pragma unroll
        for (int u = 0; u < kMerge; ++u) cm = fmaxf(cm, mv[u][e]);
        const float r = exp2_approx(mm[e] - cm);
        ll[e] *= r;
        aa[e] *= r;
#pragma unroll
        for (int u = 0; u < kMerge; ++u) {
          const float w = exp2_approx(mv[u][e] - cm);
          ll[e] = fmaf(lv[u][e], w, ll[e]);
          aa[e] = fmaf(av[u][e], w, aa[e]);
        }
        mm[e] = cm;
      }
    }
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      const int i = i0 + e * kThreads + tid;
      if (i < G * D) o[i] = from_f32<T>(ll[e] == 0.f ? 0.f : aa[e] / ll[e]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* table,
           const int* lengths, void* out, float* ws, int* arrivals, int B,
           int Hq, int Hkv, int page_tokens, int NP, int split_tokens,
           long long page_stride, long long token_stride,
           long long head_stride, float scale, cudaStream_t stream) {
  const int n_splits = (NP * page_tokens + split_tokens - 1) / split_tokens;
  const dim3 grid(Hkv, B, max(n_splits, 1));  // a table of 0 pages: zeros
  auto kernel = Hq / Hkv <= 4 ? paged_attention_kernel<T, D, 4>
                              : paged_attention_kernel<T, D, 8>;
  constexpr int kRow = kWarps * 32 / (D * (int)sizeof(T) / 16);
  const int smem = 2 * (kRow > kPass ? kRow : kPass) / kRow * kThreads * 16;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), table, lengths, static_cast<T*>(out), ws,
      arrivals, Hq, Hkv, page_tokens, NP, split_tokens, n_splits, page_stride,
      token_stride, head_stride, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v,
             const int* table, const int* lengths, void* out, float* ws,
             int* arrivals, int B, int Hq, int Hkv, int page_tokens, int NP,
             int split_tokens, long long sp, long long st, long long sh,
             float scale, cudaStream_t s) {
  switch (D) {
    case 8:
      return launch<T, 8>(q, k, v, table, lengths, out, ws, arrivals, B, Hq,
                          Hkv, page_tokens, NP, split_tokens, sp, st, sh,
                          scale, s);
    case 16:
      return launch<T, 16>(q, k, v, table, lengths, out, ws, arrivals, B, Hq,
                           Hkv, page_tokens, NP, split_tokens, sp, st, sh,
                           scale, s);
    case 32:
      return launch<T, 32>(q, k, v, table, lengths, out, ws, arrivals, B, Hq,
                           Hkv, page_tokens, NP, split_tokens, sp, st, sh,
                           scale, s);
    case 64:
      return launch<T, 64>(q, k, v, table, lengths, out, ws, arrivals, B, Hq,
                           Hkv, page_tokens, NP, split_tokens, sp, st, sh,
                           scale, s);
    case 128:
      return launch<T, 128>(q, k, v, table, lengths, out, ws, arrivals, B,
                            Hq, Hkv, page_tokens, NP, split_tokens, sp, st,
                            sh, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, K, V and out share it). Strides are
// in elements; D (8 to 128, a power of two) is contiguous. ws holds
// B * Hkv * ceil(NP * page_tokens / split_tokens) * (Hq / Hkv) * (D + 2)
// floats (unused when that is one split); arrivals B * Hkv ints, 0 before
// the launch and left at 0 by it (one buffer per stream: launches that may
// overlap need their own). split_tokens is a multiple of page_tokens.
// Returns cudaGetLastError() after the launch.
extern "C" int repro_paged_attention(int dtype, const void* q, const void* k,
                                     const void* v, const int* table,
                                     const int* lengths, void* out, float* ws,
                                     int* arrivals, int B, int Hq, int Hkv,
                                     int D, int page_tokens, int NP,
                                     int split_tokens, long long page_stride,
                                     long long token_stride,
                                     long long head_stride, float scale,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, table, lengths, out, ws, arrivals, B,
                           Hq, Hkv, page_tokens, NP, split_tokens,
                           page_stride, token_stride, head_stride, scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, table, lengths, out, ws,
                                   arrivals, B, Hq, Hkv, page_tokens, NP,
                                   split_tokens, page_stride, token_stride,
                                   head_stride, scale, s);
  return (int)cudaErrorInvalidValue;
}
