// GAScore ring collectives for Hopper (sm_90a): all-gather, reduce-scatter.
//
// Replaces two TPU kernels of src/repro/kernels/gascore.py:
//   ring_all_gather     (:207, body :221, hops :229-247)
//     (n, m, ...) -> every rank holds the (n*m, ...) concatenation;
//   ring_reduce_scatter (:265, body :284, hops :294-320)
//     (n, n*m, ...) -> rank c holds the sum over ranks of chunk c.
// On the TPU each is one fused kernel of n-1 remote-DMA hops with per-hop
// semaphores. On one H100 all ranks' partitions lie in one HBM, so each
// collective reduces to a single pass with no cross-CTA flags (and so no
// cooperative launch and no deadlock): one launch writes all n x n
// all-gather slots, and one launch computes all n reduce-scatter chunks.
//
// The reduce-scatter keeps the ring's summation order exactly: the packet
// for chunk c starts at rank c+1 and each visited rank adds its own
// contribution (collectives.py:128-141, gascore.py:271-273), so
//   acc = x[c+1][c]; acc += x[c+2][c]; ...; acc += x[c][c]
// in the input dtype (bf16 sums round to bf16 after every add, as the
// reference's do). One thread owns one output vector and loops over the
// ranks in that order; the result is bit-exact against the software
// engine's ring.
//
// Bound: bytes. All-gather reads n*m rows once and writes n*n*m; the
// reduce-scatter reads n*n*m and writes n*m, with one add per element read
// (far below the card's flop/byte balance). Design: 16-byte vector loads
// and stores when rows and pointers are 16-byte aligned, the all-gather
// loads each source vector once and stores it to all n ranks' slots, and
// the grid covers every (chunk, vector) pair with enough CTAs to fill the
// 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

int grid_x(long long work, int rows, int sms) {
  long long want = (work + kThreads - 1) / kThreads;
  long long cap = (4LL * sms + rows - 1) / rows;
  if (cap < 1) cap = 1;
  if (want < 1) want = 1;
  return (int)(want < cap ? want : cap);
}

// ---------------------------------------------------------------- gather --
// src (n, words) -> out (n, n, words): out[r][c] = src[c] for every r.
template <typename W>
__global__ void all_gather_kernel(const W* __restrict__ src,
                                  W* __restrict__ out, int n,
                                  long long words) {
  const int c = blockIdx.y;
  const W* s = src + (long long)c * words;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < words; i += stride) {
    const W v = s[i];
    for (int r = 0; r < n; ++r) {
      out[((long long)r * n + c) * words + i] = v;
    }
  }
}

template <typename W>
int gather_launch(const void* src, void* out, int n, long long row_bytes,
                  int sms, cudaStream_t stream) {
  const long long words = row_bytes / (long long)sizeof(W);
  dim3 grid(grid_x(words, n, sms), n);
  all_gather_kernel<W><<<grid, kThreads, 0, stream>>>(
      static_cast<const W*>(src), static_cast<W*>(out), n, words);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------- reduce-scatter --
template <typename T>
struct Add;

template <>
struct Add<float> {
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
};

template <>
struct Add<int32_t> {
  __device__ static int32_t add(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);  // wraps, as XLA's does
  }
};

template <>
struct Add<__nv_bfloat16> {
  __device__ static __nv_bfloat16 add(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(a), __bfloat162float(b)));
  }
};

// x (n ranks, n chunks, m elements of T) -> out (n, m): out[c] is the ring
// sum of chunk c. VEC elements per thread, moved as one 16-byte vector when
// VEC * sizeof(T) == 16.
template <typename T, int VEC>
__global__ void reduce_scatter_kernel(const T* __restrict__ x,
                                      T* __restrict__ out, int n,
                                      long long m) {
  static_assert(VEC * sizeof(T) == 16 || VEC == 1, "vector of 16 bytes or 1");
  const int c = blockIdx.y;
  const long long vecs = m / VEC;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       v < vecs; v += stride) {
    alignas(16) T acc[VEC];
    alignas(16) T cur[VEC];
    for (int j = 1; j <= n; ++j) {
      const int r = (c + j) % n;
      const T* p = x + ((long long)r * n + c) * m + v * VEC;
      if constexpr (VEC == 1) {
        cur[0] = p[0];
      } else {
        *reinterpret_cast<uint4*>(cur) = *reinterpret_cast<const uint4*>(p);
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        acc[e] = (j == 1) ? cur[e] : Add<T>::add(acc[e], cur[e]);
      }
    }
    T* o = out + (long long)c * m + v * VEC;
    if constexpr (VEC == 1) {
      o[0] = acc[0];
    } else {
      *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(acc);
    }
  }
}

template <typename T>
int rs_launch(const void* x, void* out, int n, long long m, int vector,
              int sms, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (vector) {
    dim3 grid(grid_x(m / kVec, n, sms), n);
    reduce_scatter_kernel<T, kVec><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), n, m);
  } else {
    dim3 grid(grid_x(m, n, sms), n);
    reduce_scatter_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), n, m);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// src (n, row_bytes) -> out (n, n, row_bytes). word_bytes is 16, 4, 2 or 1
// and divides row_bytes and both pointers' alignment (the wrapper checks).
int repro_gascore_all_gather(const void* src, void* out, int n,
                             long long row_bytes, int word_bytes, int sms,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (word_bytes) {
    case 16: return gather_launch<uint4>(src, out, n, row_bytes, sms, s);
    case 4: return gather_launch<uint32_t>(src, out, n, row_bytes, sms, s);
    case 2: return gather_launch<uint16_t>(src, out, n, row_bytes, sms, s);
    case 1: return gather_launch<uint8_t>(src, out, n, row_bytes, sms, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x (n, n, m) of dtype (0 f32, 1 bf16, 2 int32) -> out (n, m), ring order.
// vector != 0: m * sizeof(T) and both pointers are 16-byte aligned.
int repro_gascore_reduce_scatter(int dtype, const void* x, void* out, int n,
                                 long long m, int vector, int sms,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return rs_launch<float>(x, out, n, m, vector, sms, s);
    case 1: return rs_launch<__nv_bfloat16>(x, out, n, m, vector, sms, s);
    case 2: return rs_launch<int32_t>(x, out, n, m, vector, sms, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
