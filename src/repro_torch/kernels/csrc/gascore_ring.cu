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
// reference's do). Each thread owns whole output words and adds the ranks
// in that order; the result is bit-exact against the software engine's
// ring.
//
// Bound: bytes. All-gather reads n*m rows once and writes n*n*m; the
// reduce-scatter reads n*n*m and writes n*m, with one add per element read
// (far below the card's flop/byte balance). Design: 16-byte vector loads
// and stores when rows and pointers are 16-byte aligned. The all-gather
// loads each source vector once and stores it to all n ranks' slots, with
// a grid that covers every (chunk, vector) pair and fills the SMs. The
// reduce-scatter keeps HBM busy with many loads in flight: for n of 2 to
// 16 (a template each) a thread issues the loads of all n ranks for two
// vectors before its first add, streaming past the caches (each byte is
// read or written once), with one pass of CTAs over the data (up to 8
// times what the card holds at once, then the threads loop).

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

// One 32-bit word of T lanes added lane by lane with Add<T>.
template <typename T>
__device__ __forceinline__ uint32_t add32(uint32_t a, uint32_t b);

template <>
__device__ __forceinline__ uint32_t add32<float>(uint32_t a, uint32_t b) {
  return __float_as_uint(
      Add<float>::add(__uint_as_float(a), __uint_as_float(b)));
}

template <>
__device__ __forceinline__ uint32_t add32<int32_t>(uint32_t a, uint32_t b) {
  return (uint32_t)Add<int32_t>::add((int32_t)a, (int32_t)b);
}

template <>
__device__ __forceinline__ uint32_t add32<__nv_bfloat16>(uint32_t a,
                                                         uint32_t b) {
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162 y = *reinterpret_cast<const __nv_bfloat162*>(&b);
  __nv_bfloat162 r;
  r.x = Add<__nv_bfloat16>::add(x.x, y.x);
  r.y = Add<__nv_bfloat16>::add(x.y, y.y);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Words W of elements T: one element (W = T), or 16 bytes (W = uint4)
// read and written with the streaming hints (each byte is touched once).
template <typename T, typename W>
struct Words {
  __device__ static T load(const T* p) { return *p; }
  __device__ static void store(T* p, T v) { *p = v; }
  __device__ static T add(T a, T b) { return Add<T>::add(a, b); }
};

template <typename T>
struct Words<T, uint4> {
  __device__ static uint4 load(const uint4* p) { return __ldcs(p); }
  __device__ static void store(uint4* p, uint4 v) { __stcs(p, v); }
  __device__ static uint4 add(uint4 a, uint4 b) {
    return make_uint4(add32<T>(a.x, b.x), add32<T>(a.y, b.y),
                      add32<T>(a.z, b.z), add32<T>(a.w, b.w));
  }
};

constexpr int kUnroll = 2;  // words per thread per pass
constexpr int kWaves = 8;   // the grid's cap, in CTAs the card holds at once

// x (n ranks, n chunks, `words` words W of T each) -> out (n, words):
// out[c] is the ring sum of chunk c. In pass p, lane l of warp w (of the
// W warps of chunk c's CTAs) takes words 32 kUnroll g + 32 u + l (g = p W
// + w, u < kUnroll), so each load of a warp is 32 neighbouring words.
// N > 0 (n == N): the N ranks' loads of all its words are issued before
// the first add, 2 N in flight a thread; N == 0: any n, one rank at a
// time. Either way a word's sum runs in the ring's order.
template <typename T, typename W, int N>
__global__ void __launch_bounds__(kThreads)
    reduce_scatter_kernel(const W* __restrict__ x, W* __restrict__ out,
                          int n, long long words) {
  using O = Words<T, W>;
  constexpr int U = kUnroll;
  const int c = blockIdx.y;
  W* dst = out + (long long)c * words;
  const int lane = threadIdx.x % 32;
  const long long warps = (long long)gridDim.x * (blockDim.x / 32);
  for (long long g = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
       g * 32 * U < words; g += warps) {
    const long long w0 = g * 32 * U + lane;
    if constexpr (N > 0) {
      W cur[N][U];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int r = c + 1 + j < N ? c + 1 + j : c + 1 + j - N;
        const W* p = x + ((long long)r * N + c) * words;
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (w0 + 32 * u < words) cur[j][u] = O::load(p + w0 + 32 * u);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (w0 + 32 * u >= words) continue;
        W acc = cur[0][u];
#pragma unroll
        for (int j = 1; j < N; ++j) acc = O::add(acc, cur[j][u]);
        O::store(dst + w0 + 32 * u, acc);
      }
    } else {
      W acc[U];
      for (int j = 1; j <= n; ++j) {
        const W* p = x + ((long long)((c + j) % n) * n + c) * words;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (w0 + 32 * u >= words) continue;
          const W v = O::load(p + w0 + 32 * u);
          acc[u] = j == 1 ? v : O::add(acc[u], v);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (w0 + 32 * u < words) O::store(dst + w0 + 32 * u, acc[u]);
    }
  }
}

// One pass of CTAs over each chunk, capped at kWaves times what the card
// holds at once (the threads then loop).
template <typename T, typename W, int N>
int rs_launch_n(const void* x, void* out, int n, long long words, int sms,
                cudaStream_t stream) {
  const auto kernel = reduce_scatter_kernel<T, W, N>;
  static int per_sm = 0;  // CTAs of this kernel an SM holds at once
  if (per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
  }
  const long long pass = (long long)kThreads * kUnroll;
  const long long cap = ((long long)kWaves * per_sm * sms + n - 1) / n;
  long long gx = (words + pass - 1) / pass;
  if (gx > cap) gx = cap;
  if (gx < 1) gx = 1;
  kernel<<<dim3((unsigned)gx, n), kThreads, 0, stream>>>(
      static_cast<const W*>(x), static_cast<W*>(out), n, words);
  return (int)cudaGetLastError();
}

template <typename T>
int rs_launch(const void* x, void* out, int n, long long m, int vector,
              int sms, cudaStream_t stream) {
  if (!vector) return rs_launch_n<T, T, 0>(x, out, n, m, sms, stream);
  const long long words = m * (long long)sizeof(T) / 16;
  switch (n) {
#define REPRO_RS_N(NN) \
  case NN:             \
    return rs_launch_n<T, uint4, NN>(x, out, n, words, sms, stream);
    REPRO_RS_N(2) REPRO_RS_N(3) REPRO_RS_N(4) REPRO_RS_N(5) REPRO_RS_N(6)
    REPRO_RS_N(7) REPRO_RS_N(8) REPRO_RS_N(9) REPRO_RS_N(10) REPRO_RS_N(11)
    REPRO_RS_N(12) REPRO_RS_N(13) REPRO_RS_N(14) REPRO_RS_N(15)
    REPRO_RS_N(16)
#undef REPRO_RS_N
    default:
      return rs_launch_n<T, uint4, 0>(x, out, n, words, sms, stream);
  }
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
