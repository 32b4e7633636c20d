// Shared pieces of the flash-attention kernels (flash_attention.cu and
// flash_attention_bwd.cu): the mask of the TPU kernels, and for the SIMT
// kernels (f32, and the dQ kernel in both dtypes) the tile shape, tile
// loads into shared memory and the products over 64-row tiles. The bf16
// forward and dK/dV kernels run on the tensor cores (flash_wgmma.cuh).
//
// Every SIMT tile is 64 rows. A CTA has 256 threads laid out 16 x 16: thread
// (ty, tx) owns rows ty + 16 i (i < 4) of a 64-row tile and columns
// tx + 16 j of its 64 or D columns, so the 16 threads that share a row sit
// in one half of a warp and reduce a row with four shuffles. Tiles live in
// shared memory as f32 with rows padded by one word (D + 1, 64 + 1), so the
// 16 threads that read 16 different rows at one column hit 16 banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kBlock = 64;     // q rows and kv rows per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr float kNegInf = -1e30f;

// 16-byte vector of elements, widened to f32.
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

// `_mask` of src/repro/kernels/flash_attention_bwd.py:44-52, positions of q
// and k both counted from 0. window < 0 means no window.
__device__ __forceinline__ bool visible(int qpos, int kpos, bool causal,
                                        int window) {
  if (causal && qpos < kpos) return false;
  if (window >= 0) {
    if (qpos - kpos >= window) return false;
    if (!causal && kpos - qpos >= window) return false;
  }
  return true;
}

// True when the mask hides every (q, k) of [q0, q1) x [k0, k1). Such a block
// adds exactly nothing (p = 0 there and the running max does not move), so
// the kernels skip it; the TPU kernel computes and then masks it.
__device__ __forceinline__ bool block_hidden(int q0, int q1, int k0, int k1,
                                             bool causal, int window) {
  if (causal && q1 - 1 < k0) return true;
  if (window >= 0) {
    if (q0 - (k1 - 1) >= window) return true;
    if (!causal && k0 - (q1 - 1) >= window) return true;
  }
  return false;
}

// True when every (q, k) of [q0, q0 + nq) x [k0, k0 + nk) lies inside
// (Sq, Sk) and the mask shows it: the tensor-core kernels then skip the
// per-element mask of that block.
__device__ __forceinline__ bool block_full(int q0, int nq, int k0, int nk,
                                           int Sq, int Sk, bool causal,
                                           int window) {
  const int q1 = q0 + nq - 1, k1 = k0 + nk - 1;  // the last row and column
  if (q1 >= Sq || k1 >= Sk) return false;
  if (causal && k1 > q0) return false;
  if (window >= 0) {
    if (q1 - k0 >= window) return false;
    if (!causal && k1 - q0 >= window) return false;
  }
  return true;
}

// Rows [r0, r0 + 64) of a (rows, D) row-major matrix into a (64, D + 1) f32
// tile, each element times `mul`; rows past `rows` are zero. 16-byte loads.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int r0, int rows, float mul) {
  constexpr int VN = Vec<T>::N;
  constexpr int CH = D / VN;  // vectors per row
  for (int c = threadIdx.x; c < kBlock * CH; c += kThreads) {
    const int r = c / CH;
    const int d0 = (c % CH) * VN;
    float f[VN];
    if (r0 + r < rows) {
      Vec<T>::widen(
          *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + d0), f);
    } else {
#pragma unroll
      for (int j = 0; j < VN; ++j) f[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VN; ++j) dst[r * (D + 1) + d0 + j] = f[j] * mul;
  }
}

// Rows [r0, r0 + 64) of a length-`rows` f32 vector into registers: v[i] is
// row ty + 16 i (0 past the end).
__device__ __forceinline__ void load_rows(float (&v)[4], const float* src,
                                          int r0, int rows, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    v[i] = r < rows ? src[r] : 0.f;
  }
}

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// s[i][j] += sum_d a[ty + 16 i][d] * b[tx + 16 j][d], for two (64, D + 1)
// tiles: a 64 x 64 block of a . b^T (scores, dO . V^T).
template <int D>
__device__ __forceinline__ void dot_nt(const float* a, const float* b, int ty,
                                       int tx, float (&s)[4][4]) {
  constexpr int DP = D + 1;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * DP + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * DP + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[i][j] += sum_c A[ty + 16 i][c] * b[c][tx + 16 j] over the 64 rows c of
// a (64, D + 1) tile b, with A a (64, 64 + 1) tile p (kTransA = false: A = p,
// for p . V and dS . K) or its transpose (kTransA = true: A = p^T, for
// p^T . dO and dS^T . q).
template <int D, bool kTransA>
__device__ __forceinline__ void acc_nn(const float* p, const float* b, int ty,
                                       int tx, float (&acc)[4][D / 16]) {
  constexpr int DP = D + 1;
  constexpr int BP = kBlock + 1;
  constexpr int NJ = D / 16;
#pragma unroll 4
  for (int c = 0; c < kBlock; ++c) {
    float av[4], bv[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = kTransA ? p[c * BP + ty + 16 * i] : p[(ty + 16 * i) * BP + c];
#pragma unroll
    for (int j = 0; j < NJ; ++j) bv[j] = b[c * DP + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Rows [r0, r0 + 64) of a (rows, D) output from the thread's acc, times mul.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, float (&acc)[4][D / 16],
                                           int r0, int rows, int ty, int tx,
                                           float mul) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      dst[(size_t)r * D + tx + 16 * j] = from_f32<T>(acc[i][j] * mul);
  }
}

}  // namespace flash
