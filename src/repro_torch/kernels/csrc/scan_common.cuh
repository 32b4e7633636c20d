// Pieces shared by the scan kernels (ssm_scan.cu, ssm_scan_bwd.cu,
// rglru.cu, rglru_bwd.cu): f32 conversions, TMA maps, loads and stores of
// 3-D boxes between device and shared memory, the element-by-element edge
// path for rows TMA cannot take, and tile stores from shared memory.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace scan {

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 128-byte boundary at or after p (TMA writes boxes there).
__device__ __forceinline__ unsigned char* align128(unsigned char* p) {
  return p + ((128 - smem_addr(p) % 128) % 128);
}

template <typename E>
constexpr CUtensorMapDataType tma_type() {
  return sizeof(E) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// True where TMA can read boxes of `cols` elements of E a row from a
// tensor at `p` whose rows lie `ld` elements apart and whose batch rows
// `bld` elements apart: p and both strides on 16 bytes, a box row whole
// 16 bytes. Else the kernels take the edge path.
template <typename E>
inline bool tma_ok(const void* p, long long ld, long long bld, int cols) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (ld * (long long)sizeof(E)) % 16 == 0 &&
         (bld * (long long)sizeof(E)) % 16 == 0 &&
         (cols * sizeof(E)) % 16 == 0;
}

// Host: the TMA map of a (batch, rows, cols) tensor of E with rows `ld` and
// batch rows `bld` elements apart, for boxes of box_cols x box_rows x 1,
// unswizzled; elements past the tensor's ends read as zeros. Returns 0 or
// a CUDA error code.
template <typename E>
inline int make_map(CUtensorMap* map, const void* base, int batch, int rows,
                    int cols, long long ld, long long bld, int box_cols,
                    int box_rows) {
  int err = 0;
  const tma::Encode encode = tma::encoder(&err);
  if (encode == nullptr) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)(ld * sizeof(E)),
                                 (cuuint64_t)(bld * sizeof(E))};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, tma_type<E>(), 3, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The box at (col, row, batch) of `map` into shared memory at dst by TMA;
// its bytes (the whole box, zeros past the tensor's ends included) count
// on the mbarrier at shared-memory address `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int col, int row, int batch,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(col), "r"(row), "r"(batch), "r"(bar)
      : "memory");
}

// The box at (col, row, batch) of `map` from shared memory at src by TMA
// (elements past the tensor's ends are not written), in the issuing
// thread's current bulk group. The threads that wrote src call
// fence_async_smem first; bulk_commit closes the group; bulk_wait_read<N>
// returns once at most N of the thread's groups may still read their
// shared memory, bulk_wait<0> once every group's writes are done.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int col, int row,
                                          int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%1, %2, %3}], [%4];\n" ::"l"(map),
      "r"(col), "r"(row), "r"(batch), "r"(smem_addr(src))
      : "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// The edge path: a rows x cols tile (row r at src + r * ld) into dst,
// row-major with `cols` elements a row, element by element through
// registers: rows < live_rows and columns < live_cols, zeros elsewhere.
// Threads tid of n share the work.
template <typename E>
__device__ __forceinline__ void stage_elements(E* dst, const E* src,
                                               long long ld, int rows,
                                               int cols, int live_rows,
                                               int live_cols, int tid, int n) {
  for (int i = tid; i < rows * cols; i += n) {
    const int r = i / cols;
    const int c = i % cols;
    dst[i] = r < live_rows && c < live_cols ? src[r * ld + c]
                                            : from_f32<E>(0.f);
  }
}

// Write a rows x cols tile of shared memory (row-major) to dst (row r at
// dst + r * ld): rows < live_rows, columns < live_cols; by 16-byte chunks
// where `vec` (dst, ld and cols whole 16 bytes), else element by element.
template <typename E>
__device__ __forceinline__ void store_tile(E* dst, long long ld, const E* src,
                                           int cols, int live_rows,
                                           int live_cols, bool vec, int tid,
                                           int n) {
  if (vec) {
    constexpr int kChunk = 16 / sizeof(E);
    const int per_row = cols / kChunk;
    for (int i = tid; i < live_rows * per_row; i += n) {
      const int r = i / per_row;
      const int c = (i % per_row) * kChunk;
      if (c < live_cols)
        *reinterpret_cast<uint4*>(dst + r * ld + c) =
            *reinterpret_cast<const uint4*>(src + r * cols + c);
    }
  } else {
    for (int i = tid; i < live_rows * cols; i += n) {
      const int r = i / cols;
      const int c = i % cols;
      if (c < live_cols) dst[r * ld + c] = src[i];
    }
  }
}

}  // namespace scan
