// Tensor-core pieces of the bf16 flash-attention kernels for Hopper
// (sm_90a): the shared-memory tile layout that wgmma reads and TMA loads
// and stores, its matrix descriptors and TMA maps, mbarriers and named
// barriers for the producer / consumer pipeline, and the warpgroup
// products.
//
// A tile holds R rows x D bf16 columns. It is stored as D / W column blocks
// of W = min(D, 64) columns, one after another; each block is (R, W)
// row-major, rows of 2W bytes (32, 64 or 128), with the 16-byte chunks of
// row r permuted by the 32-, 64- or 128-byte swizzle (chunk bits 4-6 of the
// address XOR bits 7-9): the layout that a TMA box of W x R with the same
// swizzle writes and that the descriptor's layout type names. Read with
// the rows as M or N and the columns as K ("K-major": q and k for scores)
// or with the rows as K and the columns as N ("MN-major": v for p . v, dO
// and q for p^T . dO and dS^T . q); both views read one layout. Tiles start
// on 1024-byte boundaries, so the swizzle of the absolute address is the
// swizzle of the offset.
//
// Products are wgmma.mma_async m64nNk16, bf16 in and f32 accumulators, by a
// warpgroup of 128 threads: A from shared memory (ss) or from registers
// (rs), B from shared memory. Fragment of a 64 x N accumulator d, thread t
// of the warpgroup: d[4j + 2h + e] is row 16 (t / 32) + (t % 32) / 4 + 8h,
// column 8j + 2 (t % 4) + e. The A fragment of a 64 x 16 slice from
// registers is the same layout packed in bf16 pairs: a[0] (row, k 2(t % 4)
// + {0, 1}), a[1] (row + 8), a[2] (row, k + 8), a[3] (row + 8, k + 8).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {
namespace tc {

constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int W = D < 64 ? D : 64;  // columns per block
  static constexpr int RB = 2 * W;           // bytes per row of a block
  static constexpr int CH = RB / 16;         // 16-byte chunks per row
  // descriptor layout type: 1 = 128-byte swizzle, 2 = 64-byte, 3 = 32-byte
  static constexpr int kLayout = RB == 128 ? 1 : RB == 64 ? 2 : 3;

  // Byte offset of 16-byte chunk c (columns 8c .. 8c + 7) of row r in a
  // tile of R rows.
  __device__ static uint32_t chunk(int R, int r, int c) {
    const uint32_t o = r * RB + (c % CH) * 16;
    return (c / CH) * R * RB + (o ^ (((o >> 7) & (CH - 1)) << 4));
  }
};

// Host: the TMA map of a (mats, rows, D) row-major bf16 tensor for boxes
// of Tile<D>::W columns x R rows of one matrix, swizzled as the tiles are.
// cuTensorMapEncodeTiled is looked up through the runtime's entry-point
// query, so the library needs no link to libcuda. Returns 0 or a CUDA
// error code.
template <int D>
inline int make_tile_map(CUtensorMap* map, const void* base, int mats,
                         int rows, int R) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
      CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
      CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return (int)e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<Encode>(fn);
  }
  using T = Tile<D>;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)mats};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)T::W, (cuuint32_t)R, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = T::RB == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : T::RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Matrix descriptor: start address, leading and stride byte offsets, type.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

// K-major operand: tile rows [r0, r0 + 64 or N) as M or N, columns
// [16 kk, 16 kk + 16) as K. Eight-row groups lie 8 rows apart (SBO); the
// leading offset is unused by the swizzled K-major layouts.
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int R, int r0,
                                           int kk) {
  using T = Tile<D>;
  const int col = 16 * kk;
  return desc(tile + (col / T::W) * R * T::RB + r0 * T::RB + (col % T::W) * 2,
              16, 8 * T::RB, T::kLayout);
}

// MN-major operand: tile rows [16 kk, 16 kk + 16) as K, all D columns as
// N. Column blocks lie R rows apart (LBO), eight-row groups 8 rows (SBO).
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int R, int kk) {
  using T = Tile<D>;
  return desc(tile + 16 * kk * T::RB, R * T::RB, 8 * T::RB, T::kLayout);
}

// Rows [r0, r0 + R) of matrix `mat` of a (mats, rows, D) bf16 tensor into a
// tile by TMA, one box per column block (`map` from make_tile_map); rows
// past the matrix's end are zeros. Completion counts on mbarrier `bar`.
template <int D, int R>
__device__ __forceinline__ void tma_tile(uint32_t tile, const void* map,
                                         int r0, int mat, uint32_t bar) {
  using T = Tile<D>;
#pragma unroll
  for (int blk = 0; blk < D / T::W; ++blk)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
            tile + blk * R * T::RB),
        "l"(map), "r"(blk * T::W), "r"(r0), "r"(mat), "r"(bar)
        : "memory");
}

// Rows [r0, r0 + box) of matrix `mat` from shared memory to global memory
// by TMA (`map` from make_tile_map with R = box): `tile` is the first of
// those rows in a tile whose column blocks lie RT rows apart. Rows past
// the matrix's end are not written. The writes to `tile` must be made
// visible first (fence_async_smem, then a barrier of the writers); the
// store joins the issuing thread's bulk group (bulk_commit), and the tile
// may be written again once bulk_wait_read says TMA has read it.
template <int D, int RT>
__device__ __forceinline__ void tma_store(const void* map, uint32_t tile,
                                          int r0, int mat) {
  using T = Tile<D>;
#pragma unroll
  for (int blk = 0; blk < D / T::W; ++blk)
    asm volatile(
        "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
        " [%0, {%1, %2, %3}], [%4];\n" ::"l"(map),
        "r"(blk * T::W), "r"(r0), "r"(mat), "r"(tile + blk * RT * T::RB)
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

// mbarriers in shared memory: init (one thread, then fence_barrier_init
// and a CTA barrier), arrive, arrive announcing a TMA copy's bytes, and
// wait for the completion of the phase of the given parity. A wait that
// outlasts 2^32 clocks (about 2 s) gives up, so that a lost arrival shows
// as a wrong result, not a hang.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done && clock64() - t0 < (1ll << 32));
}

// Move this warpgroup's register budget to N per thread (setmaxnreg):
// a producer gives registers back, the consumers take them. Each role
// runs in its own branch that never rejoins the other.
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Named CTA barriers (ids 1-15) among `n` threads: sync waits for all n,
// arrive counts this thread and goes on.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed product groups are
// still running (they finish in order).
template <int N>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// After mma_wait: registers that wgmma reads or writes asynchronously stay
// put; the compiler moves no use of them above the wait and reuses none
// of them before it.
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// 2^x by the special-function unit (relative error about 2^-22; 0 for
// -inf and for results below 2^-126).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// A fragments (64 x 16 slices, bf16) of a 64 x 16T f32 accumulator: slice
// t is columns [16t, 16t + 16).
template <int T>
__device__ __forceinline__ void to_a(const float (&d)[8 * T],
                                     uint32_t (&a)[T][4]) {
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[t][i] = pack_bf16(d[8 * t + 2 * i], d[8 * t + 2 * i + 1]);
}

template <int N>
struct Mma;

template <>
struct Mma<16> {
  // d (64 x 16, f32) {=, +=} A (64 x 16, smem) . B (16 x 16, smem)
  template <int kTransB>
  __device__ __forceinline__ static void ss(float (&d)[8], uint64_t a,
                                            uint64_t b, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, %11;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(acc), "n"(kTransB));
  }
  // d (64 x 16, f32) {=, +=} A (64 x 16, registers) . B (16 x 16, smem)
  template <int kTransB>
  __device__ __forceinline__ static void rs(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
        "n"(kTransB));
  }
};

template <>
struct Mma<32> {
  // d (64 x 32, f32) {=, +=} A (64 x 16, smem) . B (16 x 32, smem)
  template <int kTransB>
  __device__ __forceinline__ static void ss(float (&d)[16], uint64_t a,
                                            uint64_t b, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc), "n"(kTransB));
  }
  // d (64 x 32, f32) {=, +=} A (64 x 16, registers) . B (16 x 32, smem)
  template <int kTransB>
  __device__ __forceinline__ static void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
        "n"(kTransB));
  }
};

template <>
struct Mma<64> {
  // d (64 x 64, f32) {=, +=} A (64 x 16, smem) . B (16 x 64, smem)
  template <int kTransB>
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc), "n"(kTransB));
  }
  // d (64 x 64, f32) {=, +=} A (64 x 16, registers) . B (16 x 64, smem)
  template <int kTransB>
  __device__ __forceinline__ static void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
        "n"(kTransB));
  }
};

template <>
struct Mma<128> {
  // d (64 x 128, f32) {=, +=} A (64 x 16, smem) . B (16 x 128, smem)
  template <int kTransB>
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc), "n"(kTransB));
  }
  // d (64 x 128, f32) {=, +=} A (64 x 16, registers) . B (16 x 128, smem)
  template <int kTransB>
  __device__ __forceinline__ static void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
        "n"(kTransB));
  }
};

// d {=, +=} A . B: A a 64 x 16 shared-memory operand (descriptor a,
// K-major), B 16 x N (descriptor b; kTransB = 1 when it is MN-major);
// acc = 0 overwrites d.
template <int N, int kTransB>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a,
                                                       uint64_t b, int acc) {
  Mma<N>::template ss<kTransB>(d, a, b, acc);
}

// d {=, +=} A . B with A a 64 x 16 slice in registers (to_a's fragment).
template <int N, int kTransB>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t b,
                                       int acc) {
  Mma<N>::template rs<kTransB>(d, a, b, acc);
}

}  // namespace tc
}  // namespace flash
