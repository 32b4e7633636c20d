// RG-LRU gated linear scan, backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference trains the RG-LRU through XLA's
// autodiff of its `lax.scan` oracle (src/repro/kernels/ref.py:352); the
// port's forward is the hand kernel csrc/rglru.cu, so its backward is one
// too. From the forward's saved output h and the cotangent dh (B, S, W),
// the reverse scan
//   g_t = dh_t + a_{t+1} g_{t+1},   g_{S-1} = dh_{S-1},
//   db_t = g_t,   da_t = g_t h_{t-1}   (h_{-1} = 0),
// a, h, dh and both outputs contiguous (B, S, W) of one dtype, f32 or bf16;
// f32 inside. The update rounds as ref.gated_linear_scan_bwd does (a
// multiply, then an add; no fused multiply-add), so results equal the plain
// version bit for bit in either dtype.
//
// Bound: bytes. a, h and dh are read once and da and db written once, two
// multiplies and an add an element: at recurrentgemma's training shape (B
// 1, S 4096, W 4096, f32) 335.5 MB, 100.162 us at 3.35 TB/s (bf16 half of
// it, 50.081 us). The chain (a multiply and an add, ~8 clocks a step) is
// ~17 us over 4,096 steps.
//
// What held the first version back (467.86 us f32, 1,503.46 us bf16 at
// that shape on an NVIDIA H100 80GB HBM3 at 700 W): a CTA was one warp of
// 32 channels, 128 CTAs on 132 SMs, and a thread loaded 32 steps of a, dh
// and h_{t-1} into registers with scalar loads, then ran the chain and
// stored every step, then loaded the next block. An SM had at most ~12 KB
// of reads in flight (~6 KB in bf16) and none during the chain and the
// stores: 0.72 TB/s. Why bf16 took 3.2x f32's time for half the bytes
// (its `nvcc -Xptxas -v` and `cuobjdump -sass`): both instantiations used
// all 255 registers and spilled (96 values a block, their addresses and
// predicates), and in bf16 each 16-bit load is widened by an IMAD.U32
// into a register of its own. Short of registers, ptxas put 24 of a
// block's 96 LDG.E.U16 right behind the widening of the load before
// (LDG, IMAD.U32, LDG, IMAD.U32, ...): those went one memory round trip
// at a time, a cost per element. Here every load from device memory is a
// TMA box; bf16 is widened from shared memory after its stage has landed
// (93 registers in f32, 120 in bf16, no spill).
//
// Design:
// - A CTA owns kCols = 32 channels of one batch row (W / 32 x B CTAs: 128
//   at W 4,096, one an SM). A producer warp keeps a ring of kStages = 4
//   stages in shared memory, each a box of kSteps steps x 32 channels of a,
//   of dh and of h one step back (the box of h starting at row t0 - 1:
//   h_{t-1} for the steps t0 .. t0 + kSteps - 1; TMA fills row -1 of tile
//   0 with zeros, which is h_{-1}), 24 KB a stage: 64 steps in f32, 128 in
//   bf16. The stages come in reverse time order (tiles nt - 1 .. 0), each
//   landing on its "full" mbarrier and freed on its "empty" one.
// - Little's law: at 3.35 TB/s over 128 CTAs a CTA moves ~26 GB/s, ~16
//   GB/s of it reads; at 1-2 us of loaded latency that wants 16-32 KB of
//   reads in flight a CTA. The ring holds up to three stages (72 KB) ahead
//   of the one being read, against the first version's 12 KB. Probes at
//   that shape (tools/ab_scan.py --bwd, in turns): against 4 stages, 6 ran
//   1-2% slower and 8 ran 2-7% slower; against 6 stages, 64 channels a
//   CTA (two consumer warps, 64 CTAs, 128-byte box rows in bf16) ran 2%
//   slower in bf16 and 11% in f32.
// - One consumer warp, a channel a lane, walks its stage backwards from
//   shared memory with g and a_{t+1} in registers (a_{t+1} carried across
//   tiles): 32 steps of a, dh and h_{t-1} into registers, then the chain
//   in straight code. Steps past S are zeros in the boxes, so g stays 0
//   there and no step is guarded.
// - da and db go into an output tile in shared memory (two of each,
//   alternating by tile) and leave as TMA box stores (rows past S and
//   channels past W are not written); a tile is rewritten only once the
//   store issued two tiles before has read it. The reads of the next
//   stages are never behind them.
// - An array TMA cannot take (W x the element size not a multiple of 16
//   bytes, or a base off 16 bytes) is staged element by element by the
//   producer, and an output tile stored element by element by its warp.
// Dynamic shared memory: 4 x 24 KB of stages, 32 KB of output tiles, the
// mbarriers: 131,264 bytes of the 232,448 a block may have.

#include "scan_common.cuh"

namespace {

using scan::from_f32;
using scan::to_f32;

constexpr int kConsumers = 1;            // consumer warps, one channel a lane
constexpr int kCols = 32 * kConsumers;   // channels a CTA
constexpr int kThreads = 32 * (kConsumers + 1);  // the last warp produces
constexpr int kStageBytes = 24576;       // a, dh and h_{t-1} of one stage
constexpr int kStages = 4;
constexpr int kBatch = 32;  // steps the consumer loads before it uses them

// Shared memory: kStages stages, each a, dh and h_{t-1} as (kSteps, kCols)
// row-major boxes; the output tiles, (kSteps, 32) row-major for each
// (buffer, da or db, consumer warp); the full and empty mbarriers; 128
// bytes of slack to align. Every part starts on 128 bytes.
template <typename T>
struct Ring {
  static constexpr int kSteps = kStageBytes / (3 * kCols * sizeof(T));
  static constexpr int kBox = kSteps * kCols;  // elements of one input box
  static constexpr int kOut = kSteps * 32;     // elements of one output tile
  static constexpr int kOutBase = kStages * kStageBytes;
  static constexpr int kBars = kOutBase + 4 * kConsumers * kOut * sizeof(T);
  static constexpr int kBytes = kBars + 2 * kStages * 8 + 128;
  static_assert(kSteps % kBatch == 0 && kSteps <= 256, "whole batches");
  static_assert(kOut * sizeof(T) % 128 == 0, "128-byte output tiles");

  __device__ static T* a(unsigned char* smem, int s) {
    return reinterpret_cast<T*>(smem + s * kStageBytes);
  }
  __device__ static T* dh(unsigned char* smem, int s) {
    return a(smem, s) + kBox;
  }
  __device__ static T* hp(unsigned char* smem, int s) {
    return a(smem, s) + 2 * kBox;
  }
  // the output tile of da (array 0) or db (1) of warp `warp` in `buf`
  __device__ static T* out(unsigned char* smem, int buf, int array,
                           int warp) {
    return reinterpret_cast<T*>(smem + kOutBase) +
           ((buf * 2 + array) * kConsumers + warp) * kOut;
  }
  // the mbarriers' shared-memory addresses
  __device__ static uint32_t full(unsigned char* smem, int s) {
    return scan::smem_addr(smem + kBars + 8 * s);
  }
  __device__ static uint32_t empty(unsigned char* smem, int s) {
    return scan::smem_addr(smem + kBars + 8 * (kStages + s));
  }
};

// One CTA per (kCols channels blockIdx.x, batch row blockIdx.y). With
// `load_boxes`, a, dh and h come by TMA boxes of (kCols channels, kSteps
// steps) through map_a / map_dh / map_h, else element by element; with
// `store_boxes`, da and db leave by TMA boxes of (32 channels, kSteps
// steps) through map_da / map_db, else element by element.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_bwd_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_dh,
                     const __grid_constant__ CUtensorMap map_h,
                     const __grid_constant__ CUtensorMap map_da,
                     const __grid_constant__ CUtensorMap map_db,
                     const T* __restrict__ a, const T* __restrict__ h,
                     const T* __restrict__ dh, T* __restrict__ da,
                     T* __restrict__ db, int S, int W, bool load_boxes,
                     bool store_boxes) {
  using R = Ring<T>;
  constexpr int kSteps = R::kSteps;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = scan::align128(smem_raw);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int w0 = blockIdx.x * kCols;
  const int bi = blockIdx.y;
  const int live_cols = min(kCols, W - w0);
  const long long base = (long long)bi * S * W + w0;
  const int nt = (S + kSteps - 1) / kSteps;  // tiles of this row

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      tma::mbar_init(R::full(smem, s), load_boxes ? 1 : 32);
      tma::mbar_init(R::empty(smem, s), 32 * kConsumers);
    }
    tma::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers) {
    // producer: the i-th stage (slot i % kStages) holds tile nt - 1 - i
    for (int i = 0; i < nt; ++i) {
      const int s = i % kStages;
      const int t0 = (nt - 1 - i) * kSteps;
      if (i >= kStages)
        tma::mbar_wait(R::empty(smem, s), (i / kStages - 1) & 1);
      if (load_boxes) {
        if (lane == 0) {
          const uint32_t bar = R::full(smem, s);
          tma::mbar_expect(bar, kStageBytes);
          scan::tma_load(R::a(smem, s), &map_a, w0, t0, bi, bar);
          scan::tma_load(R::dh(smem, s), &map_dh, w0, t0, bi, bar);
          scan::tma_load(R::hp(smem, s), &map_h, w0, t0 - 1, bi, bar);
        }
      } else {
        const long long off = base + (long long)t0 * W;
        const int rows = min(kSteps, S - t0);
        scan::stage_elements(R::a(smem, s), a + off, W, kSteps, kCols, rows,
                             live_cols, lane, 32);
        scan::stage_elements(R::dh(smem, s), dh + off, W, kSteps, kCols,
                             rows, live_cols, lane, 32);
        T* hs = R::hp(smem, s);
        if (t0 == 0) {  // row 0 is h_{-1} = 0
          for (int c = lane; c < kCols; c += 32) hs[c] = from_f32<T>(0.f);
          scan::stage_elements(hs + kCols, h + off, W, kSteps - 1, kCols,
                               min(kSteps - 1, S), live_cols, lane, 32);
        } else {
          scan::stage_elements(hs, h + off - W, W, kSteps, kCols,
                               min(kSteps, rows + 1), live_cols, lane, 32);
        }
        tma::mbar_arrive(R::full(smem, s));
      }
    }
    return;
  }

  // consumer: column c = channel w0 + c, time in reverse
  const int c = warp * 32 + lane;
  const int wc = w0 + warp * 32;  // this warp's first channel
  const int warp_cols = min(32, W - wc);
  float g = 0.f, anext = 0.f;
  for (int i = 0; i < nt; ++i) {
    const int s = i % kStages;
    const int t0 = (nt - 1 - i) * kSteps;
    T* oda = R::out(smem, i & 1, 0, warp);
    T* odb = R::out(smem, i & 1, 1, warp);
    if (store_boxes && i >= 2) {
      // the stores issued from this buffer two tiles ago have read it
      if (lane == 0) scan::bulk_wait_read<1>();
      __syncwarp();
    }
    tma::mbar_wait(R::full(smem, s), (i / kStages) & 1);
    const T* as = R::a(smem, s) + c;
    const T* ds = R::dh(smem, s) + c;
    const T* hs = R::hp(smem, s) + c;
#pragma unroll
    for (int u0 = kSteps - kBatch; u0 >= 0; u0 -= kBatch) {
      // a batch of steps into registers, then the chain in one block of
      // straight code
      float av[kBatch], dv[kBatch], hv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        av[u] = to_f32(as[(u0 + u) * kCols]);
        dv[u] = to_f32(ds[(u0 + u) * kCols]);
        hv[u] = to_f32(hs[(u0 + u) * kCols]);
      }
#pragma unroll
      for (int u = kBatch - 1; u >= 0; --u) {
        g = __fadd_rn(dv[u], __fmul_rn(anext, g));
        odb[(u0 + u) * 32 + lane] = from_f32<T>(g);
        oda[(u0 + u) * 32 + lane] = from_f32<T>(__fmul_rn(g, hv[u]));
        anext = av[u];
      }
    }
    tma::mbar_arrive(R::empty(smem, s));
    if (store_boxes) {
      scan::fence_async_smem();
      __syncwarp();
      if (lane == 0 && warp_cols > 0) {
        scan::tma_store(&map_da, oda, wc, t0, bi);
        scan::tma_store(&map_db, odb, wc, t0, bi);
        scan::bulk_commit();
      }
    } else {
      __syncwarp();
      const long long off = base + (long long)t0 * W + warp * 32;
      const int rows = min(kSteps, S - t0);
      scan::store_tile(da + off, W, oda, 32, rows, warp_cols, false, lane,
                       32);
      scan::store_tile(db + off, W, odb, 32, rows, warp_cols, false, lane,
                       32);
      __syncwarp();
    }
  }
  if (store_boxes && lane == 0) scan::bulk_wait<0>();
}

template <typename T>
int launch(const void* a, const void* h, const void* dh, void* da, void* db,
           int B, int S, int W, cudaStream_t stream) {
  using R = Ring<T>;
  const cudaError_t e =
      cudaFuncSetAttribute(rglru_bwd_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           R::kBytes);
  if (e != cudaSuccess) return (int)e;
  const long long bld = (long long)S * W;
  const bool load_boxes = scan::tma_ok<T>(a, W, bld, kCols) &&
                          scan::tma_ok<T>(h, W, bld, kCols) &&
                          scan::tma_ok<T>(dh, W, bld, kCols);
  const bool store_boxes =
      scan::tma_ok<T>(da, W, bld, 32) && scan::tma_ok<T>(db, W, bld, 32);
  CUtensorMap map_a{}, map_dh{}, map_h{}, map_da{}, map_db{};
  int m = 0;
  if (load_boxes) {
    m = scan::make_map<T>(&map_a, a, B, S, W, W, bld, kCols, R::kSteps);
    if (m == 0)
      m = scan::make_map<T>(&map_dh, dh, B, S, W, W, bld, kCols, R::kSteps);
    if (m == 0)
      m = scan::make_map<T>(&map_h, h, B, S, W, W, bld, kCols, R::kSteps);
  }
  if (store_boxes) {
    if (m == 0) m = scan::make_map<T>(&map_da, da, B, S, W, W, bld, 32,
                                      R::kSteps);
    if (m == 0) m = scan::make_map<T>(&map_db, db, B, S, W, W, bld, 32,
                                      R::kSteps);
  }
  if (m != 0) return m;
  const dim3 grid((W + kCols - 1) / kCols, B);
  rglru_bwd_kernel<T><<<grid, kThreads, R::kBytes, stream>>>(
      map_a, map_dh, map_h, map_da, map_db, static_cast<const T*>(a),
      static_cast<const T*>(h), static_cast<const T*>(dh),
      static_cast<T*>(da), static_cast<T*>(db), S, W, load_boxes,
      store_boxes);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every array shares it). All arrays are
// contiguous (B, S, W). Returns cudaGetLastError() after the launch.
extern "C" int repro_rglru_scan_bwd(int dtype, const void* a, const void* h,
                                    const void* dh, void* da, void* db, int B,
                                    int S, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, h, dh, da, db, B, S, W, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, h, dh, da, db, B, S, W, s);
  return (int)cudaErrorInvalidValue;
}
