// RG-LRU gated linear scan for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t.
//
// Replaces the TPU kernel `gated_linear_scan` / `_lru_kernel` of
// src/repro/kernels/rglru.py (pallas_call at :73). Same function: a and b
// (B, S, W) contiguous, f32 or bf16 (one dtype for both), h_0 = 0, every
// h_t written in b's dtype; f32 inside. recurrentgemma's `rec` blocks run
// it over the RG-LRU's gates in f32 at every prefill.
//
// Bound: bytes. Each element of a and b is read once and each h_t written
// once, with one multiply and one add per element: at recurrentgemma's
// prefill (B 1, S 2560, W 4096, f32) that is ~126 MB, ~38 us at 3.35 TB/s.
// The dependent chain (a multiply, then an add, ~8 clocks a step) takes
// 2,560 steps x 8 clocks, ~11 us: under the byte floor, so a walk in time
// order can reach the memory rate if enough bytes are in flight. By
// Little's law that is tens of KB per SM; one thread per channel loading a
// few steps ahead puts ~4 KB there.
//
// What this design does about it: a CTA owns kCols = 64 channels of one
// batch row (W / 64 x B CTAs). A producer warp keeps a ring of kStages
// stages in shared memory, each kSteps time steps x 64 channels of a and of
// b (32 KB: 64 steps of f32, 128 of bf16), filled by TMA boxes that land on
// the stage's "full" mbarrier, so the copies cost the producer one
// instruction a box and the whole ring but the stage being read is in
// flight. Two consumer warps, one channel a lane, walk time in order from
// shared memory with the state in a register: 32 steps of a and b into
// registers, then the chain in straight code (no branch a step, which
// would keep each load next to its use), each h_t stored to device memory
// (a warp's 32 channels a step), the stage freed on its "empty" mbarrier.
// Ragged W and S are zeros in the boxes and never stored. A row that TMA
// cannot take (W x the element size not a multiple of 16 bytes, or a base
// off 16 bytes) is staged element by element by the producer. The update
// rounds as the plain PyTorch version does (a multiply, then an add; no
// fused multiply-add) in the same order, so f32 results equal it bit for
// bit.

#include "scan_common.cuh"

namespace {

using scan::from_f32;
using scan::to_f32;

constexpr int kConsumers = 2;          // consumer warps, one channel a lane
constexpr int kCols = 32 * kConsumers;  // channels a CTA
constexpr int kThreads = 32 * (kConsumers + 1);  // the last warp produces
constexpr int kStageBytes = 32768;      // a and b of one stage
constexpr int kStages = 3;
constexpr int kBatch = 32;  // steps the consumer loads before it uses them

// Shared memory: kStages stages, each a then b, (kSteps, kCols) row-major;
// then the full and empty mbarriers; 128 bytes of slack to align.
template <typename T>
struct Ring {
  static constexpr int kSteps = kStageBytes / (2 * kCols * sizeof(T));
  static constexpr int kBars = kStages * kStageBytes;
  static constexpr int kBytes = kBars + 2 * kStages * 8 + 128;
  __device__ static T* a(unsigned char* smem, int s) {
    return reinterpret_cast<T*>(smem + s * kStageBytes);
  }
  __device__ static T* b(unsigned char* smem, int s) {
    return a(smem, s) + kSteps * kCols;
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
// `boxes`, a and b come by TMA boxes of (kCols channels, kSteps steps)
// through map_a / map_b; else element by element.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const T* __restrict__ a, const T* __restrict__ b,
                 T* __restrict__ y, int S, int W, bool boxes) {
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
  const int n = (S + kSteps - 1) / kSteps;  // stages of this row

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      tma::mbar_init(R::full(smem, s), boxes ? 1 : 32);
      tma::mbar_init(R::empty(smem, s), 32 * kConsumers);
    }
    tma::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers) {
    // producer: stage i into slot i % kStages once its last use is freed
    for (int i = 0; i < n; ++i) {
      const int s = i % kStages;
      if (i >= kStages)
        tma::mbar_wait(R::empty(smem, s), (i / kStages - 1) & 1);
      if (boxes) {
        if (lane == 0) {
          tma::mbar_expect(R::full(smem, s), kStageBytes);
          scan::tma_load(R::a(smem, s), &map_a, w0, i * kSteps, bi,
                         R::full(smem, s));
          scan::tma_load(R::b(smem, s), &map_b, w0, i * kSteps, bi,
                         R::full(smem, s));
        }
      } else {
        const long long off = base + (long long)i * kSteps * W;
        const int rows = min(kSteps, S - i * kSteps);
        scan::stage_elements(R::a(smem, s), a + off, W, kSteps, kCols, rows,
                             live_cols, lane, 32);
        scan::stage_elements(R::b(smem, s), b + off, W, kSteps, kCols, rows,
                             live_cols, lane, 32);
        tma::mbar_arrive(R::full(smem, s));
      }
    }
    return;
  }

  // consumer: column c = channel w0 + c, time in order
  const int c = warp * 32 + lane;
  const bool live = c < live_cols;
  T* out = y + base + c;
  float h = 0.f;
  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    tma::mbar_wait(R::full(smem, s), (i / kStages) & 1);
    const T* as = R::a(smem, s) + c;
    const T* bs = R::b(smem, s) + c;
    const int rows = min(kSteps, S - i * kSteps);
    for (int u0 = 0; u0 < rows; u0 += kBatch) {
      // a batch of steps into registers, then the chain in one block of
      // straight code (a branch a step would keep each load next to its
      // use). Steps past S run on the ring's zeros and are not stored:
      // nothing reads h after the last stage.
      float av[kBatch], bv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        av[u] = to_f32(as[(u0 + u) * kCols]);
        bv[u] = to_f32(bs[(u0 + u) * kCols]);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
        if (live && u0 + u < rows) *out = from_f32<T>(h);
        out += W;
      }
    }
    tma::mbar_arrive(R::empty(smem, s));
  }
}

template <typename T>
int launch(const void* a, const void* b, void* y, int B, int S, int W,
           cudaStream_t stream) {
  using R = Ring<T>;
  const cudaError_t e = cudaFuncSetAttribute(
      rglru_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kBytes);
  if (e != cudaSuccess) return (int)e;
  const long long bld = (long long)S * W;
  const bool boxes = scan::tma_ok<T>(a, W, bld, kCols) &&
                   scan::tma_ok<T>(b, W, bld, kCols);
  CUtensorMap map_a{}, map_b{};
  if (boxes) {
    int m = scan::make_map<T>(&map_a, a, B, S, W, W, bld, kCols, R::kSteps);
    if (m == 0)
      m = scan::make_map<T>(&map_b, b, B, S, W, W, bld, kCols, R::kSteps);
    if (m != 0) return m;
  }
  const dim3 grid((W + kCols - 1) / kCols, B);
  rglru_kernel<T><<<grid, kThreads, R::kBytes, stream>>>(
      map_a, map_b, static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(y), S, W, boxes);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (a, b and y share it). a, b and y are
// contiguous (B, S, W). Returns cudaGetLastError() after the launch.
extern "C" int repro_rglru_scan(int dtype, const void* a, const void* b,
                                void* y, int B, int S, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, y, B, S, W, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, y, B, S, W, s);
  return (int)cudaErrorInvalidValue;
}
