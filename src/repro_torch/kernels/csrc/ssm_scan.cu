// Mamba-1 selective scan for Hopper (sm_90a): the recurrence runs over time
// inside one CTA, the SSM state in registers.
//
// Replaces the TPU kernel `selective_scan` / `_ssm_kernel` of
// src/repro/kernels/ssm_scan.py (pallas_call at :109). Same function:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t,   h_0 = 0,
//   y_t = C_t . h_t + D * x_t,
// with x (B, S, Di) f32 or bf16, dt (B, S, Di) f32, A (Di, N) f32, B and C
// (B, S, N) in x's dtype (strided views allowed: the model slices them out
// of one (B, S, R + 2N) projection), D (Di,) f32; y (B, S, Di) in x's
// dtype. Optionally the final state h_S (B, Di, N) f32, which the prefill
// hands to decode (the reference computes it in a second scan).
//
// Bound: bytes. Each (b, t, channel) reads x and dt and writes y once; B
// and C are (B, S, N), small. At the falcon-mamba prefill (B 1, S 512, Di
// 8192, N 16, bf16) that is ~34 MB, ~10 us at 3.35 TB/s; the ~7 f32
// operations a state step are ~0.5 GFLOP, ~7 us at 67 TFLOP/s. Two floors
// above both: the B S Di N = 67.1 M exponentials go through the
// special-function units at 16 a clock per SM, ~16 us at 1.98 GHz on 132
// SMs; and issue: 4 warp instructions a clock per SM, so each instruction
// a state step costs ~2 us. At B 1 there are only B Di N / 4 threads (8
// warps a SM), too few to hide latency at a full issue rate.
//
// What this design does about them. Instructions: a thread holds 4 states
// of one channel (G = N / 4 lanes a channel, 32 channels a CTA); a state
// step is 5 instructions: dt A' (A pre-scaled by log2 e), one MUFU.EX2
// (ex2.approx.ftz), dx B, h = fma(decay, h, dx B), acc = fma(h, C, acc);
// B_t and C_t come as one float4 each, dt_t and x_t one load each, all as
// f32 from shared memory (bf16 tiles are widened there once, by all
// threads, one tile ahead). The sum of y over N takes no shuffles a step:
// each lane keeps its partial sums of G steps in registers, and one
// butterfly of G - 1 shuffles leaves lane j of the channel with the whole
// sum of step j. A whole tile of kSteps steps is one block of straight code
// (its y sums in registers until the tile's end, no branch a step), so the
// compiler can overlap one step's loads and exponentials with another's
// chain; the kernel is built for one CTA's worth of registers a thread.
// Latency: tiles of 64 steps of x, dt, B and C come by TMA boxes into a
// ring of 4 stages, three tiles ahead of the one being computed, waited on
// by one mbarrier a stage, with one CTA barrier a tile; the y tile goes
// out from shared memory in 16-byte stores at the next tile. An array TMA
// cannot take (rows or strides off 16 bytes: Di or N x the element size,
// B and C's strides, a misaligned base) is staged element by element;
// ragged Di and S are zeros in the tiles, never stored, and steps past S
// leave the state as it is. Rounding: the exponential is ex2.approx of dt
// A' (relative error ~2^-22 against the plain version's expf), the state
// update one fused multiply-add, the sum over N in another order: f32
// stays within 2e-5 x (1 + |plain|) of the plain version, bf16 within its
// output's rounding.

#include "scan_common.cuh"

namespace {

using scan::from_f32;

constexpr int kStates = 4;    // SSM states a thread
constexpr int kChannels = 32;  // channels a CTA
constexpr int kSteps = 64;    // time steps a tile
constexpr int kRing = 4;      // tiles in the ring
constexpr float kLog2e = 1.4426950408889634f;

// A thread's kStates (4) consecutive floats of shared memory, 16-byte
// aligned, in one load.
__device__ __forceinline__ void load4(float (&out)[kStates], const float* p) {
  static_assert(kStates == 4, "one float4 a thread");
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Eight bf16 from shared memory to eight f32, 16 bytes in, 32 out.
__device__ __forceinline__ void widen8(float* dst,
                                       const __nv_bfloat16* src) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float f[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
  *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

// Shared memory of a CTA: kRing raw stages, each x, B and C of one tile
// (T: kSteps x kChannels, kSteps x N, kSteps x N) then dt (f32, kSteps x
// kChannels); for bf16, two widened tiles (x, B and C as f32, the same
// layout); two y tiles (T, kSteps x kChannels); a "full" mbarrier a stage;
// 128 bytes of slack to align. Every part starts on 128 bytes.
template <typename T, int N>
struct Smem {
  static constexpr int kX = kSteps * kChannels;
  static constexpr int kBC = kSteps * N;
  static constexpr int kRawT = kX + 2 * kBC;  // x, B, C: T elements
  static constexpr int kRawBytes = kRawT * sizeof(T) + kX * 4;
  static constexpr bool kWiden = sizeof(T) == 2;
  static constexpr int kWideBytes = kWiden ? 2 * kRawT * 4 : 0;
  static constexpr int kYOffset = kRing * kRawBytes + kWideBytes;
  static constexpr int kBarOffset = kYOffset + 2 * kX * sizeof(T);
  static constexpr int kBytes = kBarOffset + kRing * 8 + 128;

  __device__ static T* raw(unsigned char* s, int i) {
    return reinterpret_cast<T*>(s + i * kRawBytes);
  }
  __device__ static float* dt(unsigned char* s, int i) {
    return reinterpret_cast<float*>(s + i * kRawBytes + kRawT * sizeof(T));
  }
  // x, B and C of ring stage i as f32: widened (bf16) or raw (f32)
  __device__ static float* wide(unsigned char* s, int i) {
    if constexpr (kWiden)
      return reinterpret_cast<float*>(s + kRing * kRawBytes +
                                      (i & 1) * kRawT * 4);
    else
      return reinterpret_cast<float*>(raw(s, i % kRing));
  }
  __device__ static T* y(unsigned char* s, int i) {
    return reinterpret_cast<T*>(s + kYOffset) + (i & 1) * kX;
  }
  // the mbarrier's shared-memory address
  __device__ static uint32_t full(unsigned char* s, int i) {
    return scan::smem_addr(s + kBarOffset + 8 * i);
  }
};

// A whole kSteps x kChannels tile of shared memory (row-major) to dst (row
// r at dst + r * ld) in 16-byte chunks, all loads before all stores; dst
// and ld whole 16 bytes.
template <int kThreads, typename E>
__device__ __forceinline__ void store_whole(E* dst, long long ld,
                                            const E* src, int tid) {
  constexpr int kChunk = 16 / sizeof(E);
  constexpr int kPerRow = kChannels / kChunk;
  constexpr int kRounds = kSteps * kPerRow / kThreads;
  static_assert(kSteps * kPerRow % kThreads == 0, "whole rounds");
  uint4 v[kRounds];
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    const int c = j * kThreads + tid;
    v[j] = *reinterpret_cast<const uint4*>(src + c * kChunk);
  }
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    const int c = j * kThreads + tid;
    *reinterpret_cast<uint4*>(dst + (c / kPerRow) * ld +
                              (c % kPerRow) * kChunk) = v[j];
  }
}

// G = N / kStates steps t0 .. t0 + G - 1 of one channel g (tile column),
// states lane * kStates .. of it: the state update, then the sum of C_t .
// h_t over the channel's G lanes, by a butterfly: at offset o a lane keeps
// the half of its G partial sums that its bit o picks and adds the
// partner's copy of that half, so lane j ends with the whole sum of step
// t0 + j. Returns that sum plus D x for step t0 + lane. kGuard: steps from
// `steps` on keep the state (decay 1, drive 0), for a ragged last tile.
template <int N, bool kGuard>
__device__ __forceinline__ float steps_of(float (&h)[kStates],
                                          const float (&a2)[kStates],
                                          const float* xs, const float* dts,
                                          const float* bs, const float* cs,
                                          int g, int lane, int t0, int steps,
                                          float dv) {
  constexpr int G = N / kStates;
  float acc[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int t = t0 + j;
    const bool on = !kGuard || t < steps;
    const float dtt = on ? dts[t * kChannels + g] : 0.f;
    const float dx = dtt * xs[t * kChannels + g];
    float bv[kStates], cv[kStates];
    load4(bv, bs + t * N + lane * kStates);
    load4(cv, cs + t * N + lane * kStates);
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kStates; ++k) {
      const float decay = on ? exp2_approx(dtt * a2[k]) : 1.f;
      h[k] = fmaf(decay, h[k], dx * bv[k]);
      sum = fmaf(h[k], cv[k], sum);
    }
    acc[j] = sum;
  }
#pragma unroll
  for (int o = G / 2; o >= 1; o /= 2) {
    const bool up = lane & o;
#pragma unroll
    for (int i = 0; i < o; ++i) {
      const float send = up ? acc[i] : acc[i + o];
      const float keep = up ? acc[i + o] : acc[i];
      acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  return acc[0] + dv * xs[(t0 + lane) * kChannels + g];
}

// Which arrays go by TMA (x, dt, B, C) or by 16-byte stores (y), as bits.
enum : int { kTmaX = 1, kTmaDt = 2, kTmaB = 4, kTmaC = 8, kVecY = 16 };

// One CTA per (kChannels channels blockIdx.x, batch row blockIdx.y), G =
// N / kStates lanes a channel. The maps are those of x, dt, B and C (boxes
// of kChannels or N columns x kSteps steps), read where `paths` has their
// bit; the other arrays take the edge path.
template <typename T, int N>
__global__ void __launch_bounds__(kChannels * N / kStates, 1)
    ssm_scan_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_dt,
                    const __grid_constant__ CUtensorMap map_b,
                    const __grid_constant__ CUtensorMap map_c,
                    const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const T* __restrict__ bm,
                    const T* __restrict__ cm, const float* __restrict__ dskip,
                    T* __restrict__ y, float* __restrict__ h_out, int S, int Di,
                    long long b_bstride, long long b_tstride,
                    long long c_bstride, long long c_tstride, int paths) {
  using L = Smem<T, N>;
  constexpr int G = N / kStates;
  constexpr int kThreads = kChannels * G;
  constexpr int kLag = L::kWiden ? 1 : 0;  // tiles widened ahead
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = scan::align128(smem_raw);

  const int tid = threadIdx.x;
  const int g = tid / G;     // channel within the CTA
  const int lane = tid % G;  // states lane * kStates ..
  const int c0 = blockIdx.x * kChannels;
  const int ch = c0 + g;
  const int bi = blockIdx.y;
  const bool live = ch < Di;
  const int live_cols = min(kChannels, Di - c0);

  float a2[kStates], h[kStates];
#pragma unroll
  for (int k = 0; k < kStates; ++k) {
    a2[k] = live ? a[(long long)ch * N + lane * kStates + k] * kLog2e : 0.f;
    h[k] = 0.f;
  }
  const float dv = live ? dskip[ch] : 0.f;
  const long long row0 = (long long)bi * S * Di + c0;  // x, dt, y
  const T* bb = bm + bi * b_bstride;
  const T* cc = cm + bi * c_bstride;
  const int nt = (S + kSteps - 1) / kSteps;
  const int tma_bytes = (paths & kTmaX ? L::kX * (int)sizeof(T) : 0) +
                        (paths & kTmaDt ? L::kX * 4 : 0) +
                        (paths & kTmaB ? L::kBC * (int)sizeof(T) : 0) +
                        (paths & kTmaC ? L::kBC * (int)sizeof(T) : 0);

  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) tma::mbar_init(L::full(smem, i), 1);
    tma::fence_barrier_init();
  }
  __syncthreads();

  // tile i into ring stage i % kRing (if it exists): thread 0 announces
  // the TMA bytes on the stage's mbarrier (its one arrival) and asks for
  // the boxes; every thread stages the edge-path arrays
  auto issue = [&](int i) {
    if (i >= nt) return;
    const int st = i % kRing;
    const int t0 = i * kSteps;
    const int rows = min(kSteps, S - t0);
    T* r = L::raw(smem, st);
    const uint32_t bar = L::full(smem, st);
    if (tid == 0) {
      tma::mbar_expect(bar, tma_bytes);
      if (paths & kTmaX) scan::tma_load(r, &map_x, c0, t0, bi, bar);
      if (paths & kTmaB) scan::tma_load(r + L::kX, &map_b, 0, t0, bi, bar);
      if (paths & kTmaC)
        scan::tma_load(r + L::kX + L::kBC, &map_c, 0, t0, bi, bar);
      if (paths & kTmaDt)
        scan::tma_load(L::dt(smem, st), &map_dt, c0, t0, bi, bar);
    }
    const long long off = row0 + (long long)t0 * Di;
    if (!(paths & kTmaX))
      scan::stage_elements(r, x + off, Di, kSteps, kChannels, rows, live_cols,
                           tid, kThreads);
    if (!(paths & kTmaB))
      scan::stage_elements(r + L::kX, bb + t0 * b_tstride, b_tstride, kSteps,
                           N, rows, N, tid, kThreads);
    if (!(paths & kTmaC))
      scan::stage_elements(r + L::kX + L::kBC, cc + t0 * c_tstride, c_tstride,
                           kSteps, N, rows, N, tid, kThreads);
    if (!(paths & kTmaDt))
      scan::stage_elements(L::dt(smem, st), dt + off, Di, kSteps, kChannels,
                           rows, live_cols, tid, kThreads);
  };
  // wait for the TMA boxes of tile i (the edge-path arrays are ordered by
  // the CTA barrier that follows every wait)
  auto landed = [&](int i) {
    if (i < nt) tma::mbar_wait(L::full(smem, i % kRing), (i / kRing) & 1);
  };
  // bf16: x, B and C of tile i widened to f32
  auto widen = [&](int i) {
    if constexpr (L::kWiden) {
      const T* r = L::raw(smem, i % kRing);
      float* w = L::wide(smem, i);
      static_assert(L::kRawT % (kThreads * 8) == 0, "whole rounds");
#pragma unroll
      for (int j = 0; j < L::kRawT / (kThreads * 8); ++j) {
        const int e = (j * kThreads + tid) * 8;
        widen8(w + e, reinterpret_cast<const __nv_bfloat16*>(r) + e);
      }
    }
  };
  auto store_y = [&](int i) {
    T* dst = y + row0 + (long long)i * kSteps * Di;
    const int rows = min(kSteps, S - i * kSteps);
    if ((paths & kVecY) && rows == kSteps && live_cols == kChannels)
      store_whole<kThreads>(dst, Di, L::y(smem, i), tid);
    else
      scan::store_tile(dst, Di, L::y(smem, i), kChannels, rows, live_cols,
                 paths & kVecY, tid, kThreads);
  };

  for (int i = 0; i < kRing - 1; ++i) issue(i);
  if constexpr (L::kWiden) {
    landed(0);
    __syncthreads();
    widen(0);
  }
  for (int i = 0; i < nt; ++i) {
    // tile i + kLag has landed; after the barrier every thread's stores
    // (edge-path tiles, the widened tile i, the y tile i - 1) are visible
    // and every thread is done with tile i - 1
    landed(i + kLag);
    __syncthreads();
    if (i > 0) store_y(i - 1);
    issue(i + kRing - 1);  // into the stage tile i - 1 held
    if (i + 1 < nt) widen(i + 1);

    const float* xs = L::wide(smem, i);
    const float* bs = xs + L::kX;
    const float* cs = bs + L::kBC;
    const float* dts = L::dt(smem, i % kRing);
    T* ys = L::y(smem, i);
    const int steps = min(kSteps, S - i * kSteps);
    if (steps == kSteps) {
      // a whole tile, one block of straight code: the y sums stay in
      // registers until its end, so no shared-memory store stands between
      // one group's loads and the next group's
      float yv[kSteps / G];
#pragma unroll
      for (int q = 0; q < kSteps / G; ++q)
        yv[q] = steps_of<N, false>(h, a2, xs, dts, bs, cs, g, lane, q * G,
                                   kSteps, dv);
#pragma unroll
      for (int q = 0; q < kSteps / G; ++q)
        ys[(q * G + lane) * kChannels + g] = from_f32<T>(yv[q]);
    } else {
      for (int t0 = 0; t0 < steps; t0 += G) {
        const float yt = steps_of<N, true>(h, a2, xs, dts, bs, cs, g, lane,
                                           t0, steps, dv);
        if (t0 + lane < steps)
          ys[(t0 + lane) * kChannels + g] = from_f32<T>(yt);
      }
    }
  }
  __syncthreads();
  store_y(nt - 1);
  if (h_out != nullptr && live) {
    float* o = h_out + ((long long)bi * Di + ch) * N + lane * kStates;
#pragma unroll
    for (int k = 0; k < kStates; ++k) o[k] = h[k];
  }
}

template <typename T, int N>
int launch(const void* x, const float* dt, const float* a, const void* bm,
           const void* cm, const float* dskip, void* y, float* h_out, int B,
           int S, int Di, long long b_bstride, long long b_tstride,
           long long c_bstride, long long c_tstride, cudaStream_t stream) {
  using L = Smem<T, N>;
  const cudaError_t e = cudaFuncSetAttribute(
      ssm_scan_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (e != cudaSuccess) return (int)e;
  const long long xb = (long long)S * Di;  // x, dt, y: batch rows apart
  CUtensorMap mx{}, mdt{}, mb{}, mc{};
  int paths = 0, m = 0;
  if (scan::tma_ok<T>(x, Di, xb, kChannels)) {
    paths |= kTmaX;
    m = scan::make_map<T>(&mx, x, B, S, Di, Di, xb, kChannels, kSteps);
  }
  if (m == 0 && scan::tma_ok<float>(dt, Di, xb, kChannels)) {
    paths |= kTmaDt;
    m = scan::make_map<float>(&mdt, dt, B, S, Di, Di, xb, kChannels, kSteps);
  }
  if (m == 0 && scan::tma_ok<T>(bm, b_tstride, b_bstride, N)) {
    paths |= kTmaB;
    m = scan::make_map<T>(&mb, bm, B, S, N, b_tstride, b_bstride, N, kSteps);
  }
  if (m == 0 && scan::tma_ok<T>(cm, c_tstride, c_bstride, N)) {
    paths |= kTmaC;
    m = scan::make_map<T>(&mc, cm, B, S, N, c_tstride, c_bstride, N, kSteps);
  }
  if (m != 0) return m;
  if (scan::tma_ok<T>(y, Di, xb, kChannels)) paths |= kVecY;
  const dim3 grid((Di + kChannels - 1) / kChannels, B);
  ssm_scan_kernel<T, N><<<grid, kChannels * N / kStates, L::kBytes, stream>>>(
      mx, mdt, mb, mc, static_cast<const T*>(x), dt, a,
      static_cast<const T*>(bm), static_cast<const T*>(cm), dskip,
      static_cast<T*>(y), h_out, S, Di, b_bstride, b_tstride, c_bstride,
      c_tstride, paths);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int N, const void* x, const float* dt, const float* a,
             const void* bm, const void* cm, const float* dskip, void* y,
             float* h_out, int B, int S, int Di, long long b_bstride,
             long long b_tstride, long long c_bstride, long long c_tstride,
             cudaStream_t s) {
  switch (N) {
    case 4:
      return launch<T, 4>(x, dt, a, bm, cm, dskip, y, h_out, B, S, Di,
                          b_bstride, b_tstride, c_bstride, c_tstride, s);
    case 8:
      return launch<T, 8>(x, dt, a, bm, cm, dskip, y, h_out, B, S, Di,
                          b_bstride, b_tstride, c_bstride, c_tstride, s);
    case 16:
      return launch<T, 16>(x, dt, a, bm, cm, dskip, y, h_out, B, S, Di,
                           b_bstride, b_tstride, c_bstride, c_tstride, s);
    case 32:
      return launch<T, 32>(x, dt, a, bm, cm, dskip, y, h_out, B, S, Di,
                           b_bstride, b_tstride, c_bstride, c_tstride, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y share it; dt, A, D and
// h_out are float32). x, dt and y are contiguous (B, S, Di); A is (Di, N)
// and D (Di,) contiguous; B and C are read through their batch and time
// strides (in elements) with N contiguous. h_out (B, Di, N) may be null.
// N is 4, 8, 16 or 32. Returns cudaGetLastError() after the launch.
extern "C" int repro_ssm_scan(int dtype, const void* x, const float* dt,
                              const float* a, const void* bm, const void* cm,
                              const float* dskip, void* y, float* h_out, int B,
                              int S, int Di, int N, long long b_bstride,
                              long long b_tstride, long long c_bstride,
                              long long c_tstride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(N, x, dt, a, bm, cm, dskip, y, h_out, B, S, Di,
                           b_bstride, b_tstride, c_bstride, c_tstride, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(N, x, dt, a, bm, cm, dskip, y, h_out, B, S,
                                   Di, b_bstride, b_tstride, c_bstride,
                                   c_tstride, s);
  return (int)cudaErrorInvalidValue;
}
