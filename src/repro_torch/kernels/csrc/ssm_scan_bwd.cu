// Mamba-1 selective scan, backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference trains mamba through XLA's
// autodiff of its `lax.scan` oracle (src/repro/kernels/ref.py:229); the
// port's forward is the hand kernel csrc/ssm_scan.cu, so its backward is
// one too. For the forward
//   h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t,   y_t = C_t . h_t + D x_t
// and the cotangent dy of y, with gh_t = C_t dy_t + exp(dt_{t+1} A) gh_{t+1}
// (the reverse state scan, per channel and state):
//   dx_t  = D dy_t + dt_t (B_t . gh_t)
//   ddt_t = x_t (B_t . gh_t) + sum_n gh_t h_{t-1} exp(dt_t A) A
//   dA    = sum_{b,t} gh_t h_{t-1} exp(dt_t A) dt_t      (Di, N)
//   dD    = sum_{b,t} dy_t x_t                           (Di,)
//   dB_t  = sum_i dt_t x_t gh_t,   dC_t = sum_i dy_t h_t  (B, S, N)
// x and dy (B, S, Di) f32 or bf16, dt (B, S, Di) f32, A (Di, N) f32, B and
// C (B, S, N) in x's dtype through their batch and time strides, D (Di,)
// f32; dx in x's dtype, ddt, dA and dD f32, dB and dC in x's dtype.
// ref.selective_scan_bwd is the same algorithm in plain torch.
//
// Bound: operations. At falcon-mamba's training shape (B 1, S 4,096, Di
// 8,192, N 16, bf16) the function reads x, dt, dy, B and C and writes dx,
// ddt, dB, dC, dA and dD once (~470 MB, 0.14 ms at 3.35 TB/s), and does 19
// f32 operations a (b, t, channel, state) and 9 a (b, t, channel)
// (kernels/cost.py `scan_work`): 10.5 GFLOP, 156.754 us at 67 TFLOP/s.
// Its B S Di N = 537 M exponentials, each computed once, take 128.384 us
// on the special-function units (16 a clock per SM, 1,980 MHz, 132 SMs).
//
// Design (a redesign of a first version that took 4.34 ms at that shape
// on an NVIDIA H100 80GB HBM3 at 700 W: its steps loaded dt, x, dy, B and
// C from device memory inside the dependent loop, with ~8 warps an SM to
// hide them, and summed dB and dC over shared memory between two CTA
// barriers a chunk):
// - One CTA per 32 channels and batch row, a thread 4 states of one
//   channel (G = N / 4 lanes a channel), as the forward kernel.
// - Staging: tiles of 32 steps of dt, x and B (the forward pass) and of
//   dt, x, dy, B and C (the reverse walk) come by TMA boxes into a ring of
//   4 stages, three tiles ahead, one mbarrier a stage, through one
//   sequence over both passes (tiles 0 .. nt - 1, then nt - 1 .. 0); an
//   array TMA cannot take is staged element by element (the forward's
//   edge path). Steps read f32 or bf16 from shared memory only. Steps past
//   S and channels past Di are zeros in the tiles: such a step keeps the
//   state (exp(0) = 1, drive 0) and adds nothing, so every chunk is one
//   block of straight code and only the stores are guarded.
// - h_{t-1} in the reverse walk: the forward pass keeps the state at the
//   start of every chunk of 16 steps ((B, S/16, Di, N) f32 scratch,
//   written and read back by the same thread; the next chunk's is loaded
//   a chunk ahead); the reverse walk recomputes the chunk's 16 states
//   into registers with the forward pass's rounding, then steps back
//   through them. Three exponentials a state step in all (the forward
//   pass, the recomputation, the reverse step): the SFU time is 3 x 128
//   us, under the instructions' issue time.
// - Sums over a channel's 4 state lanes (B . gh and the ddt term) wait
//   for G steps and then take one butterfly of G - 1 shuffles each (lane
//   j ends with step j's sum), as the forward's y.
// - dB and dC: a step's 8 terms a thread are summed over the warp's
//   channels by a butterfly reduce-scatter of warp shuffles (7 at N 16:
//   each lane ends with one of the warp's 2N sums), then over the CTA's
//   warps from shared memory at the chunk's end (one CTA barrier a chunk,
//   double-buffered), then over channel blocks by a second small kernel,
//   all in a fixed order: deterministic, no atomics. dx and ddt leave
//   through shared memory in 16-byte rows at the chunk's end.
// - dA and dD sum over time in registers, over batch rows in a third
//   small kernel.
// Not taken: splitting time across CTAs (a carry pass and a fourth
// exponential a step), and chunk-start states from a training variant of
// the forward kernel (it would save the forward pass here, and change the
// forward's interface).
// Where its time goes at that shape (tools/ab_scan.py --bwd on probes, an
// NVIDIA H100 80GB HBM3 at 700 W; ~1.37 ms in all): ~0.32 ms the dB/dC
// reduce-scatter, ~0.12 ms the forward pass. Neither a per-warp shared
// memory transpose in place of the shuffles, nor 8-step chunks, nor a
// 255-register cap ran faster.

#include "scan_common.cuh"

namespace {

using scan::from_f32;
using scan::to_f32;

constexpr int kStates = 4;     // SSM states a thread
constexpr int kChannels = 32;  // channels a CTA
constexpr int kSteps = 32;     // time steps a tile
constexpr int kRing = 4;       // tiles in the ring
constexpr int kChunk = 16;     // steps a chunk (start states kept)
constexpr int kChunks = kSteps / kChunk;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Four consecutive elements of shared memory (16 or 8 bytes, aligned) as
// f32.
__device__ __forceinline__ void load4(float (&o)[kStates], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void load4(float (&o)[kStates],
                                      const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  o[0] = __uint_as_float(v.x << 16);
  o[1] = __uint_as_float(v.x & 0xffff0000u);
  o[2] = __uint_as_float(v.y << 16);
  o[3] = __uint_as_float(v.y & 0xffff0000u);
}

// Shared memory of a CTA: kRing stages, each x, dy (T, kSteps x
// kChannels), B, C (T, kSteps x N) and dt (f32, kSteps x kChannels); two
// chunk buffers (by the chunk's parity), each the warps' dB and dC sums
// (f32, kChunk x warps x 2N) and the chunk's dx (T) and ddt (f32) tiles
// (kChunk x kChannels); a "full" mbarrier a stage; 128 bytes of slack to
// align. Every part starts on 128 bytes.
template <typename T, int N>
struct Smem {
  static constexpr int kWarps = kChannels * (N / kStates) / 32;
  static constexpr int kXBytes = kSteps * kChannels * sizeof(T);
  static constexpr int kBCBytes = kSteps * N * sizeof(T);
  static constexpr int kStage = 2 * kXBytes + 2 * kBCBytes +
                                kSteps * kChannels * 4;
  static constexpr int kRed = kChunk * kWarps * 2 * N * 4;
  static constexpr int kDx = kChunk * kChannels * sizeof(T);
  static constexpr int kDdt = kChunk * kChannels * 4;
  static constexpr int kBuf = kRed + kDx + kDdt;
  static constexpr int kBarOffset = kRing * kStage + 2 * kBuf;
  static constexpr int kBytes = kBarOffset + kRing * 8 + 128;
  static_assert(kBCBytes % 128 == 0 && kDx % 128 == 0, "128-byte parts");

  __device__ static unsigned char* stage(unsigned char* s, int i) {
    return s + (i % kRing) * kStage;
  }
  __device__ static T* x(unsigned char* st) {
    return reinterpret_cast<T*>(st);
  }
  __device__ static T* dy(unsigned char* st) {
    return reinterpret_cast<T*>(st + kXBytes);
  }
  __device__ static T* b(unsigned char* st) {
    return reinterpret_cast<T*>(st + 2 * kXBytes);
  }
  __device__ static T* c(unsigned char* st) {
    return reinterpret_cast<T*>(st + 2 * kXBytes + kBCBytes);
  }
  __device__ static float* dt(unsigned char* st) {
    return reinterpret_cast<float*>(st + 2 * kXBytes + 2 * kBCBytes);
  }
  __device__ static float* red(unsigned char* s, int chunk) {
    return reinterpret_cast<float*>(s + kRing * kStage + (chunk & 1) * kBuf);
  }
  __device__ static T* dx(unsigned char* s, int chunk) {
    return reinterpret_cast<T*>(s + kRing * kStage + (chunk & 1) * kBuf +
                                kRed);
  }
  __device__ static float* ddt(unsigned char* s, int chunk) {
    return reinterpret_cast<float*>(s + kRing * kStage + (chunk & 1) * kBuf +
                                    kRed + kDx);
  }
  __device__ static uint32_t full(unsigned char* s, int i) {
    return scan::smem_addr(s + kBarOffset + 8 * (i % kRing));
  }
};

// The butterfly reduce-scatter of a step's 8 dB and dC terms over the
// warp's channels (lane bits O = 16, 8, ... down to G): while a lane holds
// M > 1 values it keeps the half its bit O picks and adds the partner's
// copy of that half; once it holds one, it adds the partner's. A lane
// ends with terms [idx, idx + M) summed over the warp, idx = 4 (bit 16) +
// 2 (bit 8) + 1 (bit 4, when G <= 4).
template <int M, int O, int G>
__device__ __forceinline__ void scatter_sum(float (&v)[8], int lane) {
  if constexpr (O >= G) {
    if constexpr (M > 1) {
      const bool up = lane & O;
#pragma unroll
      for (int i = 0; i < M / 2; ++i) {
        const float send = up ? v[i] : v[i + M / 2];
        const float keep = up ? v[i + M / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      scatter_sum<M / 2, O / 2, G>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      scatter_sum<1, O / 2, G>(v, lane);
    }
  }
}

// Which arrays go by TMA (x, dt, dy, B, C) or by 16-byte stores (dx, ddt),
// as bits.
enum : int {
  kTmaX = 1,
  kTmaDt = 2,
  kTmaDy = 4,
  kTmaB = 8,
  kTmaC = 16,
  kVecDx = 32,
  kVecDdt = 64
};

struct Args {
  const void* x;
  const float* dt;
  const float* a;
  const void* bm;
  const void* cm;
  const float* dskip;
  const void* dy;
  void* dx;
  float* ddt;
  float* da_part;  // (B, Di, N)
  float* dd_part;  // (B, Di)
  float* bc_part;  // (Di / 32, B, S, 2N)
  float* hs;       // (B, S / kChunk, Di, N): chunk-start states
  int S, Di;
  long long b_bstride, b_tstride, c_bstride, c_tstride;
  int paths;
};

template <typename T, int N>
__global__ void __launch_bounds__(kChannels * N / kStates)
    ssm_scan_bwd_kernel(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_dt,
                        const __grid_constant__ CUtensorMap map_dy,
                        const __grid_constant__ CUtensorMap map_b,
                        const __grid_constant__ CUtensorMap map_c,
                        const Args p) {
  using L = Smem<T, N>;
  constexpr int G = N / kStates;
  constexpr int kThreads = kChannels * G;
  constexpr int kWarps = L::kWarps;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = scan::align128(smem_raw);
  const T* x = static_cast<const T*>(p.x);
  const T* dy = static_cast<const T*>(p.dy);
  const T* bm = static_cast<const T*>(p.bm);
  const T* cm = static_cast<const T*>(p.cm);
  const int S = p.S, Di = p.Di, paths = p.paths;
  const int tid = threadIdx.x;
  const int g = tid / G;     // channel within the CTA
  const int lane = tid % G;  // states lane * kStates ..
  const int wl = tid % 32;   // lane in the warp
  const int warp = tid / 32;
  const int c0 = blockIdx.x * kChannels;
  const int ch = c0 + g;
  const int bi = blockIdx.y;
  const bool live = ch < Di;
  const int live_cols = min(kChannels, Di - c0);
  const int nt = (S + kSteps - 1) / kSteps;
  const int nch = (S + kChunk - 1) / kChunk;

  float av[kStates], a2[kStates];
#pragma unroll
  for (int k = 0; k < kStates; ++k) {
    av[k] = live ? p.a[(long long)ch * N + lane * kStates + k] : 0.f;
    a2[k] = av[k] * kLog2e;
  }
  const float dv = live ? p.dskip[ch] : 0.f;
  const long long row0 = (long long)bi * S * Di + c0;  // x, dt, dy, dx, ddt
  const T* bb = bm + bi * p.b_bstride;
  const T* cc = cm + bi * p.c_bstride;
  const long long hstride = (long long)Di * N;  // chunk to chunk
  float* hst = p.hs + ((long long)bi * nch * Di + ch) * N + lane * kStates;
  const int fwd_bytes = (paths & kTmaX ? L::kXBytes : 0) +
                        (paths & kTmaDt ? kSteps * kChannels * 4 : 0) +
                        (paths & kTmaB ? L::kBCBytes : 0);
  const int rev_bytes = fwd_bytes + (paths & kTmaDy ? L::kXBytes : 0) +
                        (paths & kTmaC ? L::kBCBytes : 0);

  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) tma::mbar_init(L::full(smem, i), 1);
    tma::fence_barrier_init();
  }
  __syncthreads();

  // The ring's sequence: s < nt is tile s of the forward pass (dt, x, B),
  // s >= nt tile 2 nt - 1 - s of the reverse walk (all five). Entry s into
  // stage s % kRing: thread 0 announces the TMA bytes on the stage's
  // mbarrier (its one arrival) and asks for the boxes; every thread
  // stages the edge-path arrays.
  auto issue = [&](int s) {
    if (s >= 2 * nt) return;
    const bool rev = s >= nt;
    const int t0 = (rev ? 2 * nt - 1 - s : s) * kSteps;
    const int rows = min(kSteps, S - t0);
    unsigned char* st = L::stage(smem, s);
    const uint32_t bar = L::full(smem, s);
    if (tid == 0) {
      tma::mbar_expect(bar, rev ? rev_bytes : fwd_bytes);
      if (paths & kTmaX) scan::tma_load(L::x(st), &map_x, c0, t0, bi, bar);
      if (paths & kTmaDt) scan::tma_load(L::dt(st), &map_dt, c0, t0, bi, bar);
      if (paths & kTmaB) scan::tma_load(L::b(st), &map_b, 0, t0, bi, bar);
      if (rev && (paths & kTmaDy))
        scan::tma_load(L::dy(st), &map_dy, c0, t0, bi, bar);
      if (rev && (paths & kTmaC))
        scan::tma_load(L::c(st), &map_c, 0, t0, bi, bar);
    }
    const long long off = row0 + (long long)t0 * Di;
    if (!(paths & kTmaX))
      scan::stage_elements(L::x(st), x + off, Di, kSteps, kChannels, rows,
                           live_cols, tid, kThreads);
    if (!(paths & kTmaDt))
      scan::stage_elements(L::dt(st), p.dt + off, Di, kSteps, kChannels, rows,
                           live_cols, tid, kThreads);
    if (!(paths & kTmaB))
      scan::stage_elements(L::b(st), bb + t0 * p.b_tstride, p.b_tstride,
                           kSteps, N, rows, N, tid, kThreads);
    if (rev && !(paths & kTmaDy))
      scan::stage_elements(L::dy(st), dy + off, Di, kSteps, kChannels, rows,
                           live_cols, tid, kThreads);
    if (rev && !(paths & kTmaC))
      scan::stage_elements(L::c(st), cc + t0 * p.c_tstride, p.c_tstride,
                           kSteps, N, rows, N, tid, kThreads);
  };
  // wait for the TMA boxes of entry s (the edge-path arrays are ordered by
  // the CTA barrier that follows every wait)
  auto landed = [&](int s) {
    if (s < 2 * nt) tma::mbar_wait(L::full(smem, s), (s / kRing) & 1);
  };

  // The forward pass: the state at the start of every chunk to the
  // scratch.
  for (int i = 0; i < kRing - 1; ++i) issue(i);
  {
    float h[kStates] = {0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < nt; ++s) {
      landed(s);
      __syncthreads();  // every thread is done with entry s - 1
      issue(s + kRing - 1);  // into the stage entry s - 1 held
      unsigned char* st = L::stage(smem, s);
      const float* dts = L::dt(st);
      const T* xs = L::x(st);
      const T* bs = L::b(st);
      for (int q = 0; q < kChunks; ++q) {
        const int c = s * kChunks + q;
        if (c >= nch) break;
        if (live)
          *reinterpret_cast<float4*>(hst + c * hstride) =
              make_float4(h[0], h[1], h[2], h[3]);
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const int row = q * kChunk + j;
          const float dtt = dts[row * kChannels + g];
          const float dx = dtt * to_f32(xs[row * kChannels + g]);
          float bv[kStates];
          load4(bv, bs + row * N + lane * kStates);
#pragma unroll
          for (int k = 0; k < kStates; ++k)
            h[k] = fmaf(exp2_approx(dtt * a2[k]), h[k], dx * bv[k]);
        }
      }
    }
  }

  // The reverse walk, chunk by chunk; chunk c's dB/dC sums, dx and ddt
  // leave after the barrier that opens chunk c - 1 (or the last one).
  float* part = p.bc_part + ((long long)blockIdx.x * gridDim.y + bi) * S * 2 * N;
  auto flush = [&](int c) {
    const int t0 = c * kChunk;
    const int rows = min(kChunk, S - t0);
    const float* rb = L::red(smem, c);
    for (int o = tid; o < rows * 2 * N; o += kThreads) {
      const int j = o / (2 * N), v = o % (2 * N);
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += rb[(j * kWarps + w) * 2 * N + v];
      part[(long long)t0 * 2 * N + o] = sum;
    }
    const long long off = row0 + (long long)t0 * Di;
    scan::store_tile(static_cast<T*>(p.dx) + off, Di, L::dx(smem, c),
                     kChannels, rows, live_cols, paths & kVecDx, tid,
                     kThreads);
    scan::store_tile(p.ddt + off, Di, L::ddt(smem, c), kChannels, rows,
                     live_cols, paths & kVecDdt, tid, kThreads);
  };
  // a lane's dB/dC sums after scatter_sum: terms [idx, idx + M) of the
  // 8, written by one lane of each group that holds the same sums
  constexpr int M = G == 8 ? 2 : 1;
  const int idx = (wl & 16 ? 4 : 0) + (wl & 8 ? 2 : 0) +
                  (G <= 4 && (wl & 4) ? 1 : 0);
  const bool writer = (wl & (3 & ~(G - 1))) == 0;
  int red_at[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int i = idx + m;
    red_at[m] = warp * 2 * N +
                (i < 4 ? lane * kStates + i : N + lane * kStates + i - 4);
  }

  float r[kStates] = {0.f, 0.f, 0.f, 0.f};  // exp(dt_{t+1} A) gh_{t+1}
  float da[kStates] = {0.f, 0.f, 0.f, 0.f};
  float dd = 0.f;
  float hn[kStates] = {0.f, 0.f, 0.f, 0.f};  // the next chunk's start
  if (live) load4(hn, hst + (nch - 1) * hstride);
  for (int c = nch - 1; c >= 0; --c) {
    const int q = c % kChunks;  // the chunk's place in its tile
    const int s = 2 * nt - 1 - c / kChunks;
    const bool opens = c == nch - 1 || q == kChunks - 1;  // a tile's first
    if (opens) landed(s);
    __syncthreads();  // chunk c + 1's buffers written; entry s - 1 done
    if (c < nch - 1) flush(c + 1);
    if (opens) issue(s + kRing - 1);
    unsigned char* st = L::stage(smem, s);
    const float* dts = L::dt(st);
    const T* xs = L::x(st);
    const T* dys = L::dy(st);
    const T* bs = L::b(st);
    const T* cs = L::c(st);
    float* rb = L::red(smem, c);
    T* dxs = L::dx(smem, c);
    float* ddts = L::ddt(smem, c);
    const int r0 = q * kChunk;  // the chunk's first row in the tile

    float h0[kStates];
#pragma unroll
    for (int k = 0; k < kStates; ++k) h0[k] = hn[k];
    if (live && c > 0) load4(hn, hst + (c - 1) * hstride);

    // the chunk's states from its start, rounded as the forward pass
    float hist[kChunk][kStates];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int row = r0 + j;
      const float dtt = dts[row * kChannels + g];
      const float dx = dtt * to_f32(xs[row * kChannels + g]);
      float bv[kStates];
      load4(bv, bs + row * N + lane * kStates);
#pragma unroll
      for (int k = 0; k < kStates; ++k)
        hist[j][k] = fmaf(exp2_approx(dtt * a2[k]), j > 0 ? hist[j - 1][k]
                                                          : h0[k],
                          dx * bv[k]);
    }
    // the reverse state scan through the chunk, G steps a group
#pragma unroll
    for (int grp = kChunk / G - 1; grp >= 0; --grp) {
      float psb[G], psa[G];
#pragma unroll
      for (int jj = G - 1; jj >= 0; --jj) {
        const int j = grp * G + jj;
        const int row = r0 + j;
        const float dtt = dts[row * kChannels + g];
        const float xt = to_f32(xs[row * kChannels + g]);
        const float dyt = to_f32(dys[row * kChannels + g]);
        float bv[kStates], cv[kStates];
        load4(bv, bs + row * N + lane * kStates);
        load4(cv, cs + row * N + lane * kStates);
        const float dxb = dtt * xt;
        float sb = 0.f, sa = 0.f, v[8];
#pragma unroll
        for (int k = 0; k < kStates; ++k) {
          const float decay = exp2_approx(dtt * a2[k]);
          const float prev = j > 0 ? hist[j - 1][k] : h0[k];
          const float gh = fmaf(cv[k], dyt, r[k]);
          sb = fmaf(bv[k], gh, sb);
          const float gd = gh * prev * decay;
          sa = fmaf(gd, av[k], sa);
          da[k] = fmaf(gd, dtt, da[k]);
          r[k] = decay * gh;
          v[k] = dxb * gh;
          v[kStates + k] = dyt * hist[j][k];
        }
        psb[jj] = sb;
        psa[jj] = sa;
        dd = fmaf(dyt, xt, dd);
        scatter_sum<8, 16, G>(v, wl);
        if (writer) {
#pragma unroll
          for (int m = 0; m < M; ++m)
            rb[j * kWarps * 2 * N + red_at[m]] = v[m];
        }
      }
      // B . gh and the ddt term over the channel's G lanes: lane jj ends
      // with step grp * G + jj's
#pragma unroll
      for (int o = G / 2; o >= 1; o /= 2) {
        const bool up = lane & o;
#pragma unroll
        for (int i = 0; i < o; ++i) {
          const float sb_send = up ? psb[i] : psb[i + o];
          const float sb_keep = up ? psb[i + o] : psb[i];
          const float sa_send = up ? psa[i] : psa[i + o];
          const float sa_keep = up ? psa[i + o] : psa[i];
          psb[i] = sb_keep + __shfl_xor_sync(0xffffffffu, sb_send, o);
          psa[i] = sa_keep + __shfl_xor_sync(0xffffffffu, sa_send, o);
        }
      }
      const int j = grp * G + lane;
      const int row = r0 + j;
      const float dtt = dts[row * kChannels + g];
      const float xt = to_f32(xs[row * kChannels + g]);
      const float dyt = to_f32(dys[row * kChannels + g]);
      dxs[j * kChannels + g] = from_f32<T>(fmaf(dv, dyt, dtt * psb[0]));
      ddts[j * kChannels + g] = fmaf(xt, psb[0], psa[0]);
    }
  }
  __syncthreads();
  flush(0);
  if (live) {
#pragma unroll
    for (int k = 0; k < kStates; ++k)
      p.da_part[((long long)bi * Di + ch) * N + lane * kStates + k] = da[k];
    if (lane == 0) p.dd_part[(long long)bi * Di + ch] = dd;
  }
}

// dB and dC: the (blocks, rows, 2N) partials summed over blocks in order.
template <typename T>
__global__ void reduce_bc(const float* __restrict__ part, int blocks,
                          long long rows, int N, T* __restrict__ db,
                          T* __restrict__ dc) {
  const long long total = rows * 2 * N;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int k = 0; k < blocks; ++k) s += part[k * total + i];
  const long long r = i / (2 * N);
  const int n2 = (int)(i % (2 * N));
  if (n2 < N)
    db[r * N + n2] = from_f32<T>(s);
  else
    dc[r * N + n2 - N] = from_f32<T>(s);
}

// out[i] = sum over k < nb of part[k n + i], in order.
__global__ void reduce_rows(const float* __restrict__ part, int nb,
                            long long n, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < nb; ++k) s += part[k * n + i];
  out[i] = s;
}

constexpr int kReduceThreads = 256;

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kReduceThreads - 1) / kReduceThreads);
}

template <typename T, int N>
int launch(Args args, int B, void* db, void* dc, float* da, float* dd,
           cudaStream_t stream) {
  using L = Smem<T, N>;
  const cudaError_t e = cudaFuncSetAttribute(
      ssm_scan_bwd_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (e != cudaSuccess) return (int)e;
  const int S = args.S, Di = args.Di;
  const long long xb = (long long)S * Di;  // x, dt, dy: batch rows apart
  CUtensorMap mx{}, mdt{}, mdy{}, mb{}, mc{};
  int paths = 0, m = 0;
  if (scan::tma_ok<T>(args.x, Di, xb, kChannels)) {
    paths |= kTmaX;
    m = scan::make_map<T>(&mx, args.x, B, S, Di, Di, xb, kChannels, kSteps);
  }
  if (m == 0 && scan::tma_ok<float>(args.dt, Di, xb, kChannels)) {
    paths |= kTmaDt;
    m = scan::make_map<float>(&mdt, args.dt, B, S, Di, Di, xb, kChannels,
                              kSteps);
  }
  if (m == 0 && scan::tma_ok<T>(args.dy, Di, xb, kChannels)) {
    paths |= kTmaDy;
    m = scan::make_map<T>(&mdy, args.dy, B, S, Di, Di, xb, kChannels, kSteps);
  }
  if (m == 0 && scan::tma_ok<T>(args.bm, args.b_tstride, args.b_bstride, N)) {
    paths |= kTmaB;
    m = scan::make_map<T>(&mb, args.bm, B, S, N, args.b_tstride,
                          args.b_bstride, N, kSteps);
  }
  if (m == 0 && scan::tma_ok<T>(args.cm, args.c_tstride, args.c_bstride, N)) {
    paths |= kTmaC;
    m = scan::make_map<T>(&mc, args.cm, B, S, N, args.c_tstride,
                          args.c_bstride, N, kSteps);
  }
  if (m != 0) return m;
  if (scan::tma_ok<T>(args.dx, Di, xb, kChannels)) paths |= kVecDx;
  if (scan::tma_ok<float>(args.ddt, Di, xb, kChannels)) paths |= kVecDdt;
  args.paths = paths;
  const int nblk = (Di + kChannels - 1) / kChannels;
  const dim3 grid(nblk, B);
  ssm_scan_bwd_kernel<T, N><<<grid, kChannels * N / kStates, L::kBytes,
                              stream>>>(mx, mdt, mdy, mb, mc, args);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)B * S;
  reduce_bc<T><<<blocks_for(rows * 2 * N), kReduceThreads, 0, stream>>>(
      args.bc_part, nblk, rows, N, static_cast<T*>(db), static_cast<T*>(dc));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n_a = (long long)Di * N;
  reduce_rows<<<blocks_for(n_a), kReduceThreads, 0, stream>>>(args.da_part, B,
                                                               n_a, da);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows<<<blocks_for(Di), kReduceThreads, 0, stream>>>(args.dd_part, B,
                                                             Di, dd);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int N, const Args& args, int B, void* db, void* dc, float* da,
             float* dd, cudaStream_t s) {
  switch (N) {
    case 4:
      return launch<T, 4>(args, B, db, dc, da, dd, s);
    case 8:
      return launch<T, 8>(args, B, db, dc, da, dd, s);
    case 16:
      return launch<T, 16>(args, B, db, dc, da, dd, s);
    case 32:
      return launch<T, 32>(args, B, db, dc, da, dd, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, dy, B, C, dx, dB and dC share it;
// dt, A, D, ddt, dA and dD are float32). x, dt, dy, dx and ddt are
// contiguous (B, S, Di); A (Di, N), D (Di,), dA and dD contiguous; B and C
// read through their batch and time strides (in elements) with N
// contiguous; dB and dC contiguous (B, S, N). ws is the f32 scratch of
// repro_ssm_scan_bwd_workspace(B, S, Di, N) floats, 16-byte aligned. N is
// 4, 8, 16 or 32. Returns the first CUDA error of the four launches.
extern "C" long long repro_ssm_scan_bwd_workspace(int B, int S, int Di,
                                                  int N) {
  const long long nch = (S + kChunk - 1) / kChunk;
  const long long nblk = (Di + kChannels - 1) / kChannels;
  return (long long)B * nch * Di * N + nblk * B * S * 2 * N +
         (long long)B * Di * N + (long long)B * Di;
}

extern "C" int repro_ssm_scan_bwd(int dtype, const void* x, const float* dt,
                                  const float* a, const void* bm,
                                  const void* cm, const float* dskip,
                                  const void* dy, void* dx, float* ddt,
                                  float* da, void* db, void* dc, float* dd,
                                  float* ws, int B, int S, int Di, int N,
                                  long long b_bstride, long long b_tstride,
                                  long long c_bstride, long long c_tstride,
                                  void* stream) {
  const long long nch = (S + kChunk - 1) / kChunk;
  const long long nblk = (Di + kChannels - 1) / kChannels;
  Args args{};
  args.x = x;
  args.dt = dt;
  args.a = a;
  args.bm = bm;
  args.cm = cm;
  args.dskip = dskip;
  args.dy = dy;
  args.dx = dx;
  args.ddt = ddt;
  args.hs = ws;
  args.bc_part = args.hs + (long long)B * nch * Di * N;
  args.da_part = args.bc_part + nblk * B * S * 2 * N;
  args.dd_part = args.da_part + (long long)B * Di * N;
  args.S = S;
  args.Di = Di;
  args.b_bstride = b_bstride;
  args.b_tstride = b_tstride;
  args.c_bstride = c_bstride;
  args.c_tstride = c_tstride;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(N, args, B, db, dc, da, dd, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(N, args, B, db, dc, da, dd, s);
  return (int)cudaErrorInvalidValue;
}
