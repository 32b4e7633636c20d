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
// Bound: operations. Each (b, t, channel) reads x, dt and dy and writes
// dx and ddt once (at falcon-mamba's training shape, B 1, S 4096, Di
// 8192, N 16, bf16: ~470 MB, ~0.14 ms at 3.35 TB/s), but every (b, t,
// channel, state) is stepped three times (the forward pass, its
// recomputation and the reverse step: ~25 f32 operations and three
// exponentials in all, the special-function units' 16 a clock per SM
// bounding the exponentials at ~0.3 ms).
//
// Choices (a simple kernel first):
// - h_{t-1} in the reverse walk: a first forward pass in this kernel
//   stores the state at the start of every chunk of kChunk = 16 steps
//   ((B, S/16, Di, N) f32 scratch: 134 MB at the shape above, written and
//   read back by the same thread); the reverse walk recomputes h inside
//   a chunk from its start state into registers (16 steps x 4 states),
//   then steps the chunk backwards. No forward variant is needed, and
//   the forward kernel stays as it is.
// - Thread layout as the forward's: a thread holds 4 states of one
//   channel (G = N / 4 lanes a channel, 32 channels a CTA, one CTA per
//   32 channels and batch row); B_t . gh_t and the ddt sum over N take a
//   butterfly of log2 G shuffles each a step; exponentials by ex2.approx
//   of dt A log2 e and the state update by one fused multiply-add, as the
//   forward rounds them, so the recomputed states are the forward's.
// - dA and dD sum over time in registers, over batch rows in a second
//   pass (a (B, Di, N) partial each). dB and dC sum over channels: a CTA
//   writes its 32 channels' terms of a chunk into shared memory, sums
//   them in channel order after a barrier and writes f32 partials
//   (Di / 32, B, S, 2N); a second kernel sums the partials over channel
//   blocks in block order. No atomics: the result is deterministic.

#include "scan_common.cuh"

namespace {

using scan::from_f32;
using scan::to_f32;

constexpr int kStates = 4;     // SSM states a thread
constexpr int kChannels = 32;  // channels a CTA
constexpr int kChunk = 16;     // steps a chunk (start states kept)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory of a CTA: a chunk's dB and dC terms, [kChunk][kChannels][2N].
template <int N>
constexpr int red_bytes() {
  return kChunk * kChannels * 2 * N * 4;
}

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
};

template <typename T, int N>
__global__ void __launch_bounds__(kChannels * N / kStates)
    ssm_scan_bwd_kernel(const Args p) {
  constexpr int G = N / kStates;
  constexpr int kThreads = kChannels * G;
  extern __shared__ float red[];
  const T* x = static_cast<const T*>(p.x);
  const T* dy = static_cast<const T*>(p.dy);
  const int S = p.S, Di = p.Di;
  const int tid = threadIdx.x;
  const int g = tid / G;     // channel within the CTA
  const int lane = tid % G;  // states lane * kStates ..
  const int ch = blockIdx.x * kChannels + g;
  const int bi = blockIdx.y;
  const bool live = ch < Di;
  const int nch = (S + kChunk - 1) / kChunk;

  float av[kStates], a2[kStates];
#pragma unroll
  for (int k = 0; k < kStates; ++k) {
    av[k] = live ? p.a[(long long)ch * N + lane * kStates + k] : 0.f;
    a2[k] = av[k] * kLog2e;
  }
  const float dv = live ? p.dskip[ch] : 0.f;
  const long long row = (long long)bi * S * Di + ch;  // x, dt, dy, dx, ddt
  const T* bb = static_cast<const T*>(p.bm) + bi * p.b_bstride + lane * kStates;
  const T* cc = static_cast<const T*>(p.cm) + bi * p.c_bstride + lane * kStates;
  const long long hstride = (long long)Di * N;  // chunk to chunk
  float* hst = p.hs + ((long long)bi * nch * Di + ch) * N + lane * kStates;

  // the forward pass: the state at the start of every chunk but the first
  // (zeros) to the scratch; the last chunk's steps are not needed
  {
    float h[kStates] = {0.f, 0.f, 0.f, 0.f};
    for (int c = 0; c < nch; ++c) {
      if (live)
        *reinterpret_cast<float4*>(hst + c * hstride) =
            make_float4(h[0], h[1], h[2], h[3]);
      if (c == nch - 1) break;
#pragma unroll 4
      for (int j = 0; j < kChunk; ++j) {
        const int t = c * kChunk + j;
        const float dtt = live ? p.dt[row + (long long)t * Di] : 0.f;
        const float dx = dtt * (live ? to_f32(x[row + (long long)t * Di]) : 0.f);
        const T* bt = bb + t * p.b_tstride;
#pragma unroll
        for (int k = 0; k < kStates; ++k)
          h[k] = fmaf(exp2_approx(dtt * a2[k]), h[k], dx * to_f32(bt[k]));
      }
    }
  }

  // the reverse walk, chunk by chunk
  float r[kStates] = {0.f, 0.f, 0.f, 0.f};  // exp(dt_{t+1} A) gh_{t+1}
  float da[kStates] = {0.f, 0.f, 0.f, 0.f};
  float dd = 0.f;
  float* part = p.bc_part + ((long long)blockIdx.x * gridDim.y + bi) * S * 2 * N;
  for (int c = nch - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    float h0[kStates] = {0.f, 0.f, 0.f, 0.f};
    if (live) {
      const float4 v = *reinterpret_cast<const float4*>(hst + c * hstride);
      h0[0] = v.x;
      h0[1] = v.y;
      h0[2] = v.z;
      h0[3] = v.w;
    }
    // h inside the chunk from its start state; steps past S keep it
    float hist[kChunk][kStates];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int t = t0 + j;
      const bool on = live && t < S;
      const float dtt = on ? p.dt[row + (long long)t * Di] : 0.f;
      const float dx = dtt * (on ? to_f32(x[row + (long long)t * Di]) : 0.f);
      const T* bt = bb + (t < S ? t : 0) * p.b_tstride;
#pragma unroll
      for (int k = 0; k < kStates; ++k) {
        const float prev = j > 0 ? hist[j - 1][k] : h0[k];
        hist[j][k] = fmaf(exp2_approx(dtt * a2[k]), prev, dx * to_f32(bt[k]));
      }
    }
    // the reverse state scan through the chunk
#pragma unroll
    for (int j = kChunk - 1; j >= 0; --j) {
      const int t = t0 + j;
      const bool in = t < S;
      const bool on = live && in;
      const long long i = row + (long long)t * Di;
      const float dtt = on ? p.dt[i] : 0.f;
      const float xt = on ? to_f32(x[i]) : 0.f;
      const float dyt = on ? to_f32(dy[i]) : 0.f;
      const T* bt = bb + (in ? t : 0) * p.b_tstride;
      const T* ct = cc + (in ? t : 0) * p.c_tstride;
      float sb = 0.f, sa = 0.f, gh[kStates];
#pragma unroll
      for (int k = 0; k < kStates; ++k) {
        const float decay = exp2_approx(dtt * a2[k]);
        const float prev = j > 0 ? hist[j - 1][k] : h0[k];
        gh[k] = fmaf(in ? to_f32(ct[k]) : 0.f, dyt, r[k]);
        sb = fmaf(in ? to_f32(bt[k]) : 0.f, gh[k], sb);
        const float gd = gh[k] * prev * decay;
        sa = fmaf(gd, av[k], sa);
        da[k] = fmaf(gd, dtt, da[k]);
        r[k] = decay * gh[k];
      }
#pragma unroll
      for (int o = 1; o < G; o *= 2) {
        sb += __shfl_xor_sync(0xffffffffu, sb, o);
        sa += __shfl_xor_sync(0xffffffffu, sa, o);
      }
      if (lane == 0 && on) {
        static_cast<T*>(p.dx)[i] = from_f32<T>(fmaf(dv, dyt, dtt * sb));
        p.ddt[i] = fmaf(xt, sb, sa);
      }
      dd = fmaf(dyt, xt, dd);
      const float dxb = dtt * xt;
      float* rr = red + (j * kChannels + g) * 2 * N + lane * kStates;
      *reinterpret_cast<float4*>(rr) =
          make_float4(dxb * gh[0], dxb * gh[1], dxb * gh[2], dxb * gh[3]);
      *reinterpret_cast<float4*>(rr + N) =
          make_float4(dyt * hist[j][0], dyt * hist[j][1], dyt * hist[j][2],
                      dyt * hist[j][3]);
    }
    __syncthreads();
    // the chunk's dB and dC terms summed over the CTA's channels in order
    for (int o = tid; o < kChunk * 2 * N; o += kThreads) {
      const int j = o / (2 * N);
      const int n2 = o % (2 * N);
      if (t0 + j < S) {
        float s = 0.f;
#pragma unroll 8
        for (int q = 0; q < kChannels; ++q)
          s += red[(j * kChannels + q) * 2 * N + n2];
        part[(long long)(t0 + j) * 2 * N + n2] = s;
      }
    }
    __syncthreads();
  }
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
int launch(const Args& args, int B, void* db, void* dc, float* da, float* dd,
           cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      ssm_scan_bwd_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      red_bytes<N>());
  if (e != cudaSuccess) return (int)e;
  const int nblk = (args.Di + kChannels - 1) / kChannels;
  const dim3 grid(nblk, B);
  ssm_scan_bwd_kernel<T, N>
      <<<grid, kChannels * N / kStates, red_bytes<N>(), stream>>>(args);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)B * args.S;
  reduce_bc<T><<<blocks_for(rows * 2 * N), kReduceThreads, 0, stream>>>(
      args.bc_part, nblk, rows, N, static_cast<T*>(db), static_cast<T*>(dc));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n_a = (long long)args.Di * N;
  reduce_rows<<<blocks_for(n_a), kReduceThreads, 0, stream>>>(args.da_part, B,
                                                               n_a, da);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows<<<blocks_for(args.Di), kReduceThreads, 0, stream>>>(
      args.dd_part, B, args.Di, dd);
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
