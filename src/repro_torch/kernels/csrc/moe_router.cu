// MoE router for Hopper (sm_90a): softmax gating, top-k and capacity slots.
//
// Replaces the TPU kernel `moe_router` / `_router_kernel` of
// src/repro/kernels/moe_dispatch.py (pallas_call at :144). Same function:
// from router logits (T, E) f32, for every token the f32 softmax over the
// E experts, the K largest probabilities (equal ones lower expert index
// first), their weights (optionally renormalised by max(sum, 1e-9)), the
// capacity slot of each (token, choice) -- its exclusive rank among the
// choices of the same expert in flat token-major order over the whole
// call -- and keep = slot < capacity. Outputs expert_idx, slot (int32),
// weight (f32) and keep (bool as one byte), each (T, K). Any T >= 1
// (the Pallas kernel needs T % block_t == 0), E <= 1024, K <= min(32, E).
//
// Bound: bytes. The logits are read once (4 T E bytes) and 13 bytes are
// written per choice: at kimi-k2's 128-token prefill (E 384, K 8) that
// is 209,920 bytes, 0.063 us at 3.35 TB/s, so at serving sizes the
// launch and the chain of one token's work are the cost.
//
// Design: one launch per call. The Pallas kernel walks token blocks in
// order and carries the per-expert counters in VMEM from one block to
// the next; here CTAs run at once, and the wrapper picks one of three
// plans from T and the SM count (moe_router.py: plan):
//   one CTA   (decode batches), a token a warp: a token's K experts are
//             distinct, so a choice's slot is the number of lower warps
//             whose token chose its expert: one bit a warp in a mask per
//             expert in shared memory (atomicOr), one __syncthreads, a
//             popcount;
//   cluster   (short prefills), one thread-block cluster of up to 16
//             CTAs, a token a warp: the same masks, a cluster
//             barrier, and each choice also counts its expert's bits in
//             the masks of the lower-ranked CTAs through distributed
//             shared memory;
//   grid      (long prefills): a cooperative launch of at most one wave,
//             `tpw` tokens a warp. Each warp ranks its choices against its
//             own per-expert counts in shared memory, an exclusive scan
//             over the warps gives each warp's offset within the CTA, the
//             CTA's counts go to its row of a scratch, and after a grid
//             barrier each CTA sums the rows before its own. The choices
//             wait, packed as (rank << 10 | expert), in shared memory (or
//             in the slot output, when they do not fit) until then.
// None of the plans needs zeroed memory from the host or a second launch.
// Lane l holds the logits of experts l, l + 32, ...; max and sum are warp
// butterflies. The per-lane order of the sum, the xor butterfly, expf and
// the IEEE division are those of PyTorch's warp softmax, so the
// probabilities are bit-equal to torch.softmax's on the card and ties are
// decided on the same values. Top-k works on keys, key = the
// probability's bits + 1 (a non-negative float orders like an unsigned
// int; 0 marks a padded value), packed with the expert as key << 32 |
// (1023 - expert) so that one comparison applies the tie rule. Each lane
// keeps its best two values; a round is a max butterfly on the lanes'
// best keys and a ballot (a shuffle brings the winner's expert; equal
// keys in several lanes take a second butterfly on the packed words);
// the winning lane moves to its second, and rescans its values (below
// the one taken) only on every second win. The next token's logits load
// while a token is routed where a warp routes several (the grid plan).
// Non-finite logits give unspecified choices, always distinct and within
// [0, E).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxWarps = 32;
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr int kMaxCluster = 16;
constexpr int kSmemMax = 232448;  // 227 KB, the most a block may use
constexpr int kSmemDefault = 49152;  // usable without an opt-in
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
enum : int { kCta = 0, kCluster = 1, kGrid = 2 };

struct Args {
  const float* logits;
  int* eidx;
  int* slot;
  float* weight;
  uint8_t* keep;
  int* counts;  // grid: (gridDim.x, E) scratch
  int T, E, K, capacity, renormalize, tpw, stage_smem;
};

template <int NPL>
__device__ __forceinline__ void load_row(float (&x)[NPL], const float* row,
                                         int E, int lane) {
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int e = lane + 32 * i;
    x[i] = e < E ? __ldg(row + e) : -INFINITY;
  }
}

// A (key, expert) pair as one 64-bit word, key << 32 | (1023 - expert):
// the larger word is the larger key, or an equal key at a lower expert.
__device__ __forceinline__ unsigned long long pack(unsigned key, int e) {
  return (unsigned long long)key << 32 | (unsigned)(1023 - e);
}

__device__ __forceinline__ int expert(unsigned long long packed) {
  return 1023 - (int)(unsigned)packed;
}

__device__ __forceinline__ unsigned long long umax(unsigned long long a,
                                                  unsigned long long b) {
  return a > b ? a : b;
}

// The best two of this lane's values below `ceil` (key[i] holds expert
// lane + 32 i), as packed words.
template <int NPL>
__device__ __forceinline__ void lane_top2(const unsigned (&key)[NPL], int lane,
                                          unsigned long long ceil,
                                          unsigned long long& b1,
                                          unsigned long long& b2) {
  b1 = 0ull;
  b2 = 0ull;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const unsigned long long c = pack(key[i], lane + 32 * i);
    if (c < ceil) {
      if (c > b1) {
        b2 = b1;
        b1 = c;
      } else if (c > b2) {
        b2 = c;
      }
    }
  }
}

// Softmax and top-k of the token whose logits the warp holds in x
// (-inf past E); lane j < K gets choice j (expert and weight).
template <int NPL>
__device__ __forceinline__ void route_token(const float (&x)[NPL], int E,
                                            int K, int renormalize, int lane,
                                            int& my_e, float& my_w) {
  float p[NPL];
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    p[i] = x[i];
    m = fmaxf(m, p[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    p[i] = expf(p[i] - m);  // 0 past E: no branch around expf
    s += p[i];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  unsigned key[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const unsigned bits = min(__float_as_uint(p[i] / s), 0xfffffffeu) + 1u;
    key[i] = lane + 32 * i < E ? bits : 0u;
  }
  // b1: this lane's best live value; b2: its second, while have2
  unsigned long long b1, b2;
  lane_top2(key, lane, ~0ull, b1, b2);
  bool have2 = true;
  my_e = 0;
  my_w = 0.f;
  float wsum = 0.f;
  for (int j = 0; j < K; ++j) {
    // K <= E live keys, all >= 1: the winner is live and within [0, E)
    const unsigned k1 = (unsigned)(b1 >> 32);
    unsigned mk = k1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mk = max(mk, __shfl_xor_sync(kFull, mk, o));
    }
    const unsigned tie = __ballot_sync(kFull, k1 == mk);
    int wl, wi;
    if (__popc(tie) == 1) {
      wl = __ffs(tie) - 1;
      wi = expert(__shfl_sync(kFull, (unsigned)b1, wl));
    } else {  // equal keys in several lanes: the lowest expert of them
      unsigned long long win = k1 == mk ? b1 : 0ull;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        win = umax(win, __shfl_xor_sync(kFull, win, o));
      }
      wi = expert(win);
      wl = wi & 31;
    }
    const float w = __uint_as_float(mk - 1u);
    if (lane == j) {
      my_e = wi;
      my_w = w;
    }
    wsum += w;
    if (lane == wl && j + 1 < K) {  // the winning lane's next best
      if (have2) {
        b1 = b2;
      } else {
        lane_top2(key, lane, b1, b1, b2);
      }
      have2 = !have2;
    }
  }
  if (renormalize) my_w = my_w / fmaxf(wsum, 1e-9f);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// One CTA or one cluster, a token a warp: the K experts of a warp's token
// are distinct, so a choice's rank is the number of lower warps (and, in
// a cluster, of lower CTAs' warps) whose token chose the same expert.
// Shared memory: mask [E], bit w set when warp w's token chose the expert.
template <int NPL, int MODE>
__device__ __forceinline__ void route_by_masks(const Args& a, int lane,
                                               int warp, float (&x)[NPL]) {
  extern __shared__ int smem[];
  unsigned* mask = reinterpret_cast<unsigned*>(smem);
  const int E = a.E, K = a.K;
  const long long t = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  for (int e = threadIdx.x; e < E; e += blockDim.x) mask[e] = 0u;
  __syncthreads();
  int my_e = 0;
  float my_w;
  if (t < a.T) {  // uniform over the warp
    route_token(x, E, K, a.renormalize, lane, my_e, my_w);
    if (lane < K) {
      a.eidx[t * K + lane] = my_e;
      a.weight[t * K + lane] = my_w;
      atomicOr(mask + my_e, 1u << warp);
    }
  }
  int s = 0;
  if constexpr (MODE == kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every CTA's masks are complete
    if (t < a.T && lane < K) {
      const int me = (int)cluster.block_rank();
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) {  // all loads in flight at once
        if (q < me) s += __popc(cluster.map_shared_rank(mask, q)[my_e]);
      }
    }
    cluster_arrive();  // no more reads of the other CTAs' shared memory
  } else {
    __syncthreads();
  }
  if (t < a.T && lane < K) {
    s += __popc(mask[my_e] & ((1u << warp) - 1u));
    a.slot[t * K + lane] = s;
    a.keep[t * K + lane] = s < a.capacity;
  }
  if constexpr (MODE == kCluster) cluster_wait();  // others may still read
}

// A cooperative grid, `tpw` tokens a warp. Each warp ranks its choices
// against its own per-expert counts; an exclusive scan over the warps
// gives each warp's offset within the CTA; each CTA's counts go to its
// row of the scratch, and after a grid barrier each CTA sums the rows
// before its own. Shared memory: wcnt [W][E] (each warp's count per
// expert, then its offset), off [E] (the CTA's offset per expert), then
// the staged choices [W tpw K] when they fit.
template <int NPL>
__device__ __forceinline__ void route_by_counts(const Args& a, int lane,
                                                int warp, float (&x)[NPL]) {
  extern __shared__ int smem[];
  constexpr bool kAhead = NPL <= 16;  // registers for the next row too
  const int W = blockDim.x >> 5, E = a.E, K = a.K;
  int* wcnt = smem;
  int* off = wcnt + W * E;
  const long long t0 = (long long)blockIdx.x * W * a.tpw;
  int* stage = a.stage_smem ? off + E : a.slot + t0 * K;
  const int r0 = warp * a.tpw;
  const int nr = (int)max(0LL, min((long long)a.tpw, a.T - t0 - r0));
  const float* row = a.logits + (t0 + r0) * (long long)E;
  int* cnt = wcnt + warp * E;
  for (int e = lane; e < E; e += 32) cnt[e] = 0;
  for (int e = threadIdx.x; e < E; e += blockDim.x) off[e] = 0;
  __syncwarp();

  for (int r = 0; r < nr; ++r) {
    float next[kAhead ? NPL : 1];
    if constexpr (kAhead) {
      if (r + 1 < nr) load_row(next, row + (long long)(r + 1) * E, E, lane);
    } else if (r > 0) {
      load_row(x, row + (long long)r * E, E, lane);
    }
    int my_e;
    float my_w;
    route_token(x, E, K, a.renormalize, lane, my_e, my_w);
    if constexpr (kAhead) {
#pragma unroll
      for (int i = 0; i < NPL; ++i) x[i] = next[i];
    }
    if (lane < K) {
      const long long g = (t0 + r0 + r) * K + lane;
      a.eidx[g] = my_e;
      a.weight[g] = my_w;
      const int rank = cnt[my_e];  // the token's K experts are distinct
      cnt[my_e] = rank + 1;
      stage[(r0 + r) * K + lane] = rank << 10 | my_e;
    }
    __syncwarp();
  }
  __syncthreads();

  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    int run = 0;
#pragma unroll 8
    for (int w = 0; w < W; ++w) {
      const int c = wcnt[w * E + e];
      wcnt[w * E + e] = run;
      run += c;
    }
    __stcg(a.counts + (long long)blockIdx.x * E + e, run);
  }
  cg::this_grid().sync();
  // the rows before this CTA's, nslice threads an expert
  const int nslice = max(1, (int)blockDim.x / E);
  for (int i = threadIdx.x; i < nslice * E; i += blockDim.x) {
    const int e = i % E;
    int o = 0;
#pragma unroll 8
    for (int b = i / E; b < (int)blockIdx.x; b += nslice) {
      o += __ldcg(a.counts + (long long)b * E + e);
    }
    if (o) atomicAdd(off + e, o);
  }
  __syncthreads();

  for (int c = lane; c < nr * K; c += 32) {  // this warp's choices
    const int f = r0 * K + c;
    const unsigned v = (unsigned)stage[f];
    const int e = (int)(v & 1023u);
    const int s = (int)(v >> 10) + wcnt[warp * E + e] + off[e];
    a.slot[t0 * K + f] = s;
    a.keep[t0 * K + f] = s < a.capacity;
  }
}

template <int NPL, int MODE>
__global__ void __launch_bounds__(kMaxThreads, 1)
    moe_router_kernel(const Args a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the warp's first row, in flight while the counts clear
  const long long t = (long long)blockIdx.x * blockDim.x / 32 * a.tpw +
                      (long long)warp * a.tpw;
  float x[NPL];
  if (t < a.T) load_row(x, a.logits + t * a.E, a.E, lane);
  if constexpr (MODE == kGrid) {
    route_by_counts<NPL>(a, lane, warp, x);
  } else {
    route_by_masks<NPL, MODE>(a, lane, warp, x);
  }
}

// Once per device and kernel: shared memory above 48 KB, set only once a
// launch needs it, and clusters of 16 for the cluster kernels.
template <int NPL, int MODE>
cudaError_t prepare(size_t smem) {
  static bool done[kMaxDevices][2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  auto* k = moe_router_kernel<NPL, MODE>;
  if (MODE == kCluster && !done[dev][0]) {
    err = cudaFuncSetAttribute(
        k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    done[dev][0] = true;
  }
  if (smem > kSmemDefault && !done[dev][1]) {
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemMax);
    if (err != cudaSuccess) return err;
    done[dev][1] = true;
  }
  return cudaSuccess;
}

template <int NPL, int MODE>
cudaError_t launch(const Args& a, int ctas, int warps, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = prepare<NPL, MODE>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (MODE == kCluster) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  } else if (MODE == kGrid) {
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cudaLaunchKernelEx(&cfg, moe_router_kernel<NPL, MODE>, a);
}

template <int NPL>
cudaError_t launch_mode(int mode, const Args& a, int ctas, int warps,
                        size_t smem, cudaStream_t stream) {
  if (mode == kCta) return launch<NPL, kCta>(a, ctas, warps, smem, stream);
  if (mode == kCluster) {
    return launch<NPL, kCluster>(a, ctas, warps, smem, stream);
  }
  return launch<NPL, kGrid>(a, ctas, warps, smem, stream);
}

}  // namespace

// The largest cluster (16, 8, 4, 2 or 1 CTAs) of `warps` warps each that
// the current device can hold. A CTA of 32 warps fills an SM's registers,
// so its shared memory does not change the answer.
extern "C" int repro_moe_router_max_cluster(int warps) {
  if (warps < 1 || warps > kMaxWarps) return 1;
  if (prepare<12, kCluster>(0) != cudaSuccess) {
    cudaGetLastError();
    return 1;
  }
  for (int c = kMaxCluster; c > 1; c /= 2) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c);
    cfg.blockDim = dim3(32 * warps);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, moe_router_kernel<12, kCluster>,
                                       &cfg) == cudaSuccess &&
        n > 0) {
      return c;
    }
    cudaGetLastError();
  }
  return 1;
}

// logits (T, E) f32 contiguous. `out` holds n = T K int32 words of each
// output in turn: expert_idx, slot, weight (f32), then, in the grid mode
// only, a scratch of ctas E int32; keep: n bytes (bool). The plan: `mode`
// 0 (one CTA) or 1 (one cluster of `ctas` <= 16 CTAs), a token a warp
// (`tpw` 1), or 2 (a cooperative grid of `ctas` CTAs, one wave, `tpw`
// tokens a warp); `warps` <= 32 warps a CTA; CTA b routes tokens
// [b warps tpw, (b + 1) warps tpw). 1 <= T <= ctas warps tpw,
// T K < 2^31, 1 <= E <= 1024, 1 <= K <= min(32, E). Returns the launch's
// CUDA error.
extern "C" int repro_moe_router(const void* logits, int T, int E, int K,
                                int capacity, int renormalize, int mode,
                                int ctas, int warps, int tpw, void* out,
                                void* keep, void* stream) {
  if (T < 1 || E < 1 || E > 1024 || K < 1 || K > 32 || K > E ||
      mode < kCta || mode > kGrid || ctas < 1 || warps < 1 ||
      warps > kMaxWarps || tpw < 1 || tpw >= (1 << 22) ||
      (long long)ctas * warps * tpw < T || (long long)T * K >= (1LL << 31) ||
      (mode != kGrid && tpw != 1) || (mode == kCta && ctas != 1) ||
      (mode == kCluster && ctas > kMaxCluster)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n = (long long)T * K;
  int* base = static_cast<int*>(out);
  Args a;
  a.logits = static_cast<const float*>(logits);
  a.eidx = base;
  a.slot = base + n;
  a.weight = reinterpret_cast<float*>(base + 2 * n);
  a.keep = static_cast<uint8_t*>(keep);
  a.counts = mode == kGrid ? base + 3 * n : nullptr;
  a.T = T;
  a.E = E;
  a.K = K;
  a.capacity = capacity;
  a.renormalize = renormalize;
  a.tpw = tpw;
  size_t smem = 4 * (size_t)E;  // one CTA, a cluster: the masks
  a.stage_smem = 0;
  if (mode == kGrid) {
    const long long words = (long long)(warps + 1) * E;
    const long long staged = (long long)warps * tpw * K;
    a.stage_smem = 4 * (words + staged) <= kSmemMax;
    smem = 4 * (words + (a.stage_smem ? staged : 0));
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define GO(N) err = launch_mode<N>(mode, a, ctas, warps, smem, s)
  if (E <= 32) {
    GO(1);
  } else if (E <= 64) {
    GO(2);
  } else if (E <= 128) {
    GO(4);
  } else if (E <= 256) {
    GO(8);
  } else if (E <= 384) {
    GO(12);
  } else if (E <= 512) {
    GO(16);
  } else {
    GO(32);
  }
#undef GO
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
