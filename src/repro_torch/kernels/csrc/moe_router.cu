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
// launches are the cost.
//
// Design. The Pallas kernel walks token blocks in order and carries the
// per-expert counters in VMEM from one block to the next. Hopper's blocks
// run in parallel and in no order, so the global rank takes two more
// passes when the call has more than one block:
//   1. route: one warp per token. Lane l holds the logits of experts
//      l, l + 32, ...; max and sum are warp butterflies. The per-lane
//      order of the sum and the xor butterfly are those of PyTorch's warp
//      softmax, so the probabilities are bit-equal to torch.softmax's on
//      the card and ties are decided on the same values. Top-k is K rounds
//      of a warp argmax on (probability, -index). After all tokens of the
//      block, warp 0 ranks the block's flat choices 32 at a time:
//      __match_any_sync groups the lanes of one expert, the rank is the
//      expert's running count in shared memory plus the popcount of the
//      group's lower lanes. It writes the in-block rank and the block's
//      per-expert counts (nblocks, E) to a scratch array. With one block
//      (decode batches) the rank is final and keep is written here.
//   2. scan: one warp per expert turns that expert's column of block
//      counts into exclusive offsets (a shuffle scan, 32 blocks a round).
//   3. finish: one thread per choice adds its block's offset for its
//      expert and writes keep.
// Blocks hold 8 warps of 1-8 tokens each (the wrapper picks the tokens a
// warp takes so that a call fills about one wave of the card's SMs).
// Non-finite logits give unspecified choices, always within [0, E).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

// (v, i) comes before (bv, bi): a larger probability, or an equal one at
// a lower expert index.
__device__ __forceinline__ bool before(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <int NPL>  // experts held per lane: E <= 32 * NPL
__global__ void __launch_bounds__(kThreads)
    moe_router_route(const float* __restrict__ logits, int T, int E, int K,
                     int capacity, int renormalize, int tpw,
                     int* __restrict__ eidx, int* __restrict__ slot,
                     float* __restrict__ weight, uint8_t* __restrict__ keep,
                     int* __restrict__ counts) {
  extern __shared__ int smem[];
  int* cnt = smem;      // [E] running count per expert in this block
  int* sel = smem + E;  // [8 * tpw * K] chosen experts, flat token-major
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bt = kWarps * tpw;
  const int t0 = blockIdx.x * bt;
  for (int e = threadIdx.x; e < E; e += kThreads) cnt[e] = 0;

  for (int r = 0; r < tpw; ++r) {
    const int tl = warp * tpw + r;  // token within the block
    const int t = t0 + tl;
    if (t >= T) break;  // uniform over the warp
    const float* row = logits + (long long)t * E;
    float p[NPL];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int e = lane + 32 * i;
      p[i] = e < E ? row[e] : -INFINITY;
      m = fmaxf(m, p[i]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      p[i] = lane + 32 * i < E ? expf(p[i] - m) : 0.f;
      s += p[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      p[i] = lane + 32 * i < E ? p[i] / s : -INFINITY;
    }

    int my_e = 0;  // lane j keeps choice j
    float my_w = 0.f, wsum = 0.f;
    for (int j = 0; j < K; ++j) {
      float bv = -INFINITY;
      int bi = 0x7fffffff;
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        if (before(p[i], lane + 32 * i, bv, bi)) {
          bv = p[i];
          bi = lane + 32 * i;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, o);
        const int oi = __shfl_xor_sync(kFull, bi, o);
        if (before(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (bi >= E) bi = 0;  // a non-finite row: keep the index in range
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        if (lane + 32 * i == bi) p[i] = -INFINITY;
      }
      if (lane == j) {
        my_e = bi;
        my_w = bv;
      }
      wsum += bv;
    }
    if (renormalize) my_w = my_w / fmaxf(wsum, 1e-9f);
    if (lane < K) {
      const long long g = (long long)t * K + lane;
      eidx[g] = my_e;
      weight[g] = my_w;
      sel[tl * K + lane] = my_e;
    }
  }
  __syncthreads();

  // in-block ranks, flat token-major, 32 choices a round
  const int n = min(bt, T - t0) * K;
  if (warp == 0) {
    for (int c = 0; c < n; c += 32) {
      const int f = c + lane;
      const int e = f < n ? sel[f] : -1;
      const unsigned peers = __match_any_sync(kFull, e);
      const int rank =
          e >= 0 ? cnt[e] + __popc(peers & ((1u << lane) - 1u)) : 0;
      __syncwarp();
      if (e >= 0 && lane == 31 - __clz(peers)) cnt[e] += __popc(peers);
      __syncwarp();
      if (f < n) {
        const long long g = (long long)t0 * K + f;
        slot[g] = rank;
        if (gridDim.x == 1) keep[g] = rank < capacity;
      }
    }
  }
  if (gridDim.x > 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < E; e += kThreads) {
      counts[(long long)blockIdx.x * E + e] = cnt[e];
    }
  }
}

// counts (nblocks, E): each expert's column of block counts becomes its
// exclusive prefix, in place. One warp per expert.
__global__ void __launch_bounds__(kThreads)
    moe_router_scan(int* __restrict__ counts, int nblocks, int E) {
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (e >= E) return;  // uniform over the warp
  int carry = 0;
  for (int b0 = 0; b0 < nblocks; b0 += 32) {
    const int b = b0 + lane;
    const long long i = (long long)b * E + e;
    const int v = b < nblocks ? counts[i] : 0;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += u;
    }
    if (b < nblocks) counts[i] = carry + incl - v;
    carry += __shfl_sync(kFull, incl, 31);
  }
}

__global__ void __launch_bounds__(kThreads)
    moe_router_finish(const int* __restrict__ eidx, int* __restrict__ slot,
                      uint8_t* __restrict__ keep, const int* __restrict__ offs,
                      long long n, int K, int bt, int E, int capacity) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= n) return;
  const long long b = g / K / bt;
  const int s = slot[g] + offs[b * E + eidx[g]];
  slot[g] = s;
  keep[g] = s < capacity;
}

template <int NPL>
void launch_route(int nblocks, size_t smem, cudaStream_t stream,
                  const float* logits, int T, int E, int K, int capacity,
                  int renormalize, int tpw, int* eidx, int* slot,
                  float* weight, uint8_t* keep, int* counts) {
  moe_router_route<NPL><<<nblocks, kThreads, smem, stream>>>(
      logits, T, E, K, capacity, renormalize, tpw, eidx, slot, weight, keep,
      counts);
}

}  // namespace

// Blocks of the route pass for T tokens at `tpw` tokens per warp.
extern "C" int repro_moe_router_blocks(int T, int tpw) {
  const int bt = kWarps * tpw;
  return (T + bt - 1) / bt;
}

// logits (T, E) f32 contiguous; eidx, slot (T, K) int32, weight (T, K)
// f32, keep (T, K) one byte each; counts: scratch of
// repro_moe_router_blocks(T, tpw) * E int32 (unused, may be null, when
// that is 1). 1 <= T, T * K < 2^31, 1 <= E <= 1024, 1 <= K <= min(32, E),
// 1 <= tpw <= 8. Returns cudaGetLastError() after the launches.
extern "C" int repro_moe_router(const void* logits, int T, int E, int K,
                                int capacity, int renormalize, int tpw,
                                void* eidx, void* slot, void* weight,
                                void* keep, void* counts, void* stream) {
  if (T < 1 || E < 1 || E > 1024 || K < 1 || K > 32 || K > E || tpw < 1 ||
      tpw > 8) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblocks = repro_moe_router_blocks(T, tpw);
  if (nblocks > 1 && counts == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * (E + kWarps * tpw * K);
  const float* x = static_cast<const float*>(logits);
  int* ei = static_cast<int*>(eidx);
  int* sl = static_cast<int*>(slot);
  float* w = static_cast<float*>(weight);
  uint8_t* kp = static_cast<uint8_t*>(keep);
  int* cn = static_cast<int*>(counts);
#define ROUTE(N)                                                         \
  launch_route<N>(nblocks, smem, s, x, T, E, K, capacity, renormalize, \
                  tpw, ei, sl, w, kp, cn)
  if (E <= 32) {
    ROUTE(1);
  } else if (E <= 64) {
    ROUTE(2);
  } else if (E <= 128) {
    ROUTE(4);
  } else if (E <= 256) {
    ROUTE(8);
  } else if (E <= 512) {
    ROUTE(16);
  } else {
    ROUTE(32);
  }
#undef ROUTE
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nblocks == 1) return (int)err;
  moe_router_scan<<<(E + kWarps - 1) / kWarps, kThreads, 0, s>>>(cn, nblocks,
                                                                 E);
  const long long n = (long long)T * K;
  moe_router_finish<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                      s>>>(ei, sl, kp, cn, n, K, kWarps * tpw, E, capacity);
  return (int)cudaGetLastError();
}
