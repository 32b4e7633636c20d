// Flash-attention forward with the row log-sum-exp, for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention` / `_fa_kernel` of
// src/repro/kernels/flash_attention.py (kernel :36, wrapper :117,
// pallas_call :167). Same function: q (B, Hq, Sq, D) against k, v
// (B, Hkv, Sk, D), q head h reading KV head h / (Hq / Hkv), scores
// (q . k) * scale in f32 under the causal / window mask of `_mask` with q
// and k positions both counted from 0, the online softmax with its running
// max m and sum l, and out = acc / l (out = 0 where a row sees no key) in
// q's dtype; lse = m + log(l) in f32 (-1e30 where a row sees no key).
//
// Bound: operations. At the training shape (B 2, Hq 32, Hkv 8, S 2048,
// D 128, causal) the two products take 4 * D flops per visible (q, k) pair,
// 68.7 GFLOP, against 84 MB of q, k, v, out and lse: about 820 flop per byte,
// far above the ~295 at which the H100's bf16 tensor cores stop waiting on
// memory. Least time 69.52 us at 989 TFLOP/s (bf16), 1.03 ms at 67 TFLOP/s
// (f32 outside the tensor cores).
//
// What the design does about it. bf16 runs on the tensor cores, in a
// persistent kernel: one CTA per SM (fewer when there are fewer work
// tiles) of three warpgroups walks work tiles (q block of 128, q head,
// batch), the late q blocks (the most causal work) first, in a fixed
// snake: CTA i takes tiles i, 2G - 1 - i, 2G + i, ... of the G CTAs' rounds,
// so that the long tiles of one round meet short ones in the next. (It
// balances the causal training shape as well as a global counter drawn
// at run time, and needs no state between launches.) A producer warpgroup
// (one thread, 40 registers after setmaxnreg) asks TMA for the next tile's
// q into a free q slot, then for each KV block of 128 rows the q block
// can see (a contiguous run: the mask is a band; blocks the mask hides
// whole are never loaded) into two k slots and two v slots, swizzled as
// wgmma reads them, out-of-range rows zero-filled. It runs ahead across
// tiles: the next tile's q and first k and v land while the consumers
// finish this one, so no tile starts with the tensor cores waiting on a
// load. mbarriers say when a slot has landed and when the consumers are
// done with it; their phases follow running counts of tiles and KV blocks.
// k and v have barriers of their own, because k is done with one product
// before v: with two slots each, a load has about one step to land. Two
// consumer warpgroups (232 registers) own 64 q rows each: S = q . k^T by
// wgmma m64n128k16 from shared memory into f32 registers, times scale
// there (q is not rounded after scaling), the mask only on blocks it or
// the ragged edge cuts, the online softmax in f32, p rounded to bf16 and
// fed from registers as A of out += p . v (wgmma m64nDk16, v read
// MN-major). A step issues its block's S and the previous block's p . v
// together and runs its softmax while p . v is on the tensor cores; the
// consumers take turns to issue (named barriers), so that one's softmax
// also overlaps the other's products, and their turns run on across tile
// boundaries, so that one's epilogue overlaps the other's last product.
// The output leaves by TMA store from the warpgroup's rows of its q slot
// (nothing else reads them by then); the slot takes a later tile's q once
// TMA has read them, which the storing thread checks only at its next
// tile's first product, so no warpgroup waits on a store. Two q slots, not
// one, so that the next q never waits on a store: q 2 x 32 KB + k 2 x 32
// KB + v 2 x 32 KB = 192 KB of shared memory at D 128 (three k and v
// stages beside two q slots would need 256). Blocks the mask cuts compare
// each score with the band of key positions its row sees.
// f32 keeps the SIMT kernel: one CTA per (q block of 64, q head, batch),
// scaled q in shared memory, a 4 x 4 block of scores and a 4 x (D / 16)
// block of the accumulator per thread, f32 FMAs (TF32 would miss the f32
// tolerance).

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

namespace flash {
namespace {

// f32 on the SIMT cores (the header's last paragraph).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ out,
               float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk,
               float scale, int causal, int window) {
  constexpr int DP = D + 1;
  constexpr int BP = kBlock + 1;
  constexpr int NJ = D / 16;
  const int q0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  extern __shared__ float smem[];
  float* q_s = smem;                 // (64, D + 1): q * scale
  float* k_s = q_s + kBlock * DP;    // (64, D + 1)
  float* v_s = k_s + kBlock * DP;    // (64, D + 1)
  float* p_s = v_s + kBlock * DP;    // (64, 64 + 1): this block's p

  const size_t qoff = ((size_t)b * Hq + h) * Sq * D;
  const size_t koff = ((size_t)b * Hkv + hk) * Sk * D;
  load_tile<T, D>(q_s, q + qoff, q0, Sq, scale);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int q1 = min(q0 + kBlock, Sq);
  const int nk = (Sk + kBlock - 1) / kBlock;
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * kBlock;
    if (block_hidden(q0, q1, k0, min(k0 + kBlock, Sk), causal, window))
      continue;
    __syncthreads();  // the previous block's readers are done with k, v, p
    load_tile<T, D>(k_s, k + koff, k0, Sk, 1.f);
    load_tile<T, D>(v_s, v + koff, k0, Sk, 1.f);
    __syncthreads();
    float s[4][4] = {};
    dot_nt<D>(q_s, k_s, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool vis[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        vis[j] = qpos < Sq && kpos < Sk && visible(qpos, kpos, causal, window);
        if (!vis[j]) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // rows with no visible key keep m == -1e30; exp() there must be 0
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[(ty + 16 * i) * BP + tx + 16 * j] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    acc_nn<D, false>(p_s, v_s, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      out[qoff + (size_t)r * D + tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
    if (tx == 0) lse[((size_t)b * Hq + h) * Sq + r] = m[i] + logf(denom);
  }
}

// bf16 on the tensor cores (the header's design).
constexpr int kTcM = 128;  // q rows per work tile: two consumer warpgroups
constexpr int kTcN = 128;  // kv rows per tile
constexpr int kTcThreads = 384;  // the two consumers and a producer warpgroup
// registers per thread after setmaxnreg: 2 x 128 x 232 + 128 x 40 <= 65,536
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;

template <int D>
struct FwdSmem {
  static constexpr int kQ = kTcM * D * 2;   // a q tile (out leaves from it)
  static constexpr int kKV = kTcN * D * 2;  // a k or a v tile
  static constexpr int kK = 2 * kQ;         // two q slots, two k, two v
  static constexpr int kV = kK + 2 * kKV;
  static constexpr int kBars = kV + 2 * kKV;
  // six pairs of mbarriers (q, k, v: full and empty), and 1 KB to align
  // the start
  static constexpr int kBytes = kBars + 12 * 8 + 1024;
};

// The online softmax of one step for one thread: its scores s of rows
// row0 and row0 + 8 (s[4j + 2h + e] is row row0 + 8h, column k0 + 8j +
// col + e) masked where the block needs it, the running max m (of scores
// times scale) moved, p = exp(s * scale - m) in s, alpha = exp(m_old - m)
// for the old sums, sum = the thread's row sums of p.
template <int NS>
__device__ __forceinline__ void online_softmax(
    float (&s)[NS], float (&m)[2], float (&alpha)[2], float (&sum)[2],
    int k0, int row0, int col, int q0, int Sq, int Sk, float scale,
    int causal, int window) {
  if (!block_full(q0, kTcM, k0, kTcN, Sq, Sk, causal, window)) {
    // `visible` as a band [lo, hi] of key positions per row (empty past
    // Sq), taken relative to the thread's first column, so that each score
    // compares with a constant
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      int hi = Sk - 1;
      if (causal)
        hi = min(hi, r);
      else if (window >= 0)
        hi = min(hi, r + window - 1);
      const int lo_rel = (window >= 0 ? r - window + 1 : 0) - (k0 + col);
      const int hi_rel = r < Sq ? hi - (k0 + col) : -1;
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * j + e < lo_rel || 8 * j + e > hi_rel)
            s[4 * j + 2 * h + e] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY}, ml[2];
#pragma unroll
  for (int i = 0; i < NS; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // a row with no visible key keeps m = -1e30, and its p are exp(-inf)
    const float mn = fmaxf(m[r], mx[r] * scale);
    alpha[r] = tc::exp2_approx((m[r] - mn) * tc::kLog2e);
    m[r] = mn;
    ml[r] = mn * tc::kLog2e;
    sum[r] = 0.f;
  }
  const float sl = scale * tc::kLog2e;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    s[i] = tc::exp2_approx(fmaf(s[i], sl, -ml[(i >> 1) & 1]));
    sum[(i >> 1) & 1] += s[i];
  }
}


// The j-th work tile of this CTA: a stride over the tiles by the grid,
// reversed on odd rounds (a snake), so that a CTA that took a long tile in
// one round takes a short one in the next.
__device__ __forceinline__ int cta_tile(int j) {
  return j * gridDim.x +
         (j % 2 ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

// A work tile's place: q block nq - 1 - t / (B Hq) (the late blocks, with
// the most causal work, come first), head t % (B Hq), and the run of kv
// blocks [kb_lo, kb_lo + nkv) that the mask leaves visible to it (a band:
// blocks the mask hides whole are never loaded).
struct Work {
  int q0, b, h, kb_lo, nkv;
};

__device__ __forceinline__ Work work_tile(int t, int nq, int B, int Hq,
                                          int Sq, int Sk, int causal,
                                          int window) {
  Work w;
  const int heads = B * Hq;
  w.q0 = (nq - 1 - t / heads) * kTcM;
  w.h = t % heads % Hq;
  w.b = t % heads / Hq;
  const int q1 = min(w.q0 + kTcM, Sq);
  const int nk = (Sk + kTcN - 1) / kTcN;
  int lo = nk, hi = -1;
  for (int kb = 0; kb < nk; ++kb) {
    if (!block_hidden(w.q0, q1, kb * kTcN, min(kb * kTcN + kTcN, Sk), causal,
                      window)) {
      lo = min(lo, kb);
      hi = kb;
    }
  }
  w.kb_lo = lo;
  w.nkv = max(hi - lo + 1, 0);
  return w;
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_o,
                    float* __restrict__ lse, int B, int Hq, int Hkv, int Sq,
                    int Sk, float scale, int causal, int window) {
  using L = tc::Tile<D>;
  using S = FwdSmem<D>;
  constexpr int NO = D / 2;     // accumulator floats per thread (64 x D)
  constexpr int NS = kTcN / 2;  // score floats per thread (64 x 128)
  constexpr int NP = kTcN / 16;  // A fragments of p
  const int nq = (Sq + kTcM - 1) / kTcM;
  const int n_tiles = nq * B * Hq;
  const int tid = threadIdx.x;
  const int wg = tid / 128;  // 0, 1: consumers; 2: the producer
  const int lane = tid % 32;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = tc::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* base_p = smem_raw + (base - raw);
  // q slot j % 2 holds work tile j; kv block n (counted over all of this
  // CTA's tiles) lands in k and v slot n % 2
  auto q_tile = [&](int slot) { return base + slot * S::kQ; };
  auto k_tile = [&](int n) { return base + S::kK + (n & 1) * S::kKV; };
  auto v_tile = [&](int n) { return base + S::kV + (n & 1) * S::kKV; };
  // mbarrier `kind` of slot s: kQFull (q has landed),
  // kQEmpty (both consumers' output stores have read the slot), kKFull,
  // kKEmpty and kVFull, kVEmpty (the 8 consumer warps are done with it)
  enum { kQFull, kQEmpty, kKFull, kKEmpty, kVFull, kVEmpty };
  auto bar = [&](int kind, int s) {
    return base + S::kBars + 8 * (2 * kind + (s & 1));
  };

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      tc::mbar_init(bar(kQFull, s), 1);
      tc::mbar_init(bar(kQEmpty, s), 2);
      tc::mbar_init(bar(kKFull, s), 1);
      tc::mbar_init(bar(kKEmpty, s), 8);
      tc::mbar_init(bar(kVFull, s), 1);
      tc::mbar_init(bar(kVEmpty, s), 8);
    }
    tc::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // The producer: one thread asks TMA for the q of the CTA's next work
    // tile once its slot is free, then for each kv block into the next k
    // and v slots once the consumers have released them; it runs ahead of
    // the consumers across tiles.
    tc::regs_dec<kProducerRegs>();
    if (tid == 256) {
      int n = 0;
      for (int j = 0;; ++j) {
        const int t = cta_tile(j);
        if (t >= n_tiles) break;
        if (j >= 2) tc::mbar_wait(bar(kQEmpty, j), ((j >> 1) - 1) & 1);
        const Work w = work_tile(t, nq, B, Hq, Sq, Sk, causal, window);
        const int kv = w.b * Hkv + w.h / (Hq / Hkv);
        tc::mbar_expect(bar(kQFull, j), S::kQ);
        tc::tma_tile<D, kTcM>(q_tile(j & 1), &tm_q, w.q0, w.b * Hq + w.h,
                              bar(kQFull, j));
        for (int it = 0; it < w.nkv; ++it, ++n) {
          const int k0 = (w.kb_lo + it) * kTcN;
          if (n >= 2) tc::mbar_wait(bar(kKEmpty, n), ((n >> 1) - 1) & 1);
          tc::mbar_expect(bar(kKFull, n), S::kKV);
          tc::tma_tile<D, kTcN>(k_tile(n), &tm_k, k0, kv, bar(kKFull, n));
          if (n >= 2) tc::mbar_wait(bar(kVEmpty, n), ((n >> 1) - 1) & 1);
          tc::mbar_expect(bar(kVFull, n), S::kKV);
          tc::tma_tile<D, kTcN>(v_tile(n), &tm_v, k0, kv, bar(kVFull, n));
        }
      }
    }
  } else {
    tc::regs_inc<kConsumerRegs>();
    // Warpgroup wg owns rows [64 wg, 64 wg + 64) of each work tile; this
    // thread rows rloc and rloc + 8, columns 8j + col + {0, 1}.
    const int rloc = 64 * wg + 16 * ((tid % 128) / 32) + lane / 4;
    const int col = 2 * (lane % 4);
    // s = q . k^T of kv block n, issued and committed (not waited)
    auto scores = [&](float (&s)[NS], uint32_t q_s, int n) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        tc::mma_ss<kTcN, 0>(s, tc::desc_k<D>(q_s, kTcM, 64 * wg, kk),
                            tc::desc_k<D>(k_tile(n), kTcN, 0, kk), kk);
      tc::mma_commit();
    };
    // o += p . v of kv block n, issued and committed (not waited)
    auto accumulate = [&](float (&o)[NO], const uint32_t (&p)[NP][4],
                          int n) {
#pragma unroll
      for (int t = 0; t < NP; ++t)
        tc::mma_rs<D, 1>(o, p[t], tc::desc_mn<D>(v_tile(n), kTcN, t), 1);
      tc::mma_commit();
    };
    // The warpgroups take turns to issue their products (barriers 1 and
    // 2), so that one's softmax runs while the other's products are on the
    // tensor cores. Both run the same tiles, so their turns alternate
    // across tile boundaries too: warpgroup 1 opens the first turn once,
    // and warpgroup 0 takes its last arrival (or that opening one) before
    // the CTA ends. No branch lies between a product's issue and its wait:
    // ptxas would serialise every product.
    auto turn_begin = [&]() { tc::bar_sync(1 + wg, 256); };
    auto turn_end = [&]() { tc::bar_arrive(2 - wg, 256); };
    if (wg == 1) tc::bar_arrive(1, 256);
    // The thread that stores a warpgroup's output releases the q slot it
    // left from once TMA has read it: at the next tile's first product (by
    // then long read), before its own next store, or at the end, so that
    // no warpgroup waits on a store.
    int stored = -1;  // the work tile whose slot awaits release
    auto release = [&]() {
      if (tid % 128 == 0 && stored >= 0) {
        tc::bulk_wait_read<0>();
        tc::mbar_arrive(bar(kQEmpty, stored));
        stored = -1;
      }
    };

    int n = 0;  // kv blocks consumed before this tile
    for (int j = 0;; ++j) {
      const int t = cta_tile(j);
      if (t >= n_tiles) break;
      tc::mbar_wait(bar(kQFull, j), (j >> 1) & 1);
      const Work w = work_tile(t, nq, B, Hq, Sq, Sk, causal, window);
      const uint32_t q_s = q_tile(j & 1);
      const int row0 = w.q0 + rloc;

      float o[NO], m[2], l[2], alpha[2], sum[2];
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[r] = kNegInf;
        l[r] = 0.f;
      }
      uint32_t p[NP][4];  // p of the step before, as A fragments
      // Step `it` issues s of its block c and o += p . v of block c - 1,
      // runs its softmax while that product runs, rescales o once the
      // product is done and releases k of c and v of c - 1.
      if (w.nkv > 0) {
        tc::mbar_wait(bar(kKFull, n), (n >> 1) & 1);
        float s[NS];
        turn_begin();
        tc::mma_fence();
        scores(s, q_s, n);
        turn_end();
        tc::mma_wait<0>();
        tc::hold(s);
        if (lane == 0) tc::mbar_arrive(bar(kKEmpty, n));
        release();
        online_softmax(s, m, alpha, sum, w.kb_lo * kTcN, row0, col, w.q0, Sq,
                       Sk, scale, causal, window);
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = sum[r];
        tc::to_a<NP>(s, p);
      }
      for (int it = 1; it < w.nkv; ++it) {
        const int c = n + it;
        tc::mbar_wait(bar(kKFull, c), (c >> 1) & 1);
        tc::mbar_wait(bar(kVFull, c - 1), ((c - 1) >> 1) & 1);
        float s[NS];
        turn_begin();
        tc::mma_fence();
        scores(s, q_s, c);
        accumulate(o, p, c - 1);
        turn_end();
        tc::mma_wait<1>();
        tc::hold(s);
        online_softmax(s, m, alpha, sum, (w.kb_lo + it) * kTcN, row0, col,
                       w.q0, Sq, Sk, scale, causal, window);
        tc::mma_wait<0>();
        tc::hold(o);
        tc::hold(p);
        if (lane == 0) {
          tc::mbar_arrive(bar(kKEmpty, c));
          tc::mbar_arrive(bar(kVEmpty, c - 1));
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + sum[r];
#pragma unroll
        for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
        tc::to_a<NP>(s, p);
      }
      if (w.nkv > 0) {
        const int c = n + w.nkv - 1;
        tc::mbar_wait(bar(kVFull, c), (c >> 1) & 1);
        turn_begin();
        tc::mma_fence();
        accumulate(o, p, c);
        turn_end();
        tc::mma_wait<0>();
        tc::hold(o);
        tc::hold(p);
        if (lane == 0) tc::mbar_arrive(bar(kVEmpty, c));
      }
      n += w.nkv;

      // lse = m + log(l); out = o / l into this warpgroup's rows of the q
      // slot (its products are done with them), then one thread stores
      // them by TMA
      release();
      const size_t row_base = ((size_t)w.b * Hq + w.h) * Sq;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const float denom = l[r] == 0.f ? 1.f : l[r];
        const int row = row0 + 8 * r;
        if (lane % 4 == 0 && row < Sq) lse[row_base + row] = m[r] + logf(denom);
        l[r] = 1.f / denom;
      }
      uint8_t* q_p = base_p + (j & 1) * S::kQ;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<uint32_t*>(q_p + L::chunk(kTcM, rloc + 8 * r, jj) +
                                       2 * col) =
              tc::pack_bf16(o[4 * jj + 2 * r] * l[r],
                            o[4 * jj + 2 * r + 1] * l[r]);
      tc::fence_async_smem();
      tc::bar_sync(3 + wg, 128);
      if (tid % 128 == 0) {
        if (w.q0 + 64 * wg < Sq) {
          tc::tma_store<D, kTcM>(&tm_o, q_s + 64 * wg * L::RB, w.q0 + 64 * wg,
                                 w.b * Hq + w.h);
          tc::bulk_commit();
        }
        stored = j;
      }
    }
    release();
    if (wg == 0) tc::bar_sync(1, 256);  // warpgroup 1's last arrival
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int Hq, int Hkv, int Sq, int Sk,
                float scale, int causal, int window, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  int e = tc::make_tile_map<D>(&tm_q, q, B * Hq, Sq, kTcM);
  if (e == 0) e = tc::make_tile_map<D>(&tm_k, k, B * Hkv, Sk, kTcN);
  if (e == 0) e = tc::make_tile_map<D>(&tm_v, v, B * Hkv, Sk, kTcN);
  if (e == 0) e = tc::make_tile_map<D>(&tm_o, out, B * Hq, Sq, kTcM / 2);
  if (e != 0) return e;
  cudaError_t a = cudaFuncSetAttribute(
      fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      FwdSmem<D>::kBytes);
  int dev = 0, sms = 0;
  if (a == cudaSuccess) a = cudaGetDevice(&dev);
  if (a == cudaSuccess)
    a = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (a != cudaSuccess) return (int)a;
  const int n_tiles = (Sq + kTcM - 1) / kTcM * B * Hq;
  fwd_bf16_kernel<D><<<min(sms, n_tiles), kTcThreads, FwdSmem<D>::kBytes,
                       stream>>>(tm_q, tm_k, tm_v, tm_o, lse, B, Hq, Hkv,
                                 Sq, Sk, scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int Hq, int Hkv, int Sq, int Sk, float scale, int causal,
           int window, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (3 * kBlock * (D + 1) + kBlock * (kBlock + 1));
  const cudaError_t e = cudaFuncSetAttribute(
      fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kBlock - 1) / kBlock, Hq, B);
  fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Hq, Hkv, Sq, Sk,
      scale, causal, window);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dtype(int dtype, const void* q, const void* k, const void* v,
                 void* out, float* lse, int B, int Hq, int Hkv, int Sq,
                 int Sk, float scale, int causal, int window,
                 cudaStream_t s) {
  if (dtype == 0)
    return launch<float, D>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, scale,
                            causal, window, s);
  if (dtype == 1)
    return launch_bf16<D>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, scale,
                          causal, window, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace flash

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it); lse is f32.
// All tensors contiguous, (B, H, S, D) row-major; D is 16, 32, 64 or 128;
// window < 0 means none. Returns cudaGetLastError() after the launch.
extern "C" int repro_flash_attention_fwd(int dtype, const void* q,
                                         const void* k, const void* v,
                                         void* out, float* lse, int B, int Hq,
                                         int Hkv, int Sq, int Sk, int D,
                                         float scale, int causal, int window,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 16)
    return flash::launch_dtype<16>(dtype, q, k, v, out, lse, B, Hq, Hkv, Sq,
                                   Sk, scale, causal, window, s);
  if (D == 32)
    return flash::launch_dtype<32>(dtype, q, k, v, out, lse, B, Hq, Hkv, Sq,
                                   Sk, scale, causal, window, s);
  if (D == 64)
    return flash::launch_dtype<64>(dtype, q, k, v, out, lse, B, Hq, Hkv, Sq,
                                   Sk, scale, causal, window, s);
  if (D == 128)
    return flash::launch_dtype<128>(dtype, q, k, v, out, lse, B, Hq, Hkv, Sq,
                                    Sk, scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
