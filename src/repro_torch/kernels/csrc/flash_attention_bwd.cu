// Flash-attention backward for Hopper (sm_90a): the dK/dV kernel and the dQ
// kernel.
//
// Replace the TPU kernels `_dkv_kernel` (src/repro/kernels/
// flash_attention_bwd.py:58, pallas_call :233) and `_dq_kernel` (:129,
// pallas_call :270) that `flash_attention_vjp` (:186) runs. Same function:
// from q, k, v, dO, the forward's lse and delta = rowsum(dO * O) (computed
// in plain torch, as the reference does in jnp), recompute
//   p  = exp((q . k^T) * scale - lse) under the mask (0 where hidden),
//   dS = p * (dO . V^T - delta),
// and accumulate in f32
//   dV = p^T . dO and dK = dS^T . q * scale, summed over the q heads of
//   the KV head's GQA group, in k's and v's dtype;
//   dQ = dS . K * scale, in q's dtype.
// Masks are those of `_mask` (:44-52), q and k positions counted from 0.
//
// Bound: operations. At the training shape (B 2, Hq 32, Hkv 8, S 2048,
// D 128, causal) the dK/dV kernel does 4 products of 2 * D flops per
// visible (q, k) pair (s recomputed, dO . V^T, p^T . dO, dS^T . q), 137.5
// GFLOP, least time 139.04 us at 989 TFLOP/s (bf16); the dQ kernel does 3
// (s, dO . V^T, dS . K), 103.1 GFLOP, 104 us. Their bytes (q, k, v, dO, lse,
// delta in; dK, dV or dQ out) are under 100 MB, 30 us at 3.35 TB/s.
//
// What the design does about it. The bf16 dK/dV kernel runs on the tensor
// cores: one CTA per (KV block of 128, KV head, batch), the KV blocks that
// see the most q blocks (the first, under a causal mask) launched first,
// of three warpgroups. The CTA keeps K and V in shared memory and dK and
// dV in registers for the whole loop over the group's q heads x the q
// blocks of 64 it can see (a contiguous run; the rest are never loaded),
// so dK and dV are written once, with no atomics. A producer warpgroup (24
// registers after setmaxnreg) has TMA bring K, V and then each step's q
// and dO tiles into a ring of three stages, swizzled as wgmma reads them,
// and writes the step's lse and delta rows; mbarriers say when a stage has
// landed and when the consumers are done with it. Two consumer warpgroups
// (240 registers) own 64 kv rows each. Per step: S^T = K . q^T and dP^T =
// V . dO^T by wgmma m64n64k16 from shared memory into f32 registers;
// p^T = exp(S^T * scale - lse) and dS^T = p^T * (dP^T - delta) in f32, the
// mask only on blocks it or the ragged edge cuts; p^T and dS^T rounded to
// bf16 and fed from registers as A of dV += p^T . dO and dK += dS^T . q
// (wgmma m64nDk16, dO and q read MN-major). The consumers take turns to
// issue their products (named barriers), so that one's elementwise work
// overlaps the other's products. scale is applied to dK at the store,
// which leaves through shared memory in 16-byte rows. Budget at D 128: K
// and V 64 KB + 3 x (q 16 KB + dO 16 KB + 512 B) = 161.5 KB.
// The bf16 dQ kernel mirrors the forward: one CTA per (q block of 128, q
// head, batch), the late q blocks (the most causal work) launched first,
// of three warpgroups. A producer warpgroup (one thread, 40 registers) has
// TMA bring q and dO once, then the k and v tiles of each KV block of 64
// rows the q block can see (a contiguous run; out-of-range rows
// zero-filled) into a ring of four stages. Two consumer warpgroups (232
// registers) own 64 q rows each and hold their lse and delta rows in
// registers. Per step: S = q . k^T and dP = dO . v^T by wgmma m64n64k16
// from shared memory into f32 registers; p = exp(S * scale - lse) and
// dS = p * (dP - delta) in f32, the mask only on blocks it or the ragged
// edge cuts; dS rounded to bf16 and fed from registers as A of
// dQ += dS . K (wgmma m64nDk16, k read MN-major). A step issues its
// block's S and dP with the previous block's dS . K and computes its dS
// while that product runs; the consumers take turns to issue. dQ stays in
// registers (64 f32 a thread at D 128; a KV tile of 128 rows would add
// 96 more and spill), is scaled at the store and written once through
// shared memory in 16-byte rows, with no atomics. Budget at D 128: q 32 KB
// + dO 32 KB + 4 x (k 16 KB + v 16 KB) = 192 KB.
// The f32 kernels stay SIMT (TF32 would miss the f32 tolerance): dK/dV
// per (KV block of 64, KV head, batch) with the same loop and
// 4 x (D / 16) accumulators per thread; dQ per (q block, q head, batch)
// holding q, dO and its dQ accumulator and looping over the KV blocks,
// reading K and V of head h / G in place. Both skip the blocks the mask
// hides whole. Their products are f32 FMAs.

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

namespace flash {
namespace {

// Scores of one (q block, kv block) pair into p and dS (both (64, 64 + 1) in
// shared memory, [q row][kv row]): p = exp(s - lse) under the mask, and
// dS = p * (dO . V^T - delta). q_s holds q * scale.
template <int D>
__device__ __forceinline__ void p_and_ds(const float* q_s, const float* k_s,
                                         const float* do_s, const float* v_s,
                                         const float (&lse)[4],
                                         const float (&delta)[4], int q0,
                                         int k0, int Sq, int Sk, bool causal,
                                         int window, int ty, int tx,
                                         float* p_s, float* ds_s) {
  constexpr int BP = kBlock + 1;
  float s[4][4] = {};
  float dp[4][4] = {};
  dot_nt<D>(q_s, k_s, ty, tx, s);
  dot_nt<D>(do_s, v_s, ty, tx, dp);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kpos = k0 + tx + 16 * j;
      const bool vis =
          qpos < Sq && kpos < Sk && visible(qpos, kpos, causal, window);
      const float p = vis ? expf(s[i][j] - lse[i]) : 0.f;
      const int at = (ty + 16 * i) * BP + tx + 16 * j;
      if (p_s != nullptr) p_s[at] = p;
      ds_s[at] = p * (dp[i][j] - delta[i]);
    }
  }
}

// f32 dK/dV on the SIMT cores (the header's last paragraph).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv, int Sq,
               int Sk, float scale, int causal, int window) {
  constexpr int DP = D + 1;
  constexpr int BP = kBlock + 1;
  constexpr int NJ = D / 16;
  const int k0 = blockIdx.x * kBlock;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  extern __shared__ float smem[];
  float* k_s = smem;                  // (64, D + 1)
  float* v_s = k_s + kBlock * DP;     // (64, D + 1)
  float* q_s = v_s + kBlock * DP;     // (64, D + 1): q * scale
  float* do_s = q_s + kBlock * DP;    // (64, D + 1)
  float* p_s = do_s + kBlock * DP;    // (64, 64 + 1): [q row][kv row]
  float* ds_s = p_s + kBlock * BP;    // (64, 64 + 1)

  const size_t koff = ((size_t)b * Hkv + hk) * Sk * D;
  load_tile<T, D>(k_s, k + koff, k0, Sk, 1.f);
  load_tile<T, D>(v_s, v + koff, k0, Sk, 1.f);

  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int k1 = min(k0 + kBlock, Sk);
  const int nq = (Sq + kBlock - 1) / kBlock;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const size_t qoff = ((size_t)b * Hq + h) * Sq * D;
    const float* lse_h = lse + ((size_t)b * Hq + h) * Sq;
    const float* delta_h = delta + ((size_t)b * Hq + h) * Sq;
    for (int qb = 0; qb < nq; ++qb) {
      const int q0 = qb * kBlock;
      if (block_hidden(q0, min(q0 + kBlock, Sq), k0, k1, causal, window))
        continue;
      __syncthreads();  // the previous block's readers are done
      load_tile<T, D>(q_s, q + qoff, q0, Sq, scale);
      load_tile<T, D>(do_s, dout + qoff, q0, Sq, 1.f);
      float lse_r[4], delta_r[4];
      load_rows(lse_r, lse_h, q0, Sq, ty);
      load_rows(delta_r, delta_h, q0, Sq, ty);
      __syncthreads();
      p_and_ds<D>(q_s, k_s, do_s, v_s, lse_r, delta_r, q0, k0, Sq, Sk, causal,
                  window, ty, tx, p_s, ds_s);
      __syncthreads();
      acc_nn<D, true>(p_s, do_s, ty, tx, dv_acc);   // dV += p^T . dO
      acc_nn<D, true>(ds_s, q_s, ty, tx, dk_acc);   // dK += dS^T . q * scale
    }
  }
  store_rows<T, D>(dk + koff, dk_acc, k0, Sk, ty, tx, 1.f);
  store_rows<T, D>(dv + koff, dv_acc, k0, Sk, ty, tx, 1.f);
}

// f32 dQ on the SIMT cores (the header's last paragraph).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int Hq, int Hkv, int Sq, int Sk, float scale,
              int causal, int window) {
  constexpr int DP = D + 1;
  constexpr int NJ = D / 16;
  const int q0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  extern __shared__ float smem[];
  float* q_s = smem;                  // (64, D + 1): q * scale
  float* do_s = q_s + kBlock * DP;    // (64, D + 1)
  float* k_s = do_s + kBlock * DP;    // (64, D + 1)
  float* v_s = k_s + kBlock * DP;     // (64, D + 1)
  float* ds_s = v_s + kBlock * DP;    // (64, 64 + 1): [q row][kv row]

  const size_t qoff = ((size_t)b * Hq + h) * Sq * D;
  const size_t koff = ((size_t)b * Hkv + hk) * Sk * D;
  load_tile<T, D>(q_s, q + qoff, q0, Sq, scale);
  load_tile<T, D>(do_s, dout + qoff, q0, Sq, 1.f);
  float lse_r[4], delta_r[4];
  load_rows(lse_r, lse + ((size_t)b * Hq + h) * Sq, q0, Sq, ty);
  load_rows(delta_r, delta + ((size_t)b * Hq + h) * Sq, q0, Sq, ty);

  float dq_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq_acc[i][j] = 0.f;

  const int q1 = min(q0 + kBlock, Sq);
  const int nk = (Sk + kBlock - 1) / kBlock;
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * kBlock;
    if (block_hidden(q0, q1, k0, min(k0 + kBlock, Sk), causal, window))
      continue;
    __syncthreads();  // the previous block's readers are done
    load_tile<T, D>(k_s, k + koff, k0, Sk, 1.f);
    load_tile<T, D>(v_s, v + koff, k0, Sk, 1.f);
    __syncthreads();
    p_and_ds<D>(q_s, k_s, do_s, v_s, lse_r, delta_r, q0, k0, Sq, Sk, causal,
                window, ty, tx, nullptr, ds_s);
    __syncthreads();
    acc_nn<D, false>(ds_s, k_s, ty, tx, dq_acc);  // dQ += dS . K
  }
  store_rows<T, D>(dq + qoff, dq_acc, q0, Sq, ty, tx, scale);
}

// bf16 dK/dV on the tensor cores (the header's design).
constexpr int kTcN = 128;  // kv rows per CTA: two consumer warpgroups of 64
constexpr int kTcM = 64;   // q rows per tile
constexpr int kTcThreads = 384;  // the two consumers and a producer warpgroup
// registers per thread after setmaxnreg: 2 x 128 x 240 + 128 x 24 <= 65,536
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;

template <int D>
struct DkvSmem {
  static constexpr int kStages = 3;  // q, dO, lse and delta in flight
  static constexpr int kKV = kTcN * D * 2;  // k, and v
  static constexpr int kQ = kTcM * D * 2;   // q, and dO, per stage
  static constexpr int kRows = 2 * kTcM * 4;  // lse then delta, per stage
  static constexpr int kRowsAt = 2 * kKV + 2 * kStages * kQ;
  static constexpr int kBars = kRowsAt + kStages * kRows;  // kv, full, empty
  // k, v; (q, dO) per stage; (lse, delta) per stage; the barriers; 1 KB to
  // align the start
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    dkv_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int B, int Hq, int Hkv,
                    int Sq, int Sk, float scale, int causal, int window) {
  using L = tc::Tile<D>;
  using S = DkvSmem<D>;
  constexpr int NO = D / 2;     // accumulator floats per thread (64 x D)
  constexpr int NS = kTcM / 2;  // score floats per thread (64 x 64)
  constexpr int NP = kTcM / 16;  // A fragments of p^T and dS^T
  const int heads = B * Hkv;
  const int kb = blockIdx.x / heads;  // the first kv blocks first
  const int hk = blockIdx.x % heads % Hkv;
  const int b = blockIdx.x % heads / Hkv;
  const int G = Hq / Hkv;
  const int k0 = kb * kTcN;
  const int k1 = min(k0 + kTcN, Sk);
  const int tid = threadIdx.x;
  const int wg = tid / 128;  // 0, 1: consumers; 2: the producer
  const int lane = tid % 32;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = tc::smem_u32(smem_raw);
  const uint32_t k_s = (raw + 1023) & ~1023u;
  uint8_t* k_p = smem_raw + (k_s - raw);
  const uint32_t v_s = k_s + S::kKV;
  // step it reads stage it % kStages: q at q_tile(it), dO after it, and its
  // lse then delta rows at rows(it)
  auto q_tile = [&](int it) {
    return v_s + S::kKV + (it % S::kStages) * 2 * S::kQ;
  };
  auto rows = [&](int it) {
    return reinterpret_cast<float*>(k_p + S::kRowsAt +
                                    (it % S::kStages) * S::kRows);
  };
  // barriers: k and v landed; stage st landed (the TMA copies and the
  // producer's 128 threads' rows); the 8 consumer warps are done with it
  const uint32_t kv_full = k_s + S::kBars;
  auto full = [&](int st) { return kv_full + 8 + 8 * st; };
  auto empty = [&](int st) { return kv_full + 8 + 8 * (S::kStages + st); };

  const int nq = (Sq + kTcM - 1) / kTcM;
  int qb_lo = nq, qb_hi = -1;
  for (int qb = 0; qb < nq; ++qb) {
    if (!block_hidden(qb * kTcM, min(qb * kTcM + kTcM, Sq), k0, k1, causal,
                      window)) {
      qb_lo = min(qb_lo, qb);
      qb_hi = qb;
    }
  }
  const int nqv = max(qb_hi - qb_lo + 1, 0);
  const int n_it = G * nqv;  // (q head, q block) pairs: it = g * nqv + i

  if (tid == 0) {
    tc::mbar_init(kv_full, 1);
    for (int st = 0; st < S::kStages; ++st) {
      tc::mbar_init(full(st), 1 + 128);
      tc::mbar_init(empty(st), 8);
    }
    tc::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // The producer: one thread asks TMA for k and v, then for each step's
    // q and dO tiles once the consumers have released its stage; all 128
    // threads write the step's lse and delta rows.
    tc::regs_dec<kProducerRegs>();
    const int pt = tid - 256;
    if (pt == 0) {
      tc::mbar_expect(kv_full, 2 * S::kKV);
      tc::tma_tile<D, kTcN>(k_s, &tm_k, k0, b * Hkv + hk, kv_full);
      tc::tma_tile<D, kTcN>(v_s, &tm_v, k0, b * Hkv + hk, kv_full);
    }
    for (int it = 0; it < n_it; ++it) {
      const int st = it % S::kStages;
      const int h = hk * G + it / nqv;
      const int q0 = (qb_lo + it % nqv) * kTcM;
      if (it >= S::kStages)
        tc::mbar_wait(empty(st), (it / S::kStages - 1) & 1);
      if (pt == 0) {
        tc::mbar_expect(full(st), 2 * S::kQ);
        tc::tma_tile<D, kTcM>(q_tile(it), &tm_q, q0, b * Hq + h, full(st));
        tc::tma_tile<D, kTcM>(q_tile(it) + S::kQ, &tm_do, q0, b * Hq + h,
                              full(st));
      }
      const int r = q0 + pt % kTcM;
      const float* src = pt < kTcM ? lse : delta;
      rows(it)[pt] = r < Sq ? src[((size_t)b * Hq + h) * Sq + r] : 0.f;
      tc::mbar_arrive(full(st));
    }
  } else {
    tc::regs_inc<kConsumerRegs>();
    // Warpgroup wg owns kv rows [64 wg, 64 wg + 64) of the block; this
    // thread kv rows row0 and row0 + 8, q columns 8j + col + {0, 1}.
    const int row0 = k0 + 64 * wg + 16 * ((tid % 128) / 32) + lane / 4;
    const int col = 2 * (lane % 4);
    // The warpgroups take turns to issue their products (barriers 1 and
    // 2), so that one's elementwise work runs while the other's products
    // are on the tensor cores. Warpgroup 1 opens the first turn; warpgroup
    // 0 takes the last arrival after its last turn. No branch lies between
    // a product's issue and its wait: ptxas would serialise every product.
    auto turn_begin = [&]() { tc::bar_sync(1 + wg, 256); };
    auto turn_end = [&]() { tc::bar_arrive(2 - wg, 256); };
    if (wg == 1 && n_it > 0) tc::bar_arrive(1, 256);

    float dk_acc[NO], dv_acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    tc::mbar_wait(kv_full, 0);
    const float sl = scale * tc::kLog2e;
    for (int it = 0; it < n_it; ++it) {
      const int q0 = (qb_lo + it % nqv) * kTcM;
      const uint32_t qt = q_tile(it);
      const uint32_t do_t = qt + S::kQ;
      tc::mbar_wait(full(it % S::kStages), (it / S::kStages) & 1);

      // S^T = K . q^T and dP^T = V . dO^T
      float s[NS], dp[NS];
      turn_begin();
      tc::mma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        tc::mma_ss<kTcM, 0>(s, tc::desc_k<D>(k_s, kTcN, 64 * wg, kk),
                            tc::desc_k<D>(qt, kTcM, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        tc::mma_ss<kTcM, 0>(dp, tc::desc_k<D>(v_s, kTcN, 64 * wg, kk),
                            tc::desc_k<D>(do_t, kTcM, 0, kk), kk);
      tc::mma_commit();
      turn_end();
      tc::mma_wait<0>();
      tc::hold(s);
      tc::hold(dp);

      // p^T = exp(S^T * scale - lse) and dS^T = p^T * (dP^T - delta)
      const float* lse_s = rows(it);
      const float* delta_s = lse_s + kTcM;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int qc = 8 * (i >> 2) + col + (i & 1);  // within the q block
        s[i] = tc::exp2_approx(fmaf(s[i], sl, -lse_s[qc] * tc::kLog2e));
      }
      if (!block_full(q0, kTcM, k0, kTcN, Sq, Sk, causal, window)) {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int kr = row0 + 8 * ((i >> 1) & 1);
          const int qc = q0 + 8 * (i >> 2) + col + (i & 1);
          if (!(qc < Sq && kr < Sk && visible(qc, kr, causal, window)))
            s[i] = 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int qc = 8 * (i >> 2) + col + (i & 1);
        dp[i] = s[i] * (dp[i] - delta_s[qc]);
      }
      uint32_t pa[NP][4], da[NP][4];
      tc::to_a<NP>(s, pa);
      tc::to_a<NP>(dp, da);

      // dV += p^T . dO and dK += dS^T . q
      turn_begin();
      tc::mma_fence();
#pragma unroll
      for (int t = 0; t < NP; ++t)
        tc::mma_rs<D, 1>(dv_acc, pa[t], tc::desc_mn<D>(do_t, kTcM, t), 1);
#pragma unroll
      for (int t = 0; t < NP; ++t)
        tc::mma_rs<D, 1>(dk_acc, da[t], tc::desc_mn<D>(qt, kTcM, t), 1);
      tc::mma_commit();
      turn_end();
      tc::mma_wait<0>();
      tc::hold(dv_acc);
      tc::hold(dk_acc);
      tc::hold(pa);
      tc::hold(da);
      if (lane == 0) tc::mbar_arrive(empty(it % S::kStages));
    }
    if (wg == 0 && n_it > 0) tc::bar_sync(1, 256);  // warpgroup 1's last

    // dK * scale and dV through this warpgroup's rows of k's and v's
    // shared memory (its products are done with them), then 16-byte rows
    const size_t koff = ((size_t)b * Hkv + hk) * Sk * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r - k0;
        const uint32_t at = L::chunk(kTcN, row, j) + 2 * col;
        const int i = 4 * j + 2 * r;
        *reinterpret_cast<uint32_t*>(k_p + at) =
            tc::pack_bf16(dk_acc[i] * scale, dk_acc[i + 1] * scale);
        *reinterpret_cast<uint32_t*>(k_p + S::kKV + at) =
            tc::pack_bf16(dv_acc[i], dv_acc[i + 1]);
      }
    tc::bar_sync(3 + wg, 128);
    for (int i = tid % 128; i < 64 * (D / 8); i += 128) {
      const int r = 64 * wg + i / (D / 8), c = i % (D / 8);
      if (k0 + r >= Sk) continue;
      const size_t at = koff + (size_t)(k0 + r) * D + 8 * c;
      const uint32_t from = L::chunk(kTcN, r, c);
      *reinterpret_cast<uint4*>(dk + at) =
          *reinterpret_cast<const uint4*>(k_p + from);
      *reinterpret_cast<uint4*>(dv + at) =
          *reinterpret_cast<const uint4*>(k_p + S::kKV + from);
    }
  }
}

template <int D>
int launch_dkv_bf16(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Sk,
                    float scale, int causal, int window,
                    cudaStream_t stream) {
  using T = __nv_bfloat16;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int e = tc::make_tile_map<D>(&tm_q, q, B * Hq, Sq, kTcM);
  if (e == 0) e = tc::make_tile_map<D>(&tm_do, dout, B * Hq, Sq, kTcM);
  if (e == 0) e = tc::make_tile_map<D>(&tm_k, k, B * Hkv, Sk, kTcN);
  if (e == 0) e = tc::make_tile_map<D>(&tm_v, v, B * Hkv, Sk, kTcN);
  if (e != 0) return e;
  const cudaError_t a = cudaFuncSetAttribute(
      dkv_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DkvSmem<D>::kBytes);
  if (a != cudaSuccess) return (int)a;
  const int nk = (Sk + kTcN - 1) / kTcN;
  dkv_bf16_kernel<D><<<nk * B * Hkv, kTcThreads, DkvSmem<D>::kBytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), B, Hq, Hkv, Sq, Sk, scale, causal, window);
  return (int)cudaGetLastError();
}

// bf16 dQ on the tensor cores (the header's design).
constexpr int kDqM = 128;  // q rows per CTA: two consumer warpgroups of 64
constexpr int kDqN = 64;   // kv rows per tile
// registers per thread after setmaxnreg: 2 x 128 x 232 + 128 x 40 <= 65,536
constexpr int kDqConsumerRegs = 232;
constexpr int kDqProducerRegs = 40;

template <int D>
struct DqSmem {
  static constexpr int kStages = 4;  // k and v tiles in flight
  static constexpr int kQ = kDqM * D * 2;   // q, and dO
  static constexpr int kKV = kDqN * D * 2;  // k, and v, per stage
  static constexpr int kBars = 2 * kQ + 2 * kStages * kKV;  // full, empty
  // q, dO, (k, v) per stage, the barriers, and 1 KB to align the start
  static constexpr int kBytes = kBars + 16 * kStages + 1024;
};

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    dq_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int B, int Hq, int Hkv,
                   int Sq, int Sk, float scale, int causal, int window) {
  using L = tc::Tile<D>;
  using S = DqSmem<D>;
  constexpr int NO = D / 2;      // accumulator floats per thread (64 x D)
  constexpr int NS = kDqN / 2;   // score floats per thread (64 x 64)
  constexpr int NP = kDqN / 16;  // A fragments of dS
  const int nq = (Sq + kDqM - 1) / kDqM;
  const int heads = B * Hq;
  const int qb = nq - 1 - (int)(blockIdx.x / heads);  // late blocks first
  const int h = blockIdx.x % heads % Hq;
  const int b = blockIdx.x % heads / Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qb * kDqM;
  const int q1 = min(q0 + kDqM, Sq);
  const int tid = threadIdx.x;
  const int wg = tid / 128;  // 0, 1: consumers; 2: the producer
  const int lane = tid % 32;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = tc::smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;
  uint8_t* q_p = smem_raw + (q_s - raw);
  const uint32_t do_s = q_s + S::kQ;
  // stage st: full (its copies have landed), empty (the 8 consumer warps
  // are done with it)
  auto full = [&](int st) { return q_s + S::kBars + 8 * st; };
  auto empty = [&](int st) { return q_s + S::kBars + 8 * (S::kStages + st); };
  // step `it` reads kv block kb_lo + it: k at k_tile(it), v after it
  auto k_tile = [&](int it) {
    return q_s + 2 * S::kQ + (it % S::kStages) * 2 * S::kKV;
  };

  const int nk = (Sk + kDqN - 1) / kDqN;
  int kb_lo = nk, kb_hi = -1;
  for (int kb = 0; kb < nk; ++kb) {
    if (!block_hidden(q0, q1, kb * kDqN, min(kb * kDqN + kDqN, Sk), causal,
                      window)) {
      kb_lo = min(kb_lo, kb);
      kb_hi = kb;
    }
  }
  const int nkv = max(kb_hi - kb_lo + 1, 0);

  if (tid == 0) {
    for (int st = 0; st < S::kStages; ++st) {
      tc::mbar_init(full(st), 1);
      tc::mbar_init(empty(st), 8);
    }
    tc::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // The producer: one thread asks TMA for q and dO with the first block,
    // then for each kv block's k and v once the consumers have released
    // its stage.
    tc::regs_dec<kDqProducerRegs>();
    if (tid == 256) {
      for (int it = 0; it < nkv; ++it) {
        const int st = it % S::kStages;
        if (it >= S::kStages)
          tc::mbar_wait(empty(st), (it / S::kStages - 1) & 1);
        tc::mbar_expect(full(st), 2 * S::kKV + (it == 0 ? 2 * S::kQ : 0));
        if (it == 0) {
          tc::tma_tile<D, kDqM>(q_s, &tm_q, q0, b * Hq + h, full(st));
          tc::tma_tile<D, kDqM>(do_s, &tm_do, q0, b * Hq + h, full(st));
        }
        const int k0 = (kb_lo + it) * kDqN;
        tc::tma_tile<D, kDqN>(k_tile(it), &tm_k, k0, b * Hkv + hk, full(st));
        tc::tma_tile<D, kDqN>(k_tile(it) + S::kKV, &tm_v, k0, b * Hkv + hk,
                              full(st));
      }
    }
  } else {
    tc::regs_inc<kDqConsumerRegs>();
    // Warpgroup wg owns q rows [wq0, wq0 + 64) of the block; this thread
    // rows row0 and row0 + 8, columns 8j + col + {0, 1}.
    const int wq0 = q0 + 64 * wg;
    const int row0 = wq0 + 16 * ((tid % 128) / 32) + lane / 4;
    const int col = 2 * (lane % 4);
    // lse * log2(e) and delta of the thread's two rows (0 past Sq)
    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const size_t at = ((size_t)b * Hq + h) * Sq + row;
      lse2[r] = row < Sq ? lse[at] * tc::kLog2e : 0.f;
      dlt[r] = row < Sq ? delta[at] : 0.f;
    }
    // S = q . k^T and dP = dO . v^T of step `it`, issued and committed
    auto products = [&](float (&s)[NS], float (&dp)[NS], int it) {
      const uint32_t kt = k_tile(it);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        tc::mma_ss<kDqN, 0>(s, tc::desc_k<D>(q_s, kDqM, 64 * wg, kk),
                            tc::desc_k<D>(kt, kDqN, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        tc::mma_ss<kDqN, 0>(dp, tc::desc_k<D>(do_s, kDqM, 64 * wg, kk),
                            tc::desc_k<D>(kt + S::kKV, kDqN, 0, kk), kk);
      tc::mma_commit();
    };
    // acc += dS . K of step `it` (k read MN-major), issued and committed
    auto accumulate = [&](float (&acc)[NO], const uint32_t (&a)[NP][4],
                          int it) {
#pragma unroll
      for (int t = 0; t < NP; ++t)
        tc::mma_rs<D, 1>(acc, a[t], tc::desc_mn<D>(k_tile(it), kDqN, t), 1);
      tc::mma_commit();
    };
    // p = exp(S * scale - lse) under the mask (in s), then
    // dS = p * (dP - delta) (in dp), of step `it`
    const float sl = scale * tc::kLog2e;
    auto grads = [&](float (&s)[NS], float (&dp)[NS], int it) {
      const int k0 = (kb_lo + it) * kDqN;
#pragma unroll
      for (int i = 0; i < NS; ++i)
        s[i] = tc::exp2_approx(fmaf(s[i], sl, -lse2[(i >> 1) & 1]));
      if (!block_full(wq0, 64, k0, kDqN, Sq, Sk, causal, window)) {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int r = row0 + 8 * ((i >> 1) & 1);
          const int c = k0 + 8 * (i >> 2) + col + (i & 1);
          if (!(r < Sq && c < Sk && visible(r, c, causal, window)))
            s[i] = 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < NS; ++i)
        dp[i] = s[i] * (dp[i] - dlt[(i >> 1) & 1]);
    };
    // The warpgroups take turns to issue their products (barriers 1 and
    // 2), so that one's elementwise work runs while the other's products
    // are on the tensor cores. Warpgroup 1 opens the first turn; warpgroup
    // 0 takes the last arrival after its last turn. No branch lies between
    // a product's issue and its wait: ptxas would serialise every product.
    auto turn_begin = [&]() { tc::bar_sync(1 + wg, 256); };
    auto turn_end = [&]() { tc::bar_arrive(2 - wg, 256); };
    if (wg == 1 && nkv > 0) tc::bar_arrive(1, 256);

    float acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;
    uint32_t da[NP][4];  // dS of the step before, as A fragments
    // Step `it` issues S and dP of its block and acc += dS . K of the
    // block before, computes its dS while that product runs, and releases
    // the block before to the producer once the product is done.
    if (nkv > 0) {
      tc::mbar_wait(full(0), 0);
      float s[NS], dp[NS];
      turn_begin();
      tc::mma_fence();
      products(s, dp, 0);
      turn_end();
      tc::mma_wait<0>();
      tc::hold(s);
      tc::hold(dp);
      grads(s, dp, 0);
      tc::to_a<NP>(dp, da);
    }
    for (int it = 1; it < nkv; ++it) {
      tc::mbar_wait(full(it % S::kStages), (it / S::kStages) & 1);
      float s[NS], dp[NS];
      turn_begin();
      tc::mma_fence();
      products(s, dp, it);
      accumulate(acc, da, it - 1);
      turn_end();
      tc::mma_wait<1>();
      tc::hold(s);
      tc::hold(dp);
      grads(s, dp, it);
      tc::mma_wait<0>();
      tc::hold(acc);
      tc::hold(da);
      if (lane == 0) tc::mbar_arrive(empty((it - 1) % S::kStages));
      tc::to_a<NP>(dp, da);
    }
    if (nkv > 0) {
      turn_begin();
      tc::mma_fence();
      accumulate(acc, da, nkv - 1);
      turn_end();
      tc::mma_wait<0>();
      tc::hold(acc);
      tc::hold(da);
      if (wg == 0) tc::bar_sync(1, 256);  // warpgroup 1's last arrival
    }

    // dQ = acc * scale through this warpgroup's rows of q's shared memory
    // (its products are done with them), then 16-byte rows; rows that see
    // no key (nkv == 0, or p = 0 throughout) store 0
    const size_t qoff = ((size_t)b * Hq + h) * Sq * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r - q0;
        *reinterpret_cast<uint32_t*>(q_p + L::chunk(kDqM, row, j) + 2 * col) =
            tc::pack_bf16(acc[4 * j + 2 * r] * scale,
                          acc[4 * j + 2 * r + 1] * scale);
      }
    tc::bar_sync(3 + wg, 128);
    for (int i = tid % 128; i < 64 * (D / 8); i += 128) {
      const int r = 64 * wg + i / (D / 8), c = i % (D / 8);
      if (q0 + r < Sq)
        *reinterpret_cast<uint4*>(dq + qoff + (size_t)(q0 + r) * D + 8 * c) =
            *reinterpret_cast<const uint4*>(q_p + L::chunk(kDqM, r, c));
    }
  }
}

template <int D>
int launch_dq_bf16(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int B, int Hq, int Hkv, int Sq, int Sk,
                   float scale, int causal, int window, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int e = tc::make_tile_map<D>(&tm_q, q, B * Hq, Sq, kDqM);
  if (e == 0) e = tc::make_tile_map<D>(&tm_do, dout, B * Hq, Sq, kDqM);
  if (e == 0) e = tc::make_tile_map<D>(&tm_k, k, B * Hkv, Sk, kDqN);
  if (e == 0) e = tc::make_tile_map<D>(&tm_v, v, B * Hkv, Sk, kDqN);
  if (e != 0) return e;
  const cudaError_t a = cudaFuncSetAttribute(
      dq_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DqSmem<D>::kBytes);
  if (a != cudaSuccess) return (int)a;
  const int nq = (Sq + kDqM - 1) / kDqM;
  dq_bf16_kernel<D><<<nq * B * Hq, kTcThreads, DqSmem<D>::kBytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse, delta, static_cast<__nv_bfloat16*>(dq), B,
      Hq, Hkv, Sq, Sk, scale, causal, window);
  return (int)cudaGetLastError();
}

template <int D>
size_t dkv_smem() {
  return sizeof(float) * (4 * kBlock * (D + 1) + 2 * kBlock * (kBlock + 1));
}

template <int D>
size_t dq_smem() {
  return sizeof(float) * (4 * kBlock * (D + 1) + kBlock * (kBlock + 1));
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv, int B,
               int Hq, int Hkv, int Sq, int Sk, float scale, int causal,
               int window, cudaStream_t stream) {
  const size_t smem = dkv_smem<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sk + kBlock - 1) / kBlock, Hkv, B);
  dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), Hq, Hkv, Sq, Sk, scale, causal,
      window);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int Hq,
              int Hkv, int Sq, int Sk, float scale, int causal, int window,
              cudaStream_t stream) {
  const size_t smem = dq_smem<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kBlock - 1) / kBlock, Hq, B);
  dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), Hq, Hkv, Sq, Sk, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace flash

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout, dk, dv share it); lse and
// delta are f32 (B, Hq, Sq). All tensors contiguous; D is 16, 32, 64 or 128;
// window < 0 means none. Each returns cudaGetLastError() after its launch.
extern "C" int repro_flash_attention_dkv(int dtype, const void* q,
                                         const void* k, const void* v,
                                         const void* dout, const float* lse,
                                         const float* delta, void* dk,
                                         void* dv, int B, int Hq, int Hkv,
                                         int Sq, int Sk, int D, float scale,
                                         int causal, int window,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_DKV(T, DD)                                                     \
  return flash::launch_dkv<T, DD>(q, k, v, dout, lse, delta, dk, dv, B, Hq, \
                                  Hkv, Sq, Sk, scale, causal, window, s)
  if (dtype == 0 && D == 16) REPRO_DKV(float, 16);
  if (dtype == 0 && D == 32) REPRO_DKV(float, 32);
  if (dtype == 0 && D == 64) REPRO_DKV(float, 64);
  if (dtype == 0 && D == 128) REPRO_DKV(float, 128);
#undef REPRO_DKV
#define REPRO_DKV_BF16(DD)                                                    \
  return flash::launch_dkv_bf16<DD>(q, k, v, dout, lse, delta, dk, dv, B, Hq, \
                                    Hkv, Sq, Sk, scale, causal, window, s)
  if (dtype == 1 && D == 16) REPRO_DKV_BF16(16);
  if (dtype == 1 && D == 32) REPRO_DKV_BF16(32);
  if (dtype == 1 && D == 64) REPRO_DKV_BF16(64);
  if (dtype == 1 && D == 128) REPRO_DKV_BF16(128);
#undef REPRO_DKV_BF16
  return (int)cudaErrorInvalidValue;
}

extern "C" int repro_flash_attention_dq(int dtype, const void* q,
                                        const void* k, const void* v,
                                        const void* dout, const float* lse,
                                        const float* delta, void* dq, int B,
                                        int Hq, int Hkv, int Sq, int Sk, int D,
                                        float scale, int causal, int window,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_DQ(T, DD)                                                     \
  return flash::launch_dq<T, DD>(q, k, v, dout, lse, delta, dq, B, Hq, Hkv, \
                                 Sq, Sk, scale, causal, window, s)
  if (dtype == 0 && D == 16) REPRO_DQ(float, 16);
  if (dtype == 0 && D == 32) REPRO_DQ(float, 32);
  if (dtype == 0 && D == 64) REPRO_DQ(float, 64);
  if (dtype == 0 && D == 128) REPRO_DQ(float, 128);
#undef REPRO_DQ
#define REPRO_DQ_BF16(DD)                                                    \
  return flash::launch_dq_bf16<DD>(q, k, v, dout, lse, delta, dq, B, Hq, Hkv, \
                                   Sq, Sk, scale, causal, window, s)
  if (dtype == 1 && D == 16) REPRO_DQ_BF16(16);
  if (dtype == 1 && D == 32) REPRO_DQ_BF16(32);
  if (dtype == 1 && D == 64) REPRO_DQ_BF16(64);
  if (dtype == 1 && D == 128) REPRO_DQ_BF16(128);
#undef REPRO_DQ_BF16
  return (int)cudaErrorInvalidValue;
}
