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
// What the design does about it. bf16 runs on the tensor cores: one CTA per
// (q block of 128, q head, batch), the late q blocks (the most causal work)
// launched first, of three warpgroups. A producer warpgroup (one thread,
// 40 registers after setmaxnreg) asks TMA for the q tile, then for each
// KV block of 128 rows the q block can see (a contiguous run: the mask is
// a band; blocks the mask hides whole are never loaded) into a ring of
// three stages of k and v tiles, swizzled as wgmma reads them, out-of-range
// rows zero-filled; mbarriers say when a stage has landed and when both
// consumers are done with it. Two consumer warpgroups (232 registers) own
// 64 q rows each: S = q . k^T by wgmma m64n128k16 from shared memory into
// f32 registers, times scale there (q is not rounded after scaling), the
// mask only on blocks it or the ragged edge cuts, the online softmax in
// f32, p rounded to bf16 and fed from registers as A of out += p . v
// (wgmma m64nDk16, v read MN-major). A step issues its block's S and the
// previous block's p . v together and runs its softmax while p . v is on
// the tensor cores; the consumers take turns to issue (named barriers), so
// that one's softmax also overlaps the other's products. The output leaves
// through shared memory in 16-byte rows. Budget at D 128: q 32 KB + 3 x
// (k 32 KB + v 32 KB) = 224 KB of shared memory, one CTA per SM.
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
constexpr int kTcM = 128;  // q rows per CTA: two consumer warpgroups of 64
constexpr int kTcN = 128;  // kv rows per tile
constexpr int kTcThreads = 384;  // the two consumers and a producer warpgroup
// registers per thread after setmaxnreg: 2 x 128 x 232 + 128 x 40 <= 65,536
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;

template <int D>
struct FwdSmem {
  static constexpr int kStages = 3;  // k and v tiles in flight
  static constexpr int kQ = kTcM * D * 2;
  static constexpr int kKV = kTcN * D * 2;
  static constexpr int kBars = kQ + 2 * kStages * kKV;  // full[], empty[]
  // q, (k, v) per stage, the barriers, and 1 KB to align the start
  static constexpr int kBytes = kBars + 16 * kStages + 1024;
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
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = row0 + 8 * ((i >> 1) & 1);
      const int c = k0 + 8 * (i >> 2) + col + (i & 1);
      if (!(r < Sq && c < Sk && visible(r, c, causal, window)))
        s[i] = -INFINITY;
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

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    int B, int Hq, int Hkv, int Sq, int Sk, float scale,
                    int causal, int window) {
  using L = tc::Tile<D>;
  using S = FwdSmem<D>;
  constexpr int NO = D / 2;     // accumulator floats per thread (64 x D)
  constexpr int NS = kTcN / 2;  // score floats per thread (64 x 128)
  constexpr int NP = kTcN / 16;  // A fragments of p
  const int nq = (Sq + kTcM - 1) / kTcM;
  const int heads = B * Hq;
  const int qb = nq - 1 - (int)(blockIdx.x / heads);  // late blocks first
  const int h = blockIdx.x % heads % Hq;
  const int b = blockIdx.x % heads / Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qb * kTcM;
  const int q1 = min(q0 + kTcM, Sq);
  const int tid = threadIdx.x;
  const int wg = tid / 128;  // 0, 1: consumers; 2: the producer
  const int lane = tid % 32;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = tc::smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;
  uint8_t* q_p = smem_raw + (q_s - raw);
  // stage st: full (its copies have landed), empty (the 8 consumer warps
  // are done with it)
  auto full = [&](int st) { return q_s + S::kBars + 8 * st; };
  auto empty = [&](int st) { return q_s + S::kBars + 8 * (S::kStages + st); };
  // step `it` reads kv block kb_lo + it: k at k_tile(it), v after it
  auto k_tile = [&](int it) {
    return q_s + S::kQ + (it % S::kStages) * 2 * S::kKV;
  };

  const int nk = (Sk + kTcN - 1) / kTcN;
  int kb_lo = nk, kb_hi = -1;
  for (int kb = 0; kb < nk; ++kb) {
    if (!block_hidden(q0, q1, kb * kTcN, min(kb * kTcN + kTcN, Sk), causal,
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
    // The producer: one thread asks TMA for q with the first block, then
    // for each kv block once the consumers have released its stage.
    tc::regs_dec<kProducerRegs>();
    if (tid == 256) {
      for (int it = 0; it < nkv; ++it) {
        const int st = it % S::kStages;
        if (it >= S::kStages)
          tc::mbar_wait(empty(st), (it / S::kStages - 1) & 1);
        tc::mbar_expect(full(st), 2 * S::kKV + (it == 0 ? S::kQ : 0));
        if (it == 0)
          tc::tma_tile<D, kTcM>(q_s, &tm_q, q0, b * Hq + h, full(st));
        const int k0 = (kb_lo + it) * kTcN;
        tc::tma_tile<D, kTcN>(k_tile(it), &tm_k, k0, b * Hkv + hk, full(st));
        tc::tma_tile<D, kTcN>(k_tile(it) + S::kKV, &tm_v, k0, b * Hkv + hk,
                              full(st));
      }
    }
  } else {
    tc::regs_inc<kConsumerRegs>();
    // Warpgroup wg owns q rows [64 wg, 64 wg + 64) of the block; this
    // thread rows row0 and row0 + 8, columns 8j + col + {0, 1}.
    const int row0 = q0 + 64 * wg + 16 * ((tid % 128) / 32) + lane / 4;
    const int col = 2 * (lane % 4);
    // s = q . k^T of step `it`, issued and committed (not waited)
    auto scores = [&](float (&s)[NS], int it) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        tc::mma_ss<kTcN, 0>(s, tc::desc_k<D>(q_s, kTcM, 64 * wg, kk),
                            tc::desc_k<D>(k_tile(it), kTcN, 0, kk), kk);
      tc::mma_commit();
    };
    // o += p . v of step `it`, issued and committed (not waited)
    auto accumulate = [&](float (&o)[NO], const uint32_t (&p)[NP][4],
                          int it) {
#pragma unroll
      for (int t = 0; t < NP; ++t)
        tc::mma_rs<D, 1>(o, p[t],
                         tc::desc_mn<D>(k_tile(it) + S::kKV, kTcN, t), 1);
      tc::mma_commit();
    };
    // The warpgroups take turns to issue their products (barriers 1 and
    // 2), so that one's softmax runs while the other's products are on the
    // tensor cores. Warpgroup 1 opens the first turn; warpgroup 0 takes the
    // last arrival after its last turn. No branch lies between a product's
    // issue and its wait: ptxas would serialise every product.
    auto turn_begin = [&]() { tc::bar_sync(1 + wg, 256); };
    auto turn_end = [&]() { tc::bar_arrive(2 - wg, 256); };
    if (wg == 1 && nkv > 0) tc::bar_arrive(1, 256);

    float o[NO], m[2], l[2], alpha[2], sum[2];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
    }
    uint32_t p[NP][4];  // p of the step before, as A fragments
    // Step `it` issues s of its block and o += p . v of the block before,
    // runs its softmax while that product runs, rescales o once the
    // product is done and releases the block before to the producer.
    if (nkv > 0) {
      tc::mbar_wait(full(0), 0);
      float s[NS];
      turn_begin();
      tc::mma_fence();
      scores(s, 0);
      turn_end();
      tc::mma_wait<0>();
      tc::hold(s);
      online_softmax(s, m, alpha, sum, kb_lo * kTcN, row0, col, q0, Sq, Sk,
                     scale, causal, window);
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = sum[r];
      tc::to_a<NP>(s, p);
    }
    for (int it = 1; it < nkv; ++it) {
      tc::mbar_wait(full(it % S::kStages), (it / S::kStages) & 1);
      float s[NS];
      turn_begin();
      tc::mma_fence();
      scores(s, it);
      accumulate(o, p, it - 1);
      turn_end();
      tc::mma_wait<1>();
      tc::hold(s);
      online_softmax(s, m, alpha, sum, (kb_lo + it) * kTcN, row0, col, q0,
                     Sq, Sk, scale, causal, window);
      tc::mma_wait<0>();
      tc::hold(o);
      tc::hold(p);
      if (lane == 0) tc::mbar_arrive(empty((it - 1) % S::kStages));
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + sum[r];
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
      tc::to_a<NP>(s, p);
    }
    if (nkv > 0) {
      turn_begin();
      tc::mma_fence();
      accumulate(o, p, nkv - 1);
      turn_end();
      tc::mma_wait<0>();
      tc::hold(o);
      tc::hold(p);
      if (wg == 0) tc::bar_sync(1, 256);  // warpgroup 1's last arrival
    }

    // out = o / l through this warpgroup's rows of q's shared memory (its
    // products are done with them), then 16-byte rows to global memory;
    // lse = m + log(l)
    const size_t qoff = ((size_t)b * Hq + h) * Sq * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float denom = l[r] == 0.f ? 1.f : l[r];
      const int row = row0 + 8 * r;
      if (lane % 4 == 0 && row < Sq)
        lse[((size_t)b * Hq + h) * Sq + row] = m[r] + logf(denom);
      l[r] = 1.f / denom;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r - q0;
        *reinterpret_cast<uint32_t*>(q_p + L::chunk(kTcM, row, j) + 2 * col) =
            tc::pack_bf16(o[4 * j + 2 * r] * l[r],
                          o[4 * j + 2 * r + 1] * l[r]);
      }
    tc::bar_sync(3 + wg, 128);
    for (int i = tid % 128; i < 64 * (D / 8); i += 128) {
      const int r = 64 * wg + i / (D / 8), c = i % (D / 8);
      if (q0 + r < Sq)
        *reinterpret_cast<uint4*>(out + qoff + (size_t)(q0 + r) * D + 8 * c) =
            *reinterpret_cast<const uint4*>(q_p + L::chunk(kTcM, r, c));
    }
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int Hq, int Hkv, int Sq, int Sk,
                float scale, int causal, int window, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  int e = tc::make_tile_map<D>(&tm_q, q, B * Hq, Sq, kTcM);
  if (e == 0) e = tc::make_tile_map<D>(&tm_k, k, B * Hkv, Sk, kTcN);
  if (e == 0) e = tc::make_tile_map<D>(&tm_v, v, B * Hkv, Sk, kTcN);
  if (e != 0) return e;
  const cudaError_t a = cudaFuncSetAttribute(
      fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      FwdSmem<D>::kBytes);
  if (a != cudaSuccess) return (int)a;
  const int nq = (Sq + kTcM - 1) / kTcM;
  fwd_bf16_kernel<D><<<nq * B * Hq, kTcThreads, FwdSmem<D>::kBytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(out), lse, B, Hq, Hkv, Sq,
      Sk, scale, causal, window);
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
                 void* out, float* lse, int B, int Hq, int Hkv, int Sq, int Sk,
                 float scale, int causal, int window, cudaStream_t s) {
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
