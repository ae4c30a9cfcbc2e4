// Flash-attention backward on Hopper's tensor cores (wgmma + TMA), bf16:
// dQ, dK and dV of causal or non-causal attention with GQA, at
// q_offset 0.
//
//   s_ij = scale * q_i . k_j,  P_ij = exp(s_ij - lse_i),
//   dP_ij = dO_i . v_j,  D_i = dO_i . O_i,  dS_ij = P_ij (dP_ij - D_i),
//   dQ_i = scale * sum_j dS_ij k_j,  dK_j = scale * sum_i dS_ij q_i,
//   dV_j = sum_i P_ij dO_i,
//   with j visible to i iff j <= i under the causal mask (always
//   otherwise, i < sq, j < sk), and the kv head
//   g = h / (H / KVH) of query head h: dK and dV of head g sum over its
//   query group.
//
// Replaces: no TPU kernel.  The JAX package trains through the chunked
//   XLA form of attention under autodiff and has no backward kernel; this
//   is the gradient of the port's forward kernel flash_attention_sm90.cu
//   (which replaces flash_attention_fwd,
//   src/repro/kernels/flash_attention/kernel.py) for bf16 at head dim 64,
//   128 and 256.  float32 stays on flash_attention_bwd.cu.  The plain
//   version is autograd through kernels/flash_attention/ref.py
//   attention_ref in float32.
//
// Arithmetic: lse_i comes from the forward kernel (its optional output),
// so no pass over the scores rebuilds it.  D_i is taken from the forward's
// bf16 output O, as FlashAttention-2 does.  The five products run as bf16
// wgmma with float32 accumulators: S and dP from the bf16 inputs (exact
// products), P and dS rounded once to bf16 before they enter dV += P^T dO,
// dK += dS^T Q and dQ += dS K.  The scale is applied to the float32
// scores after the product, as in the forward.  dQ, dK, dV round once to
// bf16.  (A plain-torch model of these roundings sits within the bf16
// gate with a third of it to spare: tests/test_torch_flash_design.py.)
//
// What bounds it on an H100: operations.  The least work is five
// products of 2 d flops a visible pair (the scores again, dP, dV, dK,
// dQ); at gemma-2b's training micro-batch (b=4, H=8, KVH=1, s=1024,
// d=256, causal) that is 43 GFLOP, 0.0435 ms at 989 TFLOP/s.  This
// kernel does seven: dQ has a kernel of its own, which computes S and dP
// once more, so that nothing is summed with float atomics.
//
// Design: four launches on the caller's stream, in order; no atomics
// anywhere, so the result is the same bits on every run (the resumed
// training run is bit-equal to the clean one).
//   1. delta: D_i = rowsum(dO_i * O_i) in float32, one warp a row.
//   2. dQ: one CTA per (query tile, head, batch row), heaviest causal
//      tiles first; the forward's shape: a producer warp loads Q and dO
//      once and keeps a ring of (K, V) tiles of 64 keys in flight with
//      TMA; each consumer warpgroup owns 64 query rows, computes
//      S = Q K^T and dP = dO V^T (m64n64k16, both operands K-major from
//      shared memory), P and dS in its accumulator fragments, and
//      dQ += dS K with dS from registers (the accumulator layout of S is
//      the A-fragment layout) and K as an MN-major B operand.  At d = 256
//      a CTA is one consumer warpgroup (Q and dO are 64 KB, two 64 KB
//      stages fill the rest of 227 KB); at d = 64 and 128 two.
//   3. dK/dV: one CTA of two consumer warpgroups and a producer warp per
//      (64-key tile, QUERY head, batch row): for gemma's MQA 16 x 8 x 4 =
//      512 CTAs instead of 16 x 1 x 4 under a CTA per kv head.  The key
//      tiles with the most causal work launch first (the grid is ordered
//      key tile outermost).  K and V stay in shared memory; a ring of
//      (Q, dO) tiles of 64 queries streams past from the diagonal on.
//      Per tile, warpgroup w computes the key-major S^T and dP^T for
//      queries 32w..32w+31 (m64n32k16: A = K or V, B = Q or dO), makes
//      P^T and dS^T there, and writes them as bf16 to shared memory in
//      the 128B swizzle; after a barrier of the two warpgroups,
//      warpgroup 0 accumulates dV += P^T dO and warpgroup 1
//      dK += dS^T Q over all 64 queries, each A from shared memory and B
//      MN-major.  The d = 256 pressure is split that way: each
//      warpgroup holds one 64 x 256 float32 accumulator (128 registers a
//      thread), not both, and the scores are computed once, half by
//      each.  At d = 256 the producer is a warpgroup that hands its
//      registers to the consumers (setmaxnreg, 24 and 240 a thread):
//      ptxas allots a 288-thread CTA 168 a thread, which spilled.
//      Shared memory at d = 256: K, V 64 KB, two (Q, dO) stages 128 KB,
//      P^T and dS^T 16 KB.
//   4. reduce (H > KVH only): each query head's dK/dV CTA wrote float32
//      partials to scratch the wrapper allocates (B, H, sk, d) x 2; this
//      sums a group's heads in ascending order and rounds once to bf16.
//      With H = KVH the dK/dV CTA writes bf16 directly.
// Queries and keys have lengths of their own, sq and sk (cross attention:
// sq decoder positions over sk encoder frames); causal attention takes
// sq == sk only (the wrapper checks).  Any sq, sk >= 1 is taken: TMA
// zero-fills rows past either length, and queries past sq and keys past
// sk are masked (P = 0) explicitly, each against its own length.

#include "flash_sm90.cuh"

namespace {

constexpr int kTile = 64;   // queries a dQ warpgroup, keys a dK/dV CTA,
                            // queries a dK/dV step, keys a dQ step

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// --- 1. delta --------------------------------------------------------------

__global__ void bwd_delta_kernel(const __nv_bfloat16* __restrict__ o,
                                 const __nv_bfloat16* __restrict__ dout,
                                 float* __restrict__ delta, long long rows,
                                 int D) {
  const long long row =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const __nv_bfloat16* po = o + row * D;
  const __nv_bfloat16* pd = dout + row * D;
  float acc = 0.f;
  for (int c = 8 * lane; c < D; c += 256) {
    const uint4 a = *reinterpret_cast<const uint4*>(po + c);
    const uint4 b = *reinterpret_cast<const uint4*>(pd + c);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(a2[i]);
      const float2 y = __bfloat1622float2(b2[i]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

// --- 2. dQ -------------------------------------------------------------------

template <int D>
struct DqCfg {
  static constexpr int kPanels = D / 64;
  static constexpr int kWG = D == 256 ? 1 : 2;        // consumer warpgroups
  static constexpr int kStages = D == 256 ? 2 : 4;    // (K, V) ring
  static constexpr int kConsumerWarps = 4 * kWG;
  static constexpr int kThreads = 32 * kConsumerWarps + 32;
  static constexpr int kBQ = kTile * kWG;              // query rows a CTA
  static constexpr int kQPanel = kBQ * kRowBytes;
  static constexpr int kQBytes = kPanels * kQPanel;    // Q; dO the same
  static constexpr int kStageBytes = 2 * kPanels * kPanelBytes;   // K, V
  static constexpr int kBarrierOff = 2 * kQBytes + kStages * kStageBytes;
  static constexpr int kAlloc = kBarrierOff + (2 * kStages + 1) * 8 + 1024;
  static_assert(kAlloc <= 232448, "dQ stage exceeds 227 KB");
};

template <int D>
__global__ void __launch_bounds__(DqCfg<D>::kThreads, 1)
bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tdo,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dq, int B, int H, int KVH, int sq,
              int sk, int causal, float scale) {
  using C = DqCfg<D>;
  constexpr int NP = C::kPanels;
  constexpr int kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                     // NP panels of kBQ rows
  const uint32_t do_s = base + C::kQBytes;       // the same for dO
  const uint32_t kv_s = base + 2 * C::kQBytes;   // per stage: K, then V
  const uint32_t bars = base + C::kBarrierOff;   // full[], empty[], q
  const uint32_t q_bar = bars + 16 * kStages;

  // heaviest causal tiles (the last query tiles) first
  const int nqt = (sq + C::kBQ - 1) / C::kBQ;
  const int bh = blockIdx.x % (B * H);
  const int q0 = (nqt - 1 - (int)blockIdx.x / (B * H)) * C::kBQ;
  const int h = bh % H;
  const int b = bh / H;
  const int g = h / (H / KVH);
  const int kend = causal ? min(sk, q0 + C::kBQ) : sk;
  const int ntiles = (kend + kTile - 1) / kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 8 * (kStages + st), C::kConsumerWarps);
    }
    mbar_init(q_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == C::kConsumerWarps) {
    // producer: Q and dO once, then the (K, V) ring
    if (lane == 0) {
      mbar_expect_tx(q_bar, 2 * C::kQBytes);
      for (int p = 0; p < NP; ++p)
        for (int w = 0; w < C::kWG; ++w) {
          const uint32_t off = p * C::kQPanel + w * kPanelBytes;
          tma_load(q_s + off, &tq, q_bar, 64 * p, q0 + kTile * w, bh);
          tma_load(do_s + off, &tdo, q_bar, 64 * p, q0 + kTile * w, bh);
        }
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages)
          mbar_wait(bars + 8 * (kStages + st), ((t / kStages) - 1) & 1);
        const uint32_t full = bars + 8 * st;
        const uint32_t ks = kv_s + st * C::kStageBytes;
        mbar_expect_tx(full, C::kStageBytes);
        for (int p = 0; p < NP; ++p) {
          tma_load(ks + p * kPanelBytes, &tk, full, 64 * p, t * kTile,
                   b * KVH + g);
          tma_load(ks + (NP + p) * kPanelBytes, &tv, full, 64 * p,
                   t * kTile, b * KVH + g);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63; this
  // thread holds rows row_a and row_a + 8 of its warp's 16
  const int wg = warp / 4;
  const int quad = lane % 4;
  const int row_a = q0 + wg * kTile + (warp % 4) * 16 + lane / 4;
  const int row_b = row_a + 8;
  const int wg_last = min(q0 + wg * kTile + kTile - 1, sq - 1);
  const bool wg_active = q0 + wg * kTile < sq;
  const uint32_t q_wg = q_s + wg * kPanelBytes;
  const uint32_t do_wg = do_s + wg * kPanelBytes;
  const long long rbase = (long long)bh * sq;
  const float lse_a = row_a < sq ? lse[rbase + row_a] : 0.f;
  const float lse_b = row_b < sq ? lse[rbase + row_b] : 0.f;
  const float del_a = row_a < sq ? delta[rbase + row_a] : 0.f;
  const float del_b = row_b < sq ? delta[rbase + row_b] : 0.f;

  float acc[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;

  mbar_wait(q_bar, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int st = t % kStages;
    const int k0 = t * kTile;
    mbar_wait(bars + 8 * st, (t / kStages) & 1);
    const uint32_t ks = kv_s + st * C::kStageBytes;
    const uint32_t vs = ks + NP * kPanelBytes;
    if (wg_active && (!causal || k0 <= wg_last)) {
      // S = Q K^T and dP = dO V^T over d in k-steps of 16
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      fence_regs(sc);
      fence_regs(dp);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;   // bytes into the row
        wgmma_ss(sc, sw128_desc(q_wg + (kk / 4) * C::kQPanel + col, 16),
                 sw128_desc(ks + (kk / 4) * kPanelBytes + col, 16), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss(dp, sw128_desc(do_wg + (kk / 4) * C::kQPanel + col, 16),
                 sw128_desc(vs + (kk / 4) * kPanelBytes + col, 16), kk > 0);
      }
      wg_commit();
      wg_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // P and dS; sc[4j + e] is row (e < 2 ? a : b), key
      // k0 + 8j + 2 quad + (e & 1)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * quad + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          const bool vis = key < sk && (!causal || key <= row);
          const float p =
              vis ? expf(sc[4 * j + e] * scale - (e < 2 ? lse_a : lse_b))
                  : 0.f;
          sc[4 * j + e] = p * (dp[4 * j + e] - (e < 2 ? del_a : del_b));
        }
      // dS as wgmma A fragments: step kk (keys 16kk..16kk+15) takes
      // sc[8kk + 2r], sc[8kk + 2r + 1] into register r
      uint32_t ds[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          ds[kk][r] = as_u32(__floats2bfloat162_rn(sc[8 * kk + 2 * r],
                                                   sc[8 * kk + 2 * r + 1]));

      // dQ += dS K, K's 64-column panel p for dQ columns 64p..64p+63
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int p = 0; p < NP; ++p)
          wgmma_rs_tb(acc[p], ds[kk],
                      sw128_desc(ks + p * kPanelBytes + kk * 16 * kRowBytes,
                                 1024));
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(ds[kk]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (kStages + st));   // release
  }

  if (!wg_active) return;
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * p + 8 * j + 2 * quad;
      if (row_a < sq)
        *reinterpret_cast<__nv_bfloat162*>(dq + (rbase + row_a) * D + col) =
            __floats2bfloat162_rn(acc[p][4 * j] * scale,
                                  acc[p][4 * j + 1] * scale);
      if (row_b < sq)
        *reinterpret_cast<__nv_bfloat162*>(dq + (rbase + row_b) * D + col) =
            __floats2bfloat162_rn(acc[p][4 * j + 2] * scale,
                                  acc[p][4 * j + 3] * scale);
    }
}

// --- 3. dK/dV ---------------------------------------------------------------

template <int D>
struct DkvCfg {
  static constexpr int kPanels = D / 64;
  static constexpr int kStages = D == 256 ? 2 : 4;    // (Q, dO) ring
  static constexpr int kConsumerWarps = 8;            // two warpgroups
  // the producer: one warp, or at d = 256 a warpgroup whose registers go
  // to the consumers (setmaxnreg: 24 a thread for it, 240 for them)
  static constexpr bool kSplitRegs = D == 256;
  static constexpr int kThreads =
      32 * kConsumerWarps + (kSplitRegs ? 128 : 32);
  static constexpr int kKVBytes = 2 * kPanels * kPanelBytes;     // K, V
  static constexpr int kStageBytes = 2 * kPanels * kPanelBytes;  // Q, dO
  static constexpr int kPOff = kKVBytes + kStages * kStageBytes;  // P^T
  static constexpr int kBarrierOff = kPOff + 2 * kPanelBytes;    // + dS^T
  static constexpr int kAlloc = kBarrierOff + (2 * kStages + 1) * 8 + 1024;
  static_assert(kAlloc <= 232448, "dK/dV stage exceeds 227 KB");
};

template <int D>
__global__ void __launch_bounds__(DkvCfg<D>::kThreads, 1)
bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                float* __restrict__ dk_part, float* __restrict__ dv_part,
                int B, int H, int KVH, int sq, int sk, int causal,
                float scale) {
  using C = DkvCfg<D>;
  constexpr int NP = C::kPanels;
  constexpr int kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = base;                           // K panels, then V
  const uint32_t v_s = base + NP * kPanelBytes;
  const uint32_t ring = base + C::kKVBytes;            // per stage: Q, dO
  const uint32_t pt_s = base + C::kPOff;               // P^T (keys x queries)
  const uint32_t dst_s = pt_s + kPanelBytes;           // dS^T
  const uint32_t bars = base + C::kBarrierOff;         // full[], empty[], kv
  const uint32_t kv_bar = bars + 16 * kStages;

  // key tile outermost: the first key tiles see the most causal queries
  const int bh = blockIdx.x % (B * H);
  const int k0 = ((int)blockIdx.x / (B * H)) * kTile;
  const int h = bh % H;
  const int b = bh / H;
  const int g = h / (H / KVH);
  const int qt0 = causal ? k0 / kTile : 0;
  const int ntiles = (sq + kTile - 1) / kTile - qt0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 8 * (kStages + st), C::kConsumerWarps);
    }
    mbar_init(kv_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= C::kConsumerWarps) {
    // producer: K and V once, then the (Q, dO) ring
    if constexpr (C::kSplitRegs) regs_dec<24>();
    if (warp == C::kConsumerWarps && lane == 0) {
      mbar_expect_tx(kv_bar, C::kKVBytes);
      for (int p = 0; p < NP; ++p) {
        tma_load(k_s + p * kPanelBytes, &tk, kv_bar, 64 * p, k0,
                 b * KVH + g);
        tma_load(v_s + p * kPanelBytes, &tv, kv_bar, 64 * p, k0,
                 b * KVH + g);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages)
          mbar_wait(bars + 8 * (kStages + st), ((t / kStages) - 1) & 1);
        const uint32_t full = bars + 8 * st;
        const uint32_t qs = ring + st * C::kStageBytes;
        const int q0 = (qt0 + t) * kTile;
        mbar_expect_tx(full, C::kStageBytes);
        for (int p = 0; p < NP; ++p) {
          tma_load(qs + p * kPanelBytes, &tq, full, 64 * p, q0, bh);
          tma_load(qs + (NP + p) * kPanelBytes, &tdo, full, 64 * p, q0, bh);
        }
      }
    }
    return;
  }
  if constexpr (C::kSplitRegs) regs_inc<240>();

  // consumers: warpgroup wg makes the S^T, dP^T columns (queries)
  // 32wg..32wg+31 of each tile, then accumulates dV (wg 0) or dK (wg 1);
  // this thread holds key rows key_a and key_a + 8
  const int wg = warp / 4;
  const int quad = lane % 4;
  const int r_a = (warp % 4) * 16 + lane / 4;   // key row in the tile
  const int key_a = k0 + r_a;
  const int key_b = key_a + 8;
  const long long rbase = (long long)bh * sq;   // lse, delta rows
  const uint32_t a_s = wg == 0 ? pt_s : dst_s;   // A of this wg's product

  float acc[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;

  mbar_wait(kv_bar, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int st = t % kStages;
    const int q0 = (qt0 + t) * kTile;
    const uint32_t qs = ring + st * C::kStageBytes;
    const uint32_t dos = qs + NP * kPanelBytes;
    // lse and D of this thread's query columns
    // q0 + 32wg + 8j + 2quad + c, j < 4, c < 2
    float lq[8], dl[8];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int q = q0 + 32 * wg + 8 * j + 2 * quad + c;
        lq[2 * j + c] = q < sq ? lse[rbase + q] : 0.f;
        dl[2 * j + c] = q < sq ? delta[rbase + q] : 0.f;
      }
    mbar_wait(bars + 8 * st, (t / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T for this wg's 32 queries
    float sc[16], dp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[i] = dp[i] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      const uint32_t bq = (kk / 4) * kPanelBytes + 32 * wg * kRowBytes + col;
      wgmma_ss_n32(sc, sw128_desc(k_s + (kk / 4) * kPanelBytes + col, 16),
                   sw128_desc(qs + bq, 16), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      const uint32_t bq = (kk / 4) * kPanelBytes + 32 * wg * kRowBytes + col;
      wgmma_ss_n32(dp, sw128_desc(v_s + (kk / 4) * kPanelBytes + col, 16),
                   sw128_desc(dos + bq, 16), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // P^T and dS^T; sc[4j + e] is key (e < 2 ? a : b), query
    // q0 + 32wg + 8j + 2quad + (e & 1); both go to shared memory as bf16
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 2 * j + (e & 1);
        const int q = q0 + 32 * wg + 8 * j + 2 * quad + (e & 1);
        const int key = e < 2 ? key_a : key_b;
        const bool vis = key < sk && q < sq && (!causal || key <= q);
        const float p = vis ? expf(sc[4 * j + e] * scale - lq[c]) : 0.f;
        sc[4 * j + e] = p;
        dp[4 * j + e] = p * (dp[4 * j + e] - dl[c]);
      }
      const int col = 32 * wg + 8 * j + 2 * quad;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t off = swz128(r_a + 8 * half, col);
        const int i = 4 * j + 2 * half;
        asm volatile("st.shared.b32 [%0], %1;" ::"r"(pt_s + off),
                     "r"(as_u32(__floats2bfloat162_rn(sc[i], sc[i + 1])))
                     : "memory");
        asm volatile("st.shared.b32 [%0], %1;" ::"r"(dst_s + off),
                     "r"(as_u32(__floats2bfloat162_rn(dp[i], dp[i + 1])))
                     : "memory");
      }
    }
    fence_async_smem();
    named_sync(1, 32 * C::kConsumerWarps);

    // wg 0: dV += P^T dO; wg 1: dK += dS^T Q, over the tile's 64
    // queries in k-steps of 16, B's 64-column panel p for columns
    // 64p..64p+63
    const uint32_t b_s = wg == 0 ? dos : qs;
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p)
        wgmma_ss_tb(acc[p], sw128_desc(a_s + kk * 32, 16),
                    sw128_desc(b_s + p * kPanelBytes + kk * 16 * kRowBytes,
                               1024));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
    // P^T and dS^T are read: the next tile may overwrite them
    named_sync(1, 32 * C::kConsumerWarps);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (kStages + st));   // release
  }

  // dV (wg 0) or dK (wg 1, times the scale) of keys key_a, key_b:
  // bf16 when this head is its group's only one, else a float32 partial
  // of query head h for the reduction
  const float mul = wg == 0 ? 1.f : scale;
  const bool direct = H == KVH;
  __nv_bfloat16* out = wg == 0 ? dv : dk;
  float* part = wg == 0 ? dv_part : dk_part;
  const long long obase =
      (direct ? (long long)b * KVH + g : (long long)bh) * sk;
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int key = half ? key_b : key_a;
        if (key >= sk) continue;
        const long long at = (obase + key) * D + 64 * p + 8 * j + 2 * quad;
        const float x = acc[p][4 * j + 2 * half] * mul;
        const float y = acc[p][4 * j + 2 * half + 1] * mul;
        if (direct)
          *reinterpret_cast<__nv_bfloat162*>(out + at) =
              __floats2bfloat162_rn(x, y);
        else
          *reinterpret_cast<float2*>(part + at) = make_float2(x, y);
      }
}

// --- 4. the group's sum ----------------------------------------------------

// out[b, g] = bf16(sum_{r < rep} part[b, g * rep + r]) in ascending r, for
// dK (blockIdx.y 0) and dV (1); plane = sk * d floats a head
__global__ void bwd_reduce_kernel(const float* __restrict__ dk_part,
                                  const float* __restrict__ dv_part,
                                  __nv_bfloat16* __restrict__ dk,
                                  __nv_bfloat16* __restrict__ dv, int rep,
                                  long long plane, long long n4) {
  const float* part = blockIdx.y == 0 ? dk_part : dv_part;
  __nv_bfloat16* out = blockIdx.y == 0 ? dk : dv;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n4; i += (long long)gridDim.x * blockDim.x) {
    const long long e = 4 * i;
    const long long bg = e / plane;
    const long long off = e % plane;
    const float* src = part + bg * rep * plane + off;
    float4 acc = *reinterpret_cast<const float4*>(src);
    for (int r = 1; r < rep; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(src + r * plane);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(out + e);
    o2[0] = __floats2bfloat162_rn(acc.x, acc.y);
    o2[1] = __floats2bfloat162_rn(acc.z, acc.w);
  }
}

// --- host side -------------------------------------------------------------------

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, void* dq, void* dk, void* dv,
           float* delta, float* dk_part, float* dv_part, int B, int H,
           int KVH, int sq, int sk, int causal, float scale,
           cudaStream_t stream) {
  using Q = DqCfg<D>;
  using KV = DkvCfg<D>;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, q, D, sq, B * H, kTile) ||
      !make_map(&tk, k, D, sk, B * KVH, kTile) ||
      !make_map(&tv, v, D, sk, B * KVH, kTile) ||
      !make_map(&tdo, dout, D, sq, B * H, kTile))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Q::kAlloc);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             KV::kAlloc);
  if (err != cudaSuccess) return (int)err;
  auto* dqp = static_cast<__nv_bfloat16*>(dq);
  auto* dkp = static_cast<__nv_bfloat16*>(dk);
  auto* dvp = static_cast<__nv_bfloat16*>(dv);

  const long long rows = (long long)B * H * sq;
  bwd_delta_kernel<<<(unsigned)((rows * 32 + 255) / 256), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), delta, rows, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const unsigned nq = (unsigned)((sq + Q::kBQ - 1) / Q::kBQ);
  bwd_dq_kernel<D><<<nq * B * H, Q::kThreads, Q::kAlloc, stream>>>(
      tq, tk, tv, tdo, lse, delta, dqp, B, H, KVH, sq, sk, causal, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const unsigned nk = (unsigned)((sk + kTile - 1) / kTile);
  bwd_dkdv_kernel<D><<<nk * B * H, KV::kThreads, KV::kAlloc, stream>>>(
      tq, tk, tv, tdo, lse, delta, dkp, dvp, dk_part, dv_part, B, H, KVH, sq,
      sk, causal, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if (H != KVH) {
    const long long plane = (long long)sk * D;
    const long long n4 = (long long)B * KVH * plane / 4;
    const long long want = (n4 + 255) / 256;
    const unsigned blocks = (unsigned)(want < 132 * 16 ? want : 132 * 16);
    bwd_reduce_kernel<<<dim3(blocks, 2), 256, 0, stream>>>(
        dk_part, dv_part, dkp, dvp, H / KVH, plane, n4);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q, out, dout, dq (B, H, sq, d); k, v, dk, dv (B, KVH, sk, d); lse
// (B, H, sq) float32 from flash_attention_sm90_fwd; float32 scratch delta
// (B, H, sq) and, when H > KVH, dk_part and dv_part (B, H, sk, d) (null
// otherwise); causal only at sq == sk; every base 16-byte aligned.
// Returns cudaGetLastError() after the last launch, or the first error.
extern "C" int flash_attention_bwd_sm90(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, void* dk_part, void* dv_part, int B, int H, int KVH, int sq,
    int sk, int d, int causal, float scale, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || sq <= 0 || sk <= 0 ||
      (causal && sq != sk) ||
      (H != KVH && (dk_part == nullptr || dv_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
       reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
       reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv) |
       reinterpret_cast<uintptr_t>(dk_part) |
       reinterpret_cast<uintptr_t>(dv_part)) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* kp = static_cast<float*>(dk_part);
  float* vp = static_cast<float*>(dv_part);
  switch (d) {
    case 64:
      return launch<64>(q, k, v, o, dout, l, dq, dk, dv, dl, kp, vp, B, H,
                        KVH, sq, sk, causal, scale, st);
    case 128:
      return launch<128>(q, k, v, o, dout, l, dq, dk, dv, dl, kp, vp, B, H,
                         KVH, sq, sk, causal, scale, st);
    case 256:
      return launch<256>(q, k, v, o, dout, l, dq, dk, dv, dl, kp, vp, B, H,
                         KVH, sq, sk, causal, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
