// Flash-attention forward on Hopper's tensor cores (wgmma + TMA), bf16.
//
//   out[b, h, i] = sum_j softmax_j(scale * q[b,h,i] . k[b,g,j]) v[b,g,j]
//   g = h / (H / KVH), scale = d^-0.5, causal: key j visible to query i
//   iff j <= i + q_offset.
//
// Replaces: flash_attention_fwd (body _flash_kernel),
//   src/repro/kernels/flash_attention/kernel.py, in the JAX package, for
//   bf16 inputs at head dim 64, 128 and 256 (ops.py's dispatch table
//   sends float32 to csrc/flash_attention.cu).  Same
//   function: scores, running max, exp and sums in float32, masked
//   scores -1e30, output acc / max(l, 1e-30) rounded to bf16.  Two
//   roundings differ from the plain version: the scale is applied to the
//   float32 scores after the bf16 product instead of to q before it (one
//   float32 rounding), and P enters the second product as bf16 hi + lo
//   (p = hi + lo + O(2^-17 p)), so P.V keeps about 16 mantissa bits of P
//   where one bf16 P would keep 8 and miss the bf16 gate on rows with few
//   keys.  V is exact in bf16, so both products are exact up to their
//   float32 sums.
//
// What bounds it on an H100: operations.  At the serving shape (b=8,
// H=32, KVH=8, s=1024, d=128, causal) the two products are ~69 GFLOP
// against ~67 MB of q/k/v/out; on the tensor cores (989 TFLOP/s bf16
// dense) that is 0.07 ms, with the hi/lo split 1.5x the products.
// gemma-2b's prefill (b=8, H=8, KVH=1, s=1024, d=256) is ~34 GFLOP:
// 0.035 ms.
//
// Log-sum-exp: given a pointer (the autograd path), the kernel also
// writes lse_i = m_i + log(l_i) in float32, natural log of the scaled,
// masked scores, which the backward (flash_attention_bwd_sm90.cu) takes
// instead of recomputing the scores for it; inference passes null and
// pays nothing.
//
// Design: one CTA of 288 threads (384 at d = 256, below) per (128-query
// tile, head, batch row), heaviest causal tiles first: two consumer
// warpgroups of 64 query rows each, plus one producer warp.  The
// producer loads Q once, then keeps a ring of kStages (K, V) tiles of
// 64 keys in flight with TMA
// (cp.async.bulk.tensor, 3-d maps (d, s, b*heads) so rows past s are
// zero-filled per head), each stage completed on a "full" mbarrier and
// released by the 8 consumer warps on an "empty" one.  Tiles are stored
// as 64-column panels of 128-byte rows in TMA's 128B swizzle, which the
// wgmma shared-memory descriptors name with the same swizzle mode.  Per
// tile a warpgroup computes S = Q.K^T with wgmma m64n64k16 (A = Q and
// B = K both K-major from shared memory), scales and masks S in float32
// (keys >= sk and causal keys masked explicitly: a zero-filled K row
// scores 0, not -1e30), updates the online softmax on the accumulator
// fragments (row max and sum across the 4 lanes of a row, shfl_xor 1
// and 2), and accumulates O += P.V with P from registers (the
// accumulator layout of S is the A-fragment layout of the next wgmma)
// and V as an MN-major B operand (transpose bit).  A warpgroup skips
// tiles past its own diagonal; the CTA's key loop stops at its last
// row's diagonal.  GQA maps query head h to kv head h / (H / KVH) in
// the K/V coordinates; no repeated copy is made.
//
// Head dim 256: the ring is a per-head-dim constant, 4 stages at d = 64
// and 128, 2 at d = 256, where a stage (K and V, 64 keys) is 64 KB and Q
// another 64 KB (193 KB with the barriers and the 1 KB alignment).  The
// registers: a consumer thread holds its 64 x 256 float32 O in 128
// registers, S in 32 and P hi/lo in 32 (S is dead once P is built).
// ptxas allots registers to a 288-thread CTA as if it had 384 threads,
// 168 a thread, and the d = 256 working set spilled to local memory.  Of
// the three ways to make room (setmaxnreg, a 64-query CTA with one
// consumer warpgroup, fewer keys per tile) d = 256 takes setmaxnreg:
// the producer becomes a warpgroup that keeps 24 registers a thread, the
// two consumer warpgroups take 240.  A 64-query CTA would load each K/V
// tile for half as many queries and leave one warpgroup's softmax
// unhidden by the other's products; fewer keys per tile frees only the
// 32 registers of S and P, not enough under 168.

#include "flash_sm90.cuh"

namespace {

constexpr int kBQ = 128;             // query rows per CTA
constexpr int kBK = 64;              // keys per K/V tile
constexpr int kConsumerWarps = 8;    // two warpgroups

template <int D>
struct Smem {
  static constexpr int kPanels = D / 64;                  // 64-column panels
  // depth of the K/V ring: a d = 256 stage is 64 KB, and Q another 64
  static constexpr int kStages = D == 256 ? 2 : 4;
  static constexpr int kQPanel = kBQ * kRowBytes;         // 16 KB
  static constexpr int kKVPanel = kBK * kRowBytes;        // 8 KB
  static constexpr int kQBytes = kPanels * kQPanel;
  static constexpr int kStageBytes = 2 * kPanels * kKVPanel;   // K then V
  static constexpr int kBarrierOff = kQBytes + kStages * kStageBytes;
  static constexpr int kBytes = kBarrierOff + (2 * kStages + 1) * 8;
  static constexpr int kAlloc = kBytes + 1024;   // base aligned up to 1 KB
  // the producer: one warp, or at d = 256 a warpgroup whose registers
  // go to the consumers (setmaxnreg: 24 a thread for it, 240 for them)
  static constexpr bool kSplitRegs = D == 256;
  static constexpr int kThreads = 32 * kConsumerWarps + (kSplitRegs ? 128 : 32);
  static_assert(D == 64 || D == 128 || D == 256,
                "tensor-core kernel takes d = 64, 128, 256");
  static_assert(kAlloc <= 232448, "shared stage exceeds 227 KB");
};

// --- the kernel ---------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(Smem<D>::kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int H, int KVH, int sq,
                      int sk, int causal, int q_offset, float scale) {
  using S = Smem<D>;
  constexpr int kStages = S::kStages;
  constexpr int NP = S::kPanels;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                     // NP panels of 128 rows
  const uint32_t kv_s = base + S::kQBytes;       // per stage: K, then V
  const uint32_t bars = base + S::kBarrierOff;   // full[], empty[], q
  const uint32_t q_bar = bars + 16 * kStages;

  const int q0 = ((int)gridDim.x - 1 - (int)blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KVH);
  const int kend = causal ? min(sk, min(q0 + kBQ, sq) + q_offset) : sk;
  const int ntiles = (kend + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 8 * (kStages + st), kConsumerWarps);
    }
    mbar_init(q_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // producer: Q once, then the K/V ring
    if constexpr (S::kSplitRegs) regs_dec<24>();
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect_tx(q_bar, S::kQBytes);
      for (int p = 0; p < NP; ++p)
        tma_load(q_s + p * S::kQPanel, &tq, q_bar, 64 * p, q0, b * H + h);
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages)
          mbar_wait(bars + 8 * (kStages + st), ((t / kStages) - 1) & 1);
        const uint32_t full = bars + 8 * st;
        const uint32_t ks = kv_s + st * S::kStageBytes;
        mbar_expect_tx(full, S::kStageBytes);
        for (int p = 0; p < NP; ++p) {
          tma_load(ks + p * S::kKVPanel, &tk, full, 64 * p, t * kBK,
                   b * KVH + g);
          tma_load(ks + (NP + p) * S::kKVPanel, &tv, full, 64 * p, t * kBK,
                   b * KVH + g);
        }
      }
    }
    return;
  }
  if constexpr (S::kSplitRegs) regs_inc<240>();

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63; this
  // thread holds rows row_a and row_a + 8 of its warp's 16
  const int wg = warp / 4;
  const int quad = lane % 4;
  const int row_a = q0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int row_b = row_a + 8;
  const int wg_first = q0 + wg * 64;
  const int wg_last = min(wg_first + 63, sq - 1);
  const bool wg_active = wg_first < sq;
  const uint32_t q_wg = q_s + wg * 64 * kRowBytes;

  float acc[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  mbar_wait(q_bar, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int st = t % kStages;
    const int k0 = t * kBK;
    mbar_wait(bars + 8 * st, (t / kStages) & 1);
    const uint32_t ks = kv_s + st * S::kStageBytes;
    const uint32_t vs = ks + NP * S::kKVPanel;
    if (wg_active && (!causal || k0 <= wg_last + q_offset)) {
      // S = Q . K^T over d in k-steps of 16
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      fence_regs(s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;   // bytes into the row
        wgmma_ss(s, sw128_desc(q_wg + (kk / 4) * S::kQPanel + col, 16),
                 sw128_desc(ks + (kk / 4) * S::kKVPanel + col, 16), kk > 0);
      }
      wg_commit();
      wg_wait_all();
      fence_regs(s);

      // scale, mask, online softmax; s[4j + e] is row (e < 2 ? a : b),
      // key k0 + 8j + 2 quad + (e & 1)
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * quad + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          float x = s[4 * j + e] * scale;
          if (key >= sk || (causal && key > row + q_offset)) x = kNegInf;
          s[4 * j + e] = x;
          if (e < 2) mx_a = fmaxf(mx_a, x);
          else mx_b = fmaxf(mx_b, x);
        }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;

      // P as wgmma A fragments, hi + lo: step kk (keys 16kk..16kk+15)
      // takes s[8kk + 2r], s[8kk + 2r + 1] into register r (row a for
      // even r, row b for odd r)
      uint32_t hi[4][4], lo[4][4];
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i0 = 8 * kk + 2 * r;
          const float mr = (r & 1) ? mn_b : mn_a;
          const float p0 = expf(s[i0] - mr);
          const float p1 = expf(s[i0 + 1] - mr);
          if (r & 1) sum_b += p0 + p1;
          else sum_a += p0 + p1;
          const __nv_bfloat162 ph = __floats2bfloat162_rn(p0, p1);
          const float2 phf = __bfloat1622float2(ph);
          hi[kk][r] = as_u32(ph);
          lo[kk][r] = as_u32(__floats2bfloat162_rn(p0 - phf.x, p1 - phf.y));
        }
      l_a = l_a * al_a + sum_a;
      l_b = l_b * al_b + sum_b;
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[p][i] *= (i % 4) < 2 ? al_a : al_b;

      // O += P . V, V's 64-column panel p for output columns 64p..64p+63
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const uint64_t dv =
              sw128_desc(vs + p * S::kKVPanel + kk * 16 * kRowBytes, 1024);
          wgmma_rs_tb(acc[p], hi[kk], dv);
          wgmma_rs_tb(acc[p], lo[kk], dv);
        }
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(hi[kk]);
        fence_regs(lo[kk]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (kStages + st));   // release
  }

  if (!wg_active) return;
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  const long long obase = ((long long)b * H + h) * sq;
  if (lse != nullptr && quad == 0) {   // log-sum-exp of the scaled scores
    if (row_a < sq) lse[obase + row_a] = m_a + logf(den_a);
    if (row_b < sq) lse[obase + row_b] = m_b + logf(den_b);
  }
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * p + 8 * j + 2 * quad;
      if (row_a < sq)
        *reinterpret_cast<__nv_bfloat162*>(o + (obase + row_a) * D + col) =
            __floats2bfloat162_rn(acc[p][4 * j] / den_a,
                                  acc[p][4 * j + 1] / den_a);
      if (row_b < sq)
        *reinterpret_cast<__nv_bfloat162*>(o + (obase + row_b) * D + col) =
            __floats2bfloat162_rn(acc[p][4 * j + 2] / den_b,
                                  acc[p][4 * j + 3] / den_b);
    }
}

// --- host side -------------------------------------------------------------------

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int KVH, int sq, int sk, int causal, int q_offset,
           float scale, cudaStream_t stream) {
  constexpr int smem = Smem<D>::kAlloc;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, D, sq, B * H, kBQ) ||
      !make_map(&tk, k, D, sk, B * KVH, kBK) ||
      !make_map(&tv, v, D, sk, B * KVH, kBK))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((sq + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  flash_fwd_sm90_kernel<D><<<grid, Smem<D>::kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, H, KVH, sq, sk,
      causal, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q (B, H, sq, d), k and v (B, KVH, sk, d), out like q; every base
// 16-byte aligned.  lse, when not null, receives each query row's
// float32 log-sum-exp (B, H, sq) of its scaled, masked scores (natural
// log: the backward's P = exp(scale q.k - lse)).  Returns
// cudaGetLastError() after the launch (or the error that kept it from
// launching).
extern "C" int flash_attention_sm90_fwd(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int B, int H, int KVH, int sq,
                                        int sk, int d, int causal,
                                        int q_offset, float scale,
                                        void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || sq <= 0 || sk <= 0 ||
      q_offset < 0)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (d) {
    case 64:
      return launch<64>(q, k, v, o, l, B, H, KVH, sq, sk, causal, q_offset,
                        scale, st);
    case 128:
      return launch<128>(q, k, v, o, l, B, H, KVH, sq, sk, causal, q_offset,
                         scale, st);
    case 256:
      return launch<256>(q, k, v, o, l, B, H, KVH, sq, sk, causal, q_offset,
                         scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
