// Flash-attention forward on Hopper's tensor cores (wgmma + TMA), bf16.
//
//   out[b, h, i] = sum_j softmax_j(scale * q[b,h,i] . k[b,g,j]) v[b,g,j]
//   g = h / (H / KVH), scale = d^-0.5, causal: key j visible to query i
//   iff j <= i + q_offset.
//
// Replaces: flash_attention_fwd (body _flash_kernel),
//   src/repro/kernels/flash_attention/kernel.py, in the JAX package, for
//   bf16 inputs at head dim 64 and 128 (ops.py's dispatch table sends
//   float32 and other head dims to csrc/flash_attention.cu).  Same
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
//
// Design: one CTA of 288 threads per (128-query tile, head, batch row),
// heaviest causal tiles first: two consumer warpgroups of 64 query rows
// each, plus one producer warp.  The producer loads Q once, then keeps a
// ring of kStages (K, V) tiles of 64 keys in flight with TMA
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;             // query rows per CTA
constexpr int kBK = 64;              // keys per K/V tile
constexpr int kStages = 4;           // depth of the K/V ring
constexpr int kConsumerWarps = 8;    // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 32;   // + the producer warp
constexpr int kRowBytes = 128;       // one swizzled row: 64 bf16 columns
constexpr float kNegInf = -1e30f;

template <int D>
struct Smem {
  static constexpr int kPanels = D / 64;                  // 64-column panels
  static constexpr int kQPanel = kBQ * kRowBytes;         // 16 KB
  static constexpr int kKVPanel = kBK * kRowBytes;        // 8 KB
  static constexpr int kQBytes = kPanels * kQPanel;
  static constexpr int kStageBytes = 2 * kPanels * kKVPanel;   // K then V
  static constexpr int kBarrierOff = kQBytes + kStages * kStageBytes;
  static constexpr int kBytes = kBarrierOff + (2 * kStages + 1) * 8;
  static constexpr int kAlloc = kBytes + 1024;   // base aligned up to 1 KB
  static_assert(D == 64 || D == 128, "tensor-core kernel takes d = 64, 128");
  static_assert(kAlloc <= 232448, "shared stage exceeds 227 KB");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers and TMA -----------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// --- wgmma -------------------------------------------------------------------

// Shared-memory matrix descriptor, 128B swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 at bits 62-63.
// Every tile base is 1 KB aligned, so the base-offset field stays 0 and a
// K-major operand's k-steps inside the 128-byte row advance the address.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep registers that an in-flight wgmma reads or writes from being
// moved across this point
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define WG_ACC32(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),    \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),    \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),    \
      "+f"(d[31])
#define WG_REGS32                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "  \
  "%26, %27, %28, %29, %30, %31}"

// d (64 x 64, f32) (+)= A (64 x 16, smem, K-major) . B (16 x 64, smem,
// K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}"
      : WG_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, bf16 registers) . B (16 x 64, smem,
// MN-major: transpose bit set)
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : WG_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// --- the kernel ---------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      __nv_bfloat16* __restrict__ o, int H, int KVH, int sq,
                      int sk, int causal, int q_offset, float scale) {
  using S = Smem<D>;
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
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer: Q once, then the K/V ring
    if (lane == 0) {
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

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime: it is
// reached through the runtime's entry-point query, so the library links
// no libcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// (d, rows, planes) bf16, row-major: boxes of 64 columns x box_rows rows
// of one plane, 128B swizzle, out-of-range elements zero-filled
bool make_map(CUtensorMap* map, const void* ptr, int d, int rows, int planes,
              int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)d * 2 * (cuuint64_t)rows};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KVH, int sq, int sk, int causal, int q_offset, float scale,
           cudaStream_t stream) {
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
  flash_fwd_sm90_kernel<D><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), H, KVH, sq, sk, causal,
      q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q (B, H, sq, d), k and v (B, KVH, sk, d), out like q; every base
// 16-byte aligned.  Returns cudaGetLastError() after the launch (or the
// error that kept it from launching).
extern "C" int flash_attention_sm90_fwd(const void* q, const void* k,
                                        const void* v, void* o, int B, int H,
                                        int KVH, int sq, int sk, int d,
                                        int causal, int q_offset, float scale,
                                        void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || sq <= 0 || sk <= 0 ||
      q_offset < 0)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch<64>(q, k, v, o, B, H, KVH, sq, sk, causal, q_offset,
                        scale, st);
    case 128:
      return launch<128>(q, k, v, o, B, H, KVH, sq, sk, causal, q_offset,
                         scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
