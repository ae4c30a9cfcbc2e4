// Behavioural (bit-exact) approximate matmul through a 16-bit product
// table resident in shared memory.
//
//   out[i, j] = sum_k T[x[i,k] + o, w[k,j] + o]       exact int32
//
// with o = 128 for signed circuits, 0 for unsigned.
//
// Replaces: lut_matmul_pallas (body _lut_kernel),
//   src/repro/kernels/approx_matmul/kernel.py, in the JAX package, for
//   tables whose range max(T) - min(T) fits 16 bits (every multiplier of
//   the library: at most 65025, mul8u_exact).  ops.py's route table sends
//   wider tables, and work too small to pay for staging the table, to
//   csrc/lut_matmul.cu, which reads the int32 table from L2.
//
// What bounds it on an H100: shared-memory lookups.  Each (i, j, k) term
// is one data-dependent 2-byte load; an SM's shared memory returns one
// 128-byte wavefront a clock, at most 32 lookups, and only when the
// warp's 32 addresses fall in distinct banks (or share a word).  On
// uniform random operands a warp's lookups land in random banks and take
// about 3 wavefronts (tests/test_torch_lut_design.py models it from the
// constants below), so about 3x the conflict-free term is the realistic
// floor.  Everything else a lookup needs is kept off that path: one XOR
// forms its address, and the operands reach it as 16-byte shared loads
// shared by the warp.
//
// Design:
// - The host narrows the table once to T - min(T) as uint16 (128 KB; the
//   int32 table is 256 KB, over the 227 KB a block may hold) and stores
//   entry (a, b) at byte (a << 9) | ((b << 1) ^ ((a & 31) << 2)): each
//   512-byte row is XOR-swizzled by its row's low 5 bits, so lanes that
//   look up one column b in different rows a spread over the banks
//   instead of all hitting the bank of b.
// - Persistent blocks, one an SM (the table leaves room for no second):
//   each loads the table into dynamic shared memory once with four 1-D
//   bulk copies (cp.async.bulk, completed on an mbarrier), then walks
//   work units strided by the grid.  A unit is an output tile and a slice
//   of k: where the tiles are fewer than the SMs, k is split so that
//   every SM has a unit, and the slices' sums meet in the output by
//   integer atomics (exact in any order) after a memset.
// - Operands are staged per chunk of kKC k-steps in shared memory, double
//   buffered, one __syncthreads a chunk: x as the row part
//   (a << 9) | ((a & 31) << 2) of its index plus the table's shared
//   address, w as the column part b << 1, each formed once (and
//   range-checked) where it is loaded, with coalesced 16-byte global
//   loads where k and n are multiples of 4.  The column part shares no
//   bit with the row part's other terms and the table is row-aligned, so
//   a lookup's shared address is their XOR: one logic op and one 16-bit
//   shared load a term, the uint32 sum folding two terms an add.
// - Two thread layouts of 256 threads.  Wide (n > kNarrowMaxN): 16 x 16
//   threads, each 4 rows (strided by 16) x 2 neighbouring columns of a
//   64 x 32 tile, so a warp's lookups span 2 rows and 32 columns.
//   Narrow (n <= kNarrowMaxN, the behavioural slot groups' n = 1): 256 x
//   1 threads, each 2 rows of a 512 x 1 tile, so a warp's 32 lanes read
//   32 rows at one column: unswizzled, all in one bank.
// - The sum of the narrowed entries is kept in uint32 and k * min(T) is
//   added at the end, modulo 2^32: the int32 result is exact whenever the
//   true sum fits int32, which the wrapper's k <= 33000 guard ensures for
//   every 8-bit table (|T| <= 65025).  Rows, columns and k-steps past the
//   edges stage index 0; the padded k-steps' lookups of entry (0, 0) are
//   taken off the sum, and padded rows and columns are not stored.  An
//   operand outside the 8-bit domain trips a device-side assert, as in
//   csrc/lut_matmul.cu, and is never dereferenced.

#include <cassert>
#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// wide layout: 16 x 16 threads, 4 x 2 outputs each, 64 x 32 tiles
constexpr int kWideCols = 16;                 // thread columns
constexpr int kWideTM = 4;                    // rows a thread
constexpr int kWideTN = 2;                    // neighbouring columns a thread
constexpr int kWideKC = 32;                   // k-steps a staged chunk
// narrow layout: 256 x 1 threads, 2 x 1 outputs each, 512 x 1 tiles
constexpr int kNarrowCols = 1;
constexpr int kNarrowTM = 2;
constexpr int kNarrowTN = 1;
constexpr int kNarrowKC = 16;
constexpr int kNarrowMaxN = 16;               // n that takes the narrow layout
constexpr int kKGroup = 4;                    // k-steps a 16-byte operand load
constexpr int kPad = 4;                       // words after each staged x row
// swizzled byte offset of entry (a, b): (a << kRowShift) |
//   ((b << kColShift) ^ ((a & kSwizzleMask) << kSwizzleShift))
constexpr int kRowShift = 9;                  // 256 entries x 2 bytes a row
constexpr int kColShift = 1;
constexpr int kSwizzleMask = 31;
constexpr int kSwizzleShift = 2;
constexpr int kTableBytes = 256 << kRowShift;             // 128 KB
constexpr int kBulkBytes = kTableBytes / 4;               // per bulk copy
constexpr int kAlign = 1 << kRowShift;    // table base: row-aligned
constexpr int kMaxSmem = 232448;          // 227 KB a block
constexpr int kMaxDevices = 64;

template <int Cols, int TM, int TN, int KC>
struct Layout {
  static constexpr int kCols = Cols;
  static constexpr int kRows = kThreads / Cols;   // thread rows
  static constexpr int kTM = TM;
  static constexpr int kTN = TN;
  static constexpr int kKC = KC;
  static constexpr int kBM = kRows * TM;
  static constexpr int kBN = Cols * TN;
  static constexpr int kXStride = KC + kPad;      // words a staged x row
  static constexpr int kStageWords = kBM * kXStride + KC * kBN;
  static constexpr int kSmem =
      kTableBytes + kAlign + 2 * 4 * kStageWords + 16;   // + the mbarrier
  static_assert(kThreads % Cols == 0 && KC % kKGroup == 0, "layout");
  static_assert(TN == 1 || TN == 2, "w is read in ones or pairs");
  static_assert(kSmem <= kMaxSmem, "table and stages exceed 227 KB");
};
using Wide = Layout<kWideCols, kWideTM, kWideTN, kWideKC>;
using Narrow = Layout<kNarrowCols, kNarrowTM, kNarrowTN, kNarrowKC>;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

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

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Operands are 8-bit by construction on every caller's path; one outside
// the domain would index past the table.  The row part carries the
// table's shared address (row-aligned, so it leaves the swizzled bits
// alone): a lookup's address is then one XOR.
__device__ __forceinline__ uint32_t row_part(int v, int offset,
                                             uint32_t tab) {
  const uint32_t a = (uint32_t)(v + offset);
  assert(a <= 255u);
  return tab + ((a << kRowShift) | ((a & kSwizzleMask) << kSwizzleShift));
}

__device__ __forceinline__ uint32_t col_part(int v, int offset) {
  const uint32_t b = (uint32_t)(v + offset);
  assert(b <= 255u);
  return b << kColShift;
}

// one zero-extended 16-bit entry at a shared address
__device__ __forceinline__ uint32_t lookup(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u16 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

// One chunk of raw operands in flight from global memory: x over
// (kBM, kKC), w over (kKC, kBN), each thread a fixed share.  Out-of-range
// elements hold `pad`, the value whose index is 0.
template <class L, bool kVec>
struct Chunk {
  static constexpr int kXVecs = L::kBM * L::kKC / 4 / kThreads;
  static constexpr int kWVecs = L::kKC * L::kBN / 4;
  static constexpr int kWVec = kVec && L::kBN % 4 == 0;
  static constexpr int kXN = kVec ? 4 * kXVecs : L::kBM * L::kKC / kThreads;
  static constexpr int kWN = kWVec ? 4 * ((kWVecs + kThreads - 1) / kThreads)
                                   : (L::kKC * L::kBN + kThreads - 1) /
                                         kThreads;
  static_assert(L::kBM * L::kKC % (4 * kThreads) == 0, "x chunk share");
  int x[kXN];
  int w[kWN];

  __device__ __forceinline__ void load(const int* __restrict__ xg,
                                       const int* __restrict__ wg, int M,
                                       int N, int K, int r0, int c0, int k0,
                                       int ke, int pad) {
    const int t = threadIdx.x;
    if constexpr (kVec) {
#pragma unroll
      for (int v = 0; v < kXVecs; ++v) {
        const int e = t + v * kThreads;
        const int r = e / (L::kKC / 4), kk = 4 * (e % (L::kKC / 4));
        int4 q = make_int4(pad, pad, pad, pad);
        if (r0 + r < M && k0 + kk < ke)
          q = __ldg(reinterpret_cast<const int4*>(
              xg + (long long)(r0 + r) * K + k0 + kk));
        x[4 * v] = q.x;
        x[4 * v + 1] = q.y;
        x[4 * v + 2] = q.z;
        x[4 * v + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int v = 0; v < kXN; ++v) {
        const int e = t + v * kThreads;
        const int r = e / L::kKC, kk = e % L::kKC;
        x[v] = (r0 + r < M && k0 + kk < ke)
                   ? __ldg(xg + (long long)(r0 + r) * K + k0 + kk)
                   : pad;
      }
    }
    if constexpr (kWVec) {
#pragma unroll
      for (int v = 0; v < kWN / 4; ++v) {
        const int e = t + v * kThreads;
        const int kk = e / (L::kBN / 4), c = 4 * (e % (L::kBN / 4));
        int4 q = make_int4(pad, pad, pad, pad);
        if (e < kWVecs && k0 + kk < ke && c0 + c < N)
          q = __ldg(reinterpret_cast<const int4*>(
              wg + (long long)(k0 + kk) * N + c0 + c));
        w[4 * v] = q.x;
        w[4 * v + 1] = q.y;
        w[4 * v + 2] = q.z;
        w[4 * v + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int v = 0; v < kWN; ++v) {
        const int e = t + v * kThreads;
        const int kk = e / L::kBN, c = e % L::kBN;
        w[v] = (e < L::kKC * L::kBN && k0 + kk < ke && c0 + c < N)
                   ? __ldg(wg + (long long)(k0 + kk) * N + c0 + c)
                   : pad;
      }
    }
  }

  // row and column parts into one stage: xs[r][kk] (row stride
  // kXStride), ws[kk][c]
  __device__ __forceinline__ void store(uint32_t* xs, uint32_t* ws,
                                        int offset, uint32_t tab) const {
    const int t = threadIdx.x;
    if constexpr (kVec) {
#pragma unroll
      for (int v = 0; v < kXVecs; ++v) {
        const int e = t + v * kThreads;
        const int r = e / (L::kKC / 4), kk = 4 * (e % (L::kKC / 4));
        *reinterpret_cast<uint4*>(xs + r * L::kXStride + kk) = make_uint4(
            row_part(x[4 * v], offset, tab),
            row_part(x[4 * v + 1], offset, tab),
            row_part(x[4 * v + 2], offset, tab),
            row_part(x[4 * v + 3], offset, tab));
      }
    } else {
#pragma unroll
      for (int v = 0; v < kXN; ++v) {
        const int e = t + v * kThreads;
        xs[(e / L::kKC) * L::kXStride + e % L::kKC] =
            row_part(x[v], offset, tab);
      }
    }
    if constexpr (kWVec) {
#pragma unroll
      for (int v = 0; v < kWN / 4; ++v) {
        const int e = t + v * kThreads;
        if (e < kWVecs)
          *reinterpret_cast<uint4*>(ws + 4 * e) = make_uint4(
              col_part(w[4 * v], offset), col_part(w[4 * v + 1], offset),
              col_part(w[4 * v + 2], offset), col_part(w[4 * v + 3], offset));
      }
    } else {
#pragma unroll
      for (int v = 0; v < kWN; ++v) {
        const int e = t + v * kThreads;
        if (e < L::kKC * L::kBN) ws[e] = col_part(w[v], offset);
      }
    }
  }
};

// The lookups of one staged chunk: for every group of 4 k-steps, the
// thread's kTM row parts as 16-byte loads, its columns' parts, then
// kTM * kTN * 4 terms of one XOR and one 16-bit shared load each.
template <class L>
__device__ __forceinline__ void lookup_chunk(const uint32_t* xs,
                                             const uint32_t* ws, int tr,
                                             int tc,
                                             uint32_t (&acc)[L::kTM][L::kTN]) {
#pragma unroll 1
  for (int kk = 0; kk < L::kKC; kk += kKGroup) {
    uint4 xr[L::kTM];
    uint32_t wc[kKGroup][L::kTN];
#pragma unroll
    for (int i = 0; i < L::kTM; ++i)
      xr[i] = *reinterpret_cast<const uint4*>(
          xs + (tr + i * L::kRows) * L::kXStride + kk);
    if constexpr (L::kTN == 2) {
#pragma unroll
      for (int q = 0; q < kKGroup; ++q) {
        const uint2 v = *reinterpret_cast<const uint2*>(
            ws + (kk + q) * L::kBN + 2 * tc);
        wc[q][0] = v.x;
        wc[q][1] = v.y;
      }
    } else {
      const uint4 v = *reinterpret_cast<const uint4*>(ws + kk);  // kBN == 1
      wc[0][0] = v.x;
      wc[1][0] = v.y;
      wc[2][0] = v.z;
      wc[3][0] = v.w;
    }
#pragma unroll
    for (int i = 0; i < L::kTM; ++i) {
      const uint32_t xq[kKGroup] = {xr[i].x, xr[i].y, xr[i].z, xr[i].w};
#pragma unroll
      for (int j = 0; j < L::kTN; ++j) {
        uint32_t s = 0;
#pragma unroll
        for (int q = 0; q < kKGroup; ++q) s += lookup(xq[q] ^ wc[q][j]);
        acc[i][j] += s;
      }
    }
  }
}

template <class L, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
    lut_matmul_sm90_kernel(const int* __restrict__ x,
                           const int* __restrict__ w,
                           const unsigned short* __restrict__ table,
                           int* __restrict__ out, int M, int N, int K,
                           int offset, int tmin, int splits, int kslice) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem_raw + (base - raw) +
                                                kTableBytes);
  const uint32_t bar = base + kTableBytes + 2 * 4 * L::kStageWords;
  const int t = threadIdx.x;
  if (t == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    mbar_expect_tx(bar, kTableBytes);
#pragma unroll
    for (int c = 0; c < kTableBytes; c += kBulkBytes)
      bulk_load(base + c, reinterpret_cast<const unsigned char*>(table) + c,
                kBulkBytes, bar);
  }
  const int pad = -offset;                      // stages index 0
  const int tr = t / L::kCols, tc = t % L::kCols;
  const int tiles_n = (N + L::kBN - 1) / L::kBN;
  const long long units =
      (long long)((M + L::kBM - 1) / L::kBM) * tiles_n * splits;
  bool table_ready = false;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const long long tile = u / splits;
    const int slice = (int)(u % splits);
    const int r0 = (int)(tile / tiles_n) * L::kBM;
    const int c0 = (int)(tile % tiles_n) * L::kBN;
    const int kb = slice * kslice;
    const int ke = min(K, kb + kslice);
    const int chunks = (ke - kb + L::kKC - 1) / L::kKC;

    uint32_t acc[L::kTM][L::kTN] = {};
    Chunk<L, kVec> ch;
    if (chunks > 0) {
      ch.load(x, w, M, N, K, r0, c0, kb, ke, pad);
      ch.store(stage, stage + L::kBM * L::kXStride, offset, base);
    }
    __syncthreads();
    if (!table_ready) {
      mbar_wait(bar, 0);
      table_ready = true;
    }
    for (int c = 0; c < chunks; ++c) {
      uint32_t* xs = stage + (c & 1) * L::kStageWords;
      if (c + 1 < chunks)
        ch.load(x, w, M, N, K, r0, c0, kb + (c + 1) * L::kKC, ke, pad);
      lookup_chunk<L>(xs, xs + L::kBM * L::kXStride, tr, tc, acc);
      if (c + 1 < chunks) {
        uint32_t* nx = stage + ((c + 1) & 1) * L::kStageWords;
        ch.store(nx, nx + L::kBM * L::kXStride, offset, base);
      }
      __syncthreads();
    }
    // k * tmin once (slice 0), less the padded k-steps' entry (0, 0)
    const uint32_t padded = (uint32_t)(chunks * L::kKC - (ke - kb));
    const uint32_t bias = (slice == 0 ? (uint32_t)K * (uint32_t)tmin : 0u) -
                          padded * lookup(base);
#pragma unroll
    for (int i = 0; i < L::kTM; ++i)
#pragma unroll
      for (int j = 0; j < L::kTN; ++j) {
        const int r = r0 + tr + i * L::kRows, c = c0 + tc * L::kTN + j;
        if (r < M && c < N) {
          int* o = out + (long long)r * N + c;
          if (splits == 1)
            *o = (int)(acc[i][j] + bias);
          else
            atomicAdd(reinterpret_cast<unsigned int*>(o), acc[i][j] + bias);
        }
      }
  }
  if (!table_ready) mbar_wait(bar, 0);   // no bulk copy outlives the block
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <class L, bool kVec>
int launch(const int* x, const int* w, const unsigned short* table, int* out,
           int m, int n, int k, int offset, int tmin, cudaStream_t stream) {
  // the shared-memory size and the SM count, set and read once a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  static int sms_of[kMaxDevices];
  int sms = sms_of[dev];
  if (sms == 0) {
    err = cudaFuncSetAttribute(lut_matmul_sm90_kernel<L, kVec>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kSmem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sms_of[dev] = sms;
  }
  const long long tiles =
      (long long)((m + L::kBM - 1) / L::kBM) * ((n + L::kBN - 1) / L::kBN);
  // fewer tiles than SMs: split k into slices of whole chunks, so that
  // every SM gets a unit
  int splits = 1, kslice = k;
  if (tiles < sms && k > L::kKC) {
    const int want = (int)(sms / tiles);
    const int chunks = (k + L::kKC - 1) / L::kKC;
    const int per = (chunks + want - 1) / want;
    kslice = per * L::kKC;
    splits = (k + kslice - 1) / kslice;
    if (splits == 1) kslice = k;
  }
  if (splits > 1) {
    const cudaError_t e = cudaMemsetAsync(out, 0, (size_t)m * n * 4, stream);
    if (e != cudaSuccess) return (int)e;
  }
  const long long units = tiles * splits;
  const int grid = (int)(units < sms ? units : sms);
  lut_matmul_sm90_kernel<L, kVec><<<grid, kThreads, L::kSmem, stream>>>(
      x, w, table, out, m, n, k, offset, tmin, splits, kslice);
  return (int)cudaGetLastError();
}

template <class L>
int launch_layout(const int* x, const int* w, const unsigned short* t,
                  int* o, int m, int n, int k, int offset, int tmin,
                  cudaStream_t s) {
  if (k % kKGroup == 0 && n % 4 == 0 && aligned16(x) && aligned16(w))
    return launch<L, true>(x, w, t, o, m, n, k, offset, tmin, s);
  return launch<L, false>(x, w, t, o, m, n, k, offset, tmin, s);
}

}  // namespace

// table: the (256, 256) table narrowed to T - tmin as uint16 in the
// swizzled layout above, 16-byte aligned (the bulk copy's unit).
extern "C" int lut_matmul_sm90(const void* x, const void* w,
                               const void* table, void* out, int m, int n,
                               int k, int offset, int tmin, void* stream) {
  if (m == 0 || n == 0) return 0;
  if (m < 0 || n < 0 || k < 0 || !aligned16(table))
    return (int)cudaErrorInvalidValue;
  const auto* xi = static_cast<const int*>(x);
  const auto* wi = static_cast<const int*>(w);
  const auto* t = static_cast<const unsigned short*>(table);
  auto* o = static_cast<int*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (n <= kNarrowMaxN)
    return launch_layout<Narrow>(xi, wi, t, o, m, n, k, offset, tmin, s);
  return launch_layout<Wide>(xi, wi, t, o, m, n, k, offset, tmin, s);
}
