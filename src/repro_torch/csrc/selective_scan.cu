// Mamba-1 selective scan, forward, on Hopper's CUDA cores and SFU.
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t
//   y_t = <h_t, C_t>
//
// x/dt (b, s, di), A (di, n), B/C (b, s, n), h0 (b, di, n), all float32,
// n in 1..16; writes y (b, s, di) and the final state hT (b, di, n), and,
// where a pointer is passed (a training forward), the chunk states hc
// (b, ceil(s / kChunk), di, n): the state entering each chunk of kChunk =
// 64 steps (hc[:, 0] = h0), which csrc/selective_scan_bwd.cu recomputes
// its chunks from with the same arithmetic, so it meets this kernel's
// bits.  Serving passes none and runs the instantiation without them.
//
// Replaces: selective_scan_pallas (body _scan_kernel),
//   src/repro/kernels/selective_scan/kernel.py, in the JAX package.
//
// What bounds it on an H100, at falcon-mamba-7b's prefill (b = 8,
// s = 1024, di = 8192, n = 16):
//   - Bytes: x and dt read, y written (12 bytes a (token, channel)),
//     plus B, C, A, h0 and hT: 815 MB over 3.35 TB/s, 0.243 ms.  This is
//     the bound.
//   - Exponentials: one per (token, channel, state), 1.07 G of them.  On
//     the SFU alone (MUFU.EX2, 16 a clock on each of the 132 SMs, 4.18
//     T/s at the 1.98 GHz that the data sheet's 67 TFLOP/s implies) they
//     take 0.257 ms; a share of them can run on the FP32 pipes instead
//     (round, polynomial, exponent insert: about 7 instructions each).
//   - FP32 lanes: 4 instructions a (token, channel, state) (dt * A, dx *
//     B, the update FMA, the y FMA) over 128 lanes x 132 SMs x 1.98 GHz.
//     With the exponentials split between the SFU and these lanes, the
//     compute floor is about 0.18-0.19 ms, below the bytes term.  An accurate
//     expf would add ~6 FP32 instructions of range reduction to each
//     exponential, which alone would put the FP32 term near 0.32 ms.
// So the design cuts instructions per exponential as well as bytes.
//
// Design:
//   - States are split across threads: 4 threads per channel, each
//     owning states 4q..4q+3 (q = its rank in the channel), with their h
//     and A * log2(e) in registers, so each step costs a thread 4
//     exponentials a channel.  States past n hold 0 and stay 0: their A,
//     h0, B and C are zero, so every n in 1..16 runs the same code.
//   - Each thread takes kCPT = 2 neighbouring channels with the same q:
//     they share its B_t and C_t reads (one float4 each from shared
//     memory), which every thread of the same q repeats, and their x and
//     dt come as float2.  At falcon's widths that is 131,072 threads (one
//     block of 128 threads = 64 channels).
//   - exp(dt * A) is ex2.approx.ftz.f32(dt * (A * log2 e)): one MUFU.EX2
//     and one FMUL, no range reduction.  Its error (2 ulp) is far inside
//     the JAX tests' rtol/atol of 1e-5 (tests/test_torch_scan_design.py
//     models it).
//   - y_t is summed across the channel's 4 threads.  Each thread keeps
//     its partial p_q of 4 consecutive steps, then a transposing
//     butterfly (shfl_xor 2, then 1: 3 shuffles and 3 adds per 4 steps,
//     against 8 and 8 for a reduction per step) leaves the whole sum of
//     step q with thread q.  The order is fixed: (p0 + p2) + (p1 + p3).
//   - x and dt come in tiles of 16 steps by the block's 64 channels, B
//     and C in tiles of 16 steps by 16 states (zero past n, so a thread
//     reads its 4 states as one float4), all with cp.async into a
//     2-stage ring: the next tile's loads are in flight while this
//     tile's recurrence runs.  Rows past s and channels past di are
//     zero-filled by the copy (src size 0); a last group of steps past s
//     leaves h as it was.
//   - y is staged per tile in shared memory, over the tile's x (each x
//     is read only by its own channel's threads, in the step group that
//     then writes its y), and written out as 16-byte stores.  16-byte
//     copies and stores need di and n multiples of 4 and 16-byte aligned
//     x, dt, y, B and C; otherwise the same kernel copies and stores 4
//     bytes at a time.
//   - Shared memory is 20 KB a block and registers are capped at 64 a
//     thread (launch bounds 128 x 8), so 8 blocks (32 warps) fit on an
//     SM: the grid (di / 64, b), 1024 blocks at falcon's widths, runs in
//     one wave on 132 SMs.
// h0 is read once and hT written once.  Offsets that can pass 2^31 are
// 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxState = 16;   // n <= 16, checked by the wrapper
constexpr int kThreads = 128;   // threads per block
constexpr int kTPC = 4;         // threads per channel, 4 states each
constexpr int kCPT = 2;         // channels per thread
constexpr int kChannels = kThreads / kTPC * kCPT;   // 64 a block
constexpr int kTile = 16;       // steps a stage
constexpr int kStages = 2;      // depth of the cp.async ring
// steps a chunk state covers (a multiple of kTile); the backward kernel's
// kChunk, which must be the same
constexpr int kChunk = 64;
constexpr int kChunkTiles = kChunk / kTile;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 (or 4) bytes; bytes past `src_bytes` are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct Smem {
  // y of a tile overwrites its x (each x is read only by its channel's
  // threads, in the step group that writes its y)
  float x[kStages][kTile][kChannels];
  float dt[kStages][kTile][kChannels];
  float B[kStages][kTile][kMaxState];
  float C[kStages][kTile][kMaxState];
};

// Butterfly over the channel's 4 threads: thread q holds partials p[0..4)
// of 4 consecutive steps and returns the whole sum of step q,
// (p0 + p2) + (p1 + p3) over the threads.
__device__ __forceinline__ float reduce_steps(const float (&p)[kTPC], int q) {
  const bool hi = q & 2;
  const float k0 = hi ? p[2] : p[0], k1 = hi ? p[3] : p[1];
  const float s0 = hi ? p[0] : p[2], s1 = hi ? p[1] : p[3];
  const float v0 = k0 + __shfl_xor_sync(0xffffffffu, s0, 2);
  const float v1 = k1 + __shfl_xor_sync(0xffffffffu, s1, 2);
  const bool odd = q & 1;
  const float keep = odd ? v1 : v0;
  const float send = odd ? v0 : v1;
  return keep + __shfl_xor_sync(0xffffffffu, send, 1);
}

// 4 steps t0..t0+4 of one stage for the thread's kCPT channels from c0:
// update h, stage y in place of x.  With kTail only the first `live`
// steps update h (the rest lie past s).
template <bool kTail>
__device__ __forceinline__ void step_group(Smem& sm, int st, int t0, int c0,
                                           int q, const float (&a)[kCPT][4],
                                           float (&h)[kCPT][4], int live) {
  float p[kCPT][kTPC];
#pragma unroll
  for (int j = 0; j < kTPC; ++j) {
    const int t = t0 + j;
    const float2 d2 = *reinterpret_cast<const float2*>(&sm.dt[st][t][c0]);
    const float2 x2 = *reinterpret_cast<const float2*>(&sm.x[st][t][c0]);
    const float dtt[kCPT] = {d2.x, d2.y}, xx[kCPT] = {x2.x, x2.y};
    const float4 b4 = *reinterpret_cast<const float4*>(&sm.B[st][t][4 * q]);
    const float4 c4 = *reinterpret_cast<const float4*>(&sm.C[st][t][4 * q]);
    const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
    const float cc[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
    for (int u = 0; u < kCPT; ++u) {
      const float dx = dtt[u] * xx[u];
      float hn[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        hn[i] = fmaf(ex2(dtt[u] * a[u][i]), h[u][i], dx * bb[i]);
      float acc = hn[0] * cc[0];
#pragma unroll
      for (int i = 1; i < 4; ++i) acc = fmaf(hn[i], cc[i], acc);
      p[u][j] = acc;
      if (!kTail || j < live) {
#pragma unroll
        for (int i = 0; i < 4; ++i) h[u][i] = hn[i];
      }
    }
  }
  const float y0 = reduce_steps(p[0], q), y1 = reduce_steps(p[1], q);
  __syncwarp();   // the group's x reads, in every thread, come first
  *reinterpret_cast<float2*>(&sm.x[st][t0 + q][c0]) = make_float2(y0, y1);
}

template <bool kVec, bool kStates>
__global__ void __launch_bounds__(kThreads, 8)
selective_scan_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ B,
                      const float* __restrict__ C,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ hT, float* __restrict__ hc,
                      int s, int di, int n) {
  constexpr int CH = kChannels;
  constexpr int CH4 = CH / 4;
  __shared__ __align__(16) Smem sm;

  const int tid = threadIdx.x;
  const int q = tid % kTPC;             // which 4 states of its channels
  const int c0 = tid / kTPC * kCPT;     // its first channel in the block
  const int b = blockIdx.y;
  const int ch0 = blockIdx.x * CH;
  const long long row = (long long)b * s;   // first token of this row

  float a[kCPT][4], h[kCPT][4];
#pragma unroll
  for (int u = 0; u < kCPT; ++u) {
    const int ch = ch0 + c0 + u;
    const long long state = ((long long)b * di + ch) * n;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 4 * q + j;
      const bool on = ch < di && i < n;
      a[u][j] = on ? A[(long long)ch * n + i] * kLog2e : 0.f;
      h[u][j] = on ? h0[state + i] : 0.f;
    }
  }

  // one tile of x, dt (channels past di zero) and of B, C (states past n
  // zero); rows past s zero
  auto load = [&](int tile, int st) {
    const int t0 = tile * kTile;
    const int len = min(kTile, s - t0);
    if constexpr (kVec) {
      for (int i = tid; i < kTile * CH4; i += kThreads) {
        const int t = i / CH4, c4 = (i % CH4) * 4;
        const bool ok = t < len && ch0 + c4 < di;
        const long long off = ok ? (row + t0 + t) * di + ch0 + c4 : 0;
        cp_async16(&sm.x[st][t][c4], x + off, ok ? 16 : 0);
        cp_async16(&sm.dt[st][t][c4], dt + off, ok ? 16 : 0);
      }
      for (int i = tid; i < kTile * (kMaxState / 4); i += kThreads) {
        const int t = i / (kMaxState / 4), j = (i % (kMaxState / 4)) * 4;
        const bool ok = t < len && j < n;
        const long long off = ok ? (row + t0 + t) * n + j : 0;
        cp_async16(&sm.B[st][t][j], B + off, ok ? 16 : 0);
        cp_async16(&sm.C[st][t][j], C + off, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kTile * CH; i += kThreads) {
        const int t = i / CH, cc = i % CH;
        const bool ok = t < len && ch0 + cc < di;
        const long long off = ok ? (row + t0 + t) * di + ch0 + cc : 0;
        cp_async4(&sm.x[st][t][cc], x + off, ok ? 4 : 0);
        cp_async4(&sm.dt[st][t][cc], dt + off, ok ? 4 : 0);
      }
      for (int i = tid; i < kTile * kMaxState; i += kThreads) {
        const int t = i / kMaxState, j = i % kMaxState;
        const bool ok = t < len && j < n;
        const long long off = ok ? (row + t0 + t) * n + j : 0;
        cp_async4(&sm.B[st][t][j], B + off, ok ? 4 : 0);
        cp_async4(&sm.C[st][t][j], C + off, ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  const int ntiles = (s + kTile - 1) / kTile;
  if (ntiles > 0) load(0, 0);
  for (int k = 0; k < ntiles; ++k) {
    const int st = k % kStages;
    cp_async_wait_all();   // tile k has landed ...
    __syncthreads();       // ... for every thread; tile k - 1 written out
    if (k + 1 < ntiles) load(k + 1, (k + 1) % kStages);

    if (kStates && k % kChunkTiles == 0) {
      // the state entering chunk k / kChunkTiles
      const int nc = (s + kChunk - 1) / kChunk;
#pragma unroll
      for (int u = 0; u < kCPT; ++u) {
        const int ch = ch0 + c0 + u;
        const long long state =
            (((long long)b * nc + k / kChunkTiles) * di + ch) * n;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (ch < di && 4 * q + j < n) hc[state + 4 * q + j] = h[u][j];
      }
    }

    const int t0 = k * kTile;
    const int len = min(kTile, s - t0);
    if (len == kTile) {
#pragma unroll
      for (int g = 0; g < kTile; g += kTPC)
        step_group<false>(sm, st, g, c0, q, a, h, kTPC);
    } else {
      int g = 0;
      for (; g + kTPC <= len; g += kTPC)
        step_group<false>(sm, st, g, c0, q, a, h, kTPC);
      if (g < len) step_group<true>(sm, st, g, c0, q, a, h, len - g);
    }
    __syncthreads();       // the y tile is complete

    if constexpr (kVec) {
      for (int i = tid; i < len * CH4; i += kThreads) {
        const int t = i / CH4, c4 = (i % CH4) * 4;
        if (ch0 + c4 < di)
          *reinterpret_cast<float4*>(y + (row + t0 + t) * di + ch0 + c4) =
              *reinterpret_cast<const float4*>(&sm.x[st][t][c4]);
      }
    } else {
      for (int i = tid; i < len * CH; i += kThreads) {
        const int t = i / CH, cc = i % CH;
        if (ch0 + cc < di) y[(row + t0 + t) * di + ch0 + cc] = sm.x[st][t][cc];
      }
    }
  }

#pragma unroll
  for (int u = 0; u < kCPT; ++u) {
    const int ch = ch0 + c0 + u;
    const long long state = ((long long)b * di + ch) * n;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (ch < di && 4 * q + j < n) hT[state + 4 * q + j] = h[u][j];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Returns cudaGetLastError() after the launch (or the error that kept it
// from launching).  hc may be null: no chunk states.
extern "C" int selective_scan_fwd(const void* x, const void* dt,
                                  const void* A, const void* B,
                                  const void* C, const void* h0, void* y,
                                  void* hT, void* hc, int b, int s, int di,
                                  int n, void* stream) {
  if (b <= 0 || b > 65535 || s < 0 || di <= 0 || n < 1 || n > kMaxState)
    return (int)cudaErrorInvalidValue;
  const bool vec = di % 4 == 0 && n % 4 == 0 && aligned16(x) &&
                   aligned16(dt) && aligned16(y) && aligned16(B) &&
                   aligned16(C);
  const auto* fx = static_cast<const float*>(x);
  const auto* fdt = static_cast<const float*>(dt);
  const auto* fA = static_cast<const float*>(A);
  const auto* fB = static_cast<const float*>(B);
  const auto* fC = static_cast<const float*>(C);
  const auto* fh0 = static_cast<const float*>(h0);
  auto* fy = static_cast<float*>(y);
  auto* fhT = static_cast<float*>(hT);
  auto* fhc = static_cast<float*>(hc);
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((di + kChannels - 1) / kChannels), (unsigned)b);
  if (vec && fhc)
    selective_scan_kernel<true, true><<<grid, kThreads, 0, st>>>(
        fx, fdt, fA, fB, fC, fh0, fy, fhT, fhc, s, di, n);
  else if (vec)
    selective_scan_kernel<true, false><<<grid, kThreads, 0, st>>>(
        fx, fdt, fA, fB, fC, fh0, fy, fhT, fhc, s, di, n);
  else if (fhc)
    selective_scan_kernel<false, true><<<grid, kThreads, 0, st>>>(
        fx, fdt, fA, fB, fC, fh0, fy, fhT, fhc, s, di, n);
  else
    selective_scan_kernel<false, false><<<grid, kThreads, 0, st>>>(
        fx, fdt, fA, fB, fC, fh0, fy, fhT, fhc, s, di, n);
  return (int)cudaGetLastError();
}
