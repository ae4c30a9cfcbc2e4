// Mamba-1 selective scan, backward, on Hopper's CUDA cores and SFU.
//
// The forward (csrc/selective_scan.cu) runs, per batch row, channel c and
// state i,
//   a_t = exp(dt_t * A),  h_t = a_t * h_{t-1} + (dt_t * x_t) * B_t,
//   y_t = <h_t, C_t>.
// Given dy (b, s, di) and optionally dhT (b, di, n), this computes with
// G_t = dL/dh_t = a_{t+1} G_{t+1} + dy_t C_t (+ dhT at the last step):
//   dx_t  = dt_t * sum_i G_t B_t          ddt_t = sum_i G_t (x_t B_t + A a_t h_{t-1})
//   dB_t  = sum_c G_t dt_t x_t            dC_t  = sum_c dy_t h_t
//   dA    = sum_{b,t} G_t dt_t a_t h_{t-1}          dh0 = a_1 G_1
// all float32: dx, ddt (b, s, di), dB, dC (b, s, n), dA (di, n), dh0
// (b, di, n).
//
// Replaces: none.  The JAX package has no backward kernel of
//   selective_scan_pallas (src/repro/kernels/selective_scan/kernel.py); it
//   trains by autodiff of its chunked XLA scan
//   (src/repro/models/ssm.py _selective_scan_chunked).  This is the
//   gradient of kernel 5 that training on the card needs.
//
// What bounds it on an H100, at falcon-mamba-7b's training micro-batch
// (b = 4, s = 1024, di = 8192, n = 16):
//   - Bytes: x, dt and dy read, dx and ddt written (20 bytes a (token,
//     channel)), plus the chunk states (4 bytes a (token, channel) over
//     16), B, C, dB, dC: about 0.71 GB over 3.35 TB/s, 0.21 ms.
//   - Exponentials: a_t is needed once a (token, channel, state), 537 M
//     of them, 0.13 ms on the SFU alone.  This kernel computes each of
//     them about 2.9 times (below): 0.75 in stage A, 0.125 in the last
//     tile's run-up, 1.0 in the history and 1.0 in the reverse step.
//   - Measured, it is bound by neither: removing, one at a time, stage A,
//     the run-up, the reverse's exponentials or the sums over states took
//     0.02-0.08 ms each off about 1.05 ms, the sums over channels 0.15 ms,
//     and all of them together left 0.73 ms of loads, shared-memory reads
//     and the recurrence's own arithmetic.  Keeping a_t beside h (a 16-step
//     history at 2 states a thread) made it slower, as did launching its
//     blocks in thread-block clusters to sum dB, dC across them: the
//     cluster launch alone, with no exchange, added a third to its time.
//
// Design:
//   - The forward saves the state entering every chunk of kChunk = 64
//     steps (its kChunk; chunk states).  A block takes 64 channels of one
//     batch row, 4 threads a channel, each thread 4 states (zeros past n,
//     as in the forward), and walks the chunks from the last to the
//     first.  In a chunk it first runs the forward recurrence from the
//     chunk state over all tiles of 16 steps but the last, keeping the
//     state entering each half-tile of kHist = 8 steps in shared memory
//     (stage A); then it takes the tiles from the last to the first
//     (stage B).  In a tile it recomputes the states of a half-tile into
//     registers from the state entering it, then runs the reverse
//     recurrence over them; only the chunk's last tile, which stage A does
//     not cover, runs its second half's run-up from the tile's start
//     state.  Every state is recomputed with the forward's own expression
//     (ex2.approx of dt * (A * log2 e), the same FMA), so it has the
//     forward's bits.
//   - Sums over a channel's 16 states (dx, ddt) go over its 4 threads by
//     the forward's transposing butterfly, 4 steps at a time.  Sums over
//     channels (dB, dC) go over the warp's 8 channels by a transposing
//     butterfly on 8 values (dB and dC of the thread's 4 states: 4 + 2 +
//     1 shuffles), then over the block's 8 warps in shared memory in
//     ascending warp order, into one partial a block; a second launch
//     sums the blocks' partials in ascending block order.  dA is summed
//     over the steps in registers, written as one partial a batch row,
//     and the second launch sums the rows in ascending order.  No float
//     atomics: two launches give the same bits.
//   - x, dt, dy come in tiles of 16 steps by 64 channels and B, C in
//     tiles of 16 steps by 16 states, with cp.async into a 2-stage ring
//     (stage A loads x, dt, B only).  dx and ddt of a tile are staged over
//     its dy and x and written out as 16-byte stores.  Rows past s and
//     channels past di are zero-filled; steps past s are skipped.  16-byte
//     copies and stores need di and n multiples of 4 and 16-byte aligned
//     x, dt, dy, dx, ddt, B and C; otherwise 4 bytes at a time.
//   - 68 KB of shared memory (24 KB of it the half-tile states) and at most
//     128 registers a thread, none spilled (launch bounds 256 x 2): the
//     grid (di / 64, b), 512 blocks at falcon's training micro-batch.
// Offsets that can pass 2^31 are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxState = 16;   // n <= 16, checked by the wrapper
constexpr int kThreads = 256;   // threads per block
constexpr int kTPC = 4;         // threads per channel, 4 states each
constexpr int kChannels = kThreads / kTPC;   // 64 a block
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;       // steps a stage of the ring
constexpr int kStages = 2;
constexpr int kHist = 8;        // steps of states held in registers
constexpr int kSubs = kTile / kHist;
// steps a chunk state covers: the forward's kChunk, which must be the same
constexpr int kChunk = 64;
constexpr int kChunkTiles = kChunk / kTile;
// half-tiles of a chunk whose entering state stage A keeps: all but the
// first (the chunk state) and the last tile's second
constexpr int kHalves = (kChunkTiles - 1) * kSubs;
constexpr int kFinishThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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
  // dx of a tile overwrites its dy, ddt its x (each read only by its
  // channel's threads, in the step group that then writes them)
  float x[kStages][kTile][kChannels];
  float dt[kStages][kTile][kChannels];
  float dy[kStages][kTile][kChannels];
  float B[kStages][kTile][kMaxState];
  float C[kStages][kTile][kMaxState];
  // each warp's sums over its 8 channels: [step][dB, dC][state]
  float part[kWarps][kTile][2][kMaxState];
  // stage A's states entering half-tiles 1 .. kHalves of the chunk, a
  // thread's 4 states in one float4
  float4 hsub[kHalves][kThreads];
};

// One tile load of the block's walk: chunk, tile in the chunk, whether
// it is a stage-A (forward) tile, and whether it is the chunk's last.
struct Item {
  int chunk, tile;
  bool fwd, last;
};

// Item m of the walk: chunks from the last to the first; in each, its
// tiles but the last forward (stage A), then all of them backward.
__device__ __forceinline__ Item item_at(int m, int s, int nc) {
  const int last_tiles = (s - (nc - 1) * kChunk + kTile - 1) / kTile;
  const int last_items = 2 * last_tiles - 1;
  constexpr int kFullItems = 2 * kChunkTiles - 1;
  int nt, idx;
  Item it;
  if (m < last_items) {
    it.chunk = nc - 1;
    idx = m;
    nt = last_tiles;
  } else {
    m -= last_items;
    it.chunk = nc - 2 - m / kFullItems;
    idx = m % kFullItems;
    nt = kChunkTiles;
  }
  it.fwd = idx < nt - 1;
  it.tile = it.fwd ? idx : 2 * nt - 2 - idx;
  it.last = it.tile == nt - 1;
  return it;
}

__device__ __forceinline__ int walk_items(int s, int nc) {
  if (nc == 0) return 0;
  const int last_tiles = (s - (nc - 1) * kChunk + kTile - 1) / kTile;
  return 2 * last_tiles - 1 + (nc - 1) * (2 * kChunkTiles - 1);
}

// The forward's step: h = exp2(dt * A log2 e) h + (dt x) B, the same
// expression as step_group in csrc/selective_scan.cu.
__device__ __forceinline__ void fwd_step(float (&h)[4], const float (&a2)[4],
                                         float dtt, float xx,
                                         const float4 b4) {
  const float dx = dtt * xx;
  const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = fmaf(ex2(dtt * a2[i]), h[i], dx * bb[i]);
}

// The forward's butterfly over the channel's 4 threads: thread q holds
// partials p[0..4) of 4 consecutive steps and returns the whole sum of
// step q, (p0 + p2) + (p1 + p3) over the threads.
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

// Sums over the warp's 8 channels (lane bits 2..4) of v[0..8), the
// thread's dB of its 4 states then its dC: returns value (lane >> 2) & 7,
// summed in a fixed order (4 + 2 + 1 shuffles).
__device__ __forceinline__ float reduce_channels(const float (&v)[8],
                                                 int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float u[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float keep = b4 ? v[4 + k] : v[k];
    const float send = b4 ? v[k] : v[4 + k];
    u[k] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
  float w[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float keep = b3 ? u[2 + k] : u[k];
    const float send = b3 ? u[k] : u[2 + k];
    w[k] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const float keep = b2 ? w[1] : w[0];
  const float send = b2 ? w[0] : w[1];
  return keep + __shfl_xor_sync(0xffffffffu, send, 4);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
selective_scan_bwd_kernel(const float* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ A,
                          const float* __restrict__ B,
                          const float* __restrict__ C,
                          const float* __restrict__ hc,
                          const float* __restrict__ dy,
                          const float* __restrict__ dhT,
                          float* __restrict__ dx, float* __restrict__ ddt,
                          float* __restrict__ dBp, float* __restrict__ dCp,
                          float* __restrict__ dAp, float* __restrict__ dh0,
                          int s, int di, int n) {
  constexpr int CH = kChannels;
  constexpr int CH4 = CH / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int q = tid % kTPC;         // which 4 states of its channel
  const int c = tid / kTPC;         // its channel in the block
  const int b = blockIdx.y;
  const int ch0 = blockIdx.x * CH;
  const int ch = ch0 + c;
  const long long row = (long long)b * s;
  const long long state = ((long long)b * di + ch) * n;
  const int nc = (s + kChunk - 1) / kChunk;

  float a2[4], Av[4], gn[4], dA[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = 4 * q + j;
    const bool on = ch < di && i < n;
    Av[j] = on ? A[(long long)ch * n + i] : 0.f;
    a2[j] = on ? A[(long long)ch * n + i] * kLog2e : 0.f;
    // gn: a_{t+1} G_{t+1}, the gradient carried into step t
    gn[j] = on && dhT != nullptr ? dhT[state + i] : 0.f;
    dA[j] = 0.f;
  }

  auto load = [&](const Item& it, int st) {
    const int t0 = (it.chunk * kChunkTiles + it.tile) * kTile;
    const int len = min(kTile, s - t0);
    const bool full = !it.fwd;
    if constexpr (kVec) {
      for (int i = tid; i < kTile * CH4; i += kThreads) {
        const int t = i / CH4, c4 = (i % CH4) * 4;
        const bool ok = t < len && ch0 + c4 < di;
        const long long off = ok ? (row + t0 + t) * di + ch0 + c4 : 0;
        cp_async16(&sm.x[st][t][c4], x + off, ok ? 16 : 0);
        cp_async16(&sm.dt[st][t][c4], dt + off, ok ? 16 : 0);
        if (full) cp_async16(&sm.dy[st][t][c4], dy + off, ok ? 16 : 0);
      }
      for (int i = tid; i < kTile * (kMaxState / 4); i += kThreads) {
        const int t = i / (kMaxState / 4), j = (i % (kMaxState / 4)) * 4;
        const bool ok = t < len && j < n;
        const long long off = ok ? (row + t0 + t) * n + j : 0;
        cp_async16(&sm.B[st][t][j], B + off, ok ? 16 : 0);
        if (full) cp_async16(&sm.C[st][t][j], C + off, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kTile * CH; i += kThreads) {
        const int t = i / CH, cc = i % CH;
        const bool ok = t < len && ch0 + cc < di;
        const long long off = ok ? (row + t0 + t) * di + ch0 + cc : 0;
        cp_async4(&sm.x[st][t][cc], x + off, ok ? 4 : 0);
        cp_async4(&sm.dt[st][t][cc], dt + off, ok ? 4 : 0);
        if (full) cp_async4(&sm.dy[st][t][cc], dy + off, ok ? 4 : 0);
      }
      for (int i = tid; i < kTile * kMaxState; i += kThreads) {
        const int t = i / kMaxState, j = i % kMaxState;
        const bool ok = t < len && j < n;
        const long long off = ok ? (row + t0 + t) * n + j : 0;
        cp_async4(&sm.B[st][t][j], B + off, ok ? 4 : 0);
        if (full) cp_async4(&sm.C[st][t][j], C + off, ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  // the state entering a chunk, as the forward saved it
  auto chunk_state = [&](int chunk, float (&h)[4]) {
    const long long off = (((long long)b * nc + chunk) * di + ch) * n;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h[j] = ch < di && 4 * q + j < n ? hc[off + 4 * q + j] : 0.f;
  };

  auto keep = [&](int half, const float (&hv)[4]) {
    sm.hsub[half - 1][tid] = make_float4(hv[0], hv[1], hv[2], hv[3]);
  };
  auto kept = [&](int half, float (&hv)[4]) {
    const float4 v = sm.hsub[half - 1][tid];
    hv[0] = v.x, hv[1] = v.y, hv[2] = v.z, hv[3] = v.w;
  };
  float h[4];   // the state entering the tile

  const int nitems = walk_items(s, nc);
  if (nitems > 0) load(item_at(0, s, nc), 0);
  for (int m = 0; m < nitems; ++m) {
    const int st = m % kStages;
    const Item it = item_at(m, s, nc);
    cp_async_wait_all();   // item m has landed ...
    __syncthreads();       // ... for every thread; item m - 1 written out
    if (m + 1 < nitems) load(item_at(m + 1, s, nc), (m + 1) % kStages);

    const int t0 = (it.chunk * kChunkTiles + it.tile) * kTile;
    const int len = min(kTile, s - t0);

    if (it.tile == 0)
      chunk_state(it.chunk, h);
    else if (!it.fwd)
      kept(it.tile * kSubs, h);

    if (it.fwd) {
      // stage A: a whole tile (only a chunk's last tile can be partial),
      // keeping the state entering each following half-tile
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        fwd_step(h, a2, sm.dt[st][t][c], sm.x[st][t][c],
                 *reinterpret_cast<const float4*>(&sm.B[st][t][4 * q]));
        if ((t + 1) % kHist == 0) keep(it.tile * kSubs + (t + 1) / kHist, h);
      }
      continue;
    }

    // stage B: sub-tiles of kHist steps, the last first
#pragma unroll
    for (int sub = kSubs - 1; sub >= 0; --sub) {
      if (sub * kHist >= len) continue;   // every step past s
      // the state entering the sub-tile: stage A's, or in the chunk's
      // last tile a run-up from the tile's start
      float hh[4] = {h[0], h[1], h[2], h[3]};
      if (sub > 0 && !it.last) {
        kept(it.tile * kSubs + sub, hh);
      } else {
#pragma unroll
        for (int t = 0; t < sub * kHist; ++t)
          fwd_step(hh, a2, sm.dt[st][t][c], sm.x[st][t][c],
                   *reinterpret_cast<const float4*>(&sm.B[st][t][4 * q]));
      }
      // hist[u]: the state entering step sub * kHist + u
      float hist[kHist][4];
#pragma unroll
      for (int u = 0; u < kHist; ++u) {
        const int t = sub * kHist + u;
#pragma unroll
        for (int i = 0; i < 4; ++i) hist[u][i] = hh[i];
        if (t < len)
          fwd_step(hh, a2, sm.dt[st][t][c], sm.x[st][t][c],
                   *reinterpret_cast<const float4*>(&sm.B[st][t][4 * q]));
      }
#pragma unroll
      for (int g = kHist / 4 - 1; g >= 0; --g) {
        float p1[kTPC], p2[kTPC];
#pragma unroll
        for (int jj = kTPC - 1; jj >= 0; --jj) {
          const int u = 4 * g + jj;
          const int t = sub * kHist + u;
          p1[jj] = p2[jj] = 0.f;
          if (t >= len) continue;
          const float dtt = sm.dt[st][t][c], xx = sm.x[st][t][c];
          const float dyy = sm.dy[st][t][c];
          const float4 b4 =
              *reinterpret_cast<const float4*>(&sm.B[st][t][4 * q]);
          const float4 c4 =
              *reinterpret_cast<const float4*>(&sm.C[st][t][4 * q]);
          const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
          const float cc[4] = {c4.x, c4.y, c4.z, c4.w};
          const float dtx = dtt * xx;
          float v[8], s1 = 0.f, s2 = 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float e = ex2(dtt * a2[i]);
            const float hp = hist[u][i];
            // the state after step t, with the forward's bits
            const float hcur = u == kHist - 1 ? hh[i] : hist[u + 1][i];
            const float G = fmaf(dyy, cc[i], gn[i]);
            v[i] = G * dtx;         // dB
            v[4 + i] = dyy * hcur;  // dC
            s1 = fmaf(G, bb[i], s1);
            gn[i] = e * G;
            const float w = gn[i] * hp;   // G a_t h_{t-1}
            s2 = fmaf(Av[i], w, s2);
            dA[i] = fmaf(dtt, w, dA[i]);
          }
          p1[jj] = s1;
          p2[jj] = s2;
          const int k = (lane >> 2) & 7;
          sm.part[warp][t][k >> 2][4 * q + (k & 3)] = reduce_channels(v, lane);
        }
        // thread q finishes step tq of the group
        const int tq = sub * kHist + 4 * g + q;
        const float S1 = reduce_steps(p1, q), S2 = reduce_steps(p2, q);
        const float dxv = sm.dt[st][tq][c] * S1;
        const float ddtv = fmaf(sm.x[st][tq][c], S1, S2);
        __syncwarp();   // the group's reads, in every thread, come first
        sm.dy[st][tq][c] = dxv;
        sm.x[st][tq][c] = ddtv;
      }
    }
    __syncthreads();   // the tile's dx, ddt and warp sums are complete

    if constexpr (kVec) {
      for (int i = tid; i < len * CH4; i += kThreads) {
        const int t = i / CH4, c4 = (i % CH4) * 4;
        if (ch0 + c4 < di) {
          const long long off = (row + t0 + t) * di + ch0 + c4;
          *reinterpret_cast<float4*>(dx + off) =
              *reinterpret_cast<const float4*>(&sm.dy[st][t][c4]);
          *reinterpret_cast<float4*>(ddt + off) =
              *reinterpret_cast<const float4*>(&sm.x[st][t][c4]);
        }
      }
    } else {
      for (int i = tid; i < len * CH; i += kThreads) {
        const int t = i / CH, cc = i % CH;
        if (ch0 + cc < di) {
          const long long off = (row + t0 + t) * di + ch0 + cc;
          dx[off] = sm.dy[st][t][cc];
          ddt[off] = sm.x[st][t][cc];
        }
      }
    }
    // this block's dB, dC of the tile: the warps' sums in ascending order
    const long long part0 =
        ((long long)blockIdx.x * gridDim.y + b) * s + t0;
    for (int i = tid; i < len * 2 * kMaxState; i += kThreads) {
      const int t = i / (2 * kMaxState), r = i % (2 * kMaxState);
      const int which = r / kMaxState, j = r % kMaxState;
      if (j >= n) continue;
      float acc = sm.part[0][t][which][j];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) acc += sm.part[w][t][which][j];
      (which ? dCp : dBp)[(part0 + t) * n + j] = acc;
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (ch < di && 4 * q + j < n) {
      dh0[state + 4 * q + j] = gn[j];
      dAp[state + 4 * q + j] = dA[j];   // this batch row's share of dA
    }
}

// dB, dC: the sum of the blocks' partials (nblk, b, s, n) in ascending
// block order; dA: the sum of the batch rows' (b, di, n) in ascending
// order.
__global__ void __launch_bounds__(kFinishThreads)
selective_scan_bwd_sum(const float* __restrict__ dBp,
                       const float* __restrict__ dCp,
                       const float* __restrict__ dAp,
                       float* __restrict__ dB, float* __restrict__ dC,
                       float* __restrict__ dA, int nblk, int b, int s,
                       int di, int n) {
  const long long bsn = (long long)b * s * n;
  const long long dn = (long long)di * n;
  const long long total = 2 * bsn + dn;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    if (i < 2 * bsn) {
      const bool isC = i >= bsn;
      const long long e = isC ? i - bsn : i;
      const float* p = isC ? dCp : dBp;
      float acc = p[e];
      for (int k = 1; k < nblk; ++k) acc += p[k * bsn + e];
      (isC ? dC : dB)[e] = acc;
    } else {
      const long long e = i - 2 * bsn;
      float acc = dAp[e];
      for (int r = 1; r < b; ++r) acc += dAp[r * dn + e];
      dA[e] = acc;
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool kVec>
cudaError_t launch(dim3 grid, cudaStream_t st, const float* x,
                   const float* dt, const float* A, const float* B,
                   const float* C, const float* hc, const float* dy,
                   const float* dhT, float* dx, float* ddt, float* dBp,
                   float* dCp, float* dAp, float* dh0, int s, int di, int n) {
  // above 48 KB of shared memory only after this opt-in (on the current
  // device)
  const cudaError_t attr = cudaFuncSetAttribute(
      selective_scan_bwd_kernel<kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem));
  if (attr != cudaSuccess) return attr;
  selective_scan_bwd_kernel<kVec><<<grid, kThreads, sizeof(Smem), st>>>(
      x, dt, A, B, C, hc, dy, dhT, dx, ddt, dBp, dCp, dAp, dh0, s, di, n);
  return cudaGetLastError();
}

}  // namespace

// Two launches: the backward recurrence, then the ordered sums.  dBp and
// dCp are (ceil(di / 64), b, s, n) scratch, dAp (b, di, n); dhT may be
// null (zero).  Returns cudaGetLastError() after the launches (or the
// error that kept one from launching).
extern "C" int selective_scan_bwd(const void* x, const void* dt,
                                  const void* A, const void* B,
                                  const void* C, const void* hc,
                                  const void* dy, const void* dhT, void* dx,
                                  void* ddt, void* dA, void* dB, void* dC,
                                  void* dh0, void* dBp, void* dCp, void* dAp,
                                  int b, int s, int di, int n,
                                  void* stream) {
  if (b <= 0 || b > 65535 || s < 1 || di <= 0 || n < 1 || n > kMaxState)
    return (int)cudaErrorInvalidValue;
  const bool vec = di % 4 == 0 && n % 4 == 0 && aligned16(x) &&
                   aligned16(dt) && aligned16(dy) && aligned16(dx) &&
                   aligned16(ddt) && aligned16(B) && aligned16(C);
  const auto* fx = static_cast<const float*>(x);
  const auto* fdt = static_cast<const float*>(dt);
  const auto* fA = static_cast<const float*>(A);
  const auto* fB = static_cast<const float*>(B);
  const auto* fC = static_cast<const float*>(C);
  const auto* fhc = static_cast<const float*>(hc);
  const auto* fdy = static_cast<const float*>(dy);
  const auto* fdhT = static_cast<const float*>(dhT);
  auto* fdx = static_cast<float*>(dx);
  auto* fddt = static_cast<float*>(ddt);
  auto* fdBp = static_cast<float*>(dBp);
  auto* fdCp = static_cast<float*>(dCp);
  auto* fdAp = static_cast<float*>(dAp);
  auto* fdh0 = static_cast<float*>(dh0);
  auto st = static_cast<cudaStream_t>(stream);
  const int nblk = (di + kChannels - 1) / kChannels;
  const dim3 grid((unsigned)nblk, (unsigned)b);
  const cudaError_t err =
      vec ? launch<true>(grid, st, fx, fdt, fA, fB, fC, fhc, fdy, fdhT, fdx,
                         fddt, fdBp, fdCp, fdAp, fdh0, s, di, n)
          : launch<false>(grid, st, fx, fdt, fA, fB, fC, fhc, fdy, fdhT, fdx,
                          fddt, fdBp, fdCp, fdAp, fdh0, s, di, n);
  if (err != cudaSuccess) return (int)err;
  const long long total = 2LL * b * s * n + (long long)di * n;
  const long long blocks = (total + kFinishThreads - 1) / kFinishThreads;
  selective_scan_bwd_sum<<<(unsigned)(blocks < 1056 ? blocks : 1056),
                           kFinishThreads, 0, st>>>(
      fdBp, fdCp, fdAp, static_cast<float*>(dB), static_cast<float*>(dC),
      static_cast<float*>(dA), nblk, b, s, di, n);
  return (int)cudaGetLastError();
}
