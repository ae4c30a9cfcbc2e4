// Mamba-1 selective scan, forward.
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t
//   y_t = <h_t, C_t>
//
// x/dt (b, s, di), A (di, n), B/C (b, s, n), h0 (b, di, n), all float32;
// writes y (b, s, di) and the final state hT (b, di, n).
//
// Replaces: selective_scan_pallas (body _scan_kernel),
//   src/repro/kernels/selective_scan/kernel.py, in the JAX package.
//
// What bounds it on an H100: bytes.  Per (token, channel) it reads x and
// dt and writes y (12 bytes) and does ~7n float32 operations (n exps);
// at falcon-mamba-7b's widths (di = 8192, n = 16, b = 8, s = 1024) that is
// 805 MB against 7.6 G operations, so HBM at 3.35 TB/s (0.24 ms) bounds it
// before the CUDA cores (0.11 ms).
//
// Design: the Pallas kernel carried h in VMEM across a sequential chunk
// axis of its grid; a CUDA grid has no ordered axis, so one thread owns
// one (batch row, channel), keeps its n states and its row of A in
// registers and walks all s steps itself.  A block is 128 consecutive
// channels of one batch row: x, dt and y accesses are coalesced across
// the block.  B_t and C_t are shared by every channel of a row, so each
// 32-step time tile of them is staged in shared memory, together with
// the tile's x and dt (each thread loads its own column, so the tile's
// loads are all in flight at once).  h0 is read once and hT written once;
// no padding of s is needed.  The arithmetic is the plain version's, in
// the same order (expf, not __expf: no fast math).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxState = 16;   // n <= 16, checked by the wrapper
constexpr int kChannels = 128;  // threads per block
constexpr int kTile = 32;       // time steps staged per tile

__global__ void __launch_bounds__(kChannels)
selective_scan_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ B,
                      const float* __restrict__ C,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ hT, int s, int di, int n) {
  __shared__ float xs[kTile][kChannels];
  __shared__ float dts[kTile][kChannels];
  __shared__ float Bs[kTile][kMaxState];
  __shared__ float Cs[kTile][kMaxState];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int ch = blockIdx.x * kChannels + tid;
  const bool live = ch < di;
  const long long state = ((long long)b * di + ch) * n;

  float a[kMaxState], h[kMaxState];
#pragma unroll
  for (int i = 0; i < kMaxState; ++i) {
    const bool on = live && i < n;
    a[i] = on ? A[(long long)ch * n + i] : 0.f;
    h[i] = on ? h0[state + i] : 0.f;
  }

  for (int t0 = 0; t0 < s; t0 += kTile) {
    const int len = min(kTile, s - t0);
    __syncthreads();   // previous tile fully consumed
    if (live) {
      for (int t = 0; t < len; ++t) {
        const long long off = ((long long)b * s + t0 + t) * di + ch;
        xs[t][tid] = x[off];
        dts[t][tid] = dt[off];
      }
    }
    for (int i = tid; i < len * n; i += kChannels) {
      const int t = i / n, j = i % n;
      const long long off = ((long long)b * s + t0 + t) * n + j;
      Bs[t][j] = B[off];
      Cs[t][j] = C[off];
    }
    __syncthreads();
    if (!live) continue;
    for (int t = 0; t < len; ++t) {
      const float dtt = dts[t][tid];
      const float dx = dtt * xs[t][tid];
      float yt = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxState; ++i) {
        if (i < n) {
          const float ai = expf(dtt * a[i]);
          h[i] = ai * h[i] + dx * Bs[t][i];
          yt += h[i] * Cs[t][i];
        }
      }
      y[((long long)b * s + t0 + t) * di + ch] = yt;
    }
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < kMaxState; ++i)
      if (i < n) hT[state + i] = h[i];
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (or the error that kept it
// from launching).
extern "C" int selective_scan_fwd(const void* x, const void* dt,
                                  const void* A, const void* B,
                                  const void* C, const void* h0, void* y,
                                  void* hT, int b, int s, int di, int n,
                                  void* stream) {
  if (b <= 0 || s < 0 || di <= 0 || n < 1 || n > kMaxState)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((di + kChannels - 1) / kChannels), (unsigned)b);
  selective_scan_kernel<<<grid, kChannels, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(hT), s, di, n);
  return (int)cudaGetLastError();
}
