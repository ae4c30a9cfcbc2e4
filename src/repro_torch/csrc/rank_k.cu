// Rank-k approximate matmul: the deployment form of one circuit choice.
//
//   out[i, j] = sum_k x[i,k] * w[k,j]
//             + sum_k sum_r U[x[i,k] + o, r] * V[w[k,j] + o, r]
//
// with o = 128 for signed circuits, 0 for unsigned, fp32 accumulation.
//
// Replaces: rank_k_mxu (body _rank_k_kernel),
//   src/repro/kernels/approx_matmul/kernel.py, in the JAX package.
//
// What bounds it on an H100: operations.  Every (i, j, k) term is one
// FMA for the base product and r FMAs plus 2r table reads for the
// correction; this slice runs them on the CUDA cores in full fp32 (no
// TF32, no tensor cores), so the bound is 2*m*n*k*(1+r) FLOPs over the
// fp32 rate.  The main path's own shapes are tiny and ragged (gaussian3x3
// deploys nine (900,1)@(1,1) slot groups), where launch overhead rules.
//
// Design: one thread per output element, 16x16 output tiles.  Each
// k-step stages a 16x16 tile of x and of w in shared memory; the (256, r)
// U and V tables are staged once per block in dynamic shared memory, so
// the data-dependent table reads stay on chip.  The JAX kernel required
// m, n, k to be multiples of 128; here the loads are masked at the ragged
// edge and the k loop stops at K, so padding never reaches the sum (a
// padded zero would still index U[o] and V[o]).  Base and correction
// sums are kept apart and added at the end, as the plain version does.

#include <cassert>

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;

// Operands are 8-bit by construction on the main path (im2col of 8-bit
// pixels, fixed coefficients).  One outside the domain would index past
// the tables: it trips a device-side assert, as PyTorch's own indexing
// does, and is never dereferenced.
__device__ __forceinline__ int in_domain(int val, int offset) {
  assert((unsigned)(val + offset) <= 255u);
  return val;
}

__global__ void rank_k_kernel(const int* __restrict__ x,
                              const int* __restrict__ w,
                              const float* __restrict__ u,
                              const float* __restrict__ v,
                              float* __restrict__ out,
                              int M, int N, int K,
                              int R, int offset) {
  extern __shared__ float uv[];  // U then V, each (256, R)
  __shared__ int xs[TILE][TILE + 1];
  __shared__ int ws[TILE][TILE + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TILE + tx;
  for (int i = tid; i < 256 * R; i += TILE * TILE) {
    uv[i] = u[i];
    uv[256 * R + i] = v[i];
  }
  const float* us = uv;
  const float* vs = uv + 256 * R;
  const int row = blockIdx.y * TILE + ty;
  const int col = blockIdx.x * TILE + tx;
  float base = 0.f, corr = 0.f;
  for (int k0 = 0; k0 < K; k0 += TILE) {
    xs[ty][tx] = in_domain(
        (row < M && k0 + tx < K) ? x[(long long)row * K + k0 + tx] : 0,
        offset);
    ws[ty][tx] = in_domain(
        (k0 + ty < K && col < N) ? w[(long long)(k0 + ty) * N + col] : 0,
        offset);
    __syncthreads();
    const int kmax = min(TILE, K - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      const int xv = xs[ty][kk];
      const int wv = ws[kk][tx];
      base = fmaf((float)xv, (float)wv, base);
      const float* ur = us + (xv + offset) * R;
      const float* vr = vs + (wv + offset) * R;
      for (int r = 0; r < R; ++r) corr = fmaf(ur[r], vr[r], corr);
    }
    __syncthreads();
  }
  if (row < M && col < N) out[(long long)row * N + col] = base + corr;
}

}  // namespace

extern "C" int rank_k_matmul(const void* x, const void* w, const void* u,
                             const void* v, void* out, int m, int n, int k,
                             int r, int offset, void* stream) {
  if (m == 0 || n == 0) return 0;
  const size_t smem = sizeof(float) * 2 * 256 * (size_t)r;
  if (smem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        rank_k_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return (int)attr;
  }
  const dim3 block(TILE, TILE);
  const dim3 grid((n + TILE - 1) / TILE, (m + TILE - 1) / TILE);
  rank_k_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      static_cast<const int*>(x), static_cast<const int*>(w),
      static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<float*>(out), m, n, k, r, offset);
  return (int)cudaGetLastError();
}
