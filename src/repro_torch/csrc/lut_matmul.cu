// Behavioural (bit-exact) approximate matmul through a product table.
//
//   out[i, j] = sum_k T[x[i,k] + o, w[k,j] + o]       exact int32
//
// with o = 128 for signed circuits, 0 for unsigned.
//
// Replaces: lut_matmul_pallas (body _lut_kernel),
//   src/repro/kernels/approx_matmul/kernel.py, in the JAX package.
//
// What bounds it on an H100: operations.  Each (i, j, k) term is one
// data-dependent 4-byte table read and one integer add, m*n*k of each;
// there is no tensor-core form of a table lookup.  |T| <= 65025, so an
// int32 sum is exact for k up to ~33,000.
//
// Design: one thread per output element, 16x16 output tiles, x and w
// tiles staged in shared memory per k-step with masked ragged edges.
// The int32 (256, 256) table is 256 KB, over the 227 KB a block can hold,
// so this slice reads it from global memory through the read-only path
// (__ldg), where it stays resident in L2.  Narrowing it to int16 so it
// fits in shared memory is a later optimisation.

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

__global__ void lut_matmul_kernel(const int* __restrict__ x,
                                  const int* __restrict__ w,
                                  const int* __restrict__ table,
                                  int* __restrict__ out,
                                  int M, int N, int K,
                                  int offset) {
  __shared__ int xs[TILE][TILE + 1];
  __shared__ int ws[TILE][TILE + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int row = blockIdx.y * TILE + ty;
  const int col = blockIdx.x * TILE + tx;
  int acc = 0;
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
      acc += __ldg(table + (xs[ty][kk] + offset) * 256 + ws[kk][tx] + offset);
    }
    __syncthreads();
  }
  if (row < M && col < N) out[(long long)row * N + col] = acc;
}

}  // namespace

extern "C" int lut_matmul(const void* x, const void* w, const void* table,
                          void* out, int m, int n, int k, int offset,
                          void* stream) {
  if (m == 0 || n == 0) return 0;
  const dim3 block(TILE, TILE);
  const dim3 grid((n + TILE - 1) / TILE, (m + TILE - 1) / TILE);
  lut_matmul_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      static_cast<const int*>(x), static_cast<const int*>(w),
      static_cast<const int*>(table), static_cast<int*>(out), m, n, k,
      offset);
  return (int)cudaGetLastError();
}
