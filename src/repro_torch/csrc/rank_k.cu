// Grouped rank-k approximate matmul: the deployment form of one variant,
// every slot group in one launch.
//
//   part_g[i, j] = sum_{k in [s_g, e_g)} t(x[i,k]) * t(w[k,j])
//                + sum_k sum_r U_g[t(x[i,k]) + o_g, r] * V_g[t(w[k,j]) + o_g, r]
//   out = part_0 + part_1 + ... + part_{G-1}      (in this order)
//
// with t(a) = sign(a) * ((|a| >> tb_g) << tb_g) the truncation circuit's
// operand mask (tb_g = 0 leaves a as it is), o_g = 128 for signed
// circuits and 0 for unsigned, fp32 accumulation.  Base and correction
// sums of a group are kept apart and added at the end of the group, then
// the group partials are added in group order: the same float32 order as
// one launch per group followed by a chain of adds.  A single circuit
// over the whole contraction is the case G = 1.
//
// Replaces: rank_k_mxu (body _rank_k_kernel),
//   src/repro/kernels/approx_matmul/kernel.py, in the JAX package, and the
//   per-group loop of grouped_matmul around it.
//
// Packed layout (int32 words, one upload): [G, G x (s, e, r, uv, o, tb),
// then the float32 U/V tables], where group g's U is the (256, r) table
// at float offset uv into the tables and its V follows it.
//
// What bounds it on an H100: operations.  Every (i, j, k) term is one
// FMA for the base product and r FMAs plus 2r table reads for the
// correction, on the CUDA cores in full fp32 (no TF32, no tensor cores),
// so the bound is 2*m*n*k*(1+r) FLOPs over the fp32 rate.  The main
// path's own shapes are tiny and ragged (gaussian3x3: nine (900,1)@(1,1)
// slot groups), where the host's launch and upload cost rules: a
// variant takes one table upload and one launch.
//
// Design: one thread per output element, 16x16 output tiles.  The packed
// descriptors and every group's U/V tables are staged once per block in
// dynamic shared memory, so the data-dependent table reads stay on chip.
// Each k-step of a group stages a 16x16 tile of x and of w, masked at the
// group's ragged edge (a padded zero would still index U[o] and V[o], so
// the k loop stops at e_g) and truncated on load.

#include <cassert>

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int kDesc = 6;   // int32 words per group descriptor

// Operands are 8-bit by construction on the main path (im2col of 8-bit
// pixels, fixed coefficients).  One outside the domain would index past
// the tables: it trips a device-side assert, as PyTorch's own indexing
// does, and is never dereferenced.
__device__ __forceinline__ int in_domain(int val, int offset) {
  assert((unsigned)(val + offset) <= 255u);
  return val;
}

__device__ __forceinline__ int truncate(int val, int tb) {
  const int mag = (abs(val) >> tb) << tb;
  return val < 0 ? -mag : mag;
}

__global__ void rank_k_kernel(const int* __restrict__ x,
                              const int* __restrict__ w,
                              const int* __restrict__ packed,
                              float* __restrict__ out,
                              int M, int N, int K, int G, int n_uv) {
  extern __shared__ float uv[];        // n_uv table floats, then G descs
  int* desc = reinterpret_cast<int*>(uv + n_uv);
  __shared__ int xs[TILE][TILE + 1];
  __shared__ int ws[TILE][TILE + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TILE + tx;
  const float* tables = reinterpret_cast<const float*>(packed + 1 + kDesc * G);
  for (int i = tid; i < n_uv; i += TILE * TILE) uv[i] = tables[i];
  for (int i = tid; i < kDesc * G; i += TILE * TILE) desc[i] = packed[1 + i];
  __syncthreads();
  const int row = blockIdx.y * TILE + ty;
  const int col = blockIdx.x * TILE + tx;
  float total = 0.f;
  for (int g = 0; g < G; ++g) {
    const int* dg = desc + kDesc * g;
    const int s = dg[0], e = dg[1], R = dg[2], offset = dg[4], tb = dg[5];
    const float* us = uv + dg[3];
    const float* vs = us + 256 * R;
    float base = 0.f, corr = 0.f;
    for (int k0 = s; k0 < e; k0 += TILE) {
      xs[ty][tx] = in_domain(
          (row < M && k0 + tx < e)
              ? truncate(x[(long long)row * K + k0 + tx], tb) : 0,
          offset);
      ws[ty][tx] = in_domain(
          (k0 + ty < e && col < N)
              ? truncate(w[(long long)(k0 + ty) * N + col], tb) : 0,
          offset);
      __syncthreads();
      const int kmax = min(TILE, e - k0);
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
    const float part = base + corr;
    total = g == 0 ? part : total + part;
  }
  if (row < M && col < N) out[(long long)row * N + col] = total;
}

// The kernel's static shared memory (its xs/ws tiles) as compiled, read
// once from the function's attributes.
cudaError_t static_smem(size_t* bytes) {
  static cudaFuncAttributes attrs;
  static const cudaError_t status =
      cudaFuncGetAttributes(&attrs, rank_k_kernel);
  *bytes = attrs.sharedSizeBytes;
  return status;
}

}  // namespace

// packed: see the layout above; n_uv: the float32 words of its tables
// (2 * 256 * sum_g r_g).  Returns cudaGetLastError() after the launch.
extern "C" int rank_k_grouped(const void* x, const void* w,
                              const void* packed, void* out, int m, int n,
                              int k, int groups, int n_uv, void* stream) {
  if (m == 0 || n == 0) return 0;
  if (groups <= 0 || n_uv < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)n_uv + (size_t)kDesc * groups);
  size_t static_bytes = 0;
  const cudaError_t got = static_smem(&static_bytes);
  if (got != cudaSuccess) return (int)got;
  // without the attribute a block has 48 KB of shared memory in all,
  // the static tiles included; the attribute also persists in the
  // process, so a launch must not count on an earlier one having set it
  if (smem + static_bytes > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        rank_k_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return (int)attr;
  }
  const dim3 block(TILE, TILE);
  const dim3 grid((n + TILE - 1) / TILE, (m + TILE - 1) / TILE);
  rank_k_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      static_cast<const int*>(x), static_cast<const int*>(w),
      static_cast<const int*>(packed), static_cast<float*>(out), m, n, k,
      groups, n_uv);
  return (int)cudaGetLastError();
}
