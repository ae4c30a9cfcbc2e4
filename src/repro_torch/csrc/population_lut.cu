// Population LUT gather for the batched behavioural simulation.
//
//   out[g, m, s] = lut[genes[g, s], s, cols[m, s]]        (shared cols)
//   out[g, m, s] = lut[genes[g, s], s, cols[g, m, s]]     (per-genome cols)
//
// Replaces: population_lut_gather_pallas (body _pop_lut_kernel),
//   src/repro/kernels/population_lut/kernel.py, in the JAX package.
//
// What bounds it on an H100: bytes.  Each output element is one 4-byte
// store (plus one 4-byte cols read with per-genome cols); the stack is
// small.  At gaussian3x3's label widths (C=23, S=9, M=3600, G=1000) the
// output is 130 MB and the stack 212 KB, so the least time is the output
// write (plus the per-genome cols read) over the HBM rate: 0.039 ms
// (0.077 ms per-genome).  The previous design read every element from the
// L2-resident stack with one 4-byte load, which L2 serves as a 32-byte
// sector: 8x the bytes used, and L2, not HBM, set its time.
//
// Design: a block takes bg genomes (4, fewer where S rows of 1 KB each
// would not fit) and a span of 8192 elements of the flat (m, s) plane
// (e = m * S + s).  It first stages the bg * S selected 256-entry rows,
// lut[genes[g, s], s, :], in shared memory (bg * S KB, read from L2 in
// 16-byte loads; above 48 KB it is requested as dynamic shared memory).
// Then each thread takes 4 consecutive plane elements at a time: one
// 16-byte load of shared cols, reused across the bg genomes, then 4
// shared-memory lookups and one 16-byte streaming store per genome.
// Per-genome cols are one 16-byte streaming load per genome.  16-byte
// loads and stores need a plane that is a multiple of 4 and 16-byte
// aligned cols and out; otherwise the same kernel moves one element a
// thread, consecutive threads on consecutive elements.  blockIdx.y walks
// the genome groups (grid-stride past 65535) and the last group may hold
// fewer than bg genomes.  Offsets that can pass 2^31 (g * M * S) are
// 64-bit; the plane M * S is checked to fit int32 by the wrapper.  Genes
// and pixels are range-checked on the host where they enter (fused.py,
// gaussian.py); an index outside the stack that gets here anyway trips a
// device-side assert, as PyTorch's own indexing does, and is never
// dereferenced.

#include <cassert>

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGenomes = 4;                    // bg, at most
constexpr int kSpan = kThreads * 4 * 8;        // plane elements a block
constexpr int kRowInts = 256;
constexpr int kMaxSmem = 232448;               // 227 KB a block
constexpr int kDefaultSmem = 48 * 1024;

int genomes_per_block(int S) {
  const int fit = kMaxSmem / (S * kRowInts * 4);
  return fit < kGenomes ? fit : kGenomes;
}

__device__ __forceinline__ int wrap(int s, int S) { return s == S ? 0 : s; }

template <bool kPerGenome>
__global__ void __launch_bounds__(kThreads)
population_lut_kernel(const int* __restrict__ lut,
                      const int* __restrict__ genes,
                      const int* __restrict__ cols, int* __restrict__ out,
                      int C, int S, long long G, int plane, int bg, int vec) {
  extern __shared__ int4 smem[];
  int* rows = reinterpret_cast<int*>(smem);   // [bg][S][256]
  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * kSpan;
  const int e1 = min(e0 + kSpan, plane);
  const long long groups = (G + bg - 1) / bg;
  const bool vec_lut = (reinterpret_cast<uintptr_t>(lut) & 15) == 0;

  for (long long grp = blockIdx.y; grp < groups; grp += gridDim.y) {
    const long long g0 = grp * bg;
    const int ng = (int)min((long long)bg, G - g0);

    // stage rows[gl][s] = lut[genes[g0 + gl, s], s, :], 16 bytes at a
    // time where the stack is 16-byte aligned (then so is every row)
    const int per = vec_lut ? kRowInts / 4 : kRowInts;
    for (int i = tid; i < ng * S * per; i += kThreads) {
      const int r = i / per, k = i % per;
      const int gl = r / S, s = r - gl * S;
      const int gene = __ldg(genes + (g0 + gl) * S + s);
      assert((unsigned)gene < (unsigned)C);
      const int* src = lut + ((long long)gene * S + s) * kRowInts;
      if (vec_lut)
        smem[i] = __ldg(reinterpret_cast<const int4*>(src) + k);
      else
        rows[i] = __ldg(src + k);
    }
    __syncthreads();

    if (vec) {
      for (int e = e0 + 4 * tid; e < e1; e += 4 * kThreads) {
        int sl[4];
        sl[0] = e % S;
        sl[1] = wrap(sl[0] + 1, S);
        sl[2] = wrap(sl[1] + 1, S);
        sl[3] = wrap(sl[2] + 1, S);
        int4 c4;
        if (!kPerGenome) c4 = __ldg(reinterpret_cast<const int4*>(cols + e));
        for (int gl = 0; gl < ng; ++gl) {
          const long long o = (g0 + gl) * (long long)plane + e;
          if (kPerGenome) c4 = __ldcs(reinterpret_cast<const int4*>(cols + o));
          assert((unsigned)c4.x < 256u && (unsigned)c4.y < 256u &&
                 (unsigned)c4.z < 256u && (unsigned)c4.w < 256u);
          const int* rg = rows + gl * S * kRowInts;
          int4 v;
          v.x = rg[sl[0] * kRowInts + c4.x];
          v.y = rg[sl[1] * kRowInts + c4.y];
          v.z = rg[sl[2] * kRowInts + c4.z];
          v.w = rg[sl[3] * kRowInts + c4.w];
          __stcs(reinterpret_cast<int4*>(out + o), v);
        }
      }
    } else {
      for (int e = e0 + tid; e < e1; e += kThreads) {
        const int s = e % S;
        const int cs = kPerGenome ? 0 : __ldg(cols + e);
        for (int gl = 0; gl < ng; ++gl) {
          const long long o = (g0 + gl) * (long long)plane + e;
          const int col = kPerGenome ? __ldcs(cols + o) : cs;
          assert((unsigned)col < 256u);
          __stcs(out + o, rows[(gl * S + s) * kRowInts + col]);
        }
      }
    }
    __syncthreads();   // rows consumed before the next group restages
  }
}

template <bool kPerGenome>
int launch(const int* lut, const int* genes, const int* cols, int* out,
           int C, int S, long long G, int plane, int vec,
           cudaStream_t stream) {
  const int bg = genomes_per_block(S);
  const int bytes = bg * S * kRowInts * 4;
  if (bytes > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        population_lut_kernel<kPerGenome>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const long long groups = (G + bg - 1) / bg;
  const dim3 grid((unsigned)((plane + kSpan - 1) / kSpan),
                  (unsigned)(groups < 65535 ? groups : 65535));
  population_lut_kernel<kPerGenome><<<grid, kThreads, bytes, stream>>>(
      lut, genes, cols, out, C, S, G, plane, bg, vec);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Returns cudaGetLastError() after the launch (or the error that kept it
// from launching); cudaErrorInvalidValue for an S whose one 1 KB row per
// slot does not fit in a block's shared memory.
extern "C" int population_lut_gather(const void* lut, const void* genes,
                                     const void* cols, void* out, int C,
                                     int S, long long G, long long M,
                                     int per_genome, void* stream) {
  const long long plane = M * S;
  if (G == 0 || plane == 0) return 0;
  if (S <= 0 || genomes_per_block(S) < 1 || plane >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const int vec = plane % 4 == 0 && aligned16(cols) && aligned16(out);
  const auto* l = static_cast<const int*>(lut);
  const auto* g = static_cast<const int*>(genes);
  const auto* c = static_cast<const int*>(cols);
  auto* o = static_cast<int*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return per_genome
             ? launch<true>(l, g, c, o, C, S, G, (int)plane, vec, st)
             : launch<false>(l, g, c, o, C, S, G, (int)plane, vec, st);
}
