// Population LUT gather for the batched behavioural simulation.
//
//   out[g, m, s] = lut[genes[g, s], s, cols[m, s]]        (shared cols)
//   out[g, m, s] = lut[genes[g, s], s, cols[g, m, s]]     (per-genome cols)
//
// Replaces: population_lut_gather_pallas (body _pop_lut_kernel),
//   src/repro/kernels/population_lut/kernel.py, in the JAX package.
//
// What bounds it on an H100: bytes.  Each output element is one 4-byte
// load from a small stack and one 4-byte store; there is no arithmetic
// to speak of.  At gaussian3x3's label widths (C=23, S=9, M=3600,
// G=1000) the output is 130 MB and the stack 212 KB, so the least time
// is the output write (plus the per-genome cols read) over the HBM rate.
//
// Design: there is no carry across blocks, so one thread per output
// element.  blockIdx.y walks genomes (grid-stride), the x dimension walks
// the flat (m, s) plane, so shared cols are read at the thread's own
// flat index and stores are fully coalesced.  The (C, S, 256) stack is
// read through the read-only path (__ldg); at 212 KB it stays resident
// in L2.  Offsets that can pass 2^31 (g * M * S) are 64-bit; the plane
// M * S is checked to fit int32 by the wrapper.  Genes and pixels are
// range-checked on the host where they enter (fused.py, gaussian.py); an
// index outside the stack that gets here anyway trips a device-side
// assert, as PyTorch's own indexing does, and is never dereferenced.
// Staging each block's selected rows in shared memory is left for a
// later optimisation.

#include <cassert>

#include <cuda_runtime.h>

namespace {

__global__ void population_lut_kernel(const int* __restrict__ lut,
                                      const int* __restrict__ genes,
                                      const int* __restrict__ cols,
                                      int* __restrict__ out, int C, int S,
                                      long long G, int plane,
                                      int per_genome) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;  // m * S + s
  if (e >= plane) return;
  const int s = e % S;
  for (long long g = blockIdx.y; g < G; g += gridDim.y) {
    const long long o = g * (long long)plane + e;
    const int gene = __ldg(genes + g * S + s);
    const int col = per_genome ? __ldg(cols + o) : __ldg(cols + e);
    assert((unsigned)gene < (unsigned)C && (unsigned)col < 256u);
    out[o] = __ldg(lut + ((long long)gene * S + s) * 256 + col);
  }
}

}  // namespace

extern "C" int population_lut_gather(const void* lut, const void* genes,
                                     const void* cols, void* out, int C,
                                     int S, long long G, long long M,
                                     int per_genome, void* stream) {
  const long long plane = M * S;
  if (G == 0 || plane == 0) return 0;
  const int threads = 256;
  const unsigned bx = (unsigned)((plane + threads - 1) / threads);
  const unsigned by = (unsigned)(G < 65535 ? G : 65535);
  population_lut_kernel<<<dim3(bx, by), threads, 0, (cudaStream_t)stream>>>(
      static_cast<const int*>(lut), static_cast<const int*>(genes),
      static_cast<const int*>(cols), static_cast<int*>(out), C, S, G,
      (int)plane, per_genome);
  return (int)cudaGetLastError();
}
