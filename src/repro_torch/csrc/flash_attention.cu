// Flash-attention forward: online-softmax attention with GQA.
//
//   out[b, h, i] = sum_j softmax_j(scale * q[b,h,i] . k[b,g,j]) v[b,g,j]
//   g = h / (H / KVH), scale = d^-0.5, causal: key j visible to query i
//   iff j <= i + q_offset.
//
// Replaces: flash_attention_fwd (body _flash_kernel),
//   src/repro/kernels/flash_attention/kernel.py, in the JAX package.
//   Same arithmetic: q scaled in float32, scores, running max, exp and
//   sums in float32, masked scores -1e30, the output acc / max(l, 1e-30).
//
// Route: ops.py's dispatch table sends float32 inputs (any head dim)
// here; bf16, which the models serve, runs on the tensor cores in
// flash_attention_sm90.cu.
//
// What bounds it on an H100: operations.  At d=128 (b=1, H=8, KVH=2,
// s=1000, causal, float32) the two products are ~2 GFLOP of fp32 FMAs,
// which this kernel runs on the CUDA cores (67 TFLOP/s peak).
//
// Design: one block of 256 threads (8 warps) per (64-query tile, head,
// batch row).  Q (pre-scaled) and each 64-key K/V tile are staged in
// shared memory as float32: 113 KB at d=128, 214 KB at d=256.  A warp
// owns 8 query rows; each lane computes 2 scores per row (keys lane,
// lane+32) with float4 reads (K rows padded by 4 floats so a quarter
// warp's float4 reads hit distinct banks), reduces max and sum across
// the warp with shuffles, writes its probabilities to shared memory, and
// accumulates P.V into registers for d/32 output columns per row.  The
// Pallas kernel's blocks needed sq, sk multiples of 128; here loads are
// masked and any sq, sk >= 1 is taken.  Causal blocks stop at their
// diagonal (a fully masked tile adds exp(-1e30 - m) = 0 with alpha = 1,
// so this gives the same result) and are scheduled heaviest first.  The
// kv head is computed per block, so repeat_kv is never materialised.

#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;                // query rows per block
constexpr int kBK = 64;                // keys per tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kBQ / kWarps;    // query rows per warp
constexpr int kCols = kBK / 32;        // keys per lane per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int D>
struct Layout {
  static constexpr int kW = D / 32 < 4 ? D / 32 : 4;   // V vector width
  static constexpr int kG = D / (32 * kW);             // V vectors per lane
  static constexpr int kKStride = D + 4;               // padded K row
  static constexpr size_t kSmemFloats =
      (size_t)kBQ * D + (size_t)kBK * kKStride + (size_t)kBK * D +
      (size_t)kBQ * kBK;
  static constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);
  static_assert(kSmemBytes <= 232448, "shared stage exceeds 227 KB");
  static_assert(D % 32 == 0 && kW >= 2, "head dim must be 64, 128 or 256");
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H,
                 int KVH, int sq, int sk, int causal, int q_offset,
                 float scale) {
  using L = Layout<D>;
  constexpr int W = L::kW, G = L::kG, KS = L::kKStride;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                      // kBQ x D, pre-scaled
  float* Ks = Qs + kBQ * D;              // kBK x KS
  float* Vs = Ks + kBK * KS;             // kBK x D
  float* Ps = Vs + kBK * D;              // kBQ x kBK probabilities

  const int nqt = gridDim.x;
  const int q0 = (nqt - 1 - (int)blockIdx.x) * kBQ;   // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KVH);
  const long long qbase = ((long long)b * H + h) * sq * D;
  const long long kbase = ((long long)b * KVH + g) * sk * D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = (tid >> 5) * kRows;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int qi = q0 + r;
    Qs[i] = qi < sq ? q[qbase + (long long)qi * D + c] * scale
                    : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][G][W];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int gg = 0; gg < G; ++gg)
#pragma unroll
      for (int w = 0; w < W; ++w) acc[i][gg][w] = 0.f;
  }

  int kend = sk;
  if (causal) {
    const int last = min(q0 + kBQ, sq) - 1 + q_offset;
    kend = min(sk, last + 1);
  }

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();   // Qs ready; previous tile's Ks/Vs no longer read
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int kj = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kj < sk) {
        const long long off = kbase + (long long)kj * D + c;
        kv = k[off];
        vv = v[off];
      }
      Ks[r * KS + c] = kv;
      Vs[r * D + c] = vv;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < D; c += 4) {
      float4 kk[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kk[j] = *reinterpret_cast<const float4*>(&Ks[(lane + 32 * j) * KS + c]);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 qq =
            *reinterpret_cast<const float4*>(&Qs[(row0 + i) * D + c]);
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qq.x, kk[j].x, s[i][j]);
          s[i][j] = fmaf(qq.y, kk[j].y, s[i][j]);
          s[i][j] = fmaf(qq.z, kk[j].z, s[i][j]);
          s[i][j] = fmaf(qq.w, kk[j].w, s[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + row0 + i + q_offset;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + lane + 32 * j;
        if (kpos >= sk || (causal && kpos > qpos)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        Ps[(row0 + i) * kBK + lane + 32 * j] = p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int gg = 0; gg < G; ++gg)
#pragma unroll
        for (int w = 0; w < W; ++w) acc[i][gg][w] *= alpha;
    }
    __syncwarp();

    for (int j = 0; j < kBK; j += 4) {
      float4 pp[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pp[i] = *reinterpret_cast<const float4*>(&Ps[(row0 + i) * kBK + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[G][W];
#pragma unroll
        for (int gg = 0; gg < G; ++gg) {
          const float* src = &Vs[(j + jj) * D + (lane + 32 * gg) * W];
          if constexpr (W == 4) {
            const float4 t = *reinterpret_cast<const float4*>(src);
            vv[gg][0] = t.x; vv[gg][1] = t.y; vv[gg][2] = t.z; vv[gg][3] = t.w;
          } else {
            const float2 t = *reinterpret_cast<const float2*>(src);
            vv[gg][0] = t.x; vv[gg][1] = t.y;
          }
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = lane_of(pp[i], jj);
#pragma unroll
          for (int gg = 0; gg < G; ++gg)
#pragma unroll
            for (int w = 0; w < W; ++w)
              acc[i][gg][w] = fmaf(p, vv[gg][w], acc[i][gg][w]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + row0 + i;
    if (qi >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* dst = o + qbase + (long long)qi * D;
#pragma unroll
    for (int gg = 0; gg < G; ++gg)
#pragma unroll
      for (int w = 0; w < W; ++w)
        dst[(lane + 32 * gg) * W + w] = acc[i][gg][w] / denom;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KVH, int sq, int sk, int causal, int q_offset,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((sq + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, KVH, sq, sk,
      causal, q_offset, scale);
  return (int)cudaGetLastError();
}

int dispatch_d(const void* q, const void* k, const void* v, void* o, int B,
               int H, int KVH, int sq, int sk, int d, int causal,
               int q_offset, float scale, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<64>(q, k, v, o, B, H, KVH, sq, sk, causal, q_offset,
                           scale, stream);
    case 128:
      return launch<128>(q, k, v, o, B, H, KVH, sq, sk, causal, q_offset,
                            scale, stream);
    case 256:
      return launch<256>(q, k, v, o, B, H, KVH, sq, sk, causal, q_offset,
                            scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// float32 q (B, H, sq, d), k and v (B, KVH, sk, d), out like q.  Returns
// cudaGetLastError() after the launch (or the error that kept it from
// launching).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int KVH, int sq, int sk, int d, int causal,
                                   int q_offset, float scale, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || sq <= 0 || sk <= 0 ||
      q_offset < 0)
    return (int)cudaErrorInvalidValue;
  return dispatch_d(q, k, v, o, B, H, KVH, sq, sk, d, causal, q_offset,
                    scale, static_cast<cudaStream_t>(stream));
}
