// Flash-attention backward: dQ, dK and dV of causal or non-causal
// attention with GQA, at q_offset 0.
//
//   s_ij = scale * q_i . k_j,  P_ij = exp(s_ij - lse_i),
//   dP_ij = dO_i . v_j,  D_i = dO_i . O_i,  dS_ij = P_ij (dP_ij - D_i),
//   dQ_i = scale * sum_j dS_ij k_j,  dK_j = scale * sum_i dS_ij q_i,
//   dV_j = sum_i P_ij dO_i,
//   with j visible to i iff j <= i under the causal mask, and the kv head
//   g = h / (H / KVH) of query head h: dK and dV of head g sum over its
//   query group.
//
// Replaces: no TPU kernel.  The JAX package trains through the chunked
//   XLA form of attention under autodiff and has no backward kernel; the
//   port's float32 training forward runs flash_attention.cu (which
//   replaces flash_attention_fwd,
//   src/repro/kernels/flash_attention/kernel.py), and this is its
//   gradient.  bf16 takes flash_attention_bwd_sm90.cu on the tensor
//   cores (ops.py's BWD_ROUTES).  The plain version is autograd through
//   kernels/flash_attention/ref.py attention_ref in float32.
//
// Arithmetic: float32 throughout; lse_i is recomputed from the scores
// (the CUDA-core forward does not return it), D_i is taken from the
// forward's output O, as FlashAttention-2 does.
//
// What bounds it on an H100: operations.  The least work is five
// products of 2 d flops a visible (query, key) pair (the scores again,
// dP, dV, dK, dQ): 2.5x the forward's two.  This first kernel runs them
// on the CUDA cores (67 TFLOP/s float32) and does 16 d flops a pair: the
// scores twice more (once for lse in the dQ kernel, once in the dK/dV
// kernel) and dP twice (once in each kernel).
//
// Design: two kernels, one launch each, on the caller's stream, in
// order; no atomics, so the result is the same bits on every run.
//   1. dQ kernel: one block of 256 threads per (32-query tile, head,
//      batch row), heaviest causal tile first.  Q (pre-scaled) and dO
//      are staged in shared memory as float32; each warp owns 4 query
//      rows.  It computes D_i, then walks the visible key tiles (64 keys,
//      K padded by 4 floats a row so a quarter warp's float4 reads hit
//      distinct banks) twice: once for lse_i (online max and sum), once
//      for dS and dQ += dS K (lanes own d/32 columns of dQ).  It writes
//      dQ, lse and D (float32 scratch the wrapper allocates).
//   2. dK/dV kernel: one block of 256 threads per (32-key tile, kv
//      head, batch row); each warp owns 4 keys, whose dK and dV stay in
//      registers while the block loops over the group's query heads and,
//      for each, over the query tiles (64 queries, Q and dO padded) that
//      can see the tile, reading lse and D from kernel 1.  Summing the
//      group inside the block is what keeps it free of atomics.
// Shared memory at d = 256: 205 KB (dQ), 213.5 KB (dK/dV) of the 227 KB
// a block may have.  Any sq, sk >= 1 is taken; loads and scores are
// masked at the ragged edges.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

// dQ kernel: query rows a block, rows a warp, keys a tile, keys a lane
constexpr int kQBlock = 32;
constexpr int kQRows = kQBlock / kWarps;
constexpr int kQTile = 64;
constexpr int kQCols = kQTile / 32;

// dK/dV kernel: keys a block, keys a warp, queries a tile, queries a lane
constexpr int kKBlock = 32;
constexpr int kKKeys = kKBlock / kWarps;
constexpr int kKTile = 64;
constexpr int kKCols = kKTile / 32;

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// a lane's columns of a d-wide row: (lane + 32 g) * W + w, g < G, w < W
template <int D>
struct Cols {
  static constexpr int kW = D / 32 < 4 ? D / 32 : 4;
  static constexpr int kG = D / (32 * kW);
  static constexpr int kPad = D + 4;     // padded row of a lane-indexed tile
  static_assert(D % 32 == 0 && kW >= 2, "head dim must be 64, 128 or 256");
};

template <int W>
__device__ __forceinline__ void load_cols(const float* src, float* dst) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(src);
    dst[0] = t.x; dst[1] = t.y;
  }
}

template <int D>
struct DqLayout {
  static constexpr size_t kFloats =
      2 * (size_t)kQBlock * D + 2 * (size_t)kQTile * Cols<D>::kPad +
      (size_t)kQBlock * kQTile;
  static constexpr size_t kBytes = kFloats * sizeof(float);
  static_assert(kBytes <= 232448, "dQ stage exceeds 227 KB");
};

template <int D>
struct DkvLayout {
  static constexpr size_t kFloats =
      2 * (size_t)kKBlock * D + 2 * (size_t)kKTile * Cols<D>::kPad +
      2 * (size_t)kKBlock * kKTile + 2 * (size_t)kKTile;
  static constexpr size_t kBytes = kFloats * sizeof(float);
  static_assert(kBytes <= 232448, "dK/dV stage exceeds 227 KB");
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ dout, float* __restrict__ dq,
                    float* __restrict__ lse_out, float* __restrict__ d_out,
                    int H, int KVH, int sq, int sk, int causal, float scale) {
  constexpr int W = Cols<D>::kW, G = Cols<D>::kG, KS = Cols<D>::kPad;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                       // kQBlock x D, pre-scaled
  float* dOs = Qs + kQBlock * D;          // kQBlock x D
  float* Ks = dOs + kQBlock * D;          // kQTile x KS
  float* Vs = Ks + kQTile * KS;           // kQTile x KS
  float* Ss = Vs + kQTile * KS;           // kQBlock x kQTile, dS

  const int q0 = ((int)gridDim.x - 1 - (int)blockIdx.x) * kQBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KVH);
  const long long rbase = ((long long)b * H + h) * sq;
  const long long qbase = rbase * D;
  const long long kbase = ((long long)b * KVH + g) * sk * D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = (tid >> 5) * kQRows;

  for (int i = tid; i < kQBlock * D; i += kThreads) {
    const int qi = q0 + i / D;
    const long long off = qbase + (long long)q0 * D + i;
    Qs[i] = qi < sq ? q[off] * scale : 0.f;
    dOs[i] = qi < sq ? dout[off] : 0.f;
  }
  __syncthreads();

  float delta[kQRows];
#pragma unroll
  for (int i = 0; i < kQRows; ++i) {
    const int qi = q0 + row0 + i;
    float acc = 0.f;
    if (qi < sq)
      for (int c = lane; c < D; c += 32)
        acc = fmaf(dOs[(row0 + i) * D + c],
                   o[qbase + (long long)qi * D + c], acc);
    delta[i] = warp_sum(acc);
  }

  int kend = sk;
  if (causal) kend = min(sk, min(q0 + kQBlock, sq));

  // pass 1: lse of each row, by online max and sum over the visible keys
  float m[kQRows], l[kQRows];
#pragma unroll
  for (int i = 0; i < kQRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < kend; k0 += kQTile) {
    __syncthreads();
    for (int i = tid; i < kQTile * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int kj = k0 + r;
      Ks[r * KS + c] =
          kj < sk ? k[kbase + (long long)kj * D + c] : 0.f;
    }
    __syncthreads();
    float s[kQRows][kQCols];
#pragma unroll
    for (int i = 0; i < kQRows; ++i)
#pragma unroll
      for (int j = 0; j < kQCols; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < D; c += 4) {
      float4 kk[kQCols];
#pragma unroll
      for (int j = 0; j < kQCols; ++j)
        kk[j] = *reinterpret_cast<const float4*>(&Ks[(lane + 32 * j) * KS + c]);
#pragma unroll
      for (int i = 0; i < kQRows; ++i) {
        const float4 qq =
            *reinterpret_cast<const float4*>(&Qs[(row0 + i) * D + c]);
#pragma unroll
        for (int j = 0; j < kQCols; ++j) s[i][j] = dot4(qq, kk[j], s[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < kQRows; ++i) {
      const int qpos = q0 + row0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kQCols; ++j) {
        const int kpos = k0 + lane + 32 * j;
        if (kpos >= sk || (causal && kpos > qpos)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], warp_max(mx));
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kQCols; ++j) psum += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + warp_sum(psum);
      m[i] = m_new;
    }
  }
  float lse[kQRows];
#pragma unroll
  for (int i = 0; i < kQRows; ++i) lse[i] = m[i] + logf(fmaxf(l[i], 1e-30f));

  // pass 2: dS = P (dP - D), dQ += dS K
  float acc[kQRows][G][W];
#pragma unroll
  for (int i = 0; i < kQRows; ++i)
#pragma unroll
    for (int gg = 0; gg < G; ++gg)
#pragma unroll
      for (int w = 0; w < W; ++w) acc[i][gg][w] = 0.f;
  for (int k0 = 0; k0 < kend; k0 += kQTile) {
    __syncthreads();
    for (int i = tid; i < kQTile * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int kj = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kj < sk) {
        const long long off = kbase + (long long)kj * D + c;
        kv = k[off];
        vv = v[off];
      }
      Ks[r * KS + c] = kv;
      Vs[r * KS + c] = vv;
    }
    __syncthreads();
    float s[kQRows][kQCols], dp[kQRows][kQCols];
#pragma unroll
    for (int i = 0; i < kQRows; ++i)
#pragma unroll
      for (int j = 0; j < kQCols; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < D; c += 4) {
      float4 kk[kQCols], vv[kQCols];
#pragma unroll
      for (int j = 0; j < kQCols; ++j) {
        kk[j] = *reinterpret_cast<const float4*>(&Ks[(lane + 32 * j) * KS + c]);
        vv[j] = *reinterpret_cast<const float4*>(&Vs[(lane + 32 * j) * KS + c]);
      }
#pragma unroll
      for (int i = 0; i < kQRows; ++i) {
        const float4 qq =
            *reinterpret_cast<const float4*>(&Qs[(row0 + i) * D + c]);
        const float4 dd =
            *reinterpret_cast<const float4*>(&dOs[(row0 + i) * D + c]);
#pragma unroll
        for (int j = 0; j < kQCols; ++j) {
          s[i][j] = dot4(qq, kk[j], s[i][j]);
          dp[i][j] = dot4(dd, vv[j], dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kQRows; ++i) {
      const int qpos = q0 + row0 + i;
#pragma unroll
      for (int j = 0; j < kQCols; ++j) {
        const int kpos = k0 + lane + 32 * j;
        const bool seen = kpos < sk && !(causal && kpos > qpos);
        const float p = seen ? expf(s[i][j] - lse[i]) : 0.f;
        Ss[(row0 + i) * kQTile + lane + 32 * j] = p * (dp[i][j] - delta[i]);
      }
    }
    __syncwarp();
    for (int j = 0; j < kQTile; j += 4) {
      float4 ds4[kQRows];
#pragma unroll
      for (int i = 0; i < kQRows; ++i)
        ds4[i] = *reinterpret_cast<const float4*>(&Ss[(row0 + i) * kQTile + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float kc[G][W];
#pragma unroll
        for (int gg = 0; gg < G; ++gg)
          load_cols<W>(&Ks[(j + jj) * KS + (lane + 32 * gg) * W], kc[gg]);
#pragma unroll
        for (int i = 0; i < kQRows; ++i) {
          const float ds = lane_of(ds4[i], jj);
#pragma unroll
          for (int gg = 0; gg < G; ++gg)
#pragma unroll
            for (int w = 0; w < W; ++w)
              acc[i][gg][w] = fmaf(ds, kc[gg][w], acc[i][gg][w]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kQRows; ++i) {
    const int qi = q0 + row0 + i;
    if (qi >= sq) continue;
    float* dst = dq + qbase + (long long)qi * D;
#pragma unroll
    for (int gg = 0; gg < G; ++gg)
#pragma unroll
      for (int w = 0; w < W; ++w)
        dst[(lane + 32 * gg) * W + w] = acc[i][gg][w] * scale;
    if (lane == 0) {
      lse_out[rbase + qi] = lse[i];
      d_out[rbase + qi] = delta[i];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int H, int KVH, int sq, int sk,
                      int causal, float scale) {
  constexpr int W = Cols<D>::kW, G = Cols<D>::kG, QS = Cols<D>::kPad;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                       // kKBlock x D, read by broadcast
  float* Vs = Ks + kKBlock * D;           // kKBlock x D
  float* Qs = Vs + kKBlock * D;           // kKTile x QS, pre-scaled
  float* dOs = Qs + kKTile * QS;          // kKTile x QS
  float* Ps = dOs + kKTile * QS;          // kKBlock x kKTile
  float* dSs = Ps + kKBlock * kKTile;     // kKBlock x kKTile
  float* Ls = dSs + kKBlock * kKTile;     // kKTile lse
  float* Ds = Ls + kKTile;                // kKTile D

  const int k0 = blockIdx.x * kKBlock;    // causal: heaviest tiles first
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / KVH;
  const long long kbase = ((long long)b * KVH + g) * sk * D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int key0 = (tid >> 5) * kKKeys;

  for (int i = tid; i < kKBlock * D; i += kThreads) {
    const int kj = k0 + i / D;
    const long long off = kbase + (long long)k0 * D + i;
    Ks[i] = kj < sk ? k[off] : 0.f;
    Vs[i] = kj < sk ? v[off] : 0.f;
  }

  float acc_k[kKKeys][G][W], acc_v[kKKeys][G][W];
#pragma unroll
  for (int kk = 0; kk < kKKeys; ++kk)
#pragma unroll
    for (int gg = 0; gg < G; ++gg)
#pragma unroll
      for (int w = 0; w < W; ++w) acc_k[kk][gg][w] = acc_v[kk][gg][w] = 0.f;

  // queries before k0 see none of this tile's keys
  const int qstart = causal ? (k0 / kKTile) * kKTile : 0;
  for (int hh = 0; hh < rep; ++hh) {
    const int h = g * rep + hh;
    const long long rbase = ((long long)b * H + h) * sq;
    const long long qbase = rbase * D;
    for (int q0 = qstart; q0 < sq; q0 += kKTile) {
      __syncthreads();   // the last tile's Qs, dOs, Ps no longer read
      for (int i = tid; i < kKTile * D; i += kThreads) {
        const int r = i / D, c = i % D;
        const int qi = q0 + r;
        float qv = 0.f, dv_ = 0.f;
        if (qi < sq) {
          const long long off = qbase + (long long)qi * D + c;
          qv = q[off] * scale;
          dv_ = dout[off];
        }
        Qs[r * QS + c] = qv;
        dOs[r * QS + c] = dv_;
      }
      for (int i = tid; i < kKTile; i += kThreads) {
        const int qi = q0 + i;
        Ls[i] = qi < sq ? lse[rbase + qi] : 0.f;
        Ds[i] = qi < sq ? delta[rbase + qi] : 0.f;
      }
      __syncthreads();

      float s[kKKeys][kKCols], dp[kKKeys][kKCols];
#pragma unroll
      for (int kk = 0; kk < kKKeys; ++kk)
#pragma unroll
        for (int j = 0; j < kKCols; ++j) s[kk][j] = dp[kk][j] = 0.f;
#pragma unroll 2
      for (int c = 0; c < D; c += 4) {
        float4 qq[kKCols], dd[kKCols];
#pragma unroll
        for (int j = 0; j < kKCols; ++j) {
          qq[j] = *reinterpret_cast<const float4*>(&Qs[(lane + 32 * j) * QS + c]);
          dd[j] = *reinterpret_cast<const float4*>(&dOs[(lane + 32 * j) * QS + c]);
        }
#pragma unroll
        for (int kk = 0; kk < kKKeys; ++kk) {
          const float4 kf =
              *reinterpret_cast<const float4*>(&Ks[(key0 + kk) * D + c]);
          const float4 vf =
              *reinterpret_cast<const float4*>(&Vs[(key0 + kk) * D + c]);
#pragma unroll
          for (int j = 0; j < kKCols; ++j) {
            s[kk][j] = dot4(kf, qq[j], s[kk][j]);
            dp[kk][j] = dot4(vf, dd[j], dp[kk][j]);
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < kKKeys; ++kk) {
        const int kpos = k0 + key0 + kk;
#pragma unroll
        for (int j = 0; j < kKCols; ++j) {
          const int r = lane + 32 * j;
          const int qpos = q0 + r;
          const bool seen =
              kpos < sk && qpos < sq && !(causal && kpos > qpos);
          const float p = seen ? expf(s[kk][j] - Ls[r]) : 0.f;
          Ps[(key0 + kk) * kKTile + r] = p;
          dSs[(key0 + kk) * kKTile + r] = p * (dp[kk][j] - Ds[r]);
        }
      }
      __syncwarp();
      for (int j = 0; j < kKTile; j += 4) {
        float4 p4[kKKeys], ds4[kKKeys];
#pragma unroll
        for (int kk = 0; kk < kKKeys; ++kk) {
          p4[kk] = *reinterpret_cast<const float4*>(&Ps[(key0 + kk) * kKTile + j]);
          ds4[kk] =
              *reinterpret_cast<const float4*>(&dSs[(key0 + kk) * kKTile + j]);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float qc[G][W], dc[G][W];
#pragma unroll
          for (int gg = 0; gg < G; ++gg) {
            const int col = (lane + 32 * gg) * W;
            load_cols<W>(&Qs[(j + jj) * QS + col], qc[gg]);
            load_cols<W>(&dOs[(j + jj) * QS + col], dc[gg]);
          }
#pragma unroll
          for (int kk = 0; kk < kKKeys; ++kk) {
            const float p = lane_of(p4[kk], jj);
            const float ds = lane_of(ds4[kk], jj);
#pragma unroll
            for (int gg = 0; gg < G; ++gg)
#pragma unroll
              for (int w = 0; w < W; ++w) {
                acc_v[kk][gg][w] = fmaf(p, dc[gg][w], acc_v[kk][gg][w]);
                acc_k[kk][gg][w] = fmaf(ds, qc[gg][w], acc_k[kk][gg][w]);
              }
          }
        }
      }
    }
  }

#pragma unroll
  for (int kk = 0; kk < kKKeys; ++kk) {
    const int kj = k0 + key0 + kk;
    if (kj >= sk) continue;
    const long long off = kbase + (long long)kj * D;
#pragma unroll
    for (int gg = 0; gg < G; ++gg)
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const int col = (lane + 32 * gg) * W + w;
        dk[off + col] = acc_k[kk][gg][w];
        dv[off + col] = acc_v[kk][gg][w];
      }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, void* lse,
           void* delta, int B, int H, int KVH, int sq, int sk, int causal,
           float scale, cudaStream_t stream) {
  constexpr size_t smem_q = DqLayout<D>::kBytes;
  constexpr size_t smem_k = DkvLayout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_k);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((unsigned)((sq + kQBlock - 1) / kQBlock), (unsigned)H,
                    (unsigned)B);
  flash_bwd_dq_kernel<D><<<grid_q, kThreads, smem_q, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), static_cast<float*>(dq),
      static_cast<float*>(lse), static_cast<float*>(delta), H, KVH, sq, sk,
      causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_k((unsigned)((sk + kKBlock - 1) / kKBlock), (unsigned)KVH,
                    (unsigned)B);
  flash_bwd_dkdv_kernel<D><<<grid_k, kThreads, smem_k, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), H, KVH, sq, sk, causal,
      scale);
  return (int)cudaGetLastError();
}

int dispatch_d(const void* q, const void* k, const void* v, const void* o,
               const void* dout, void* dq, void* dk, void* dv, void* lse,
               void* delta, int B, int H, int KVH, int sq, int sk, int d,
               int causal, float scale, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<64>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, H,
                           KVH, sq, sk, causal, scale, stream);
    case 128:
      return launch<128>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, H,
                            KVH, sq, sk, causal, scale, stream);
    case 256:
      return launch<256>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, H,
                            KVH, sq, sk, causal, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, dout, dq: (B, H, sq, d); k, v, dk, dv: (B, KVH, sk, d), all
// float32, contiguous; lse, delta: (B, H, sq) float32 scratch.  Returns
// cudaGetLastError() after the two launches (or the error that kept one
// from launching).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, void* lse, void* delta, int B,
                                   int H, int KVH, int sq, int sk, int d,
                                   int causal, float scale, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || sq <= 0 || sk <= 0)
    return (int)cudaErrorInvalidValue;
  return dispatch_d(q, k, v, o, dout, dq, dk, dv, lse, delta, B, H, KVH, sq,
                    sk, d, causal, scale, static_cast<cudaStream_t>(stream));
}
