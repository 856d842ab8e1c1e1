// Chunked linear attention (the mLSTM / Mamba2-SSD state sweep) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `chunked_linear_attention_pallas`
// (src/repro/kernels/chunked_linear_attention.py:79, body `_kernel`).
//
// What it computes, per head and per chunk of C rows, all in fp32:
//   L      = cumsum(g)                                  (C,)
//   out    = ((q k^T) * exp(L_i - L_j) [i >= j]) v + exp(L) * (q S)
//   S     <- exp(L_C) S + (k * exp(L_C - L))^T v
// with S (dk x dv) starting at zero and stored once, after the last chunk
// (the reference's store-once rule applied to the recurrent state).  `out`
// is stored in the input dtype, the state in fp32.
//
// Design.  On the TPU the whole (dk, dv) state sits in VMEM.  At
// xlstm-1.3b's width (dk = dv = 1024) one head's state is 4 MiB of fp32
// against 227 KB of shared memory per block, so the dv axis is split: the
// columns of the recurrence are independent (S[:, j] needs only v[:, j]),
// so one block owns one (head, 32-column dv tile) pair and keeps its
// dk x 32 slice of S (128 KB at dk = 1024) in shared memory across the
// whole chunk loop — the TPU's sequential chunk grid axis becomes that
// loop.  The dv split is also what fills the card: 16 (batch, head) pairs
// at the training shape become 512 blocks.  Each block recomputes the
// C x C intra-chunk scores for its own tile (q and k are read once per
// tile, from L2 after the first): at dk = dv = 1024 and C = 64 that is
// about as many FMAs again as the useful work, the price of the simple
// design.  q and k stream through shared memory 32 dk-rows at a time: one
// pass accumulates the scores and the inter-chunk read q S together (S is
// still the previous chunk's), a second pass applies the decayed k^T v
// update.  All products are SIMT fp32 FMAs on register micro-tiles fed by
// 16-byte shared-memory reads (the loop is bound by shared-memory load
// instructions, not by FMAs).
//
// What bounds it.  At the training shape (BH 16, S 256, dk = dv = 1024,
// C 64, bf16 inputs) the function moves ~101 MB (mostly the fp32 state
// store) and needs ~18.3 GFLOP of fp32, so it is bound by operations
// (~0.27 ms at 67 TFLOP/s); this kernel does ~2x those FMAs and runs them
// from shared memory, without tensor cores.  Later work: wgmma products,
// a TMA-fed chunk ring, and one pass of scores shared by all dv tiles.
//
// Contract (checked by the Python wrapper): S is a multiple of C (callers
// pad with g = 0, k = 0, which is inert); C in {16, 32, 64, 128}; any dk
// whose state slice fits shared memory, any dv; BH <= 65535.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // eight warps
constexpr int kTV = 32;        // dv columns per block (one per lane)
constexpr int kDKT = 32;       // dk rows per streamed q / k tile

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__half>(__half v) {
  return __half2float(v);
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Padded row of the q / k / score tiles: a multiple of 4 floats, so rows
// stay 16-byte aligned for vector reads, shifted by 4 banks per row.
__host__ __device__ constexpr int row_pad(int C) { return C + 4; }

// Shared memory of one block, in floats (the host sizes the launch by it).
__host__ __device__ constexpr long long smem_floats(int C, int dk) {
  // state slice | v tile | L | union(q and k tiles, scores)
  return (long long)dk * kTV + (long long)C * kTV + C +
         ((2 * kDKT * row_pad(C) > C * row_pad(C)) ? 2 * kDKT * row_pad(C)
                                                   : C * row_pad(C));
}

// dst[0..N) = src[0..N) from shared memory, as 16- or 8-byte reads where N
// allows (src is then 16- / 8-byte aligned by construction).
template <int N>
__device__ __forceinline__ void lds(float (&dst)[N], const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(src)[q];
      dst[4 * q] = t.x;
      dst[4 * q + 1] = t.y;
      dst[4 * q + 2] = t.z;
      dst[4 * q + 3] = t.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const float2 t = reinterpret_cast<const float2*>(src)[q];
      dst[2 * q] = t.x;
      dst[2 * q + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) dst[q] = src[q];
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    chunked_linear_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                    const T* __restrict__ v,
                                    const float* __restrict__ g, T* __restrict__ out,
                                    float* __restrict__ state, int S, int dk, int dv) {
  static_assert(C % 16 == 0, "chunk must be a multiple of 16");
  constexpr int CP = row_pad(C);  // padded row of the q / k / score tiles
  constexpr int RM = C / 16;      // scores: RM x RM per thread (16 x 16 threads)
  constexpr int OR = C / 8;       // out: OR consecutive rows per thread
  constexpr int SR = kDKT / 8;    // state update: SR rows per thread per tile

  extern __shared__ float smem[];
  float* st = smem;                        // [dk][kTV]   the state slice
  float* vs = st + (long long)dk * kTV;    // [C][kTV]    v tile of this chunk
  float* ls = vs + C * kTV;                // [C]         L = cumsum(g)
  float* qs = ls + C;                      // [kDKT][CP]  q tile, transposed
  float* ks = qs + kDKT * CP;              // [kDKT][CP]  k tile, transposed
  float* ss = qs;                          // [C][CP]     decayed scores (aliases q/k)

  const int bh = blockIdx.y;
  const int j0 = blockIdx.x * kTV;
  const int tid = threadIdx.x;
  q += (long long)bh * S * dk;
  k += (long long)bh * S * dk;
  v += (long long)bh * S * dv;
  g += (long long)bh * S;
  out += (long long)bh * S * dv;
  state += (long long)bh * dk * dv;

  const int ty = tid / 16, tx = tid % 16;       // score micro-tile
  // out / state: column oj (one per lane), row group og (one per warp, so a
  // warp's reads of q or k rows are broadcasts)
  const int oj = tid % kTV, og = tid / kTV;
  const bool jvalid = j0 + oj < dv;

  for (int e = tid; e < dk * kTV; e += kThreads) st[e] = 0.f;

  for (int s0 = 0; s0 < S; s0 += C) {
    __syncthreads();  // the previous chunk is done with vs / ls / the union
    if (tid == 0) {   // inclusive cumsum, in order (the reference's)
      float acc = 0.f;
      for (int i = 0; i < C; ++i) {
        acc += g[s0 + i];
        ls[i] = acc;
      }
    }
    for (int e = tid; e < C * kTV; e += kThreads) {
      const int i = e / kTV, jj = e % kTV;
      vs[e] = (j0 + jj < dv) ? to_f(v[(long long)(s0 + i) * dv + j0 + jj]) : 0.f;
    }

    // pass 1 over dk: scores q k^T and the inter-chunk read q S
    float sacc[RM][RM];
    float oacc[OR];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < RM; ++c) sacc[r][c] = 0.f;
#pragma unroll
    for (int r = 0; r < OR; ++r) oacc[r] = 0.f;

    for (int k0 = 0; k0 < dk; k0 += kDKT) {
      __syncthreads();  // previous tile consumed
      for (int e = tid; e < C * kDKT; e += kThreads) {
        const int i = e / kDKT, kk = e % kDKT;
        const int gk = k0 + kk;
        float qv = 0.f, kv = 0.f;
        if (gk < dk) {
          const long long off = (long long)(s0 + i) * dk + gk;
          qv = to_f(q[off]);
          kv = to_f(k[off]);
        }
        qs[kk * CP + i] = qv;
        ks[kk * CP + i] = kv;
      }
      __syncthreads();
      const int kn = (dk - k0) < kDKT ? (dk - k0) : kDKT;
      for (int kk = 0; kk < kn; ++kk) {
        const float* qrow = qs + kk * CP;
        const float* krow = ks + kk * CP;
        float a[RM], b[RM], qo[OR];
        lds(a, qrow + ty * RM);
        lds(b, krow + tx * RM);
        lds(qo, qrow + og * OR);
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int c = 0; c < RM; ++c) sacc[r][c] = fmaf(a[r], b[c], sacc[r][c]);
        const float sv = st[(k0 + kk) * kTV + oj];
#pragma unroll
        for (int r = 0; r < OR; ++r) oacc[r] = fmaf(qo[r], sv, oacc[r]);
      }
    }
    __syncthreads();  // every thread is done reading the q / k tiles

    // decayed, causally masked scores into shared memory (over the tiles)
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int i = ty * RM + r;
#pragma unroll
      for (int c = 0; c < RM; ++c) {
        const int j = tx * RM + c;
        ss[i * CP + j] = (i >= j) ? sacc[r][c] * expf(ls[i] - ls[j]) : 0.f;
      }
    }
    __syncthreads();

    // out = exp(L) * (q S) + scores v, stored once in the input dtype
#pragma unroll
    for (int r = 0; r < OR; ++r) {
      const int i = og * OR + r;
      float acc = oacc[r] * expf(ls[i]);
      const float* srow = ss + i * CP;
      for (int j = 0; j <= i; ++j) acc = fmaf(srow[j], vs[j * kTV + oj], acc);
      if (jvalid) out[(long long)(s0 + i) * dv + j0 + oj] = from_f<T>(acc);
    }
    __syncthreads();  // scores consumed: the union takes k tiles again

    // pass 2 over dk: S <- exp(L_C) S + (k * exp(L_C - L))^T v
    const float ltot = ls[C - 1];
    const float etot = expf(ltot);
    for (int k0 = 0; k0 < dk; k0 += kDKT) {
      for (int e = tid; e < C * kDKT; e += kThreads) {
        const int i = e / kDKT, kk = e % kDKT;
        const int gk = k0 + kk;
        ks[kk * CP + i] = (gk < dk)
                              ? to_f(k[(long long)(s0 + i) * dk + gk]) * expf(ltot - ls[i])
                              : 0.f;
      }
      __syncthreads();
      // rows og + 8 m of this tile: each v value is read once for all SR
      float acc[SR];
#pragma unroll
      for (int m = 0; m < SR; ++m) acc[m] = 0.f;
      for (int i = 0; i < C; ++i) {
        const float vv = vs[i * kTV + oj];
#pragma unroll
        for (int m = 0; m < SR; ++m) acc[m] = fmaf(ks[(og + 8 * m) * CP + i], vv, acc[m]);
      }
#pragma unroll
      for (int m = 0; m < SR; ++m) {
        const int kk = k0 + og + 8 * m;
        if (kk < dk) {
          float* sp = st + kk * kTV + oj;
          *sp = fmaf(etot, *sp, acc[m]);
        }
      }
      __syncthreads();
    }
  }

  // the state, stored once
  for (int e = tid; e < dk * kTV; e += kThreads) {
    const int kk = e / kTV, jj = e % kTV;
    if (j0 + jj < dv) state[(long long)kk * dv + j0 + jj] = st[e];
  }
}

template <typename T, int C>
int launch(const void* q, const void* k, const void* v, const float* g, void* out,
           float* state, int BH, int S, int dk, int dv, cudaStream_t stream) {
  const size_t bytes = (size_t)smem_floats(C, dk) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      chunked_linear_attention_kernel<T, C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((dv + kTV - 1) / kTV, BH);
  chunked_linear_attention_kernel<T, C><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      g, static_cast<T*>(out), state, S, dk, dv);
  return (int)cudaGetLastError();
}

template <typename T>
int by_chunk(int chunk, const void* q, const void* k, const void* v, const float* g,
             void* out, float* state, int BH, int S, int dk, int dv,
             cudaStream_t s) {
  switch (chunk) {
    case 16: return launch<T, 16>(q, k, v, g, out, state, BH, S, dk, dv, s);
    case 32: return launch<T, 32>(q, k, v, g, out, state, BH, S, dk, dv, s);
    case 64: return launch<T, 64>(q, k, v, g, out, state, BH, S, dk, dv, s);
    case 128: return launch<T, 128>(q, k, v, g, out, state, BH, S, dk, dv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory one block needs, in bytes (the wrapper checks the budget).
extern "C" long long cla_smem_bytes(int chunk, int dk) {
  return smem_floats(chunk, dk) * (long long)sizeof(float);
}

// dtype: 0 = fp16, 1 = bf16, 2 = fp32 (q, k, v and out); g and state fp32.
// q, k (BH, S, dk), v / out (BH, S, dv), g (BH, S), state (BH, dk, dv), all
// contiguous.  Returns cudaGetLastError() of the launch (0 on success).
extern "C" int chunked_linear_attention(int dtype, int chunk, const void* q,
                                        const void* k, const void* v, const void* g,
                                        void* out, void* state, int BH, int S, int dk,
                                        int dv, void* stream) {
  const float* gf = static_cast<const float*>(g);
  float* sf = static_cast<float*>(state);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_chunk<__half>(chunk, q, k, v, gf, out, sf, BH, S, dk, dv, s);
  if (dtype == 1)
    return by_chunk<__nv_bfloat16>(chunk, q, k, v, gf, out, sf, BH, S, dk, dv, s);
  if (dtype == 2)
    return by_chunk<float>(chunk, q, k, v, gf, out, sf, BH, S, dk, dv, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cla_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
