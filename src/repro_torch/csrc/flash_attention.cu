// Causal GQA flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py:102, body `_kernel` :31).
//
// What it computes.  q (BHq, S, D), k / v (BHkv, T, D), KV head = q head /
// group.  Online softmax in fp32 with running max m and sum l; masked
// scores are -1e30; a KV column is visible when col < t_valid and, if
// causal, col <= q_offset + row; KV tiles that are causally dead or lie
// wholly past t_valid are skipped; a row with no visible column (l == 0)
// stores exact zeros; the output is stored once, in q's dtype.
//
// What bounds it on an H100.  At the serving path's prefill shapes (one
// prompt of a few hundred tokens, 16 q heads, D = 128) the sweep does a few
// hundred MFLOP over about a megabyte, so neither HBM nor the tensor cores
// bound it: the time goes to latency and to how few blocks there are
// (one per (q head, 64-row q tile)).  The design keeps the simple,
// exact-fp32 form of the reference: one block of four warps per
// (q tile, q head); the q tile (64 x D) and one KV tile (32 x D) at a time
// live in shared memory; scores, the softmax state and the output
// accumulator are fp32 (fp32 FMAs, the same arithmetic as the reference's
// fp32 dot), so the kernel agrees with its plain version to rounding
// order.  Later work: tensor-core (mma / wgmma) score and PV products,
// a KV ring fed by TMA, and splitting long KV sweeps across blocks.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;    // q rows per block
constexpr int kBKV = 32;   // KV rows per step
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// rows x D tile starting at row r0 of a (n_rows, D) matrix, zero past n_rows;
// 16-byte loads (D is a multiple of 8 and rows are 16-byte aligned).
template <typename T, int ROWS, int D, int LD>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int r0,
                                          int n_rows, int tid) {
  constexpr int DV = D / 8;
  for (int e = tid; e < ROWS * DV; e += kThreads) {
    const int r = e / DV, c = (e % DV) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n_rows)
      v = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * D + c);
    const T* vals = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int q = 0; q < 8; ++q) dst[r * LD + c + q] = vals[q];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int S, int T_len,
                     int group, float scale, int t_valid, int q_offset,
                     int causal) {
  constexpr int QLD = D + 2;   // odd word stride: rows fall in distinct banks
  constexpr int DH = D / 2;    // output columns per thread
  __shared__ T qs[kBQ * QLD];
  __shared__ T ks[kBKV * D];
  __shared__ T vs[kBKV * D];
  __shared__ float ss[kBQ][kBKV + 1];
  __shared__ float alpha_s[kBQ];
  __shared__ float m_s[kBQ];
  __shared__ float l_s[kBQ];

  const int tid = threadIdx.x;
  const int head = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const T* qh = q + (long long)head * S * D;
  const T* kh = k + (long long)(head / group) * T_len * D;
  const T* vh = v + (long long)(head / group) * T_len * D;

  load_rows<T, kBQ, D, QLD>(qs, qh, q0, S, tid);
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  const int r = tid % kBQ;        // this thread's q row (scores and output)
  const int half = tid / kBQ;     // which half of the KV columns / of D
  float acc[DH];
#pragma unroll
  for (int j = 0; j < DH; ++j) acc[j] = 0.f;

  // visible columns end before min(t_valid, causal edge of the last row)
  int kv_end = t_valid < T_len ? t_valid : T_len;
  if (causal) {
    const int edge = q_offset + q0 + kBQ;  // first column dead for every row
    kv_end = kv_end < edge ? kv_end : edge;
  }
  for (int kv0 = 0; kv0 < kv_end; kv0 += kBKV) {
    __syncthreads();  // the previous step is done with ks / vs / ss
    load_rows<T, kBKV, D, D>(ks, kh, kv0, T_len, tid);
    load_rows<T, kBKV, D, D>(vs, vh, kv0, T_len, tid);
    __syncthreads();

    // scores: row r, columns [half * 16, half * 16 + 16)
    {
      float s[kBKV / 2];
#pragma unroll
      for (int c = 0; c < kBKV / 2; ++c) s[c] = 0.f;
      const T* qrow = qs + r * QLD;
      for (int d = 0; d < D; ++d) {
        const float qv = to_float(qrow[d]);
#pragma unroll
        for (int c = 0; c < kBKV / 2; ++c)
          s[c] += qv * to_float(ks[(half * (kBKV / 2) + c) * D + d]);
      }
#pragma unroll
      for (int c = 0; c < kBKV / 2; ++c) ss[r][half * (kBKV / 2) + c] = s[c];
    }
    __syncthreads();

    // online softmax, one thread per row
    if (tid < kBQ) {
      const int row = q_offset + q0 + tid;
      float sv[kBKV];
      unsigned vis = 0u;
      float m_cur = kNegInf;
#pragma unroll
      for (int c = 0; c < kBKV; ++c) {
        const int col = kv0 + c;
        const bool on = col < t_valid && col < T_len && (!causal || col <= row);
        vis |= (on ? 1u : 0u) << c;
        sv[c] = on ? ss[tid][c] * scale : kNegInf;
        m_cur = fmaxf(m_cur, sv[c]);
      }
      const float m_prev = m_s[tid];
      const float m_new = fmaxf(m_prev, m_cur);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < kBKV; ++c) {
        // a masked column contributes exactly 0, also in a row whose every
        // column so far is masked (there m_new == -1e30 and exp(0) == 1)
        const float p = (vis >> c) & 1u ? expf(sv[c] - m_new) : 0.f;
        ss[tid][c] = p;
        psum += p;
      }
      const float alpha = expf(m_prev - m_new);
      alpha_s[tid] = alpha;
      l_s[tid] = l_s[tid] * alpha + psum;
      m_s[tid] = m_new;
    }
    __syncthreads();

    // acc[r, half * DH + j] = acc * alpha + sum_c p[r, c] v[c, half * DH + j]
    {
      const float alpha = alpha_s[r];
#pragma unroll
      for (int j = 0; j < DH; ++j) acc[j] *= alpha;
      for (int c = 0; c < kBKV; ++c) {
        const float p = ss[r][c];
        const T* vrow = vs + c * D + half * DH;
#pragma unroll
        for (int j = 0; j < DH; ++j) acc[j] += p * to_float(vrow[j]);
      }
    }
  }
  __syncthreads();

  if (q0 + r < S) {
    const float l = l_s[r];
    const float inv = l == 0.f ? 1.f : 1.f / l;
    T* orow = o + ((long long)head * S + q0 + r) * D + half * DH;
#pragma unroll
    for (int j = 0; j < DH; ++j) orow[j] = from_float<T>(acc[j] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int BHq, int S,
           int T_len, int group, float scale, int t_valid, int q_offset,
           int causal, cudaStream_t stream) {
  const dim3 grid((S + kBQ - 1) / kBQ, BHq);
  flash_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, T_len, group, scale,
      t_valid, q_offset, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp16, 1 = bf16; D in {64, 128}.  q (BHq, S, D), k / v
// (BHq / group, T, D), o (BHq, S, D), all contiguous.  Returns
// cudaGetLastError() of the launch (0 on success).
extern "C" int flash_attention_fwd(int dtype, int D, const void* q, const void* k,
                                   const void* v, void* o, int BHq, int S, int T,
                                   int group, float scale, int t_valid,
                                   int q_offset, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<__half, 64>(q, k, v, o, BHq, S, T, group, scale, t_valid, q_offset, causal, s);
  if (dtype == 0 && D == 128)
    return launch<__half, 128>(q, k, v, o, BHq, S, T, group, scale, t_valid, q_offset, causal, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, BHq, S, T, group, scale, t_valid, q_offset, causal, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, BHq, S, T, group, scale, t_valid, q_offset, causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
