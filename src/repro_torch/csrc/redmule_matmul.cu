// RedMulE GEMM for Hopper (sm_90a): Z[b] = act(X[b] . W[b] + bias).
//
// Replaces the Pallas TPU kernels `redmule_matmul_pallas`
// (src/repro/kernels/redmule_matmul.py:289, body `_pipelined_kernel`, store
// step `_store_value`) and `redmule_matmul_batched_pallas` (same file, :478,
// bodies `_kernel_batched` / `_kernel_batched_bias`).  One kernel family
// serves both: the 2D entry is the batched one with a batch of 1.
//
// What it computes.  The logical contraction is always Z[M, K] = sum_N
// X[M, N] W[N, K] (the paper's naming).  Every operand is addressed through
// element strides, so the storage layouts "nn" / "nt" / "tn" are index
// arithmetic only and no transpose is ever materialised.  The batch index
// b = blockIdx.z splits into (outer, inner) = (b / inner, b % inner) with a
// stride per level and per operand; a stride of 0 broadcasts the operand
// (the decode PV reads one V for every query head of a KV group).  The
// accumulator is fp32 in registers (WMMA bf16/fp16 -> fp32 on the tensor
// cores); bias and epilogue are applied in fp32 on the accumulator right
// before the single masked store: the store-once Z rule of the paper.
//
// What bounds it on an H100.  On the serving path every call is a
// small-M GEMM (decode M = 4 slots, prefill M = prompt length) against a
// large weight, so the kernel is bound by the bytes of W read from HBM
// (3.35 TB/s), not by the 989 TFLOP/s of the tensor cores.  The design
// therefore reads each W element once per M tile: a 16 x 128 tile is used
// when M <= 16 (one M tile for the whole decode batch), 64 x 64 otherwise;
// operand tiles are loaded with 16-byte vector loads along whichever axis
// is contiguous, with neighbouring threads on neighbouring addresses.
// Ragged M / N / K edges are masked in the kernel (zero-filled tiles and a
// masked store), so the host never pads: decode shapes such as M = 1,
// K = 2 would otherwise be dominated by padding.  Later work: TMA loads,
// a multi-stage shared-memory ring and wgmma.
//
// The fp32 route.  The reference runs its FP32 policy through the same
// Pallas GEMM in full fp32 (the mLSTM gate projection, the sLSTM
// recurrence, and every GEMM of the linear-attention composition that the
// backward recomputes).  Tensor cores would round fp32 operands to TF32
// (about three decimal digits), so fp32 operands take a second kernel,
// `redmule_gemm_f32_kernel`: SIMT fp32 FMAs on 16-deep shared-memory
// tiles, each of 256 threads holding a TM x TN block of the fp32
// accumulator in registers, with the same strides, batch levels, layouts,
// ragged-edge masking and fused bias + epilogue store as the bf16 / fp16
// kernel.  Its bound on an H100 is the 67 TFLOP/s of fp32 FMAs (or the
// bytes, for the skinny shapes).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kThreads = 128;   // four warps
constexpr int kBN = 32;         // reduction step (two 16-deep WMMA steps)

enum Epilogue { kNone = 0, kRelu = 1, kGelu = 2, kSilu = 3, kTanh = 4 };

__device__ __forceinline__ float apply_epilogue(float v, int epi) {
  switch (epi) {
    case kRelu:
      return v > 0.f ? v : 0.f;
    case kGelu: {  // tanh form: jax.nn.gelu's default (approximate=True)
      const float c = 0.7978845608028654f, a = 0.044715f;
      return 0.5f * v * (1.f + tanhf(c * (v + a * v * v * v)));
    }
    case kSilu:
      return v / (1.f + expf(-v));
    case kTanh:
      return tanhf(v);
    default:
      return v;
  }
}

template <typename O> __device__ __forceinline__ O from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Copy the R x C tile whose top-left logical element is (r0, c0) into shared
// memory (row-major, leading dimension LD), zero-filling outside
// [0, rows) x [0, cols).  `vec` promises 16-byte alignment of every
// 8-element run along the contiguous axis and a multiple-of-8 extent there.
template <typename T, int R, int C, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int r0, int c0,
                                          int rows, int cols, long long s_r,
                                          long long s_c, int vec, int tid) {
  const T zero = from_float<T>(0.f);
  if (s_c == 1) {  // columns contiguous: neighbouring threads walk columns
    if (vec) {
      constexpr int CV = C / 8;
#pragma unroll 4
      for (int e = tid; e < R * CV; e += kThreads) {
        const int r = e / CV, c = (e % CV) * 8;
        const int gr = r0 + r, gc = c0 + c;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (gr < rows && gc < cols)
          v = *reinterpret_cast<const uint4*>(src + (long long)gr * s_r + gc);
        *reinterpret_cast<uint4*>(dst + r * LD + c) = v;
      }
    } else {
#pragma unroll 4
      for (int e = tid; e < R * C; e += kThreads) {
        const int r = e / C, c = e % C;
        const int gr = r0 + r, gc = c0 + c;
        dst[r * LD + c] =
            (gr < rows && gc < cols) ? src[(long long)gr * s_r + gc] : zero;
      }
    }
  } else {  // a transposed layout: rows contiguous, threads walk rows
    if (vec && s_r == 1) {
      constexpr int RV = R / 8;
#pragma unroll 4
      for (int e = tid; e < RV * C; e += kThreads) {
        const int r = (e % RV) * 8, c = e / RV;
        const int gr = r0 + r, gc = c0 + c;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (gr < rows && gc < cols)
          v = *reinterpret_cast<const uint4*>(src + gr + (long long)gc * s_c);
        const T* vals = reinterpret_cast<const T*>(&v);
#pragma unroll
        for (int q = 0; q < 8; ++q) dst[(r + q) * LD + c] = vals[q];
      }
    } else {
#pragma unroll 4
      for (int e = tid; e < R * C; e += kThreads) {
        const int r = e % R, c = e / R;
        const int gr = r0 + r, gc = c0 + c;
        dst[r * LD + c] = (gr < rows && gc < cols)
                              ? src[(long long)gr * s_r + (long long)gc * s_c]
                              : zero;
      }
    }
  }
}

struct Operand {
  long long outer, inner, row, col;  // element strides
  int vec;                           // 16-byte loads allowed (see load_tile)
};

template <typename T, typename O, int BM, int BK, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(kThreads)
    redmule_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const float* __restrict__ bias, O* __restrict__ z,
                        int M, int N, int K, int inner, int batch0, Operand xo,
                        Operand wo, long long zs_outer, long long zs_inner,
                        int epi) {
  static_assert(WARPS_M * WARPS_N * 32 == kThreads, "four warps");
  constexpr int WM = BM / WARPS_M, WN = BK / WARPS_N;
  constexpr int FM = WM / 16, FN = WN / 16;
  constexpr int XLD = kBN + 8, WLD = BK + 8, CLD = BK + 4;
  __shared__ __align__(128) T xs[BM * XLD];
  __shared__ __align__(128) T ws[kBN * WLD];
  __shared__ __align__(128) float cs[BM * CLD];

  const int b = batch0 + blockIdx.z;
  const int bo = b / inner, bi = b % inner;
  x += bo * xo.outer + bi * xo.inner;
  w += bo * wo.outer + bi * wo.inner;
  z += bo * zs_outer + bi * zs_inner;
  const int m0 = blockIdx.y * BM, k0 = blockIdx.x * BK;
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int n0 = 0; n0 < N; n0 += kBN) {
    load_tile<T, BM, kBN, XLD>(xs, x, m0, n0, M, N, xo.row, xo.col, xo.vec, tid);
    load_tile<T, kBN, BK, WLD>(ws, w, n0, k0, N, K, wo.row, wo.col, wo.vec, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBN; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bf[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], xs + (wm * WM + i * 16) * XLD + kk, XLD);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bf[j], ws + kk * WLD + wn * WN + j * 16, WLD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

  // store once: accumulator -> shared -> bias + epilogue in fp32 -> one cast
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(cs + (wm * WM + i * 16) * CLD + wn * WN + j * 16,
                              acc[i][j], CLD, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BK; e += kThreads) {
    const int r = e / BK, c = e % BK;
    const int gm = m0 + r, gk = k0 + c;
    if (gm < M && gk < K) {
      float v = cs[r * CLD + c];
      if (bias != nullptr) v += bias[gk];
      z[(long long)gm * K + gk] = from_float<O>(apply_epilogue(v, epi));
    }
  }
}

// fp32 operands: SIMT FMAs (no TF32).  Logical Z[M, K] = X[M, N] W[N, K];
// the block owns a BM x BK output tile, thread (tr, tc) the rows
// tr * TM + i and the columns tc + (BK / TN) * j of it.
constexpr int kF32Threads = 256;
constexpr int kF32BN = 16;  // reduction step

template <typename O, int BM, int BK, int TM, int TN>
__global__ void __launch_bounds__(kF32Threads)
    redmule_gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                            const float* __restrict__ bias, O* __restrict__ z, int M,
                            int N, int K, int inner, int batch0, Operand xo,
                            Operand wo, long long zs_outer, long long zs_inner,
                            int epi) {
  constexpr int TX = BK / TN;  // threads along the output columns
  static_assert((BM / TM) * TX == kF32Threads, "256 threads");
  __shared__ float xs[kF32BN][BM + 4];  // [n][m]
  __shared__ float ws[kF32BN][BK + 4];  // [n][k]

  const int b = batch0 + blockIdx.z;
  const int bo = b / inner, bi = b % inner;
  x += bo * xo.outer + bi * xo.inner;
  w += bo * wo.outer + bi * wo.inner;
  z += bo * zs_outer + bi * zs_inner;
  const int m0 = blockIdx.y * BM, k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int tr = tid / TX, tc = tid % TX;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int n0 = 0; n0 < N; n0 += kF32BN) {
    // X tile (BM x 16): neighbouring threads on the contiguous axis
    for (int e = tid; e < BM * kF32BN; e += kF32Threads) {
      int r, c;
      if (xo.col == 1) { r = e / kF32BN; c = e % kF32BN; }
      else { r = e % BM; c = e / BM; }
      const int gm = m0 + r, gn = n0 + c;
      xs[c][r] = (gm < M && gn < N)
                     ? x[(long long)gm * xo.row + (long long)gn * xo.col] : 0.f;
    }
    // W tile (16 x BK)
    for (int e = tid; e < kF32BN * BK; e += kF32Threads) {
      int r, c;
      if (wo.col == 1) { r = e / BK; c = e % BK; }
      else { r = e % kF32BN; c = e / kF32BN; }
      const int gn = n0 + r, gk = k0 + c;
      ws[r][c] = (gn < N && gk < K)
                     ? w[(long long)gn * wo.row + (long long)gk * wo.col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int nn = 0; nn < kF32BN; ++nn) {
      float a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[nn][tr * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = ws[nn][tc + TX * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // store once: bias + epilogue on the fp32 accumulator, one cast
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + tr * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gk = k0 + tc + TX * j;
      if (gm < M && gk < K) {
        float v = acc[i][j];
        if (bias != nullptr) v += bias[gk];
        z[(long long)gm * K + gk] = from_float<O>(apply_epilogue(v, epi));
      }
    }
  }
}

template <typename O, int BM, int BK, int TM, int TN>
int launch_f32(const void* x, const void* w, const float* bias, void* z, int batch,
               int inner, int M, int N, int K, Operand xo, Operand wo, int epi,
               cudaStream_t stream) {
  const unsigned gx = (K + BK - 1) / BK, gy = (M + BM - 1) / BM;
  const long long zs_inner = (long long)M * K;
  const long long zs_outer = zs_inner * inner;
  for (int b0 = 0; b0 < batch; b0 += 65535) {
    const unsigned gz = (batch - b0) < 65535 ? (batch - b0) : 65535;
    redmule_gemm_f32_kernel<O, BM, BK, TM, TN>
        <<<dim3(gx, gy, gz), kF32Threads, 0, stream>>>(
            static_cast<const float*>(x), static_cast<const float*>(w), bias,
            static_cast<O*>(z), M, N, K, inner, b0, xo, wo, zs_outer, zs_inner, epi);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename O>
int by_tile_f32(int tile, const void* x, const void* w, const float* bias, void* z,
                int batch, int inner, int M, int N, int K, Operand xo, Operand wo,
                int epi, cudaStream_t s) {
  if (tile == 0)  // 64 x 64 output tile, 4 x 4 per thread
    return launch_f32<O, 64, 64, 4, 4>(x, w, bias, z, batch, inner, M, N, K, xo, wo, epi, s);
  if (tile == 1)  // 16 x 128 (small M), 1 x 8 per thread
    return launch_f32<O, 16, 128, 1, 8>(x, w, bias, z, batch, inner, M, N, K, xo, wo, epi, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename O, int BM, int BK, int WARPS_M, int WARPS_N>
int launch(const void* x, const void* w, const float* bias, void* z, int batch,
           int inner, int M, int N, int K, Operand xo, Operand wo, int epi,
           cudaStream_t stream) {
  const dim3 block(kThreads);
  const unsigned gx = (K + BK - 1) / BK, gy = (M + BM - 1) / BM;
  const long long zs_inner = (long long)M * K;
  const long long zs_outer = zs_inner * inner;
  for (int b0 = 0; b0 < batch; b0 += 65535) {  // grid.z is at most 65535
    const unsigned gz = (batch - b0) < 65535 ? (batch - b0) : 65535;
    redmule_gemm_kernel<T, O, BM, BK, WARPS_M, WARPS_N>
        <<<dim3(gx, gy, gz), block, 0, stream>>>(
            static_cast<const T*>(x), static_cast<const T*>(w), bias,
            static_cast<O*>(z), M, N, K, inner, b0, xo, wo, zs_outer, zs_inner,
            epi);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T, typename O>
int by_tile(int tile, const void* x, const void* w, const float* bias, void* z,
            int batch, int inner, int M, int N, int K, Operand xo, Operand wo,
            int epi, cudaStream_t s) {
  if (tile == 0)  // bm 64 x bk 64: warps 2 x 2, each 32 x 32
    return launch<T, O, 64, 64, 2, 2>(x, w, bias, z, batch, inner, M, N, K, xo, wo, epi, s);
  if (tile == 1)  // bm 16 x bk 128: warps 1 x 4, each 16 x 32 (small-M decode)
    return launch<T, O, 16, 128, 1, 4>(x, w, bias, z, batch, inner, M, N, K, xo, wo, epi, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int by_out(int out_dtype, int tile, const void* x, const void* w,
           const float* bias, void* z, int batch, int inner, int M, int N,
           int K, Operand xo, Operand wo, int epi, cudaStream_t s) {
  switch (out_dtype) {
    case 0: return by_tile<T, __half>(tile, x, w, bias, z, batch, inner, M, N, K, xo, wo, epi, s);
    case 1: return by_tile<T, __nv_bfloat16>(tile, x, w, bias, z, batch, inner, M, N, K, xo, wo, epi, s);
    case 2: return by_tile<T, float>(tile, x, w, bias, z, batch, inner, M, N, K, xo, wo, epi, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype / out_dtype: 0 = fp16, 1 = bf16, 2 = fp32 (fp32 operands take the
// SIMT route and store fp32).
// tile: 0 = (bm 64, bn 32, bk 64), 1 = (bm 16, bn 32, bk 128).
// Returns cudaGetLastError() of the launch (0 on success).
extern "C" int redmule_gemm(int dtype, int out_dtype, int tile, const void* x,
                            const void* w, const void* bias, void* z, int batch,
                            int inner, int M, int N, int K, long long xs_outer,
                            long long xs_inner, long long xs_m, long long xs_n,
                            int x_vec, long long ws_outer, long long ws_inner,
                            long long ws_n, long long ws_k, int w_vec, int epi,
                            void* stream) {
  const Operand xo{xs_outer, xs_inner, xs_m, xs_n, x_vec};
  const Operand wo{ws_outer, ws_inner, ws_n, ws_k, w_vec};
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_out<__half>(out_dtype, tile, x, w, b, z, batch, inner, M, N, K, xo, wo, epi, s);
  if (dtype == 1)
    return by_out<__nv_bfloat16>(out_dtype, tile, x, w, b, z, batch, inner, M, N, K, xo, wo, epi, s);
  if (dtype == 2) {  // the fp32 route: SIMT fp32 FMAs, fp32 out only
    if (out_dtype != 2) return (int)cudaErrorInvalidValue;
    return by_tile_f32<float>(tile, x, w, b, z, batch, inner, M, N, K, xo, wo, epi, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* redmule_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
