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
//
// The paper's fp16 accumulator (`paper_faithful`, the `paper_fp16` policy).
// The reference accumulates in an fp16 scratch: every `bn`-row block of the
// reduction is one dot rounded to fp16 and added into the fp16 sum.  Here the
// per-block partial stays in the fp32 WMMA fragments; a second set of fp32
// fragments holds the fp16-representable running sum, and at every
// `accum_block` boundary of the logical reduction (a runtime argument, a
// multiple of the 32-deep smem step) and at its end
// run = round16(run + round16(part)), part = 0.  Elementwise fragment
// arithmetic is layout-agnostic because both fragments have one shape.  The
// bias (an fp32 row holding fp16 values) is added to the rounded sum and
// rounded, the epilogue applied and rounded once more: the whole layer stays
// on the binary16 datapath.  Only the fp16 WMMA route takes this mode.
//
// The fused backward epilogue (both routes).  A backward dispatch may carry
// `deriv`, stored like its dZ operand (the x slot on "nt", the w slot on
// "tn") and read through its own strides.  As the dZ tile lands in shared
// memory it is multiplied by act'(deriv) in fp32 (rounded to fp16 under the
// faithful accumulator) and written back in the compute dtype, so
// ds = dZ * act' never exists in device memory.  `db` (the bias gradient,
// "tn" only) is summed from the same scaled tile: only the blocks of the
// first M-tile row (blockIdx.y == 0) sum the columns of each dZ tile that
// passes through them, per accumulator block like the GEMM, and each writes
// its `bk` slice of db once — no atomics, and the result does not depend on
// the grid.  The reference returns an (M/bm, K) array whose every row is the
// full sum; the port returns the (K,) row.
//
// FP8 storage, upcast on load (the mixed-precision policies; the reference's
// `xt.astype(compute_dtype)` after each tile's DMA, redmule_matmul.py:227-237,
// and `_load_compute`, :403-427).  The x and w operands have their own
// global element types TX / TW, each __half or an FP8 format (__nv_fp8_e4m3,
// __nv_fp8_e5m2); the shared-memory tiles stay fp16, so the WMMA fp16 ->
// fp32 path, the faithful fold and the fused backward run unchanged on the
// widened values.  One 16-byte load carries 16 FP8 elements and is widened
// with the paired cvt (two values per instruction) into two 16-byte
// shared-memory stores of 8 halves; unaligned or ragged operands take the
// scalar path.  Every FP8 value is an fp16 value, so the product is the
// one of the pre-widened operands: the bytes change, the values do not.
// Hopper's native FP8 MMA is not used: it accumulates with fewer bits than
// fp32, which is not the function the reference computes.  Only the pairs
// the two FP8 policies produce are compiled (`kFp8Pair`); any other returns
// an error.  The FP8 bytes move the bound of the weight-streaming decode
// GEMMs from 2 to 1 byte per weight element.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

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

// act'(d) in fp32: from the pre-activation, or (relu, tanh) from the output
__device__ __forceinline__ float epilogue_grad(float d, int epi, int from_output) {
  switch (epi) {
    case kRelu:
      return d > 0.f ? 1.f : 0.f;
    case kGelu: {
      const float c = 0.7978845608028654f, a = 0.044715f;
      const float t = tanhf(c * (d + a * d * d * d));
      const float du = c * (1.f + 3.f * a * d * d);
      return 0.5f * (1.f + t) + 0.5f * d * (1.f - t * t) * du;
    }
    case kSilu: {
      const float sig = 1.f / (1.f + expf(-d));
      return sig * (1.f + d * (1.f - sig));
    }
    case kTanh: {
      if (from_output) return 1.f - d * d;
      const float t = tanhf(d);
      return 1.f - t * t;
    }
    default:
      return 1.f;
  }
}

__device__ __forceinline__ float round16(float v) {
  return __half2float(__float2half_rn(v));
}

template <typename T> __device__ __forceinline__ float to_float(T v);
template <> __device__ __forceinline__ float to_float<__half>(__half v) {
  return __half2float(v);
}
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// FP8 storage: the interpretation of each format, and its widening to fp16
using E4 = __nv_fp8_e4m3;
using E5 = __nv_fp8_e5m2;
template <typename T>
constexpr bool kFp8 = std::is_same<T, E4>::value || std::is_same<T, E5>::value;
template <typename TS> struct Fp8Interp;
template <> struct Fp8Interp<E4> {
  static constexpr __nv_fp8_interpretation_t value = __NV_E4M3;
};
template <> struct Fp8Interp<E5> {
  static constexpr __nv_fp8_interpretation_t value = __NV_E5M2;
};

// one stored element in the tile's type T (exact: an FP8 value is an fp16)
template <typename T, typename TS>
__device__ __forceinline__ T widen(TS v) {
  if constexpr (std::is_same<T, TS>::value) {
    return v;
  } else {
    static_assert(kFp8<TS> && std::is_same<T, __half>::value, "FP8 -> fp16 only");
    return __half(__nv_cvt_fp8_to_halfraw(v.__x, Fp8Interp<TS>::value));
  }
}

// two FP8 values (the low byte first) -> two halves packed the same way
template <typename TS>
__device__ __forceinline__ unsigned int widen2(unsigned int pair) {
  const __half2_raw r = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(pair), Fp8Interp<TS>::value);
  return static_cast<unsigned int>(r.x) | (static_cast<unsigned int>(r.y) << 16);
}

// one 16-byte load of 16 FP8 values -> two 16-byte runs of 8 halves
template <typename TS>
__device__ __forceinline__ void widen16(const uint4 v, uint4& lo, uint4& hi) {
  lo = make_uint4(widen2<TS>(v.x & 0xffffu), widen2<TS>(v.x >> 16),
                  widen2<TS>(v.y & 0xffffu), widen2<TS>(v.y >> 16));
  hi = make_uint4(widen2<TS>(v.z & 0xffffu), widen2<TS>(v.z >> 16),
                  widen2<TS>(v.w & 0xffffu), widen2<TS>(v.w >> 16));
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
// memory (row-major, leading dimension LD, type T), zero-filling outside
// [0, rows) x [0, cols) and widening stored FP8 (TS) to T on the way.  `vec`
// promises 16-byte alignment of every 16-byte run along the contiguous axis
// (8 fp16 / bf16 elements, 16 FP8 ones) and a multiple of it as the extent
// there.
template <typename T, typename TS, int R, int C, int LD>
__device__ __forceinline__ void load_tile(T* dst, const TS* src, int r0, int c0,
                                          int rows, int cols, long long s_r,
                                          long long s_c, int vec, int tid) {
  const T zero = from_float<T>(0.f);
  constexpr bool narrow = !std::is_same<T, TS>::value;  // FP8 storage
  constexpr int RUN = 16 / sizeof(TS);                  // elements per 16 bytes
  if (s_c == 1) {  // columns contiguous: neighbouring threads walk columns
    if (vec) {
      constexpr int CV = C / RUN;
#pragma unroll 4
      for (int e = tid; e < R * CV; e += kThreads) {
        const int r = e / CV, c = (e % CV) * RUN;
        const int gr = r0 + r, gc = c0 + c;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (gr < rows && gc < cols)
          v = *reinterpret_cast<const uint4*>(src + (long long)gr * s_r + gc);
        if constexpr (narrow) {
          uint4 lo, hi;
          widen16<TS>(v, lo, hi);
          *reinterpret_cast<uint4*>(dst + r * LD + c) = lo;
          *reinterpret_cast<uint4*>(dst + r * LD + c + 8) = hi;
        } else {
          *reinterpret_cast<uint4*>(dst + r * LD + c) = v;
        }
      }
    } else {
#pragma unroll 4
      for (int e = tid; e < R * C; e += kThreads) {
        const int r = e / C, c = e % C;
        const int gr = r0 + r, gc = c0 + c;
        dst[r * LD + c] = (gr < rows && gc < cols)
                              ? widen<T>(src[(long long)gr * s_r + gc]) : zero;
      }
    }
  } else {  // a transposed layout: rows contiguous, threads walk rows
    if (vec && s_r == 1) {
      constexpr int RV = R / RUN;
#pragma unroll 4
      for (int e = tid; e < RV * C; e += kThreads) {
        const int r = (e % RV) * RUN, c = e / RV;
        const int gr = r0 + r, gc = c0 + c;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (gr < rows && gc < cols)
          v = *reinterpret_cast<const uint4*>(src + gr + (long long)gc * s_c);
        if constexpr (narrow) {
          uint4 lo, hi;
          widen16<TS>(v, lo, hi);
          const T* vl = reinterpret_cast<const T*>(&lo);
          const T* vh = reinterpret_cast<const T*>(&hi);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            dst[(r + q) * LD + c] = vl[q];
            dst[(r + 8 + q) * LD + c] = vh[q];
          }
        } else {
          const T* vals = reinterpret_cast<const T*>(&v);
#pragma unroll
          for (int q = 0; q < 8; ++q) dst[(r + q) * LD + c] = vals[q];
        }
      }
    } else {
#pragma unroll 4
      for (int e = tid; e < R * C; e += kThreads) {
        const int r = e % R, c = e / R;
        const int gr = r0 + r, gc = c0 + c;
        dst[r * LD + c] =
            (gr < rows && gc < cols)
                ? widen<T>(src[(long long)gr * s_r + (long long)gc * s_c])
                : zero;
      }
    }
  }
}

struct Operand {
  long long outer, inner, row, col;  // element strides
  int vec;                           // 16-byte loads allowed (see load_tile)
};

// The faithful accumulator and the fused backward epilogue (2D only).
struct Ext {
  const void* deriv;        // compute dtype, stored like the dZ operand
  long long d_row, d_col;   // its element strides along the dZ operand's rows / cols
  int slot;                 // which operand is dZ: 0 none, 1 x ("nt"), 2 w ("tn")
  int grad_epi;             // Epilogue whose derivative scales dZ (0: none)
  int from_output;          // deriv holds act(s) instead of s
  float* db;                // (K,) bias gradient, slot 2 only (nullptr: none)
  int accum_block;          // > 0: faithful fp16 accumulator, re-rounded per block
};

// In place on the R x C dZ tile in shared memory (top-left logical element
// (r0, c0)): ds = dZ * act'(deriv) in fp32, rounded to fp16 under the
// faithful accumulator, written back in the compute dtype when there is a
// derivative, and copied to `dss` (fp32, leading dimension DLD) for the
// bias-gradient column sums when `dss` is given.  Cells outside
// [0, rows) x [0, cols) hold zeros and stay zero.
template <typename T, int R, int C, int LD, int DLD, int NT>
__device__ __forceinline__ void scale_dz_tile(T* tile, const Ext& ext, int r0,
                                              int c0, int rows, int cols,
                                              float* dss, int tid) {
  const T* d = static_cast<const T*>(ext.deriv);
  const bool faithful = ext.accum_block > 0;
  for (int e = tid; e < R * C; e += NT) {
    int r, c;
    if (ext.d_col == 1 || ext.grad_epi == 0) { r = e / C; c = e % C; }
    else { r = e % R; c = e / R; }
    const int gr = r0 + r, gc = c0 + c;
    float v = to_float<T>(tile[r * LD + c]);
    if (gr < rows && gc < cols) {
      if (ext.grad_epi != 0)
        v *= epilogue_grad(
            to_float<T>(d[(long long)gr * ext.d_row + (long long)gc * ext.d_col]),
            ext.grad_epi, ext.from_output);
      if (faithful) v = round16(v);
    }
    if (ext.grad_epi != 0) tile[r * LD + c] = from_float<T>(v);
    if (dss != nullptr) dss[r * DLD + c] = v;
  }
}

// T: the shared-memory tile and WMMA type (fp16 / bf16); TX / TW: the
// operands' global element types (T, or FP8 widened to T on load)
template <typename T, typename TX, typename TW, typename O, int BM, int BK,
          int WARPS_M, int WARPS_N, bool kExt>
__global__ void __launch_bounds__(kThreads)
    redmule_gemm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                        const float* __restrict__ bias, O* __restrict__ z,
                        int M, int N, int K, int inner, int batch0, Operand xo,
                        Operand wo, long long zs_outer, long long zs_inner,
                        int epi, Ext ext) {
  static_assert(WARPS_M * WARPS_N * 32 == kThreads, "four warps");
  constexpr int WM = BM / WARPS_M, WN = BK / WARPS_N;
  constexpr int FM = WM / 16, FN = WN / 16;
  constexpr int XLD = kBN + 8, WLD = BK + 8, CLD = BK + 4, DLD = BK + 1;
  static_assert(BK <= kThreads, "one thread per db column");
  __shared__ __align__(128) T xs[BM * XLD];
  __shared__ __align__(128) T ws[kBN * WLD];
  __shared__ __align__(128) float cs[BM * CLD];
  __shared__ float dss[kExt ? kBN * DLD : 1];  // the scaled dZ tile, for db

  const int b = batch0 + blockIdx.z;
  const int bo = b / inner, bi = b % inner;
  x += bo * xo.outer + bi * xo.inner;
  w += bo * wo.outer + bi * wo.inner;
  z += bo * zs_outer + bi * zs_inner;
  const int m0 = blockIdx.y * BM, k0 = blockIdx.x * BK;
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
  // the faithful running sum (fp16-representable values in fp32 fragments)
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> run[kExt ? FM : 1][kExt ? FN : 1];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const bool faithful = kExt && ext.accum_block > 0;
  // db: the first M-tile row sums its columns of every dZ tile
  const bool do_db = kExt && ext.db != nullptr && ext.slot == 2 && blockIdx.y == 0;
  float db_part = 0.f, db_run = 0.f;
  if constexpr (kExt) {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(run[i][j], 0.f);
  }

  for (int n0 = 0; n0 < N; n0 += kBN) {
    load_tile<T, TX, BM, kBN, XLD>(xs, x, m0, n0, M, N, xo.row, xo.col, xo.vec, tid);
    load_tile<T, TW, kBN, BK, WLD>(ws, w, n0, k0, N, K, wo.row, wo.col, wo.vec, tid);
    __syncthreads();
    if constexpr (kExt) {
      if (ext.slot == 1 && ext.grad_epi != 0) {
        scale_dz_tile<T, BM, kBN, XLD, DLD, kThreads>(xs, ext, m0, n0, M, N,
                                                      nullptr, tid);
        __syncthreads();
      } else if (ext.slot == 2 && (ext.grad_epi != 0 || do_db)) {
        scale_dz_tile<T, kBN, BK, WLD, DLD, kThreads>(
            ws, ext, n0, k0, N, K, do_db ? dss : nullptr, tid);
        __syncthreads();
        if (do_db && tid < BK) {
          float s = 0.f;
#pragma unroll 8
          for (int r = 0; r < kBN; ++r) s += dss[r * DLD + tid];
          db_part += s;
        }
      }
    }
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
    if constexpr (kExt) {
      // the end of a reference reduction block (or of the reduction):
      // round the block's partial and fold it into the fp16 running sums
      if (faithful && ((n0 + kBN) % ext.accum_block == 0 || n0 + kBN >= N)) {
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j)
#pragma unroll
            for (int t = 0; t < acc[i][j].num_elements; ++t) {
              run[i][j].x[t] = round16(run[i][j].x[t] + round16(acc[i][j].x[t]));
              acc[i][j].x[t] = 0.f;
            }
        db_run = round16(db_run + round16(db_part));
        db_part = 0.f;
      }
    }
    __syncthreads();
  }

  // store once: accumulator -> shared -> bias + epilogue -> one cast
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      float* dst = cs + (wm * WM + i * 16) * CLD + wn * WN + j * 16;
      if constexpr (kExt) {
        if (faithful) {
          wmma::store_matrix_sync(dst, run[i][j], CLD, wmma::mem_row_major);
          continue;
        }
      }
      wmma::store_matrix_sync(dst, acc[i][j], CLD, wmma::mem_row_major);
    }
  __syncthreads();
  for (int e = tid; e < BM * BK; e += kThreads) {
    const int r = e / BK, c = e % BK;
    const int gm = m0 + r, gk = k0 + c;
    if (gm < M && gk < K) {
      float v = cs[r * CLD + c];
      if (bias != nullptr) {
        v += bias[gk];
        if (faithful) v = round16(v);  // the fp16 bias add
      }
      z[(long long)gm * K + gk] = from_float<O>(apply_epilogue(v, epi));
    }
  }
  if (do_db && tid < BK && k0 + tid < K)
    ext.db[k0 + tid] = faithful ? db_run : db_part;
}

// fp32 operands: SIMT FMAs (no TF32).  Logical Z[M, K] = X[M, N] W[N, K];
// the block owns a BM x BK output tile, thread (tr, tc) the rows
// tr * TM + i and the columns tc + (BK / TN) * j of it.
constexpr int kF32Threads = 256;
constexpr int kF32BN = 16;  // reduction step

template <typename O, int BM, int BK, int TM, int TN, bool kExt>
__global__ void __launch_bounds__(kF32Threads)
    redmule_gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                            const float* __restrict__ bias, O* __restrict__ z, int M,
                            int N, int K, int inner, int batch0, Operand xo,
                            Operand wo, long long zs_outer, long long zs_inner,
                            int epi, Ext ext) {
  constexpr int TX = BK / TN;  // threads along the output columns
  static_assert((BM / TM) * TX == kF32Threads, "256 threads");
  static_assert(BK <= kF32Threads, "one thread per db column");
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
  float db_part = 0.f;

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
    if constexpr (kExt) {
      // the fused backward epilogue: ds = dZ * act'(deriv) on the dZ tile,
      // then (first M-tile row, "tn") the bias gradient's column sums
      const float* d = static_cast<const float*>(ext.deriv);
      if (ext.slot == 1 && ext.grad_epi != 0) {
        for (int e = tid; e < BM * kF32BN; e += kF32Threads) {
          const int r = e / kF32BN, c = e % kF32BN;   // (m, n)
          const int gm = m0 + r, gn = n0 + c;
          if (gm < M && gn < N)
            xs[c][r] *= epilogue_grad(
                d[(long long)gm * ext.d_row + (long long)gn * ext.d_col],
                ext.grad_epi, ext.from_output);
        }
        __syncthreads();
      } else if (ext.slot == 2) {
        if (ext.grad_epi != 0) {
          for (int e = tid; e < kF32BN * BK; e += kF32Threads) {
            const int r = e / BK, c = e % BK;        // (n, k)
            const int gn = n0 + r, gk = k0 + c;
            if (gn < N && gk < K)
              ws[r][c] *= epilogue_grad(
                  d[(long long)gn * ext.d_row + (long long)gk * ext.d_col],
                  ext.grad_epi, ext.from_output);
          }
          __syncthreads();
        }
        if (ext.db != nullptr && blockIdx.y == 0 && tid < BK) {
#pragma unroll
          for (int r = 0; r < kF32BN; ++r) db_part += ws[r][tid];
        }
      }
    }
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
  if (kExt && ext.slot == 2 && ext.db != nullptr && blockIdx.y == 0 && tid < BK &&
      k0 + tid < K)
    ext.db[k0 + tid] = db_part;
}

// One launch (or one per 65535 batch elements: grid.z is at most 65535).
struct Problem {
  const void* x;
  const void* w;
  const float* bias;
  void* z;
  int batch, inner, M, N, K;
  Operand xo, wo;
  int epi;
  Ext ext;
};

template <typename O, int BM, int BK, int TM, int TN, bool kExt>
int launch_f32(const Problem& p, cudaStream_t stream) {
  // gy >= 1: a dW over M == 0 rows still launches its db row of blocks
  const unsigned gx = (p.K + BK - 1) / BK, gy = p.M > 0 ? (p.M + BM - 1) / BM : 1;
  const long long zs_inner = (long long)p.M * p.K;
  const long long zs_outer = zs_inner * p.inner;
  for (int b0 = 0; b0 < p.batch; b0 += 65535) {
    const unsigned gz = (p.batch - b0) < 65535 ? (p.batch - b0) : 65535;
    redmule_gemm_f32_kernel<O, BM, BK, TM, TN, kExt>
        <<<dim3(gx, gy, gz), kF32Threads, 0, stream>>>(
            static_cast<const float*>(p.x), static_cast<const float*>(p.w), p.bias,
            static_cast<O*>(p.z), p.M, p.N, p.K, p.inner, b0, p.xo, p.wo,
            zs_outer, zs_inner, p.epi, p.ext);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <int BM, int BK, int TM, int TN>
int ext_f32(const Problem& p, bool ext, cudaStream_t s) {
  return ext ? launch_f32<float, BM, BK, TM, TN, true>(p, s)
             : launch_f32<float, BM, BK, TM, TN, false>(p, s);
}

int by_tile_f32(int tile, const Problem& p, bool ext, cudaStream_t s) {
  if (tile == 0)  // 64 x 64 output tile, 4 x 4 per thread
    return ext_f32<64, 64, 4, 4>(p, ext, s);
  if (tile == 1)  // 16 x 128 (small M), 1 x 8 per thread
    return ext_f32<16, 128, 1, 8>(p, ext, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename TX, typename TW, typename O, int BM, int BK,
          int WARPS_M, int WARPS_N, bool kExt>
int launch(const Problem& p, cudaStream_t stream) {
  const dim3 block(kThreads);
  // gy >= 1: a dW over M == 0 rows still launches its db row of blocks
  const unsigned gx = (p.K + BK - 1) / BK, gy = p.M > 0 ? (p.M + BM - 1) / BM : 1;
  const long long zs_inner = (long long)p.M * p.K;
  const long long zs_outer = zs_inner * p.inner;
  for (int b0 = 0; b0 < p.batch; b0 += 65535) {  // grid.z is at most 65535
    const unsigned gz = (p.batch - b0) < 65535 ? (p.batch - b0) : 65535;
    redmule_gemm_kernel<T, TX, TW, O, BM, BK, WARPS_M, WARPS_N, kExt>
        <<<dim3(gx, gy, gz), block, 0, stream>>>(
            static_cast<const TX*>(p.x), static_cast<const TW*>(p.w), p.bias,
            static_cast<O*>(p.z), p.M, p.N, p.K, p.inner, b0, p.xo, p.wo,
            zs_outer, zs_inner, p.epi, p.ext);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The faithful / fused-backward variant exists for the (operand, output)
// pairs a policy gives it: fp16 -> fp16 (paper_fp16, forward and its "+grad"
// backward) and fp16 / bf16 -> fp32 (the fp32-accumulating policies' "+grad"
// backward, whose output is the accumulator dtype).
template <typename T, typename O>
constexpr bool kExtPair =
    std::is_same<O, float>::value ||
    (std::is_same<T, __half>::value && std::is_same<O, __half>::value);

// The FP8 (x, w, output, ext) combinations the two FP8 policies produce
// (declared on the Python side as FP8_KERNELS; chip_smoke.py launches each
// and checks that another fails): mixed_fp8_e4m3 runs every GEMM on the
// faithful fp16 accumulator — E4M3 x E4M3 forward (fp16 out) and decode
// scores (fp32 out), E5M2 dZ x E4M3 W (dX) and E4M3 X x E5M2 dZ (dW), the
// latter two also with the fused backward; mixed_fp8_e5m2 accumulates in
// fp32, E5M2 x E5M2 with an fp16 (forward) or fp32 ("+grad") output.
template <typename TX, typename TW, typename O, bool kExt>
constexpr bool kFp8Pair =
    (std::is_same<TX, E4>::value && std::is_same<TW, E4>::value && kExt &&
     (std::is_same<O, __half>::value || std::is_same<O, float>::value)) ||
    (((std::is_same<TX, E5>::value && std::is_same<TW, E4>::value) ||
      (std::is_same<TX, E4>::value && std::is_same<TW, E5>::value)) &&
     kExt && std::is_same<O, __half>::value) ||
    (std::is_same<TX, E5>::value && std::is_same<TW, E5>::value && !kExt &&
     (std::is_same<O, __half>::value || std::is_same<O, float>::value));

template <typename TX, typename TW, typename O, bool kExt>
constexpr bool kCompiled =
    (kFp8<TX> || kFp8<TW>) ? kFp8Pair<TX, TW, O, kExt>
                           : (!kExt || kExtPair<TX, O>);

template <typename T, typename TX, typename TW, typename O, int BM, int BK,
          int WARPS_M, int WARPS_N>
int ext_or_plain(const Problem& p, bool ext, cudaStream_t s) {
  if (ext) {
    if constexpr (kCompiled<TX, TW, O, true>)
      return launch<T, TX, TW, O, BM, BK, WARPS_M, WARPS_N, true>(p, s);
  } else {
    if constexpr (kCompiled<TX, TW, O, false>)
      return launch<T, TX, TW, O, BM, BK, WARPS_M, WARPS_N, false>(p, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename TX, typename TW, typename O>
int by_tile(int tile, const Problem& p, bool ext, cudaStream_t s) {
  if (tile == 0)  // bm 64 x bk 64: warps 2 x 2, each 32 x 32
    return ext_or_plain<T, TX, TW, O, 64, 64, 2, 2>(p, ext, s);
  if (tile == 1)  // bm 16 x bk 128: warps 1 x 4, each 16 x 32 (small-M decode)
    return ext_or_plain<T, TX, TW, O, 16, 128, 1, 4>(p, ext, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename TX = T, typename TW = T>
int by_out(int out_dtype, int tile, const Problem& p, bool ext, cudaStream_t s) {
  switch (out_dtype) {
    case 0: return by_tile<T, TX, TW, __half>(tile, p, ext, s);
    case 1: return by_tile<T, TX, TW, __nv_bfloat16>(tile, p, ext, s);
    case 2: return by_tile<T, TX, TW, float>(tile, p, ext, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// FP8 storage in both slots, widened to fp16 tiles
template <typename TX>
int fp8_by_w(int w_dtype, int out_dtype, int tile, const Problem& p, bool ext,
             cudaStream_t s) {
  if (w_dtype == 3) return by_out<__half, TX, E4>(out_dtype, tile, p, ext, s);
  if (w_dtype == 4) return by_out<__half, TX, E5>(out_dtype, tile, p, ext, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x_dtype / w_dtype / out_dtype: 0 = fp16, 1 = bf16, 2 = fp32, 3 = fp8 e4m3,
// 4 = fp8 e5m2.  x and w are the same dtype (fp32 operands take the SIMT
// route and store fp32) or both FP8 (widened to fp16 on load; the compiled
// pairs are `kFp8Pair`'s).
// tile: 0 = (bm 64, bn 32, bk 64), 1 = (bm 16, bn 32, bk 128).
// accum_block > 0: the faithful fp16 accumulator, re-rounded every
// accum_block reduction rows (a multiple of 32; fp16 tiles).
// deriv / d_row / d_col / slot / grad_epi / grad_from_output / db: the fused
// backward epilogue (see the header; nulls and zeros when unused, batch 1).
// Returns cudaGetLastError() of the launch (0 on success).
extern "C" int redmule_gemm(int x_dtype, int w_dtype, int out_dtype, int tile,
                            const void* x, const void* w, const void* bias,
                            void* z, int batch, int inner, int M, int N, int K,
                            long long xs_outer, long long xs_inner,
                            long long xs_m, long long xs_n, int x_vec,
                            long long ws_outer, long long ws_inner,
                            long long ws_n, long long ws_k, int w_vec, int epi,
                            int accum_block, const void* deriv, long long d_row,
                            long long d_col, int slot, int grad_epi,
                            int grad_from_output, void* db, void* stream) {
  const Ext ext{deriv, d_row, d_col, slot, grad_epi, grad_from_output,
                static_cast<float*>(db), accum_block};
  const Problem p{x, w, static_cast<const float*>(bias), z, batch, inner, M, N, K,
                  Operand{xs_outer, xs_inner, xs_m, xs_n, x_vec},
                  Operand{ws_outer, ws_inner, ws_n, ws_k, w_vec}, epi, ext};
  const bool use_ext = accum_block > 0 || slot != 0;
  if (accum_block < 0 || accum_block % kBN != 0 || (slot != 0 && batch != 1) ||
      (grad_epi != 0 && (deriv == nullptr || slot == 0)) ||
      (db != nullptr && slot != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype >= 3 && w_dtype >= 3) {  // FP8 storage, fp16 tiles
    if (x_dtype == 3) return fp8_by_w<E4>(w_dtype, out_dtype, tile, p, use_ext, s);
    if (x_dtype == 4) return fp8_by_w<E5>(w_dtype, out_dtype, tile, p, use_ext, s);
    return (int)cudaErrorInvalidValue;
  }
  if (x_dtype != w_dtype) return (int)cudaErrorInvalidValue;
  if (x_dtype == 0)
    return by_out<__half>(out_dtype, tile, p, use_ext, s);
  if (accum_block > 0) return (int)cudaErrorInvalidValue;  // fp16 tiles only
  if (x_dtype == 1)
    return by_out<__nv_bfloat16>(out_dtype, tile, p, use_ext, s);
  if (x_dtype == 2) {  // the fp32 route: SIMT fp32 FMAs, fp32 out only
    if (out_dtype != 2) return (int)cudaErrorInvalidValue;
    return by_tile_f32(tile, p, use_ext, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* redmule_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
