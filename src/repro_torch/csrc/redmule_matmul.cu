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
// small-M GEMM against a large weight: decode M = 4 slots (4-128 operations
// per byte of W), prefill M = 128.  Both sit far below the ~295 operations
// per byte at which bf16 tensor cores, not HBM (3.35 TB/s), would be the
// limit, so the kernel is bound by the bytes of W.  Each W element is read
// once per M tile: a 16 x 128 tile when M <= 16 (one M tile for the whole
// decode batch), 64 x 64 otherwise.  Two things kept it far from that bound.
// First, too few blocks: qwen3-1.7b's decode projections give 16-96 output
// tiles for 132 SMs.  Second, a synchronous load -> sync -> MMA -> sync
// loop with nothing in flight while the MMAs ran.  The design does two
// things about them.
//
// * An in-kernel split of the reduction.  The host's plan
//   (core/tiling.py::split_plan, from the shapes alone) cuts the reduction
//   into S slices, each a multiple of the 32-deep step, so that about two
//   waves of blocks run (grid.z = batch x S).  Each block writes its fp32
//   partial to a workspace (S x batch x M x K), fences, and counts itself
//   on its output tile's counter.  The last block of a tile to arrive sums
//   the S partials in split order, so the result does not depend on which
//   block came last and is the same run to run.  It then runs the
//   store-once epilogue: bias, epilogue, one cast, Z written once.  It also
//   resets the counter, so the counters stay zero between launches with
//   no memset.  Under the faithful accumulator no slice straddles a
//   rounding block.  The last block takes each block's fp32 sum of its
//   slices, in order, and folds it as run = round16(run + round16(part)).
//   A launch with deriv or db is never split.
// * An asynchronous copy ring.  X and W slabs of 64 reduction rows (two
//   32-deep steps) stream through kStages = 3 shared-memory stages by
//   16-byte `cp.async.cg`, in the operand's stored orientation: two slabs
//   are in flight while the MMAs read the third.  A run past a ragged edge
//   or past the block's slice is a shared-memory store of zeros.  A slab
//   stored in the tile's type is read by the MMAs in place, row- or
//   column-major as it lies (the tied head's "nt" weight needs no
//   transpose).  An FP8 slab lands as bytes and is widened into the fp16
//   compute tile by the threads after arrival, in the same orientation.
//   An operand that takes no 16-byte copies (unaligned, or a ragged
//   contiguous extent) is loaded synchronously element by element, as
//   before.  64-row slabs give a transposed operand 128-byte runs (bf16)
//   per row; with 32-row slabs (64-byte runs) the "nt" tied head read its
//   weight markedly slower than the same weight stored "nn".
//
// Ragged M / N / K edges are masked in the kernel (zero-filled tiles and a
// masked store), so the host never pads: decode shapes such as M = 1,
// K = 2 would otherwise be dominated by padding.  The MMA stays WMMA: bytes
// bound these shapes, and wgmma would not move them (later work, for
// training shapes).
//
// The fp32 route.  The reference runs its FP32 policy through the same
// Pallas GEMM in full fp32 (the mLSTM gate projection, the sLSTM
// recurrence, and every GEMM of the linear-attention composition that the
// backward recomputes).  Tensor cores would round fp32 operands to TF32
// (about three decimal digits), so fp32 operands take a second kernel,
// `redmule_gemm_f32_kernel`: SIMT fp32 FMAs.  Its bound on an H100 is
// the 67 TFLOP/s of fp32 FMAs, or, for the skinny shapes, the bytes.  The
// skinny shapes are the mLSTM gates (K = 8) and the sLSTM recurrence
// (M = 4); they used to launch 16-64 blocks.  The kernel takes the same
// split of the reduction (16-deep steps) and a 4-stage `cp.async` ring of
// 16-deep slabs.  Slabs are stored [n][m] and [n][k].  An operand whose
// stored axis is that contiguous one takes 16-byte copies; the other
// orientation takes coalesced 4-byte copies, transposed on their way into
// shared memory.  Each of 128 threads holds a TM x TN (8 x 4 or 4 x 4)
// block of the accumulator (it was 4 x 4 or 1 x 8 of 256).  It reads its
// operands as float4s along m and k, without bank conflicts, and a warp
// whose outputs lie wholly past M or K skips its FMAs.  It has the same
// strides, batch levels, layouts, ragged-edge masking and fused
// bias + epilogue store as the bf16 / fp16 kernel.
//
// The paper's fp16 accumulator (`paper_faithful`, the `paper_fp16` policy).
// The reference accumulates in an fp16 scratch: every `bn`-row block of the
// reduction is one dot rounded to fp16 and added into the fp16 sum.  Here the
// per-block partial stays in the fp32 WMMA fragments; a second set of fp32
// fragments holds the fp16-representable running sum, and at every
// `accum_block` boundary of the logical reduction (a runtime argument, a
// multiple of the 32-deep smem step) and at its end
// run = round16(run + round16(part)), part = 0 (under a split the block
// keeps its slice's fp32 partial and the tile's last block folds, see
// above).  Elementwise fragment
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
// widened values.  One 16-byte copy carries 16 FP8 elements into the ring
// stage; after it lands it is widened with the paired cvt (two values per
// instruction) into two 16-byte stores of 8 halves in the compute tile;
// unaligned or ragged operands take the scalar path.  Every FP8 value is an fp16 value, so the product is the
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
constexpr int kBN = 32;         // reduction step (two 16-deep WMMA steps): the
                                // granularity of a split and of the faithful fold
constexpr int kSlab = 64;       // reduction rows a ring stage holds (two steps)
constexpr int kStages = 3;      // the copy ring: two slabs in flight

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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// cp.async (sm_80 and later): 16 or 4 bytes from global to shared memory,
// in flight until a wait_group.  A copy past a ragged edge is a plain
// shared-memory store of zeros instead, which reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  if (ok)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
                 "l"(src)
                 : "memory");
  else
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  if (ok)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
                 "l"(src)
                 : "memory");
  else
    *reinterpret_cast<float*>(dst) = 0.f;
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Issue the 16-byte copies of the R x C tile whose top-left logical element
// is (r0, c0) into a ring stage, in the operand's stored orientation:
// [R][C + RUN] when its columns are contiguous (s_c == 1), else
// [C][R + RUN] (rows contiguous).  RUN is 16 bytes of elements (8 fp16 /
// bf16, 16 FP8); the operand's `vec` promise (16-byte aligned runs, an
// extent that is a multiple of RUN along the contiguous axis) puts each run
// wholly inside or wholly outside [0, rows) x [0, cols).
template <typename TS, int R, int C>
__device__ __forceinline__ void issue_tile(TS* dst, const TS* src, int r0, int c0,
                                           int rows, int cols, long long s_r,
                                           long long s_c, int tid) {
  constexpr int RUN = 16 / sizeof(TS);
  if (s_c == 1) {  // neighbouring threads on neighbouring runs of a row
    constexpr int CV = C / RUN, LD = C + RUN;
#pragma unroll 4
    for (int e = tid; e < R * CV; e += kThreads) {
      const int r = e / CV, c = (e % CV) * RUN;
      const int gr = r0 + r, gc = c0 + c;
      const bool ok = gr < rows && gc < cols;
      cp_async16(dst + r * LD + c, src + (long long)gr * s_r + gc, ok);
    }
  } else {
    constexpr int RV = R / RUN, LD = R + RUN;
#pragma unroll 4
    for (int e = tid; e < RV * C; e += kThreads) {
      const int c = e / RV, r = (e % RV) * RUN;
      const int gr = r0 + r, gc = c0 + c;
      const bool ok = gr < rows && gc < cols;
      cp_async16(dst + c * LD + r, src + gr + (long long)gc * s_c, ok);
    }
  }
}

// A landed FP8 stage (see issue_tile) widened to fp16 in the compute tile,
// in the stage's own orientation: R x C bytes stored [R][C + 16] become
// [R][C + 8] halves.  One 16-byte read and two 16-byte writes per run of
// 16, through the paired cvt.
template <typename T, typename TS, int R, int C>
__device__ __forceinline__ void widen_tile(T* dst, const TS* stage, int tid) {
  constexpr int CV = C / 16, SLD = C + 16, LD = C + 8;
#pragma unroll 4
  for (int e = tid; e < R * CV; e += kThreads) {
    const int r = e / CV, c = (e % CV) * 16;
    uint4 lo, hi;
    widen16<TS>(*reinterpret_cast<const uint4*>(stage + r * SLD + c), lo, hi);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = lo;
    *reinterpret_cast<uint4*>(dst + r * LD + c + 8) = hi;
  }
}

// Copy the R x C tile whose top-left logical element is (r0, c0) into the
// row-major compute tile (leading dimension LD, type T) one element at a
// time, zero-filling outside [0, rows) x [0, cols) and widening stored FP8
// (TS) on the way: the path of an operand that takes no 16-byte copies
// (unaligned, or a ragged contiguous extent).  Neighbouring threads walk
// the contiguous axis.
template <typename T, typename TS, int R, int C, int LD>
__device__ __forceinline__ void load_tile_scalar(T* dst, const TS* src, int r0, int c0,
                                                 int rows, int cols, long long s_r,
                                                 long long s_c, int tid) {
  const T zero = from_float<T>(0.f);
#pragma unroll 4
  for (int e = tid; e < R * C; e += kThreads) {
    int r, c;
    if (s_c == 1) { r = e / C; c = e % C; }
    else { r = e % R; c = e / R; }
    const int gr = r0 + r, gc = c0 + c;
    dst[r * LD + c] = (gr < rows && gc < cols)
                          ? widen<T>(src[(long long)gr * s_r + (long long)gc * s_c])
                          : zero;
  }
}

struct Operand {
  long long outer, inner, row, col;  // element strides
  int vec;                           // 16-byte copies allowed (see issue_tile)
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

// The split of the reduction (core/tiling.py::split_plan).
struct Split {
  int splits;     // S >= 1 slices; block z of the grid is (batch element, slice)
  int depth;      // reduction rows per slice, a multiple of the step (S == 1: N)
  float* part;    // S x batch x M x K fp32 partials (S > 1)
  int* counters;  // one per output tile of the launch, zero between launches
};

// Called by every thread once the block's partial is stored: count the
// block on its output tile's counter.  True in the last of the tile's S
// blocks to arrive, which resets the counter for the next launch on the
// stream and may then read every partial.
__device__ __forceinline__ bool split_last(const Split& sp, int b, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const long long tile =
        ((long long)b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    const bool last = atomicAdd(sp.counters + tile, 1) == sp.splits - 1;
    if (last) sp.counters[tile] = 0;
    *flag = last;
  }
  __syncthreads();
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

// In place on the R x C dZ tile in shared memory (top-left logical element
// (r0, c0); element (r, c) at tile[r * rs + c * cs]): ds = dZ * act'(deriv)
// in fp32, rounded to fp16 under the faithful accumulator, written back in
// the compute dtype when there is a derivative, and copied to `dss` (fp32,
// row-major, leading dimension DLD) for the bias-gradient column sums when
// `dss` is given.  Cells outside [0, rows) x [0, cols) hold zeros and stay
// zero.
template <typename T, int R, int C, int DLD, int NT>
__device__ __forceinline__ void scale_dz_tile(T* tile, int rs, int cs, const Ext& ext,
                                              int r0, int c0, int rows, int cols,
                                              float* dss, int tid) {
  const T* d = static_cast<const T*>(ext.deriv);
  const bool faithful = ext.accum_block > 0;
  for (int e = tid; e < R * C; e += NT) {
    int r, c;
    if (ext.d_col == 1 || ext.grad_epi == 0) { r = e / C; c = e % C; }
    else { r = e % R; c = e / R; }
    const int gr = r0 + r, gc = c0 + c;
    float v = to_float<T>(tile[r * rs + c * cs]);
    if (gr < rows && gc < cols) {
      if (ext.grad_epi != 0)
        v *= epilogue_grad(
            to_float<T>(d[(long long)gr * ext.d_row + (long long)gc * ext.d_col]),
            ext.grad_epi, ext.from_output);
      if (faithful) v = round16(v);
    }
    if (ext.grad_epi != 0) tile[r * rs + c * cs] = from_float<T>(v);
    if (dss != nullptr) dss[r * DLD + c] = v;
  }
}

constexpr int round128(int bytes) { return (bytes + 127) / 128 * 128; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int cmin(int a, int b) { return a < b ? a : b; }

// Dynamic shared memory of one block of the tensor-core kernel: kStages ring
// stages, each an X and a W slab in its stored type and orientation (room
// for the larger orientation), then the compute tiles (fp16 / bf16) that
// the slabs of an operand stored in another type (FP8, widened) or with no
// 16-byte copies (loaded element by element, row-major) go to.  The fp32
// output staging tile of the epilogue reuses the ring after the loop.  A
// slab stored in the tile's type is read by the MMAs in place, row- or
// column-major as it lies: its leading dimension is the compute tile's.
// X is [m][n] (XLD) or [n][m] (XTLD), W [n][k] (WLD) or [k][n] (WTLD).
template <typename T, typename TX, typename TW, int BM, int BK>
struct GemmSmem {
  static constexpr int PX = 16 / sizeof(TX), PW = 16 / sizeof(TW);
  static constexpr int XLD = kSlab + 8, XTLD = BM + 8, WLD = BK + 8, WTLD = kSlab + 8;
  static constexpr int CLD = BK + 4;
  static constexpr int kXStage =
      round128(cmax(BM * (kSlab + PX), kSlab * (BM + PX)) * (int)sizeof(TX));
  static constexpr int kWStage =
      round128(cmax(kSlab * (BK + PW), BK * (kSlab + PW)) * (int)sizeof(TW));
  static constexpr int kStage = kXStage + kWStage;
  static constexpr int kRing = cmax(kStages * kStage, BM * CLD * 4);
  static constexpr int kXs = round128(cmax(BM * XLD, kSlab * XTLD) * (int)sizeof(T));
  static constexpr int kBytes =
      kRing + kXs + round128(cmax(kSlab * WLD, BK * WTLD) * (int)sizeof(T));
};

// Blocks of the tensor-core kernel one SM holds by shared memory (232,448
// bytes, at most 3): the register budget the compiler is held to.
template <typename T, typename TX, typename TW, int BM, int BK, bool kExt>
constexpr int kGemmBlocks =
    cmax(1, cmin(3, 232448 / (GemmSmem<T, TX, TW, BM, BK>::kBytes +
                              (kExt ? kSlab * (BK + 1) * 4 : 0) + 1024)));

// One 32-deep step into the warp's WM x WN block of accumulators.  LA / LB:
// how X ([m][n]: row-major; [n][m]: column-major) and W ([n][k]: row-major;
// [k][n]: column-major) lie in shared memory, with leading dimensions lda /
// ldb.
template <typename T, typename LA, typename LB, int FM, int FN, int WM, int WN>
__device__ __forceinline__ void mma_slab(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[FM][FN], const T* xa,
    int lda, const T* wb, int ldb, int wm, int wn) {
  constexpr bool a_row = std::is_same<LA, wmma::row_major>::value;
  constexpr bool b_row = std::is_same<LB, wmma::row_major>::value;
#pragma unroll
  for (int kk = 0; kk < kBN; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, LA> a[FM];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, T, LB> bf[FN];
#pragma unroll
    for (int i = 0; i < FM; ++i) {
      const int m = wm * WM + i * 16;
      wmma::load_matrix_sync(a[i], a_row ? xa + m * lda + kk : xa + kk * lda + m, lda);
    }
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      const int k = wn * WN + j * 16;
      wmma::load_matrix_sync(bf[j], b_row ? wb + kk * ldb + k : wb + k * ldb + kk, ldb);
    }
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
  }
}

// T: the compute tile and WMMA type (fp16 / bf16); TX / TW: the operands'
// global element types (T, or FP8 widened to T after the copy lands)
template <typename T, typename TX, typename TW, typename O, int BM, int BK,
          int WARPS_M, int WARPS_N, bool kExt>
__global__ void __launch_bounds__(kThreads, (kGemmBlocks<T, TX, TW, BM, BK, kExt>))
    redmule_gemm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                        const float* __restrict__ bias, O* __restrict__ z,
                        int M, int N, int K, int batch, int inner, int batch0,
                        Operand xo, Operand wo, long long zs_outer,
                        long long zs_inner, int epi, Ext ext, Split sp) {
  using L = GemmSmem<T, TX, TW, BM, BK>;
  static_assert(WARPS_M * WARPS_N * 32 == kThreads, "four warps");
  constexpr int WM = BM / WARPS_M, WN = BK / WARPS_N;
  constexpr int FM = WM / 16, FN = WN / 16;
  constexpr int XLD = L::XLD, XTLD = L::XTLD, WLD = L::WLD, WTLD = L::WTLD;
  constexpr int CLD = L::CLD, DLD = BK + 1;
  static_assert(BK <= kThreads, "one thread per db column");
  extern __shared__ __align__(128) unsigned char smem[];
  T* const xs = reinterpret_cast<T*>(smem + L::kRing);
  T* const ws = reinterpret_cast<T*>(smem + L::kRing + L::kXs);
  float* const cs = reinterpret_cast<float*>(smem);  // the ring, after the loop
  __shared__ float dss[kExt ? kSlab * DLD : 1];     // the scaled dZ tile, for db
  __shared__ int last_flag;

  const int split = blockIdx.z % sp.splits;
  const int b = batch0 + blockIdx.z / sp.splits;
  const int bo = b / inner, bi = b % inner;
  x += bo * xo.outer + bi * xo.inner;
  w += bo * wo.outer + bi * wo.inner;
  z += bo * zs_outer + bi * zs_inner;
  const int m0 = blockIdx.y * BM, k0 = blockIdx.x * BK;
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  // this block's slice of the reduction
  const int n_lo = split * sp.depth, n_hi = min(N, n_lo + sp.depth);
  const int slabs = n_hi > n_lo ? (n_hi - n_lo + kSlab - 1) / kSlab : 0;
  // how each operand's slabs lie: a 16-byte-copied slab keeps its stored
  // orientation (x_t: X as [n][m], w_t: W as [k][n]) and, stored in the
  // tile's type, is read by the MMAs in place; FP8 is widened into the
  // compute tile in the same orientation; a slab loaded element by element
  // is row-major
  const bool x_rows = xo.col == 1, w_rows = wo.col == 1;
  const bool x_t = xo.vec && !x_rows, w_t = wo.vec && !w_rows;
  const bool x_direct = std::is_same<T, TX>::value && xo.vec;
  const bool w_direct = std::is_same<T, TW>::value && wo.vec;
  const int lda = x_t ? XTLD : XLD, ldb = w_t ? WTLD : WLD;
  // a warp whose accumulators lie wholly past M or K skips its MMAs
  const bool mma_idle = m0 + wm * WM >= M || k0 + wn * WN >= K;

  // the copies of slab t into stage t % kStages, as one group (empty past
  // the slice, so the group count stays in step); rows past the slice are
  // zeros
  auto issue = [&](int t) {
    if (t < slabs) {
      unsigned char* const st = smem + (t % kStages) * L::kStage;
      const int n0 = n_lo + t * kSlab;
      if (xo.vec)
        issue_tile<TX, BM, kSlab>(reinterpret_cast<TX*>(st), x, m0, n0, M, n_hi, xo.row,
                                  xo.col, tid);
      if (wo.vec)
        issue_tile<TW, kSlab, BK>(reinterpret_cast<TW*>(st + L::kXStage), w, n0, k0,
                                  n_hi, K, wo.row, wo.col, tid);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
  // the faithful running sum (fp16-representable values in fp32 fragments)
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> run[kExt ? FM : 1][kExt ? FN : 1];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const bool faithful = kExt && ext.accum_block > 0;
  // unsplit, the block folds its own rounding blocks; a slice of a split
  // lies inside one rounding block and keeps its fp32 partial
  const bool fold = faithful && sp.splits == 1;
  // db: the first M-tile row sums its columns of every dZ tile
  const bool do_db = kExt && ext.db != nullptr && ext.slot == 2 && blockIdx.y == 0;
  float db_part = 0.f, db_run = 0.f;
  if constexpr (kExt) {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(run[i][j], 0.f);
  }

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);
  for (int t = 0; t < slabs; ++t) {
    cp_async_wait<kStages - 2>();
    // slab t has landed for every thread, and every warp is done with slab
    // t - 1, whose stage the next copies overwrite
    __syncthreads();
    issue(t + kStages - 1);
    const int n0 = n_lo + t * kSlab;
    unsigned char* const st = smem + (t % kStages) * L::kStage;
    T* const xa = x_direct ? reinterpret_cast<T*>(st) : xs;
    T* const wb = w_direct ? reinterpret_cast<T*>(st + L::kXStage) : ws;
    if (!x_direct || !w_direct) {
      if (!x_direct) {
        if (!xo.vec)
          load_tile_scalar<T, TX, BM, kSlab, XLD>(xs, x, m0, n0, M, n_hi, xo.row, xo.col,
                                                  tid);
        else if constexpr (kFp8<TX>) {
          if (x_rows) widen_tile<T, TX, BM, kSlab>(xs, reinterpret_cast<const TX*>(st), tid);
          else widen_tile<T, TX, kSlab, BM>(xs, reinterpret_cast<const TX*>(st), tid);
        }
      }
      if (!w_direct) {
        const TW* const sw = reinterpret_cast<const TW*>(st + L::kXStage);
        if (!wo.vec)
          load_tile_scalar<T, TW, kSlab, BK, WLD>(ws, w, n0, k0, n_hi, K, wo.row, wo.col,
                                                  tid);
        else if constexpr (kFp8<TW>) {
          if (w_rows) widen_tile<T, TW, kSlab, BK>(ws, sw, tid);
          else widen_tile<T, TW, BK, kSlab>(ws, sw, tid);
        }
      }
      __syncthreads();
    }
    if constexpr (kExt) {
      if (ext.slot == 1 && ext.grad_epi != 0) {
        scale_dz_tile<T, BM, kSlab, DLD, kThreads>(xa, x_t ? 1 : XLD, x_t ? XTLD : 1, ext,
                                                   m0, n0, M, n_hi, nullptr, tid);
        __syncthreads();
      } else if (ext.slot == 2 && (ext.grad_epi != 0 || do_db)) {
        scale_dz_tile<T, kSlab, BK, DLD, kThreads>(wb, w_t ? 1 : WLD, w_t ? WTLD : 1, ext,
                                                   n0, k0, n_hi, K, do_db ? dss : nullptr,
                                                   tid);
        __syncthreads();
      }
    }
    // the slab's two 32-deep steps; a step past the slice is not run
#pragma unroll
    for (int h = 0; h < kSlab / kBN; ++h) {
      const int nh = n0 + h * kBN;
      if (nh >= n_hi) continue;
      if constexpr (kExt) {
        if (do_db && tid < BK) {
          float sum = 0.f;
#pragma unroll 8
          for (int r = h * kBN; r < (h + 1) * kBN; ++r) sum += dss[r * DLD + tid];
          db_part += sum;
        }
      }
      if (!mma_idle) {
        using Row = wmma::row_major;
        using Col = wmma::col_major;
        const T* const xh = xa + (x_t ? h * kBN * lda : h * kBN);
        const T* const wh = wb + (w_t ? h * kBN : h * kBN * ldb);
        if (x_t) {
          if (w_t) mma_slab<T, Col, Col, FM, FN, WM, WN>(acc, xh, lda, wh, ldb, wm, wn);
          else mma_slab<T, Col, Row, FM, FN, WM, WN>(acc, xh, lda, wh, ldb, wm, wn);
        } else {
          if (w_t) mma_slab<T, Row, Col, FM, FN, WM, WN>(acc, xh, lda, wh, ldb, wm, wn);
          else mma_slab<T, Row, Row, FM, FN, WM, WN>(acc, xh, lda, wh, ldb, wm, wn);
        }
      }
      if constexpr (kExt) {
        // the end of a reference reduction block (or of the reduction):
        // round the block's partial and fold it into the fp16 running sums
        if (fold && ((nh + kBN) % ext.accum_block == 0 || nh + kBN >= N)) {
#pragma unroll
          for (int i = 0; i < FM; ++i)
#pragma unroll
            for (int j = 0; j < FN; ++j)
#pragma unroll
              for (int t2 = 0; t2 < acc[i][j].num_elements; ++t2) {
                run[i][j].x[t2] = round16(run[i][j].x[t2] + round16(acc[i][j].x[t2]));
                acc[i][j].x[t2] = 0.f;
              }
          db_run = round16(db_run + round16(db_part));
          db_part = 0.f;
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring, which cs reuses

  // store once: accumulator -> shared -> bias + epilogue -> one cast
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      float* dst = cs + (wm * WM + i * 16) * CLD + wn * WN + j * 16;
      if constexpr (kExt) {
        if (fold) {
          wmma::store_matrix_sync(dst, run[i][j], CLD, wmma::mem_row_major);
          continue;
        }
      }
      wmma::store_matrix_sync(dst, acc[i][j], CLD, wmma::mem_row_major);
    }
  __syncthreads();
  auto finish = [&](int gm, int gk, float v) {
    if (bias != nullptr) {
      v += bias[gk];
      if (faithful) v = round16(v);  // the fp16 bias add
    }
    z[(long long)gm * K + gk] = from_float<O>(apply_epilogue(v, epi));
  };
  if (sp.splits == 1) {
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      if (gm < M && gk < K) finish(gm, gk, cs[r * CLD + c]);
    }
    if (do_db && tid < BK && k0 + tid < K)
      ext.db[k0 + tid] = faithful ? db_run : db_part;
    return;
  }
  // split: store this slice's fp32 partial; the tile's last block sums the
  // S partials in split order (under the faithful accumulator: each
  // rounding block's slices in fp32, then the fp16 fold) and stores once.
  // Each thread folds its PER elements side by side, and every read is
  // unconditional (an element past M or K reads an in-bounds neighbour and
  // adds 0), so the reads of a slice are all in flight together.
  constexpr int PER = BM * BK / kThreads;
  const long long plane = (long long)M * K, stride = plane * batch;
  float* const part = sp.part + (long long)b * plane;
  for (int e = tid; e < BM * BK; e += kThreads) {
    const int r = e / BK, c = e % BK;
    const int gm = m0 + r, gk = k0 + c;
    if (gm < M && gk < K) part[split * stride + (long long)gm * K + gk] = cs[r * CLD + c];
  }
  if (!split_last(sp, b, &last_flag)) return;
  const int per_block = faithful ? ext.accum_block / sp.depth : sp.splits;
  float v[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) v[q] = 0.f;
  for (int j0 = 0; j0 < sp.splits; j0 += per_block) {
    const int j1 = min(sp.splits, j0 + per_block);
    float blk[PER];
#pragma unroll
    for (int q = 0; q < PER; ++q) blk[q] = 0.f;
    for (int j = j0; j < j1; ++j) {
      const float* const pj = part + j * stride;
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int e = tid + q * kThreads, gm = m0 + e / BK, gk = k0 + e % BK;
        const float r = __ldcg(pj + (long long)min(gm, M - 1) * K + min(gk, K - 1));
        blk[q] += gm < M && gk < K ? r : 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < PER; ++q)
      v[q] = faithful ? round16(v[q] + round16(blk[q])) : v[q] + blk[q];
  }
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int e = tid + q * kThreads, gm = m0 + e / BK, gk = k0 + e % BK;
    if (gm < M && gk < K) finish(gm, gk, v[q]);
  }
}

// fp32 operands: SIMT FMAs (no TF32).  Logical Z[M, K] = X[M, N] W[N, K];
// the block owns a BM x BK output tile, thread (tr, tc) TM rows in runs of
// four (`f32_row`) and the TN columns tc * TN + j of it.  16-deep slabs
// stream through a kF32Stages ring stored [n][m] (X) and [n][k] (W), so a
// thread reads its operands as float4s, and the eight lanes of a quarter
// warp read one broadcast float4 or 128 contiguous bytes.  The skinny
// side of the tile is spread over warps (rows on the small-M tile, columns
// on the 64 x 64 tile, whose skinny cases are the K = 8 gates), so a warp
// whose outputs lie wholly past M or K skips its FMAs.
constexpr int kF32Threads = 128;
constexpr int kF32BN = 16;     // reduction step
constexpr int kF32Stages = 4;

// row i of a thread's TM (a multiple of 4) rows: runs of four rows, the run
// g of row group tr at g * (BM / (TM / 4)) + tr * 4
template <int BM, int TM>
__device__ __forceinline__ int f32_row(int tr, int i) {
  return (i / 4) * (BM / (TM / 4)) + tr * 4 + i % 4;
}

template <typename O, int BM, int BK, int TM, int TN, bool kExt>
__global__ void __launch_bounds__(kF32Threads)
    redmule_gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                            const float* __restrict__ bias, O* __restrict__ z, int M,
                            int N, int K, int batch, int inner, int batch0,
                            Operand xo, Operand wo, long long zs_outer,
                            long long zs_inner, int epi, Ext ext, Split sp) {
  constexpr int RG = BM / TM, CG = BK / TN;  // row groups, column groups
  static_assert(RG * CG == kF32Threads, "128 threads");
  // rows by warp on the small-M tile (one row group a warp), else columns
  constexpr bool kRowsByWarp = RG == kF32Threads / 32;
  static_assert(kRowsByWarp || 32 % RG == 0, "a warp holds whole column groups");
  static_assert(TM % 4 == 0 && TN % 4 == 0, "float4 operand reads");
  static_assert(BK <= kF32Threads, "one thread per db column");
  constexpr int XLD = BM + 4, WLD = BK + 4;  // 16-byte aligned rows
  __shared__ __align__(16) float xs[kF32Stages][kF32BN * XLD];  // [n][m]
  __shared__ __align__(16) float ws[kF32Stages][kF32BN * WLD];  // [n][k]
  __shared__ int last_flag;

  const int split = blockIdx.z % sp.splits;
  const int b = batch0 + blockIdx.z / sp.splits;
  const int bo = b / inner, bi = b % inner;
  x += bo * xo.outer + bi * xo.inner;
  w += bo * wo.outer + bi * wo.inner;
  z += bo * zs_outer + bi * zs_inner;
  const int m0 = blockIdx.y * BM, k0 = blockIdx.x * BK;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tr = kRowsByWarp ? warp : lane % RG;
  const int tc = kRowsByWarp ? lane : warp * (32 / RG) + lane / RG;
  // a thread whose outputs lie wholly past M or K (warp-uniform on the
  // skinny side) skips the FMAs
  const bool idle = m0 + f32_row<BM, TM>(tr, 0) >= M || k0 + tc * TN >= K;
  const int n_lo = split * sp.depth, n_hi = min(N, n_lo + sp.depth);
  const int steps = n_hi > n_lo ? (n_hi - n_lo + kF32BN - 1) / kF32BN : 0;
  // 16-byte copies where the slab's contiguous axis is the stored one (m
  // for X under "tn", k for W under "nn" / "tn"); else 4-byte copies with
  // neighbouring threads on the stored contiguous axis, transposed on
  // their way into shared memory
  const bool x_vec = xo.vec && xo.col != 1 && xo.row == 1;
  const bool w_vec = wo.vec && wo.col == 1;

  auto issue = [&](int t) {
    if (t < steps) {
      float* const xd = xs[t % kF32Stages];
      float* const wd = ws[t % kF32Stages];
      const int n0 = n_lo + t * kF32BN;
      if (x_vec) {
        constexpr int MV = BM / 4;
        for (int e = tid; e < kF32BN * MV; e += kF32Threads) {
          const int n = e / MV, m = (e % MV) * 4;
          const int gm = m0 + m, gn = n0 + n;
          const bool ok = gm < M && gn < N;
          cp_async16(xd + n * XLD + m, ok ? x + gm + (long long)gn * xo.col : x, ok);
        }
      } else {
        for (int e = tid; e < BM * kF32BN; e += kF32Threads) {
          int m, n;
          if (xo.col == 1) { m = e / kF32BN; n = e % kF32BN; }
          else { n = e / BM; m = e % BM; }
          const int gm = m0 + m, gn = n0 + n;
          const bool ok = gm < M && gn < N;
          cp_async4(xd + n * XLD + m,
                    ok ? x + (long long)gm * xo.row + (long long)gn * xo.col : x, ok);
        }
      }
      if (w_vec) {
        constexpr int KV = BK / 4;
        for (int e = tid; e < kF32BN * KV; e += kF32Threads) {
          const int n = e / KV, k = (e % KV) * 4;
          const int gn = n0 + n, gk = k0 + k;
          const bool ok = gn < N && gk < K;
          cp_async16(wd + n * WLD + k, ok ? w + (long long)gn * wo.row + gk : w, ok);
        }
      } else {
        for (int e = tid; e < kF32BN * BK; e += kF32Threads) {
          int n, k;
          if (wo.row == 1) { k = e / kF32BN; n = e % kF32BN; }
          else { n = e / BK; k = e % BK; }
          const int gn = n0 + n, gk = k0 + k;
          const bool ok = gn < N && gk < K;
          cp_async4(wd + n * WLD + k,
                    ok ? w + (long long)gn * wo.row + (long long)gk * wo.col : w, ok);
        }
      }
    }
    cp_async_commit();
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  const bool do_db = kExt && ext.db != nullptr && ext.slot == 2 && blockIdx.y == 0;
  float db_part = 0.f;

#pragma unroll
  for (int t = 0; t < kF32Stages - 1; ++t) issue(t);
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kF32Stages - 2>();
    __syncthreads();  // slab t landed; every warp is done with slab t - 1
    issue(t + kF32Stages - 1);
    float* const xd = xs[t % kF32Stages];
    float* const wd = ws[t % kF32Stages];
    if constexpr (kExt) {
      // the fused backward epilogue on the landed dZ slab: ds = dZ *
      // act'(deriv), then (first M-tile row, "tn") the bias gradient's
      // column sums
      const int n0 = n_lo + t * kF32BN;
      const float* d = static_cast<const float*>(ext.deriv);
      if (ext.grad_epi != 0 && ext.slot == 1) {
        for (int e = tid; e < BM * kF32BN; e += kF32Threads) {
          const int m = e / kF32BN, n = e % kF32BN;
          const int gm = m0 + m, gn = n0 + n;
          if (gm < M && gn < N)
            xd[n * XLD + m] *= epilogue_grad(
                d[(long long)gm * ext.d_row + (long long)gn * ext.d_col], ext.grad_epi,
                ext.from_output);
        }
        __syncthreads();
      } else if (ext.grad_epi != 0 && ext.slot == 2) {
        for (int e = tid; e < kF32BN * BK; e += kF32Threads) {
          const int n = e / BK, k = e % BK;
          const int gn = n0 + n, gk = k0 + k;
          if (gn < N && gk < K)
            wd[n * WLD + k] *= epilogue_grad(
                d[(long long)gn * ext.d_row + (long long)gk * ext.d_col], ext.grad_epi,
                ext.from_output);
        }
        __syncthreads();
      }
      if (do_db && tid < BK) {
#pragma unroll
        for (int n = 0; n < kF32BN; ++n) db_part += wd[n * WLD + tid];
      }
    }
    if (idle) continue;
#pragma unroll
    for (int nn = 0; nn < kF32BN; ++nn) {
      float a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 v =
            *reinterpret_cast<const float4*>(xd + nn * XLD + f32_row<BM, TM>(tr, i));
        a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TN; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(wd + nn * WLD + tc * TN + j);
        bv[j] = v.x; bv[j + 1] = v.y; bv[j + 2] = v.z; bv[j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  // store once: bias + epilogue on the fp32 accumulator, one cast
  auto finish = [&](int gm, int gk, float v) {
    if (bias != nullptr) v += bias[gk];
    z[(long long)gm * K + gk] = from_float<O>(apply_epilogue(v, epi));
  };
  if (sp.splits == 1) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gm = m0 + f32_row<BM, TM>(tr, i), gk = k0 + tc * TN + j;
        if (gm < M && gk < K) finish(gm, gk, acc[i][j]);
      }
    if (do_db && tid < BK && k0 + tid < K) ext.db[k0 + tid] = db_part;
    return;
  }
  // split: as in the tensor-core kernel (fp32 accumulation only)
  const long long plane = (long long)M * K, stride = plane * batch;
  float* const part = sp.part + (long long)b * plane;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gm = m0 + f32_row<BM, TM>(tr, i), gk = k0 + tc * TN + j;
      if (gm < M && gk < K) part[split * stride + (long long)gm * K + gk] = acc[i][j];
    }
  if (!split_last(sp, b, &last_flag)) return;
  float v[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) v[i][j] = 0.f;
#pragma unroll 2
  for (int s = 0; s < sp.splits; ++s) {
    const float* const ps = part + s * stride;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gm = m0 + f32_row<BM, TM>(tr, i), gk = k0 + tc * TN + j;
        const float r = __ldcg(ps + (long long)min(gm, M - 1) * K + min(gk, K - 1));
        v[i][j] += gm < M && gk < K ? r : 0.f;
      }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gm = m0 + f32_row<BM, TM>(tr, i), gk = k0 + tc * TN + j;
      if (gm < M && gk < K) finish(gm, gk, v[i][j]);
    }
}

// One call: the grid is (ceil(K / BK), ceil(M / BM), batch x S), and
// grid.z is at most 65535, so a larger batch is cut into several launches
// (the counters are indexed by the global batch element).
struct Problem {
  const void* x;
  const void* w;
  const float* bias;
  void* z;
  int batch, inner, M, N, K;
  Operand xo, wo;
  int epi;
  Ext ext;
  Split split;
};

template <int BM, int BK, typename Go>
int for_each_launch(const Problem& p, Go&& go) {
  // gy >= 1: a dW over M == 0 rows still launches its db row of blocks
  const unsigned gx = (p.K + BK - 1) / BK, gy = p.M > 0 ? (p.M + BM - 1) / BM : 1;
  const int S = p.split.splits, chunk = 65535 / S;
  for (int b0 = 0; b0 < p.batch; b0 += chunk) {
    const int nb = p.batch - b0 < chunk ? p.batch - b0 : chunk;
    go(dim3(gx, gy, (unsigned)(nb * S)), b0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename O, int BM, int BK, int TM, int TN, bool kExt>
int launch_f32(const Problem& p, cudaStream_t stream) {
  const long long zs_inner = (long long)p.M * p.K;
  const long long zs_outer = zs_inner * p.inner;
  return for_each_launch<BM, BK>(p, [&](dim3 grid, int b0) {
    redmule_gemm_f32_kernel<O, BM, BK, TM, TN, kExt><<<grid, kF32Threads, 0, stream>>>(
        static_cast<const float*>(p.x), static_cast<const float*>(p.w), p.bias,
        static_cast<O*>(p.z), p.M, p.N, p.K, p.batch, p.inner, b0, p.xo, p.wo,
        zs_outer, zs_inner, p.epi, p.ext, p.split);
  });
}

template <int BM, int BK, int TM, int TN>
int ext_f32(const Problem& p, bool ext, cudaStream_t s) {
  return ext ? launch_f32<float, BM, BK, TM, TN, true>(p, s)
             : launch_f32<float, BM, BK, TM, TN, false>(p, s);
}

int by_tile_f32(int tile, const Problem& p, bool ext, cudaStream_t s) {
  if (tile == 0)  // 64 x 64 output tile, 8 x 4 per thread
    return ext_f32<64, 64, 8, 4>(p, ext, s);
  if (tile == 1)  // 16 x 128 (small M), 4 x 4 per thread
    return ext_f32<16, 128, 4, 4>(p, ext, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename TX, typename TW, typename O, int BM, int BK,
          int WARPS_M, int WARPS_N, bool kExt>
int launch(const Problem& p, cudaStream_t stream) {
  using L = GemmSmem<T, TX, TW, BM, BK>;
  const auto kern = redmule_gemm_kernel<T, TX, TW, O, BM, BK, WARPS_M, WARPS_N, kExt>;
  // the ring may exceed the 48 KB a block gets without asking
  const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return (int)attr;
  const long long zs_inner = (long long)p.M * p.K;
  const long long zs_outer = zs_inner * p.inner;
  return for_each_launch<BM, BK>(p, [&](dim3 grid, int b0) {
    kern<<<grid, kThreads, L::kBytes, stream>>>(
        static_cast<const TX*>(p.x), static_cast<const TW*>(p.w), p.bias,
        static_cast<O*>(p.z), p.M, p.N, p.K, p.batch, p.inner, b0, p.xo, p.wo,
        zs_outer, zs_inner, p.epi, p.ext, p.split);
  });
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
// route and store fp32) or both FP8 (widened to fp16 after the copy lands;
// the compiled pairs are `kFp8Pair`'s).
// tile: 0 = (bm 64, bn 32, bk 64), 1 = (bm 16, bn 32, bk 128).
// accum_block > 0: the faithful fp16 accumulator, re-rounded every
// accum_block reduction rows (a multiple of 32; fp16 tiles).
// deriv / d_row / d_col / slot / grad_epi / grad_from_output / db: the fused
// backward epilogue (see the header; nulls and zeros when unused, batch 1).
// splits / split_depth / partials / counters: the split of the reduction
// (core/tiling.py::split_plan): S slices of split_depth rows (a multiple of
// the route's step: 32, or 16 on the fp32 route; the last slice holds the
// rest), an fp32 workspace of S x batch x M x K and one zeroed int per
// output tile (batch x ceil(M / bm) x ceil(K / bk)).  S > 1 is refused with
// deriv or db, and under the faithful accumulator unless every slice lies
// inside one rounding block (accum_block a multiple of split_depth).
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
                            int grad_from_output, void* db, int splits,
                            int split_depth, void* partials, void* counters,
                            void* stream) {
  const int step = x_dtype == 2 ? kF32BN : kBN;
  if (splits < 1 || splits > 65535) return (int)cudaErrorInvalidValue;
  if (splits == 1) {
    split_depth = N;
  } else if (split_depth <= 0 || split_depth % step != 0 ||
             (long long)(splits - 1) * split_depth >= N ||
             (long long)splits * split_depth < N || partials == nullptr ||
             counters == nullptr || slot != 0 ||
             (accum_block > 0 && accum_block % split_depth != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const Ext ext{deriv, d_row, d_col, slot, grad_epi, grad_from_output,
                static_cast<float*>(db), accum_block};
  const Split sp{splits, split_depth, static_cast<float*>(partials),
                 static_cast<int*>(counters)};
  const Problem p{x, w, static_cast<const float*>(bias), z, batch, inner, M, N, K,
                  Operand{xs_outer, xs_inner, xs_m, xs_n, x_vec},
                  Operand{ws_outer, ws_inner, ws_n, ws_k, w_vec}, epi, ext, sp};
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
