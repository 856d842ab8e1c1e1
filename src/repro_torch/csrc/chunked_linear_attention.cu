// Chunked linear attention (the mLSTM / Mamba2-SSD state sweep) for Hopper
// (sm_90a), on the tensor cores.
//
// Replaces the Pallas TPU kernel `chunked_linear_attention_pallas`
// (src/repro/kernels/chunked_linear_attention.py:79, body `_kernel`).
//
// What it computes, per head and per chunk of C rows, all in fp32:
//   L      = cumsum(g)                                  (C,)
//   A      = (q k^T) * exp(L_i - L_j) [i >= j]          (C, C)
//   out    = A v + exp(L) * (q S)
//   S     <- exp(L_C) S + (k * exp(L_C - L))^T v
// with S (dk x dv) starting at zero and stored once, after the last chunk
// (the reference's store-once rule applied to the recurrent state).  `out`
// is stored in q's dtype, the state in fp32.  v may have its own element
// type: Mamba2 / SSD (hymba) feeds fp32 q / k (C and B, from an fp32 GEMM)
// with bf16 or fp16 v = dt x, as the reference kernel accepts by widening
// every operand to fp32 on load; here v is widened on load into the same
// fp32 / TF32-piece path (a 16-bit v is exact in one TF32 piece).
//
// Two launches, one wrapper call.
// 1. `chunked_linear_attention_scores_kernel`, one block per (head, chunk,
//    16 rows): L and the decayed, causally masked scores A, written once
//    per (head, chunk) to a scratch buffer (BH x S x C fp32, 1 MiB at the
//    training shape), so the dv tiles of step 2 share them instead of each
//    recomputing them (the SIMT kernel this replaces recomputed the C x C
//    scores in each of its 32 dv tiles, about as many FMAs again as the
//    useful work).
// 2. `chunked_linear_attention_kernel`, one block of eight warps per
//    (head, 32-column dv tile).  The block's slice of the state lives in
//    registers for the whole chunk loop, transposed (S^T, 32 x dk) as the
//    fp32 accumulators of `mma.sync` m16n8k8 TF32 tiles: warp w owns dk
//    columns [128 w, 128 w + 128), 128 floats a thread (so dk <= 1024).
//    The state update S^T <- e S^T + v^T kdec is then an MMA that
//    accumulates into the state itself; the inter-chunk read
//    out^T = S^T q^T takes the state's accumulator fragments as its A
//    operand (the reduction index is permuted the same way on both sides,
//    which a dot product does not see), each warp over its own dk range,
//    and the eight partial sums meet in shared memory; A v runs on the
//    same MMA (its chunk rows split over the warps).  q and k stream
//    through a two-stage `cp.async` ring of 32-row (fp32: 16-row) slabs of
//    the whole dk, with the next chunk's v, L and scores behind them.
//
// fp32 accuracy from TF32 tensor cores.  bf16 and fp16 values are exact in
// TF32 (8 and 11 significant bits of TF32's 11).  For bf16 / fp16 inputs the
// fp32 operands — the state, the decayed scores A and kdec = k exp(L_C - L)
// — are split into two TF32 pieces (big = x rounded to TF32, small = x -
// big, which the MMA reads truncated to TF32: ~22 bits together, CUTLASS's
// "3xTF32"), and big x big, big x small and small x big accumulate in fp32;
// the output is rounded to bf16 / fp16 after.  For fp32 inputs every fp32
// operand — q, k and (if fp32) v as well as the state, A and kdec — is split
// into three pieces: big = cvt.rna(x), mid = cvt.rna(x - big), small = x -
// big - mid (a few bits, exact in TF32), so the pieces carry x whole; every
// piece product at or above fp32's rounding accumulates in fp32 (big x big,
// big x mid, mid x big, big x small, small x big, mid x mid; a 16-bit v has
// one piece, so only its products with A's or kdec's three), each k-step's
// products summed apart and added to the running sum in fp32 (mma_acc),
// and L summed in fp64.  Two pieces into the running sum and an fp32 scan
// of L left ~21-22 significant bits of each operand and a few ulps of |L|,
// and the fp32 xLSTM super-block's gradients sat 11x further from the CPU
// than the same block with the sweep composed on the fp32 GEMM route.  Measured against the
// plain version on one H100 (chip_smoke.py, training shape, bf16): the state
// within 5e-7 of its max, the output within 2.6e-3 of max (one bf16
// rounding), as the SIMT kernel this replaces; in a CPU emulation
// (tests/test_torch_attn_numerics.py, tests/test_torch_kernel4_fp32.py) the
// pieces are off by ~2e-7 of max where S, A or kdec in one piece are off by
// 1-2.4e-4, and on fp32 inputs three pieces sit at the fp32 composition's
// distance from an fp64 recurrence where two do not.
//
// What bounds it.  At the training shape (BH 16, S 256, dk = dv = 1024,
// C 64, bf16 inputs) the function moves ~101 MB (mostly the fp32 state
// store) and needs ~18.3 GFLOP: 0.265 ms at the 67 TFLOP/s fp32 peak, the
// bound `chip_smoke.py` states.  On TF32 tensor cores the products as this
// kernel runs them (q k^T once, the other three in two pieces) are
// ~35.2 GFLOP, 0.071 ms at the 495 TFLOP/s TF32 peak; the kernel pair
// takes 0.415 ms there (H100 80GB HBM3, 700 W; 4.106 ms before), 1.6x
// the fp32 bound and 5.8x the TF32 one.  What still holds it back:
// `mma.sync` (not `wgmma`) at one block of eight warps per SM (the
// register-resident state takes the whole register file), the pieces'
// split in the inner loops, and each of a head's 32 dv tiles reading q
// and k again from L2 (512 MB of L2 reads a call; a cluster sharing slabs
// by TMA multicast would cut that).
//
// At hymba's dk = 16 (the SSM state size) the sweep still gives each warp
// 128 dk columns: warps 1-7 of each block idle.  On fp32 q / k (hymba's C
// and B) warp 0 skips the 32-column groups past dk, whose products are
// exact zeros, and runs one, half of it padding; the 16-bit instantiations
// keep the full loops, which the test costs ~10 % at dk = 1024 (ROADMAP
// Queue B).
//
// Contract (checked by the Python wrapper): S is a multiple of C (callers
// pad with g = 0, k = 0, which is inert); C in {16, 32, 64, 128}; dk <=
// 1024; any dv; BH <= 65535; (q / k, v) in (fp16, fp16), (bf16, bf16),
// (fp32, fp32), (fp32, bf16) or (fp32, fp16).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTV = 32;            // dv columns per sweep block (two m16 tiles)
constexpr int kDKW = 128;          // dk columns per warp
constexpr int kNT = kDKW / 8;      // n8 tiles of S^T per warp
constexpr int kMaxDK = kWarps * kDKW;
constexpr int kScoreWarps = 4;

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

// 16 bytes of T (8 bf16 / fp16, 4 fp32) as floats.
template <typename T> __device__ __forceinline__ void unpack16(const uint4& u, float* f);
template <> __device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <> __device__ __forceinline__ void unpack16<__half>(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
template <> __device__ __forceinline__ void unpack16<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// Elements 2 s and 2 s + 1 of 8 packed elements of T, as floats.
template <typename T> __device__ __forceinline__ float2 pair_at(const uint4* raw, int s);
template <> __device__ __forceinline__ float2 pair_at<__nv_bfloat16>(const uint4* raw, int s) {
  const uint32_t w = reinterpret_cast<const uint32_t*>(raw)[s];
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}
template <> __device__ __forceinline__ float2 pair_at<__half>(const uint4* raw, int s) {
  const uint32_t w = reinterpret_cast<const uint32_t*>(raw)[s];
  return __half22float2(*reinterpret_cast<const __half2*>(&w));
}
template <> __device__ __forceinline__ float2 pair_at<float>(const uint4* raw, int s) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(raw);
  return make_float2(__uint_as_float(w[2 * s]), __uint_as_float(w[2 * s + 1]));
}

// TF32 pieces of an fp32 value x = hi + mid + lo.  N = 1: x is exact in
// TF32 (a bf16 / fp16 value), hi = x.  N = 2: hi = x rounded to TF32 and
// mid = x - hi (exact in fp32; the MMA reads its top 19 bits).  N = 3: hi,
// mid = (x - hi) rounded to TF32 and lo = x - hi - mid (a few bits, exact in
// TF32), so the three carry x whole.
struct Pc {
  uint32_t hi, mid, lo;
};
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t h;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(x));
  return h;
}
template <int N>
__device__ __forceinline__ Pc pieces(float x) {
  if constexpr (N == 1) return {__float_as_uint(x), 0u, 0u};
  const uint32_t h = to_tf32(x);
  const float r = x - __uint_as_float(h);
  if constexpr (N == 2) return {h, __float_as_uint(r), 0u};
  const uint32_t m = to_tf32(r);
  return {h, m, __float_as_uint(r - __uint_as_float(m))};
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
// d += A B over the piece products a_i b_j with i + j < max(NA, NB), those
// at or above fp32's rounding: with two pieces big x big, big x small and
// small x big (small x small is dropped); with three also big x lo, lo x
// big and mid x mid.
template <int NA, int NB>
__device__ __forceinline__ void mma_p(float (&d)[4], const Pc (&a)[4], Pc b0, Pc b1) {
  constexpr int N = NA > NB ? NA : NB;
  mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.hi, b1.hi);
  if constexpr (NB >= 2) mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.mid, b1.mid);
  if constexpr (NA >= 2) mma_tf32(d, a[0].mid, a[1].mid, a[2].mid, a[3].mid, b0.hi, b1.hi);
  if constexpr (N == 3) {
    if constexpr (NB == 3) mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.lo, b1.lo);
    if constexpr (NA == 3) mma_tf32(d, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b0.hi, b1.hi);
    if constexpr (NA >= 2 && NB >= 2)
      mma_tf32(d, a[0].mid, a[1].mid, a[2].mid, a[3].mid, b0.mid, b1.mid);
  }
}

// d += A B as mma_p does.  For fp32 inputs (three pieces) a k-step's piece
// products are summed into a zeroed accumulator and that is added to d in
// fp32, round to nearest: an MMA does not round its fp32 sum to nearest (it
// aligns the terms to the largest and drops the bits below), so six MMAs a
// k-step straight into a long running sum drift with the sum's magnitude
// (2.1e-6 of max against the plain version at dk = 1024, where the exact
// products predict 5e-7); summed apart, a k-step's error scales with its
// own products.
template <int NA, int NB>
__device__ __forceinline__ void mma_acc(float (&d)[4], const Pc (&a)[4], Pc b0, Pc b1) {
  if constexpr (NA == 3 || NB == 3) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    mma_p<NA, NB>(t, a, b0, b1);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] += t[e];
  } else {
    mma_p<NA, NB>(d, a, b0, b1);
  }
}

// Pieces per operand: q / k (and v) in their own dtype, and the fp32
// quantities (the state, A, kdec), by the input element type; and the type
// the chunk's cumsum L accumulates in.  For fp32 inputs L is summed in fp64
// and rounded once (as PyTorch's CPU cumsum does, and the plain version on
// every device): an fp32 scan is off by 2-5 ulps of |L| (7.6e-6 at |L| ~
// 58), and exp(L) turns that into a relative error of the same size, 10x
// what the products' pieces leave.
template <typename T> struct NPieces {
  static constexpr int kIn = std::is_same<T, float>::value ? 3 : 1;
  static constexpr int kF32 = std::is_same<T, float>::value ? 3 : 2;
  using Acc = typename std::conditional<std::is_same<T, float>::value, double,
                                        float>::type;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// n elements of a row from global memory into shared memory as one 16-byte
// chunk: `cp.async` when the whole chunk is in range and aligned, else
// element by element (zeros past the row's end).
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, int n, bool vec) {
  constexpr int CE = 16 / sizeof(T);
  if (vec && n >= CE) {
    cp_async16(dst, src);
  } else {
#pragma unroll
    for (int z = 0; z < CE; ++z) dst[z] = z < n ? src[z] : from_f<T>(0.f);
  }
}

// 8 consecutive elements of a global row from column `col` as floats (zeros
// past `n`).
template <typename T>
__device__ __forceinline__ void load8(float (&f)[8], const T* row, int col, int n,
                                      bool vec) {
  constexpr int CE = 16 / sizeof(T);
  if (vec && col + 8 <= n) {
#pragma unroll
    for (int h = 0; h < 8 / CE; ++h)
      unpack16<T>(__ldg(reinterpret_cast<const uint4*>(row + col + h * CE)), f + h * CE);
  } else {
#pragma unroll
    for (int z = 0; z < 8; ++z) f[z] = col + z < n ? to_f(row[col + z]) : 0.f;
  }
}

// ------------------------------------------------------------------------
// Launch 1: L and the decayed, masked scores of 16 rows of one chunk.
// Grid (C / 16, S / C, BH); four warps split dk; rows i0 .. i0 + 15 need
// the columns j <= i0 + 15 only.  The reduction index is permuted: k-step
// s of 32-column slab sigma gives thread t the columns
// 32 sigma + 8 t + 2 s, + 1 (a 16-byte load covers four k-steps).
// ------------------------------------------------------------------------
template <typename T, int C>
__global__ void __launch_bounds__(32 * kScoreWarps)
    chunked_linear_attention_scores_kernel(const T* __restrict__ q,
                                           const T* __restrict__ k,
                                           const float* __restrict__ g,
                                           float* __restrict__ L_out,
                                           float* __restrict__ A_out, int S, int dk,
                                           int vec) {
  constexpr int kIn = NPieces<T>::kIn;
  constexpr int NTM = C / 8;    // n-tiles of a full chunk row
  constexpr int RLD = C + 8;    // padded row of the partial sums
  constexpr int E = C >= 32 ? C / 32 : 1;  // cumsum elements per lane
  __shared__ float Ls[C];
  __shared__ float red[kScoreWarps][16][RLD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int bh = blockIdx.z, ci = blockIdx.y, i0 = 16 * blockIdx.x;
  const int n_ch = gridDim.y;
  const long long s0 = (long long)ci * C;

  if (warp == 0) {  // inclusive cumsum of the chunk's log decays
    using Acc = typename NPieces<T>::Acc;
    Acc x[E];
    Acc run = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = lane * E + e;
      run += i < C ? g[(long long)bh * S + s0 + i] : 0.f;
      x[e] = run;
    }
    Acc incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const Acc y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    const Acc excl = incl - run;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = lane * E + e;
      if (i < C) Ls[i] = (float)(excl + x[e]);
    }
  }

  const int ntj = 2 * (blockIdx.x + 1);  // n-tiles j < i0 + 16
  float acc[NTM][4];
#pragma unroll
  for (int j = 0; j < NTM; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const T* qa = q + ((long long)bh * S + s0 + i0 + gq) * dk;
  const T* qb = qa + 8LL * dk;
  const T* kc = k + ((long long)bh * S + s0 + gq) * dk;
  const bool v16 = vec != 0;
  for (int sig = warp; 32 * sig < dk; sig += kScoreWarps) {
    const int col = 32 * sig + 8 * t;
    float fa[8], fb[8];
    load8<T>(fa, qa, col, dk, v16);
    load8<T>(fb, qb, col, dk, v16);
    Pc a[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      a[s][0] = pieces<kIn>(fa[2 * s]);
      a[s][1] = pieces<kIn>(fb[2 * s]);
      a[s][2] = pieces<kIn>(fa[2 * s + 1]);
      a[s][3] = pieces<kIn>(fb[2 * s + 1]);
    }
#pragma unroll
    for (int nt = 0; nt < NTM; ++nt) {
      if (nt < ntj) {
        float fk[8];
        load8<T>(fk, kc + 8LL * nt * dk, col, dk, v16);
#pragma unroll
        for (int s = 0; s < 4; ++s)
          mma_acc<kIn, kIn>(acc[nt], a[s], pieces<kIn>(fk[2 * s]),
                            pieces<kIn>(fk[2 * s + 1]));
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < NTM; ++nt) {
    if (nt < ntj) {
      red[warp][gq][8 * nt + 2 * t] = acc[nt][0];
      red[warp][gq][8 * nt + 2 * t + 1] = acc[nt][1];
      red[warp][gq + 8][8 * nt + 2 * t] = acc[nt][2];
      red[warp][gq + 8][8 * nt + 2 * t + 1] = acc[nt][3];
    }
  }
  __syncthreads();
  if (blockIdx.x == 0)
    for (int i = tid; i < C; i += 32 * kScoreWarps)
      L_out[(long long)bh * S + s0 + i] = Ls[i];
  float* Ao = A_out + (((long long)bh * n_ch + ci) * C + i0) * C;
  for (int e = tid; e < 16 * C; e += 32 * kScoreWarps) {
    const int i = e / C, j = e % C;
    float val = 0.f;
    if (j <= i0 + i) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kScoreWarps; ++w) s += red[w][i][j];
      val = s * expf(Ls[i0 + i] - Ls[j]);
    }
    Ao[e] = val;
  }
}

// ------------------------------------------------------------------------
// Launch 2: the sweep.  Layout of S^T's accumulators: warp w, m-tile m
// (dv columns 16 m .. 16 m + 15 of the block's 32), n-tile nt = 4 a + s of
// the warp's 128 dk columns; the n8 tile's column x is dk column
// pi(nt, x) = 128 w + 32 a + 8 (x >> 1) + 2 s + (x & 1), so that thread t's
// accumulator columns (x = 2 t, 2 t + 1) of the four n-tiles of group a
// are the eight consecutive dk columns 32 a + 8 t .. + 7: one 16-byte read
// of a q row feeds the four n-tiles of the inter-chunk read.
// ------------------------------------------------------------------------
template <typename T, typename TV, int C>
struct Sweep {
  static constexpr int kIn = NPieces<T>::kIn;     // pieces of q and k
  static constexpr int kF32 = NPieces<T>::kF32;   // of the state, A and kdec
  static constexpr int kV = NPieces<TV>::kIn;     // of v
  static constexpr int CE = 16 / sizeof(T);             // elements per 16 bytes
  static constexpr int CEV = 16 / sizeof(TV);           // v elements per 16 bytes
  static constexpr int RG0 = 64 / sizeof(T);            // slab rows: 32 (16 fp32)
  static constexpr int RG = C < RG0 ? C : RG0;
  static constexpr int NG = C / RG;                     // slabs of q (and of k) per chunk
  static constexpr int RNT = RG / 8;                    // chunk-row n-tiles per slab
  static constexpr int ALD = C + 8;                     // padded row of staged scores
  static constexpr int VLD = kTV + CEV;                 // padded row of the v chunk
  static constexpr int RED = 2 * RNT * 4 * 32;          // partial sums per warp

  // shared memory, in bytes, for a slab row of dks elements
  static __host__ __device__ long long slab_bytes(int dks) {
    return (long long)RG * dks * sizeof(T);
  }
  static __host__ __device__ long long smem_bytes(int dks) {
    return 2 * slab_bytes(dks) + 2LL * RG * ALD * 4 + 2LL * C * VLD * sizeof(TV) +
           2LL * C * 4 + (long long)kWarps * RED * 4;
  }
};

// element offset of (row, col) in a slab: 16-byte chunks XOR-swizzled on
// odd rows, so the q reads of two neighbouring rows hit disjoint banks
template <typename T>
__device__ __forceinline__ int slab_off(int row, int col, int dks) {
  constexpr int CE = 16 / sizeof(T);
  constexpr int SW = CE == 8 ? 4 : 1;
  return row * dks + (((col / CE) ^ ((row & 1) * SW)) * CE) + col % CE;
}

template <typename T, typename TV, int C>
__global__ void __launch_bounds__(kThreads, 1)
    chunked_linear_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                    const TV* __restrict__ v,
                                    const float* __restrict__ Lg,
                                    const float* __restrict__ Ag, T* __restrict__ out,
                                    float* __restrict__ state, int S, int dk, int dv,
                                    int vec_dk, int vec_dv) {
  using P = Sweep<T, TV, C>;
  constexpr int kIn = P::kIn, kF32 = P::kF32, kV = P::kV;
  constexpr int CE = P::CE, CEV = P::CEV, RG = P::RG, NG = P::NG, RNT = P::RNT;
  constexpr int ALD = P::ALD, VLD = P::VLD, RED = P::RED;
  const int dks = (dk + kDKW - 1) / kDKW * kDKW;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slab = reinterpret_cast<T*>(smem_raw);                       // [2][RG][dks]
  float* As = reinterpret_cast<float*>(smem_raw + 2 * P::slab_bytes(dks));  // [2][RG][ALD]
  TV* vbuf = reinterpret_cast<TV*>(As + 2 * RG * ALD);            // [2][C][VLD]
  float* Lbuf = reinterpret_cast<float*>(vbuf + 2 * C * VLD);     // [2][C]
  float* red = Lbuf + 2 * C;                                      // [kWarps][RED]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, j0 = blockIdx.x * kTV;
  const int n_ch = S / C;
  const int U = n_ch * 2 * NG;
  const int wc0 = warp * kDKW;
  const bool active = wc0 < dk;
  const bool vdk = vec_dk != 0, vdv = vec_dv != 0;

  const T* qh = q + (long long)bh * S * dk;
  const T* kh = k + (long long)bh * S * dk;
  const TV* vh = v + (long long)bh * S * dv;
  const float* Lh = Lg + (long long)bh * S;
  const float* Ah = Ag + (long long)bh * n_ch * C * C;

  // slab u: chunk u / (2 NG); its first NG slabs are q's rows (with their
  // scores, and with the first one the chunk's v tile and L), the next NG
  // are k's
  auto issue = [&](int u) {
    const int st = u & 1, c = u / (2 * NG), x = u % (2 * NG);
    const long long r0 = (long long)c * C + (x % NG) * RG;
    const T* src = (x < NG ? qh : kh) + r0 * dk;
    T* dst = slab + st * RG * dks;
    const int cpr = dks / CE;  // chunks per slab row
    for (int e = tid; e < RG * cpr; e += kThreads) {
      const int r = e / cpr, col = (e % cpr) * CE;
      copy_chunk<T>(dst + slab_off<T>(r, col, dks), src + (long long)r * dk + col,
                    dk - col, vdk);
    }
    if (x < NG) {
      const float* asrc = Ah + ((long long)c * C + x * RG) * C;
      float* adst = As + st * RG * ALD;
      for (int e = tid; e < RG * (C / 4); e += kThreads) {
        const int r = e / (C / 4), col = (e % (C / 4)) * 4;
        cp_async16(adst + r * ALD + col, asrc + (long long)r * C + col);
      }
      if (x == 0) {
        TV* vd = vbuf + (c & 1) * C * VLD;
        const TV* vs = vh + (long long)c * C * dv + j0;
        constexpr int VC = kTV / CEV;
        for (int e = tid; e < C * VC; e += kThreads) {
          const int r = e / VC, col = (e % VC) * CEV;
          copy_chunk<TV>(vd + r * VLD + col, vs + (long long)r * dv + col,
                         dv - (j0 + col), vdv);
        }
        float* ld = Lbuf + (c & 1) * C;
        for (int e = tid; e < C / 4; e += kThreads)
          cp_async16(ld + 4 * e, Lh + (long long)c * C + 4 * e);
      }
    }
  };

  float st[2][kNT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < kNT; ++n) st[m][n][0] = st[m][n][1] = st[m][n][2] = st[m][n][3] = 0.f;

  issue(0);
  cp_async_commit();
  for (int u = 0; u < U; ++u) {
    if (u + 1 < U) issue(u + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const int c = u / (2 * NG), x = u % (2 * NG);
    const T* sl = slab + (u & 1) * RG * dks;
    const float* Lc = Lbuf + (c & 1) * C;
    const TV* vc = vbuf + (c & 1) * C * VLD;

    // A fragments of v^T for chunk rows r, r + 1 (k positions t, t + 4)
    auto vfrag = [&](Pc (&a)[2][4], int r) {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        a[m][0] = pieces<kV>(to_f(vc[r * VLD + 16 * m + gq]));
        a[m][1] = pieces<kV>(to_f(vc[r * VLD + 16 * m + gq + 8]));
        a[m][2] = pieces<kV>(to_f(vc[(r + 1) * VLD + 16 * m + gq]));
        a[m][3] = pieces<kV>(to_f(vc[(r + 1) * VLD + 16 * m + gq + 8]));
      }
    };

    if (x < NG) {
      // ---- out rows x RG .. x RG + RG - 1: exp(L) (q S) + A v ----
      float acc[2][RNT][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < RNT; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;
      if (active && c > 0) {  // the state is zero before the first chunk
#pragma unroll
        for (int a = 0; a < kNT / 4; ++a) {
          if (kIn == 3 && wc0 + 32 * a >= dk) continue;  // zero padding
          uint4 qv[RNT][8 / CE];  // 8 elements of a q row, still packed
#pragma unroll
          for (int n = 0; n < RNT; ++n) {
            const int row = 8 * n + gq, col = wc0 + 32 * a + 8 * t;
#pragma unroll
            for (int h = 0; h < 8 / CE; ++h)
              qv[n][h] = *reinterpret_cast<const uint4*>(sl + slab_off<T>(row, col + h * CE, dks));
          }
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            Pc b0[RNT], b1[RNT];
#pragma unroll
            for (int n = 0; n < RNT; ++n) {
              const float2 f = pair_at<T>(qv[n], s);
              b0[n] = pieces<kIn>(f.x);
              b1[n] = pieces<kIn>(f.y);
            }
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              const int nt = 4 * a + s;
              const Pc am[4] = {pieces<kF32>(st[m][nt][0]), pieces<kF32>(st[m][nt][2]),
                                pieces<kF32>(st[m][nt][1]), pieces<kF32>(st[m][nt][3])};
#pragma unroll
              for (int n = 0; n < RNT; ++n) mma_acc<kF32, kIn>(acc[m][n], am, b0[n], b1[n]);
            }
          }
        }
      }
#pragma unroll
      for (int n = 0; n < RNT; ++n) {
        const int i = x * RG + 8 * n + 2 * t;
        const float e0 = expf(Lc[i]), e1 = expf(Lc[i + 1]);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          acc[m][n][0] *= e0;
          acc[m][n][1] *= e1;
          acc[m][n][2] *= e0;
          acc[m][n][3] *= e1;
        }
      }
      // A v over chunk rows j' <= the slab's last row, k-steps split over warps
      const float* Ar = As + (u & 1) * RG * ALD;
      for (int kk = warp; kk < (x + 1) * RNT; kk += kWarps) {
        Pc av[2][4];
        vfrag(av, 8 * kk + 2 * t);
#pragma unroll
        for (int n = 0; n < RNT; ++n) {
          const float2 b = *reinterpret_cast<const float2*>(Ar + (8 * n + gq) * ALD + 8 * kk + 2 * t);
          const Pc b0 = pieces<kF32>(b.x), b1 = pieces<kF32>(b.y);
#pragma unroll
          for (int m = 0; m < 2; ++m) mma_acc<kV, kF32>(acc[m][n], av[m], b0, b1);
        }
      }
      float* rw = red + warp * RED;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < RNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) rw[((m * RNT + n) * 4 + e) * 32 + lane] = acc[m][n][e];
      __syncthreads();
      T* oc = out + ((long long)bh * S + (long long)c * C + x * RG) * dv + j0;
      for (int idx = tid; idx < RED; idx += kThreads) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += red[w * RED + idx];
        const int ln = idx & 31, e = (idx >> 5) & 3, mn = idx >> 7;
        const int m = mn / RNT, n = mn % RNT;
        const int col = 16 * m + (ln >> 2) + 8 * (e >> 1);
        const int row = 8 * n + 2 * (ln & 3) + (e & 1);
        if (j0 + col < dv) oc[(long long)row * dv + col] = from_f<T>(sum);
      }
    } else {
      // ---- S^T <- exp(L_C) S^T + v^T kdec over this slab's chunk rows ----
      const int xr = x - NG;
      const float ltot = Lc[C - 1];
      if (xr == 0) {
        const float ed = expf(ltot);
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < kNT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) st[m][n][e] *= ed;
      }
      if (active) {
#pragma unroll 1
        for (int kk = 0; kk < RNT; ++kk) {
          const int ra = 8 * kk + 2 * t;  // slab rows ra, ra + 1
          const int ia = xr * RG + ra;    // chunk rows
          const float fa = expf(ltot - Lc[ia]), fb = expf(ltot - Lc[ia + 1]);
          Pc av[2][4];
          vfrag(av, ia);
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            if (kIn == 3 && wc0 + 32 * (nt >> 2) >= dk) continue;  // zero padding
            const int col = wc0 + 32 * (nt >> 2) + 8 * (gq >> 1) + 2 * (nt & 3) + (gq & 1);
            const Pc b0 = pieces<kF32>(to_f(sl[slab_off<T>(ra, col, dks)]) * fa);
            const Pc b1 = pieces<kF32>(to_f(sl[slab_off<T>(ra + 1, col, dks)]) * fb);
#pragma unroll
            for (int m = 0; m < 2; ++m) mma_acc<kV, kF32>(st[m][nt], av[m], b0, b1);
          }
        }
      }
    }
    __syncthreads();  // this stage (and the partial sums) are free again
  }

  // the state, stored once: S[dk col][dv col] from S^T's accumulators
  if (active) {
    float* sh = state + (long long)bh * dk * dv;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int dvc = j0 + 16 * m + gq + 8 * (e >> 1);
          const int dkc = wc0 + 32 * (nt >> 2) + 8 * t + 2 * (nt & 3) + (e & 1);
          if (dvc < dv && dkc < dk) sh[(long long)dkc * dv + dvc] = st[m][nt][e];
        }
  }
}

template <typename T, typename TV, int C>
int launch(const void* q, const void* k, const void* v, const float* g, void* out,
           float* state, float* Ls, float* As, int BH, int S, int dk, int dv,
           cudaStream_t stream) {
  const int dks = (dk + kDKW - 1) / kDKW * kDKW;
  const long long bytes = Sweep<T, TV, C>::smem_bytes(dks);
  cudaError_t err = cudaFuncSetAttribute(chunked_linear_attention_kernel<T, TV, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_dk = aligned(q) && aligned(k) && (dk * sizeof(T)) % 16 == 0;
  const int vec_dv = aligned(v) && (dv * sizeof(TV)) % 16 == 0;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  chunked_linear_attention_scores_kernel<T, C>
      <<<dim3(C / 16, S / C, BH), 32 * kScoreWarps, 0, stream>>>(qt, kt, g, Ls, As, S,
                                                                  dk, vec_dk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chunked_linear_attention_kernel<T, TV, C>
      <<<dim3((dv + kTV - 1) / kTV, BH), kThreads, bytes, stream>>>(
          qt, kt, static_cast<const TV*>(v), Ls, As, static_cast<T*>(out), state, S,
          dk, dv, vec_dk, vec_dv);
  return (int)cudaGetLastError();
}

template <typename T, typename TV>
int by_chunk(int chunk, const void* q, const void* k, const void* v, const float* g,
             void* out, float* state, float* Ls, float* As, int BH, int S, int dk,
             int dv, cudaStream_t s) {
  switch (chunk) {
    case 16: return launch<T, TV, 16>(q, k, v, g, out, state, Ls, As, BH, S, dk, dv, s);
    case 32: return launch<T, TV, 32>(q, k, v, g, out, state, Ls, As, BH, S, dk, dv, s);
    case 64: return launch<T, TV, 64>(q, k, v, g, out, state, Ls, As, BH, S, dk, dv, s);
    case 128: return launch<T, TV, 128>(q, k, v, g, out, state, Ls, As, BH, S, dk, dv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, typename TV>
long long smem_by_chunk(int chunk, int dks) {
  switch (chunk) {
    case 16: return Sweep<T, TV, 16>::smem_bytes(dks);
    case 32: return Sweep<T, TV, 32>::smem_bytes(dks);
    case 64: return Sweep<T, TV, 64>::smem_bytes(dks);
    case 128: return Sweep<T, TV, 128>::smem_bytes(dks);
    default: return -1;
  }
}

// The compiled (q / k, v) dtype pairs: 0 = fp16, 1 = bf16, 2 = fp32.  Calls
// F<T, TV>::run(args...), or returns `bad` for a pair that is not compiled.
template <template <typename, typename> class F, typename R, typename... A>
R by_dtypes(int dtype, int vdtype, R bad, A... args) {
  if (dtype == 0 && vdtype == 0) return F<__half, __half>::run(args...);
  if (dtype == 1 && vdtype == 1) return F<__nv_bfloat16, __nv_bfloat16>::run(args...);
  if (dtype == 2 && vdtype == 2) return F<float, float>::run(args...);
  if (dtype == 2 && vdtype == 1) return F<float, __nv_bfloat16>::run(args...);
  if (dtype == 2 && vdtype == 0) return F<float, __half>::run(args...);
  return bad;
}

template <typename T, typename TV>
struct SmemOf {
  static long long run(int chunk, int dks) { return smem_by_chunk<T, TV>(chunk, dks); }
};

template <typename T, typename TV>
struct LaunchOf {
  static int run(int chunk, const void* q, const void* k, const void* v, const float* g,
                 void* out, float* state, float* Ls, float* As, int BH, int S, int dk,
                 int dv, cudaStream_t s) {
    return by_chunk<T, TV>(chunk, q, k, v, g, out, state, Ls, As, BH, S, dk, dv, s);
  }
};

}  // namespace

// Shared memory of one sweep block in bytes (the wrapper checks the
// budget), or -1 for an unsupported dtype pair / chunk.
extern "C" long long cla_smem_bytes(int dtype, int vdtype, int chunk, int dk) {
  const int dks = (dk + kDKW - 1) / kDKW * kDKW;
  return by_dtypes<SmemOf, long long>(dtype, vdtype, -1LL, chunk, dks);
}

// dtype: q, k and out; vdtype: v (0 = fp16, 1 = bf16, 2 = fp32; the pairs
// of `by_dtypes`); g and state fp32.  q, k (BH, S, dk), v / out (BH, S, dv),
// g (BH, S), state (BH, dk, dv), all contiguous; scratch: L (BH, S) and the
// scores (BH, S, chunk), fp32.  Launches the scores kernel, then the sweep,
// on `stream`.  Returns cudaGetLastError() after the launches (0 on success).
extern "C" int chunked_linear_attention(int dtype, int vdtype, int chunk, const void* q,
                                        const void* k, const void* v, const void* g,
                                        void* out, void* state, void* L_scratch,
                                        void* A_scratch, int BH, int S, int dk, int dv,
                                        void* stream) {
  if (dk > kMaxDK) return (int)cudaErrorInvalidValue;
  return by_dtypes<LaunchOf, int>(
      dtype, vdtype, (int)cudaErrorInvalidValue, chunk, q, k, v,
      static_cast<const float*>(g), out, static_cast<float*>(state),
      static_cast<float*>(L_scratch), static_cast<float*>(A_scratch), BH, S, dk, dv,
      static_cast<cudaStream_t>(stream));
}

extern "C" const char* cla_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
