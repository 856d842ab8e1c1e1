// Causal GQA flash attention (forward) for Hopper (sm_90a), on the tensor
// cores (bf16 / fp16), with an fp32 route in SIMT FMAs (at the end).
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py:102, body `_kernel` :31).
//
// What it computes.  q (BHq, S, D), k / v (BHkv, T, D), KV head = q head /
// group.  Online softmax with running max m and sum l; masked scores are
// -1e30 in the reference (here: a masked column contributes exactly 0 and
// the running max starts at -1e30); a KV column is visible when
// col < t_valid and, if causal, col <= q_offset + row; KV tiles that are
// causally dead or lie wholly past t_valid are skipped; a row with no
// visible column (l == 0) stores exact zeros; the output is stored once,
// in q's dtype.
//
// Design.  One block of four warps per (16-row q tile, q head): the
// prefill shape (S 128, 16 q heads) gives 8 x 16 = 128 blocks on the 132
// SMs, causal tiles heaviest first.  The four warps hold the same 16 query
// rows (one m16 MMA tile) and split the KV columns: K and V stream through
// a two-stage `cp.async` ring of 64-row rounds (rows padded by 16 bytes,
// so `ldmatrix` reads are conflict-free; the q tile rides with the first),
// warp w taking rows 16 w .. 16 w + 15 of each round, so a prompt's
// diagonal block walks its KV columns four tiles at a time.  QK^T runs on
// `mma.sync` m16n8k16 (bf16 / fp16 in, fp32 accumulate; q's fragments stay
// in registers, even and odd k-steps in two accumulators); each warp's
// online softmax stays in registers (a row lives in one quad: quad
// shuffles give its max, its sum only at the end); PV runs on the same
// MMA with V fragments from `ldmatrix.trans`.  At the end the four warps'
// (m, l, O) meet in shared memory (the ring's) and each warp scales, sums
// and stores a quarter of the columns.  The KV tile of the engine's bill
// (`tiling.FLASH_BKV`) is the warp's 16 rows: tiles past the causal edge
// or t_valid are skipped at that grain.
//
// Numerics.  QK^T: a bf16 x bf16 (fp16 x fp16) product is exact in fp32,
// so it differs from the reference's fp32 dot only in summation order.
// The weights are exp(s * scale - m) in fp32, as the reference's softmax
// computes them.  PV: the reference multiplies the fp32 P by V; rounding P
// to V's dtype would change the function, so P is split into three pieces
// in V's dtype (each the rest of the last, rounded), which hold all 24
// bits of an fp32 P for bf16 (33 for fp16; a fp16 piece below 2^-14 loses
// bits to subnormals, an absolute error below 2^-25 per weight), and the
// three products go through the MMA into one fp32 accumulator, smallest
// first.  Measured against the plain version on one H100 (chip_smoke.py,
// bf16, prefill shape): max |kernel - plain| 4.9e-4, 1.3e-4 of max |out|,
// below one bf16 ulp of the output (the SIMT kernel this replaces:
// 1.95e-3); in fp32, before the output rounding, P rounded once to bf16 is
// off by 4-7e-4 of max where the pieces are off by ~3e-7
// (tests/test_torch_attn_numerics.py emulates both on the CPU).
//
// What bounds it on an H100.  At the prefill shape the sweep does ~67 MFLOP
// over ~1.3 MB: neither HBM (0.4 us) nor the tensor cores bound it, but
// latency does: the diagonal block of a prompt walks ceil(S / 64) rounds,
// each a load and ~50 MMAs per warp, then the merge.  It takes 5.2 us
// there (H100 80GB HBM3, 700 W; 74 us before; SDPA's kernels 6.0 us).  Split-KV across
// blocks (a second pass merging their (m, l, O)) would start to pay when
// BHq * ceil(S / 16) falls below the SM count while T runs to thousands of
// columns — long caches with few query rows — which the serving path does
// not run (its decode goes through the batched GEMM).  Sharing one KV
// head's tiles between the q heads of its group (GQA) would halve the K / V
// reads, which come from L2 here.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16;                 // q rows per block (one m16 MMA tile)
constexpr int kBKV = 16;                // KV rows per warp and round
constexpr int kRound = kWarps * kBKV;   // KV rows per ring stage
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared in flight until a wait_group; a row past the
// visible range is a plain store of zeros instead, which reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  if (ok)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
                 "l"(src)
                 : "memory");
  else
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col), fp32 accumulate; and the
// pair packing of the element type (element 0 in the low half).
template <typename T> struct Elt;
template <> struct Elt<__nv_bfloat16> {
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float x, float y) {
    __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
  }
};
template <> struct Elt<__half> {
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float x, float y) {
    __half2 h = __floats2half2_rn(x, y);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    return __half22float2(*reinterpret_cast<__half2*>(&u));
  }
};

// Two neighbouring fp32 weights as kPieces pieces packed in T, p[0] the
// big one: each piece is the rest of the last one rounded to T, so three
// bf16 pieces hold all 24 bits of an fp32 weight (three fp16 ones, 33).
constexpr int kPieces = 3;
template <typename T>
__device__ __forceinline__ void split_pair(float x, float y, uint32_t (&p)[kPieces]) {
#pragma unroll
  for (int i = 0; i < kPieces; ++i) {
    p[i] = Elt<T>::pack(x, y);
    const float2 h = Elt<T>::unpack(p[i]);
    x -= h.x;
    y -= h.y;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int S, int T_len,
                     int group, float scale, int t_valid, int q_offset,
                     int causal) {
  constexpr int LD = D + 8;        // padded smem row: 16 bytes more than D
  constexpr int CH = D / 8;        // 16-byte chunks per row
  constexpr int DT = D / 8;        // output n-tiles
  constexpr int KS = D / 16;       // k-steps of QK^T
  constexpr int OLD = D + 8;       // padded row of the merge buffer (floats)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [2][kRound][LD]
  T* vs = ks + 2 * kRound * LD;            // [2][kRound][LD]
  T* qs = vs + 2 * kRound * LD;            // [kBQ][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;  // heavy first
  const int q0 = qt * kBQ;
  const int head = blockIdx.y;
  const int kvh = head / group;
  const T* kh = k + (long long)kvh * T_len * D;
  const T* vh = v + (long long)kvh * T_len * D;

  // visible columns end before min(t_valid, causal edge of the last row)
  int kv_end = t_valid < T_len ? t_valid : T_len;
  const int kv_lim = kv_end;
  if (causal) {
    const int last = q0 + kBQ < S ? q0 + kBQ : S;
    kv_end = kv_end < q_offset + last ? kv_end : q_offset + last;
  }
  const int n_rounds = kv_end > 0 ? (kv_end + kRound - 1) / kRound : 0;

  auto issue = [&](int round) {
    T* kd = ks + (round & 1) * kRound * LD;
    T* vd = vs + (round & 1) * kRound * LD;
    const int r0 = round * kRound;
    for (int e = tid; e < kRound * CH; e += kThreads) {
      const int r = e / CH, c = (e % CH) * 8;
      const bool ok = r0 + r < kv_end;
      const long long off = (long long)(ok ? r0 + r : 0) * D + c;
      cp_async16(kd + r * LD + c, kh + off, ok);
      cp_async16(vd + r * LD + c, vh + off, ok);
    }
  };
  if (n_rounds > 0) {  // the block's 16 q rows ride with the first round
    const T* qh = q + ((long long)head * S + q0) * D;
    for (int e = tid; e < kBQ * CH; e += kThreads) {
      const int r = e / CH, c = (e % CH) * 8;
      const bool ok = q0 + r < S;
      cp_async16(qs + r * LD + c, qh + (ok ? (long long)r * D + c : 0), ok);
    }
    issue(0);
  }
  cp_async_commit();
  uint32_t qa[KS][4];  // q's A fragments for all of D (every warp: all 16 rows)

  float oacc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
  // this warp's running max and its part of the running sum,
  // for rows g (a) and g + 8 (b) of the tile
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  const int row_a = q_offset + q0 + g, row_b = row_a + 8;
  const float neg_inf = __int_as_float(0xff800000);

  for (int it = 0; it < n_rounds; ++it) {
    if (it + 1 < n_rounds) issue(it + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldmatrix_x4(qa[kk], qs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 16 * kk +
                                8 * (lane >> 4));
    }
    const int kv0 = it * kRound + warp * kBKV;  // this warp's 16 KV rows
    if (kv0 < kv_end) {
      const T* kt = ks + (it & 1) * kRound * LD + warp * kBKV * LD;
      const T* vt = vs + (it & 1) * kRound * LD + warp * kBKV * LD;

      // scores: sacc[nt] = q (16 x D) . K[8 nt .. 8 nt + 8)^T, the even and
      // odd k-steps in two accumulators (two chains of MMAs half as long)
      float sacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float sodd[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t b[4];
        ldmatrix_x4(b, kt + (8 * (lane >> 4) + (lane & 7)) * LD + 16 * kk +
                           8 * ((lane >> 3) & 1));
        if (kk % 2) {
          Elt<T>::mma(sodd[0], qa[kk], b[0], b[1]);
          Elt<T>::mma(sodd[1], qa[kk], b[2], b[3]);
        } else {
          Elt<T>::mma(sacc[0], qa[kk], b[0], b[1]);
          Elt<T>::mma(sacc[1], qa[kk], b[2], b[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[nt][e] += sodd[nt][e];

      // online softmax in registers; a masked column becomes -inf, so its
      // weight is exactly 0 (the running max stays finite: >= -1e30)
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = kv0 + 8 * nt + 2 * t + e;
          const bool on = col < kv_lim;
          const bool va = on && (!causal || col <= row_a);
          const bool vb = on && (!causal || col <= row_b);
          const float sa = va ? sacc[nt][e] * scale : neg_inf;
          const float sb = vb ? sacc[nt][2 + e] * scale : neg_inf;
          sacc[nt][e] = sa;
          sacc[nt][2 + e] = sb;
          mx_a = fmaxf(mx_a, sa);
          mx_b = fmaxf(mx_b, sb);
        }
      }
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        sacc[nt][0] = expf(sacc[nt][0] - mn_a);
        sacc[nt][1] = expf(sacc[nt][1] - mn_a);
        sacc[nt][2] = expf(sacc[nt][2] - mn_b);
        sacc[nt][3] = expf(sacc[nt][3] - mn_b);
        ps_a += sacc[nt][0] + sacc[nt][1];
        ps_b += sacc[nt][2] + sacc[nt][3];
      }
      l_a = l_a * al_a + ps_a;
      l_b = l_b * al_b + ps_b;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        oacc[j][0] *= al_a;
        oacc[j][1] *= al_a;
        oacc[j][2] *= al_b;
        oacc[j][3] *= al_b;
      }

      // O += (P_hi + P_lo) V: the two score tiles are the A fragment of
      // the tile's one k-step
      uint32_t pp[4][kPieces];
      split_pair<T>(sacc[0][0], sacc[0][1], pp[0]);
      split_pair<T>(sacc[0][2], sacc[0][3], pp[1]);
      split_pair<T>(sacc[1][0], sacc[1][1], pp[2]);
      split_pair<T>(sacc[1][2], sacc[1][3], pp[3]);
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vt + (8 * ((lane >> 3) & 1) + (lane & 7)) * LD +
                                 8 * (dt + (lane >> 4)));
#pragma unroll
        for (int i = kPieces - 1; i >= 0; --i) {  // the small pieces first
          const uint32_t a[4] = {pp[0][i], pp[1][i], pp[2][i], pp[3][i]};
          Elt<T>::mma(oacc[dt], a, b[0], b[1]);
          Elt<T>::mma(oacc[dt + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  // merge the four warps' (m, l, O) in shared memory (the ring is free)
  float* obuf = reinterpret_cast<float*>(smem_raw);  // [kWarps][kBQ][OLD]
  float* mbuf = obuf + kWarps * kBQ * OLD;           // [kWarps][kBQ]
  float* lbuf = mbuf + kWarps * kBQ;                 // [kWarps][kBQ]
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  {
    float* ow = obuf + warp * kBQ * OLD;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      *reinterpret_cast<float2*>(ow + g * OLD + 8 * j + 2 * t) =
          make_float2(oacc[j][0], oacc[j][1]);
      *reinterpret_cast<float2*>(ow + (g + 8) * OLD + 8 * j + 2 * t) =
          make_float2(oacc[j][2], oacc[j][3]);
    }
    if (t == 0) {
      mbuf[warp * kBQ + g] = m_a;
      mbuf[warp * kBQ + g + 8] = m_b;
      lbuf[warp * kBQ + g] = l_a;
      lbuf[warp * kBQ + g + 8] = l_b;
    }
  }
  __syncthreads();
  // warp w stores columns [w D / 4, (w + 1) D / 4) of the 16 rows: each
  // thread one row r and D / 8 consecutive columns
  constexpr int CW = D / 8;
  const int r = lane >> 1;
  const int c0 = warp * (D / 4) + (lane & 1) * CW;
  float mx = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mbuf[w * kBQ + r]);
  float wt[kWarps], l = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    wt[w] = expf(mbuf[w * kBQ + r] - mx);
    l += wt[w] * lbuf[w * kBQ + r];
  }
  // l == 0: no visible column, every partial O is exactly 0
  const float inv = l == 0.f ? 1.f : 1.f / l;
  if (q0 + r < S) {
    T* orow = o + ((long long)head * S + q0 + r) * D + c0;
#pragma unroll
    for (int c = 0; c < CW; c += 2) {
      float x = 0.f, y = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float2 p = *reinterpret_cast<const float2*>(obuf + (w * kBQ + r) * OLD + c0 + c);
        x += wt[w] * p.x;
        y += wt[w] * p.y;
      }
      *reinterpret_cast<uint32_t*>(orow + c) = Elt<T>::pack(x * inv, y * inv);
    }
  }
}

// The fp32 route: operands the reference's kernel takes in fp32 (its
// `astype(jnp.float32)` of fp32 operands is the identity), in SIMT FMAs
// with fp32 scores, softmax and PV as the reference computes them.  One
// block of four warps per (16-row q tile, q head), as above; each warp
// owns 4 of the 16 query rows.  K and V stream through shared memory in
// tiles of 32 rows: lane j computes row r's score against KV row j (K
// rows padded by one float, so the 32 lanes' reads fall in 32 banks), the
// warp's shuffles give the tile's max and sum, and each lane accumulates
// D / 32 output columns, taking every weight of the tile by shuffle.
// Causally dead columns past the tile's last row and columns past t_valid
// are never loaded; a masked column inside a tile weighs exactly 0.
constexpr int kF32KV = 32;              // KV rows per fp32 tile (one per lane)

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o, int S,
                         int T_len, int group, float scale, int t_valid,
                         int q_offset, int causal) {
  constexpr int RW = kBQ / kWarps;  // query rows per warp
  constexpr int DC = D / 32;        // output columns per lane
  constexpr int LDK = D + 1;        // padded K row
  __shared__ float qs[kBQ][D];
  __shared__ float ks[kF32KV][LDK];
  __shared__ float vs[kF32KV][D];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;  // heavy first
  const int q0 = qt * kBQ;
  const int head = blockIdx.y;
  const int kvh = head / group;
  const float* kh = k + (long long)kvh * T_len * D;
  const float* vh = v + (long long)kvh * T_len * D;
  int kv_end = t_valid < T_len ? t_valid : T_len;
  const int kv_lim = kv_end;
  if (causal) {
    const int last = q0 + kBQ < S ? q0 + kBQ : S;
    kv_end = kv_end < q_offset + last ? kv_end : q_offset + last;
  }

  const float* qh = q + ((long long)head * S + q0) * D;
  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    qs[r][c] = q0 + r < S ? qh[(long long)r * D + c] : 0.f;
  }
  float m[RW], l[RW], acc[RW][DC];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  const float neg_inf = __int_as_float(0xff800000);

  for (int t0 = 0; t0 < kv_end; t0 += kF32KV) {
    __syncthreads();  // the last tile is consumed (and q is stored)
    for (int e = tid; e < kF32KV * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const bool ok = t0 + r < kv_end;
      const long long off = (long long)(ok ? t0 + r : 0) * D + c;
      ks[r][c] = ok ? kh[off] : 0.f;
      vs[r][c] = ok ? vh[off] : 0.f;
    }
    __syncthreads();
    const int col = t0 + lane;
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = warp * RW + i;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(qs[r][d], ks[lane][d], s);
      const bool vis = col < kv_lim && (!causal || col <= q_offset + q0 + r);
      s = vis ? s * scale : neg_inf;
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);  // >= -1e30: a masked weight is 0
      const float al = expf(m[i] - mn);
      const float p = expf(s - mn);
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * al + ps;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= al;
#pragma unroll 8
      for (int j = 0; j < kF32KV; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pj, vs[j][lane + 32 * c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = warp * RW + i;
    if (q0 + r >= S) continue;
    // l == 0: no visible column, the accumulator is exactly 0
    const float inv = l[i] == 0.f ? 1.f : 1.f / l[i];
    float* orow = o + ((long long)head * S + q0 + r) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[lane + 32 * c] = acc[i][c] * inv;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int BHq, int S,
               int T_len, int group, float scale, int t_valid, int q_offset,
               int causal, cudaStream_t stream) {
  const dim3 grid((S + kBQ - 1) / kBQ, BHq);
  flash_fwd_f32_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, T_len, group, scale,
      t_valid, q_offset, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int BHq, int S,
           int T_len, int group, float scale, int t_valid, int q_offset, int causal,
           cudaStream_t stream) {
  constexpr int bytes = (4 * kRound + kBQ) * (D + 8) * (int)sizeof(T);
  static_assert(kWarps * kBQ * (D + 8) * 4 + 2 * kWarps * kBQ * 4 <= bytes,
                "the merge buffers fit the ring");
  static bool sized = false;  // the attribute is set once per instantiation
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, BHq);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, T_len, group, scale, t_valid, q_offset, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp16, 1 = bf16, 2 = fp32; D in {64, 128}.  q (BHq, S, D), k / v
// (BHq / group, T, D), o (BHq, S, D), all contiguous and 16-byte aligned.
// Returns cudaGetLastError() of the launch (0 on success).
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
  if (dtype == 2 && D == 64)
    return launch_f32<64>(q, k, v, o, BHq, S, T, group, scale, t_valid, q_offset, causal, s);
  if (dtype == 2 && D == 128)
    return launch_f32<128>(q, k, v, o, BHq, S, T, group, scale, t_valid, q_offset, causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
