// The fused decode GEMVs K4 (fused_norm_gemv_rp.cu) and K5
// (fused_requant_gemv_rp.cu) and the two legs of the fused MLP K6
// (fused_mlp_decode_rp.cu) on rowpair int4 weights, and K12's norm and
// requant entries and the two legs of its MLP on span weights
// (fused_gemv_span_sm90.cu), and the raw int8 GEMV engines of the probe P2
// (int8_gemv_engines.cu, F_RAW below), for Hopper (sm_90a), on the main loop
// of the W4A8 GEMMs (w4a8_gemm_sm90.cuh):
//
//   out[m, n] = float(sum_k q[m, k] * w[k, n]) * alpha[n] (+ beta[n]) (+ res[m, n])
//
// for the M <= 64 rows of a decode step or a verify window, with q the int8
// codes the kernel makes itself (K4 and the MLPs' gate|up legs: RMSNormQ of
// the fp32 rows x; K5: requant of x; the MLPs' down legs: the int8 h codes
// their first leg wrote, copied) and w the int8 dequantisation
// (c4 - (z - 8)) * s of the rowpair nibbles (K12: (c - z) * s of the span
// nibbles) with the compact even/odd group plane rows s_hi/s_lo/z_hi/z_lo
// (group g at (g odd ? lo : hi) + (g / 2) N), or, for the down legs, with
// 8x-replicated scale and zero rows (group g at row 8g).  The body takes
// the order of k in its stages from a Loader (FusedRowpair, FusedSpan
// below).  Each fp32 step of the epilogue is rounded on its own
// (__fmul_rn, __fadd_rn), as the plain versions round.  The gate|up legs
// end in h = clip(round(SiLU(g) * u / down_scale)) instead: a block's 128
// columns are 64 gate columns f and the same 64 up columns F + f (two TMA
// boxes a stage), so it pairs them in shared memory and writes the (M, F)
// int8 h codes that its down leg reads.
//
// What bounds it on this card: the weight bytes, K*N/2, over the 3.35 TB/s of
// device memory; the rows are few.  The design:
//   * the weights stream through K1's TMA ring: one producer thread keeps
//     F_RING stages of 64 packed rows x 128 columns (128 logical k) in
//     flight, each with the scale and zero rows of its two 64-k halves
//     (QS = 1, groupsize % 64 == 0) or four 32-k steps (QS = 2, any
//     groupsize % 32 == 0), signalled by mbarriers; two consumer warpgroups
//     unpack their column pair straight into wgmma A fragments (addresses
//     precomputed, the Loader's frags_at) and release a stage once the
//     products of its last step are issued; the products of one
//     32-k step run while the next step's fragments are built (two fragment
//     sets, as K1);
//   * the codes are the wgmma B operand.  Before its first product a block
//     makes them for its own K range only, once, into shared memory in the
//     layout a TMA box [BM][64 bytes] swizzled 64 bytes has (one box per 64-k
//     half), while the producer's first stages are already in flight.  K4's
//     sum of squares runs over the whole row in rmsnorm_codes' fixed order
//     (lane-strided float4 partials, then the xor butterfly), so every block
//     makes the same codes;
//   * one tile of BM token rows (wgmma N = 8, 16, 32, 48 or 64) holds all M
//     rows: each weight byte is read and unpacked once per call;
//   * K is split over blocks by the plan in Python (ops/fused_decode.py
//     fused_plan); the int32 partials of the splits are summed exactly, in
//     split order, by a second small kernel that also applies the epilogue,
//     launched by the same C entry point;
//   * blocks form clusters of C = 1, 2, 4 or 8 column tiles (same K range).
//     A block makes the codes of the rows r with r % C == its rank (K4: their
//     sums of squares too) and stores them into its peers' shared memory as
//     well (remote stores do not wait; loading from the peers did), so the
//     fp32 rows are read from L2 C times fewer;
//   * a ring of four stages leaves room for the codes of two blocks an SM,
//     which more stages in flight did not repay;
//   * K6 and K12's MLP are two launches of this body (and a combine each
//     when the plan splits K): every weight byte is read once a call, and
//     no block adds into another's sums (no atomics).
//
// P2 runs the body on plain int8 weights (the Loader FusedS8: stages of 128
// rows x 128 columns, no unpack, no scale rows) in its raw mode F_RAW: the
// codes are x's int8 rows, which the producer brings by TMA into the code
// boxes, and the int32 sums are the output.  (Its dp4a engine is a kernel of
// its own over the same ring, in int8_gemv_engines.cu.)  P3 (s4_gemv.cu)
// runs F_RAW on int4 weights two a byte (the Loader FusedS4: stages of 128
// rows x 64 bytes, the nibbles sign-extended in registers), in two column
// maps.  Both sum their K splits with raw_gemv.cuh's gemv_engines_combine.
//
// Everything here has internal linkage (w4a8_gemm_sm90.cuh's rule).

#pragma once

#include "w4a8_gemm_sm90.cuh"

namespace {

constexpr int F_CONSUMERS = 256;            // two consumer warpgroups
constexpr int F_THREADS = F_CONSUMERS + 32;  // and the producer warp
constexpr int F_RING = 4;                    // stages in flight
constexpr int F_W_BYTES = 64 * BN;           // a stage's packed weight rows
constexpr int F_SCL_ROWS = 8;                // room for the scale and zero rows of four 32-k steps
constexpr int F_STAGE = F_W_BYTES + F_SCL_ROWS * BN;  // 9216, 1024-aligned
constexpr int F_HB = 64;                     // bytes of a code box row: one 64-k half
constexpr size_t F_SMEM_LIMIT = 232448;      // dynamic shared memory a block may take

// Dynamic shared memory of a block of bm rows and sps stages, with ring
// stages of `stage` bytes (the Loader's): the codes, the ring, its barriers,
// K4's 64 row scales (F_RAW: the codes' barrier) and the alignment slack
// (ops/fused_decode.py fused_smem).
constexpr size_t fused_smem(int bm, int sps, int stage = F_STAGE) {
  return static_cast<size_t>(bm) * 128 * sps + F_RING * stage + 2 * F_RING * 8 + 256 + 1024;
}

// What a block computes: its codes, weight boxes, scale rows and epilogue.
enum FusedMode {
  F_NORM = 0,     // K4: RMSNormQ codes; fp32 out
  F_REQUANT = 1,  // K5: requant codes; fp32 out (+ residual)
  F_GATE_UP = 2,  // K6 leg 1: RMSNormQ codes; gate and up boxes; h codes out
  F_DOWN = 3,     // K6 leg 2: the h codes; replicated scale rows; fp32 out (+ x)
  F_RAW = 4,      // P2: x's int8 rows by TMA (the map in tm_shi's place); int32 out
};

__host__ __device__ constexpr bool norm_codes(int mode) {
  return mode == F_NORM || mode == F_GATE_UP;
}

struct FusedArgs {
  const float* x;         // (M, K) f32
  const float* lnw;       // K4: (K,) norm weight
  const float* lnb;       // K4: (K,) norm bias or null
  float eps;
  const float* in_scale;  // K5: device scalar
  float qmin;             // K5
  const float* alpha;     // (N,)
  const float* beta;      // (N,) or null
  const float* residual;  // K5: (M, N) or null
  union {
    float* out;           // (M, N)
    int* out_s32;         // F_RAW: (M, N) int32 sums
  };
  int8_t* codes_out;      // (M, K) or null
  const int8_t* h_in;     // K6 leg 2: (M, K) int8 codes
  const float* down_scale;  // K6 leg 1: device scalar
  int8_t* h_out;          // K6 leg 1: (M, N / 2) int8 h codes
  int* part;              // (splits, M, N) int32 when K is split, else null
  int M, N, K, gs;
  int nst, sps;           // stages of 128 k over K; stages per split (blockIdx.y)
};

// ---- clusters and barriers ---------------------------------------------------

// this block's rank in its cluster of column tiles, and the cluster's size
struct ClusterPos {
  uint32_t rank, size;
};

__device__ __forceinline__ ClusterPos cluster_pos() {
  ClusterPos c;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(c.rank));
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(c.size));
  return c;
}

// every thread of every block of the cluster; orders shared memory writes
// before it against reads after it, across the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// the consumer warpgroups alone
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(F_CONSUMERS) : "memory");
}

// the address of `local`'s offset in the shared memory of block `rank` of the cluster
__device__ __forceinline__ uint32_t peer_addr(const void* local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(local)), "r"(rank));
  return remote;
}

__device__ __forceinline__ void st_peer(uint32_t remote, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(remote), "r"(v) : "memory");
}

// ---- the codes ---------------------------------------------------------------

// clip(round(v), lo, 127), rounded half to even as the plain versions round
__device__ __forceinline__ int clamp_code(float v, float lo) {
  return static_cast<int>(fminf(fmaxf(rintf(v), lo), 127.0f));
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (a & 0xFF) | ((b & 0xFF) << 8) | ((c & 0xFF) << 16) | (static_cast<uint32_t>(d) << 24);
}

// Byte offset of code k (local to the block's K range, a multiple of 4) of row
// r: box k / 64 of [BM][64 bytes], swizzled 64 bytes (16-byte chunk index
// XOR bits 7-8 of the offset), as TMA would write it and wgmma reads it.
template <int BM>
__device__ __forceinline__ int code_offset(int r, int k) {
  const int off = r * F_HB + (k & 63);
  return (k >> 6) * BM * F_HB + (off ^ ((off >> 3) & 0x30));
}

// rsqrt(mean(x * x) + eps) of one row, by one warp, in a fixed order
// (chip_smoke.py's _rmsnorm_q_ordered): lane l sums the squares of
// x[4l + 128j .. + 3] for j = 0, 1, ... in turn, then an xor butterfly; the
// loads run U float4 ahead.
__device__ __forceinline__ float row_rsqrt(const float* __restrict__ xr, int K, float eps,
                                           int lane) {
  constexpr int U = 16;
  float ss = 0.0f;
  for (int k0 = 4 * lane; k0 < K; k0 += 128 * U) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (k0 + 128 * u < K) v[u] = *reinterpret_cast<const float4*>(xr + k0 + 128 * u);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (k0 + 128 * u < K) {
        ss = __fadd_rn(ss, __fmul_rn(v[u].x, v[u].x));
        ss = __fadd_rn(ss, __fmul_rn(v[u].y, v[u].y));
        ss = __fadd_rn(ss, __fmul_rn(v[u].z, v[u].z));
        ss = __fadd_rn(ss, __fmul_rn(v[u].w, v[u].w));
      }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xFFFFFFFFu, ss, o));
  return rsqrtf(__fadd_rn(__fdiv_rn(ss, static_cast<float>(K)), eps));
}

// The codes of this block's rows (r < M, r % size == rank; the j-th is row
// rank + size j) over k in [kb, kb + klen), stored at the same offset of
// `codes` in every block of the cluster (remote stores do not wait); the
// first cluster along N also hands them out.  RMSNormQ first takes each
// row's rsqrt over all of K, one warp a row, into rs[j].  Then all consumer
// threads make codes, 4 a word, loading U words before they convert any
// (stores to codes_out could alias x, so the compiler would not hoist the
// loads); K6's down leg copies the words of its h codes.  Rounding as the
// plain versions: no fma, IEEE division, half-to-even rounding.
template <int MODE, int BM>
__device__ __forceinline__ void make_codes(const FusedArgs& a, uint8_t* codes, float* rs, int kb,
                                           int klen, ClusterPos c) {
  constexpr bool NORM = norm_codes(MODE), COPY = MODE == F_DOWN;
  const int cs = static_cast<int>(c.size), r0 = static_cast<int>(c.rank);
  const int own = (a.M - r0 + cs - 1) / cs;  // rows of this block
  if (NORM) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int j = warp; j < own; j += F_CONSUMERS / 32) {
      const float v = row_rsqrt(a.x + static_cast<size_t>(r0 + cs * j) * a.K, a.K, a.eps, lane);
      if (lane == 0) rs[j] = v;
    }
    consumers_sync();
  }
  const bool hand_out = a.codes_out && blockIdx.x < c.size;
  const float scale = NORM || COPY ? 1.0f : *a.in_scale;
  uint32_t peer[8];  // `codes` in each block of the cluster
  for (int p = 0; p < cs; ++p) peer[p] = peer_addr(codes, p);
  const int words = klen / 4, total = own * words;
  constexpr int U = 4;  // words a thread loads before it converts any
  for (int i0 = threadIdx.x; i0 < total; i0 += U * F_CONSUMERS) {
    float4 v[U], wv[U], bv[U];
    uint32_t hw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * F_CONSUMERS;
      if (i >= total) break;
      const int k = kb + 4 * (i % words);
      const size_t row = static_cast<size_t>(r0 + cs * (i / words));
      if constexpr (COPY) {
        hw[u] = *reinterpret_cast<const uint32_t*>(a.h_in + row * a.K + k);
        continue;
      }
      v[u] = *reinterpret_cast<const float4*>(a.x + row * a.K + k);
      if (NORM) {
        wv[u] = *reinterpret_cast<const float4*>(a.lnw + k);
        if (a.lnb) bv[u] = *reinterpret_cast<const float4*>(a.lnb + k);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * F_CONSUMERS;
      if (i >= total) break;
      const int j = i / words, k = 4 * (i % words), r = r0 + cs * j;
      uint32_t word;
      if constexpr (COPY) {
        word = hw[u];
      } else if (NORM) {
        const float rsj = rs[j];
        float y[4] = {__fmul_rn(__fmul_rn(v[u].x, rsj), wv[u].x),
                      __fmul_rn(__fmul_rn(v[u].y, rsj), wv[u].y),
                      __fmul_rn(__fmul_rn(v[u].z, rsj), wv[u].z),
                      __fmul_rn(__fmul_rn(v[u].w, rsj), wv[u].w)};
        if (a.lnb) {
          y[0] = __fadd_rn(y[0], bv[u].x);
          y[1] = __fadd_rn(y[1], bv[u].y);
          y[2] = __fadd_rn(y[2], bv[u].z);
          y[3] = __fadd_rn(y[3], bv[u].w);
        }
        word = pack4(clamp_code(y[0], -128.0f), clamp_code(y[1], -128.0f),
                     clamp_code(y[2], -128.0f), clamp_code(y[3], -128.0f));
      } else {
        word = pack4(clamp_code(__fdiv_rn(v[u].x, scale), a.qmin),
                     clamp_code(__fdiv_rn(v[u].y, scale), a.qmin),
                     clamp_code(__fdiv_rn(v[u].z, scale), a.qmin),
                     clamp_code(__fdiv_rn(v[u].w, scale), a.qmin));
      }
      const int off = code_offset<BM>(r, k);
      *reinterpret_cast<uint32_t*>(codes + off) = word;
      for (int p = 0; p < cs; ++p)
        if (p != r0) st_peer(peer[p] + off, word);
      if (hand_out)
        *reinterpret_cast<uint32_t*>(a.codes_out + static_cast<size_t>(r) * a.K + kb + k) = word;
    }
  }
}

// ---- the order of k in a stage: the Loaders ------------------------------------
//
// A stage is 128 logical k of 128 columns, as two halves h of two 32-k steps
// kk: W_ROWS rows of the weight storage (W_BYTES bytes; the packed Loaders:
// 64 rows of nibble pairs, FusedS8: 128 int8 rows) and room for R scale rows
// (each a scale and a zero row), STAGE bytes in all, in a ring of F_RING
// stages.  The body asks its Loader L for
//   L::scale_group(st, q, a, gsm): the group of scale row q (of R = 2 QS) of
//     stage st, whose plane row the producer brings;
//   L::code_off<BM>(i, st, kk, h, a, kb, gsm): the byte offset in the codes
//     of the 32 k of product (kk, h) of stage st, the block's i-th (their
//     logical k less kb, the block's first, in boxes of 64 k);
// gsm = gs_magic(a.gs) makes a division by the groupsize one multiply-high.
//   L::offsets / L::frags_at: step kk's fragments of both halves, from the
//     thread's rows (rows + T_ROWS t 128) and its precomputed offsets;
//   L::offsets_box64 / L::frags_box64: the same in the gate|up legs' boxes
//     of 64-byte rows (rows_t = box + T_ROWS t 64).
// A gate|up stage holds two boxes [64 rows][64 bytes] swizzled 64 bytes
// (the 16-byte chunk index XOR bits 7-8 of the offset: (row >> 1) & 3),
// gate at 0 and up at GU_BOX; a thread reads column pair cp (0..31) of its
// warpgroup's box.
constexpr int GU_BOX = 64 * 64;

// 0xFFFFFFFF / gs + 1: p / gs == umulhi(p, gs_magic(gs)) for p < 2^32 / gs
__device__ __forceinline__ uint32_t gs_magic(int gs) {
  return 0xFFFFFFFFu / static_cast<uint32_t>(gs) + 1;
}

// Rowpair bytes (K4-K6): stage st is logical k 128 st .. + 127 in order; half h
// is k 128 st + 64 h .. + 63 (RowpairLoader).
template <int QS_>
struct FusedRowpair : RowpairLoader<QS_> {
  static constexpr int QS = QS_, T_ROWS = 2, OFFS = 2;
  static constexpr int W_ROWS = 64, W_BYTES = F_W_BYTES, R = 2 * QS, STAGE = F_STAGE;
  static constexpr bool NIBBLES = false;  // a weight column a byte column (FusedS4: two)

  static __device__ __forceinline__ int scale_group(int st, int q, const FusedArgs& a, uint32_t) {
    return (128 * st + 64 / QS * q) / a.gs;
  }
  template <int BM>
  static __device__ __forceinline__ int code_off(int i, int, int kk, int h, const FusedArgs&, int,
                                                 uint32_t) {
    return (2 * i + h) * BM * F_HB + 32 * kk;
  }
  static __device__ __forceinline__ void offsets(int cp, int t, uint32_t (&off)[OFFS]) {
    RowpairLoader<QS>::pair_offsets(cp, t, off);
  }
  // The rows a thread reads of a 32-k step (2t, 2t + 1, 8 + 2t, 9 + 2t past
  // a multiple of 16) all swizzle by t in a box of 64-byte rows, so one
  // offset serves them.
  static __device__ __forceinline__ void offsets_box64(int cp, int t, uint32_t (&off)[OFFS]) {
    off[0] = (((cp >> 3) ^ t) << 4) | ((cp & 7) << 1);
  }
  // RowpairLoader::frags_at on a box of 64-byte rows: rows_t = box + 2t * 64
  static __device__ __forceinline__ void frags_box64(
      const uint8_t* rows_t, const uint32_t (&off)[OFFS],
      const typename RowpairLoader<QS_>::Scales& sc, int kk, Frags& a) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint8_t* b = rows_t + (32 * h + 16 * kk) * 64 + off[0];
      auto ld = [&](int d) { return *reinterpret_cast<const uint16_t*>(b + d * 64); };
      const uint32_t t01 = __byte_perm(ld(0), ld(1), 0x5410);
      const uint32_t t23 = __byte_perm(ld(8), ld(9), 0x5410);
      const uint32_t c[2] = {__byte_perm(t01, t23, 0x6420), __byte_perm(t01, t23, 0x7531)};
      RowpairLoader<QS>::unpack(c, sc, QS == 1 ? h : 2 * h + kk, a[h]);
    }
  }
};

// Span bytes (K12): step kk of stage st is packed rows p = 64 st + 32 kk ..
// + 31, rows r = p - t gs .. of span t = p / gs (a 32-row step lies inside
// one span, as gs % 32 == 0).  Its high nibbles (half 0) are logical k
// p + t gs .. + 31 of group 2t, its low nibbles (half 1) those k + gs of
// group 2t + 1: plane row t of s_hi/z_hi and of s_lo/z_lo.  This is
// ops/fused_decode.py span_stage_map, which the CPU tests hold against the
// plain version's dequantisation.  QS 1 (groupsize % 64 == 0): both steps lie
// in one span, scale row h; QS 2: scale row 2 kk + h.  A block's K range
// holds whole spans (the plan splits K so), so every k of its stages lies in
// it.  The fragments: rows 4t .. 4t + 3 and 16 + 4t .. + 3 of the step
// (SpanLoader's, whose span_unpack they take), whose swizzle is that of row
// 4t + d, d = 0..3: row & 7 in a stage's 128-byte rows swizzled 128 bytes,
// (row >> 1) & 3 in a gate|up box's 64-byte rows swizzled 64 bytes, where
// d = 0, 1 and d = 2, 3 take two XOR values (a rowpair thread's rows take
// one).  (Lanes t and t + 2 read one 16-byte chunk of two rows, a 2-way
// bank conflict; reading in an order rotated by t / 2 removed it and moved
// no time on the card, so the reads stay plain.)  At small M the offsets'
// arithmetic is not hidden behind the products: with QS 1 it is done once a
// stage.
template <int QS_>
struct FusedSpan {
  static constexpr int QS = QS_, T_ROWS = 4, OFFS = 4;
  static constexpr int W_ROWS = 64, W_BYTES = F_W_BYTES, R = 2 * QS, STAGE = F_STAGE;
  static constexpr bool NIBBLES = false;
  using Scales = typename RowpairLoader<QS>::Scales;

  static __device__ __forceinline__ void scales(const uint8_t* scl, int cp, Scales& sc) {
    RowpairLoader<QS>::scales(scl, cp, sc);
  }
  // the span of packed row p
  static __device__ __forceinline__ int span_of(int p, uint32_t gsm) {
    return static_cast<int>(__umulhi(static_cast<uint32_t>(p), gsm));
  }
  static __device__ __forceinline__ int scale_group(int st, int q, const FusedArgs&, uint32_t gsm) {
    const int kk = QS == 1 ? 0 : q >> 1, h = QS == 1 ? q : q & 1;
    return 2 * span_of(64 * st + 32 * kk, gsm) + h;
  }
  template <int BM>
  static __device__ __forceinline__ int code_off(int, int st, int kk, int h, const FusedArgs& a,
                                                 int kb, uint32_t gsm) {
    if constexpr (QS == 1) {  // gs % 64 == 0: both steps in one span, runs 64-k aligned
      const int p0 = 64 * st;
      const int k0 = p0 + (span_of(p0, gsm) + h) * a.gs - kb;
      return (k0 >> 6) * BM * F_HB + 32 * kk;
    }
    const int p = 64 * st + 32 * kk;
    const int k = p + (span_of(p, gsm) + h) * a.gs - kb;
    return (k >> 6) * BM * F_HB + (k & 63);
  }
  static __device__ __forceinline__ void offsets(int cp, int t, uint32_t (&off)[OFFS]) {
#pragma unroll
    for (int d = 0; d < 4; ++d) off[d] = (((cp >> 3) ^ ((4 * t + d) & 7)) << 4) | ((cp & 7) << 1);
  }
  static __device__ __forceinline__ void offsets_box64(int cp, int t, uint32_t (&off)[OFFS]) {
#pragma unroll
    for (int d = 0; d < 4; ++d)
      off[d] = (((cp >> 3) ^ (((4 * t + d) >> 1) & 3)) << 4) | ((cp & 7) << 1);
  }
  static __device__ __forceinline__ void frags_at(const uint8_t* rows_t, const uint32_t (&off)[OFFS],
                                                  const Scales& sc, int kk, Frags& a) {
    frags_rows<128>(rows_t, off, sc, kk, a);
  }
  static __device__ __forceinline__ void frags_box64(const uint8_t* rows_t,
                                                     const uint32_t (&off)[OFFS],
                                                     const Scales& sc, int kk, Frags& a) {
    frags_rows<64>(rows_t, off, sc, kk, a);
  }
  // step kk's fragments from rows of RB bytes
  template <int RB>
  static __device__ __forceinline__ void frags_rows(const uint8_t* rows_t,
                                                    const uint32_t (&off)[OFFS], const Scales& sc,
                                                    int kk, Frags& a) {
    uint32_t c[2][2];  // the column words of rows 4t.. and 16 + 4t..
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const uint8_t* b = rows_t + (32 * kk + 16 * u) * RB;
      auto ld = [&](int d) { return *reinterpret_cast<const uint16_t*>(b + d * RB + off[d]); };
      const uint32_t t01 = __byte_perm(ld(0), ld(1), 0x5410);
      const uint32_t t23 = __byte_perm(ld(2), ld(3), 0x5410);
      c[u][0] = __byte_perm(t01, t23, 0x6420);
      c[u][1] = __byte_perm(t01, t23, 0x7531);
    }
    const int r = QS == 1 ? 0 : 2 * kk;  // the scale rows of the high and the low plane
    span_unpack(c[0], c[1], sc.s[r], sc.b[r], sc.s[r + 1], sc.b[r + 1], a);
  }
};

// Plain int8 weights (P2, after P1's S8Loader): stage st is rows 128 st ..
// + 127 of w (K, N) in order, a box [128 rows][128 bytes] swizzled 128
// bytes; half h is k 128 st + 64 h .. + 63, one code box, and its step kk
// rows 64 h + 32 kk .. + 31.  A warp's 8 column pairs are one 16-byte
// chunk of each row, so one ldmatrix.x4.trans of 16-bit pairs reads a step
// of a half: lane l gives row l's chunk, and thread (g, t) gets its pair's
// rows 2t, 2t + 1 of each 8 rows (no bank conflict under the swizzle).  The
// fragment slot 4t + j of each 16 k then holds row 2t, 2t + 1, 8 + 2t, 9 +
// 2t for j = 0..3, so order_codes puts the codes of those k in that order
// (the slot order of the B operand; the dot is the same).  No unpack, no
// scale rows; a ring of F_RING stages of 16 KB.
struct FusedS8 {
  static constexpr int T_ROWS = 0, OFFS = 1;
  static constexpr int W_ROWS = 128, W_BYTES = 128 * BN, R = 0, STAGE = W_BYTES;
  static constexpr bool NIBBLES = false;
  struct Scales {};

  static __device__ __forceinline__ void scales(const uint8_t*, int, Scales&) {}
  static __device__ __forceinline__ int scale_group(int, int, const FusedArgs&, uint32_t) {
    return 0;
  }
  template <int BM>
  static __device__ __forceinline__ int code_off(int i, int, int kk, int h, const FusedArgs&, int,
                                                 uint32_t) {
    return (2 * i + h) * BM * F_HB + 32 * kk;
  }
  // the lane's row of a step (lane = 4 (cp % 8) + t) and its swizzled chunk
  static __device__ __forceinline__ void offsets(int cp, int t, uint32_t (&off)[OFFS]) {
    const int lane = 4 * (cp & 7) + t;
    off[0] = lane * 128 + (((cp >> 3) ^ (lane & 7)) << 4);
  }
  static __device__ __forceinline__ void frags_at(const uint8_t* rows, const uint32_t (&off)[OFFS],
                                                  const Scales&, int kk, Frags& a) {
    const uint32_t base = smem_u32(rows) + off[0];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t r[4];  // rows 8 m + 2t, 8 m + 2t + 1 of the step, m = 0..3
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                   : "r"(base + (64 * h + 32 * kk) * 128));
#pragma unroll
      for (int j = 0; j < 2; ++j)
        put_col(a[h], j, __byte_perm(r[0], r[1], j ? 0x7531 : 0x6420),
                __byte_perm(r[2], r[3], j ? 0x7531 : 0x6420));
    }
  }
  // Each 16 codes k0 .. k0 + 15 of a row (a 16-byte chunk, whatever the
  // swizzle) into the slot order of the fragments: slot 4t + j holds k0 +
  // 2t, + 2t + 1, + 8 + 2t, + 9 + 2t.
  static __device__ __forceinline__ void order_codes(uint8_t* codes, int bytes) {
    for (int i = 16 * threadIdx.x; i < bytes; i += 16 * F_CONSUMERS) {
      uint4* p = reinterpret_cast<uint4*>(codes + i);
      const uint4 v = *p;
      *p = make_uint4(__byte_perm(v.x, v.z, 0x5410), __byte_perm(v.x, v.z, 0x7632),
                      __byte_perm(v.y, v.w, 0x5410), __byte_perm(v.y, v.w, 0x7632));
    }
  }
};

// int8 of the signed 4-bit code in the low nibble of each byte (0..15), four
// at once without a carry between the bytes
__device__ __forceinline__ uint32_t s4_to_s8(uint32_t x) {
  return ((x ^ 0x08080808u) + 0x78787878u) ^ 0x80808080u;
}

// a byte of shared memory at a shared address (the ring's base is aligned
// through an integer, which would make a pointer's loads generic)
__device__ __forceinline__ uint32_t lds_u8(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// Int4 weights two a byte (P3): the (K, N / 2) bytes' stage st is rows 128
// st .. + 127, a box [128 rows][64 bytes] swizzled 64 bytes (the 16-byte
// chunk index XOR (row >> 1) & 3): the block's 64 byte columns, its 128
// weight columns, at half FusedS8's bytes.  Thread (cp, t) owns byte column
// cp: its low nibble is the pair's column 0, its high nibble column 1, so
// each byte is read once; the weight map's columns are bytes (n0 / 2).
// Its k slots are FusedS8's (rows 2t, 2t + 1, 8 + 2t, 9 + 2t of each 16, so
// order_codes serves), read a byte at a time: the 8 rows of a step all
// swizzle by t, and the 4 lanes t of one byte column land on 4 chunks, no
// bank conflict.  Hopper's tensor cores take no int4 operand: the nibbles
// become int8 in registers (s4_to_s8).  The columns of byte B (block byte
// n0 / 2 + cp): HALVES 0 (XLA's int4 order, pallas_s4) 2 B and 2 B + 1;
// HALVES 1 (pallas_s4_bitcast) each bn = a.gs columns [low | high] nibbles
// of their bn / 2 bytes, so B's are bn (B / (bn / 2)) + B % (bn / 2) and
// bn / 2 further (F_RAW takes no groupsize; P3 gives bn in its place).
template <bool HALVES>
struct FusedS4 {
  static constexpr int T_ROWS = 0, OFFS = 1;
  static constexpr int W_ROWS = 128, W_BYTES = 128 * 64, R = 0, STAGE = W_BYTES;
  static constexpr bool NIBBLES = true;
  using Scales = FusedS8::Scales;

  static __device__ __forceinline__ void scales(const uint8_t*, int, Scales&) {}
  static __device__ __forceinline__ int scale_group(int, int, const FusedArgs&, uint32_t) {
    return 0;
  }
  template <int BM>
  static __device__ __forceinline__ int code_off(int i, int st, int kk, int h, const FusedArgs& a,
                                                 int kb, uint32_t gsm) {
    return FusedS8::code_off<BM>(i, st, kk, h, a, kb, gsm);
  }
  // byte column cp of row 2t: every row the thread reads is 64 (d + 64 h + 32 kk) further
  static __device__ __forceinline__ void offsets(int cp, int t, uint32_t (&off)[OFFS]) {
    off[0] = 2 * t * 64 + ((((cp >> 4) ^ t) << 4) | (cp & 15));
  }
  static __device__ __forceinline__ void frags_at(const uint8_t* rows, const uint32_t (&off)[OFFS],
                                                  const Scales&, int kk, Frags& a) {
    const uint32_t base = smem_u32(rows) + off[0];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t b = base + (64 * h + 32 * kk) * 64;
      auto word = [&](int d) {  // rows d, d + 1, d + 8, d + 9 past the thread's row 2t
        const uint32_t r0 = lds_u8(b + d * 64), r1 = lds_u8(b + (d + 1) * 64),
                       r2 = lds_u8(b + (d + 8) * 64), r3 = lds_u8(b + (d + 9) * 64);
        return __byte_perm(__byte_perm(r0, r1, 0x0040), __byte_perm(r2, r3, 0x0040), 0x5410);
      };
      const uint32_t w0 = word(0), w16 = word(16);
      put_col(a[h], 0, s4_to_s8(w0 & 0x0F0F0F0Fu), s4_to_s8(w16 & 0x0F0F0F0Fu));
      put_col(a[h], 1, s4_to_s8((w0 >> 4) & 0x0F0F0F0Fu), s4_to_s8((w16 >> 4) & 0x0F0F0F0Fu));
    }
  }
  static __device__ __forceinline__ void order_codes(uint8_t* codes, int bytes) {
    FusedS8::order_codes(codes, bytes);
  }
  // the weight column of nibble j of the block's byte column cp
  static __device__ __forceinline__ int column(int n0, int cp, int j, const FusedArgs& a) {
    const int byte = n0 / 2 + cp;
    if constexpr (!HALVES) return 2 * byte + j;
    const int half = a.gs / 2, blk = byte / half;
    return blk * a.gs + j * half + (byte - blk * half);
  }
};

// ---- the kernel body -----------------------------------------------------------

__device__ __forceinline__ float fused_epilogue(int acc, const FusedArgs& a, int m, int n) {
  float y = __fmul_rn(static_cast<float>(acc), a.alpha[n]);
  if (a.beta) y = __fadd_rn(y, a.beta[n]);
  if (a.residual) y = __fadd_rn(y, a.residual[static_cast<size_t>(m) * a.N + n]);
  return y;
}

// K6's down-input code of gate accumulator ag and up accumulator au of
// column f (F = N / 2), rounded as the plain version rounds: g = ag *
// alpha[f], u = au * alpha[F + f], h = (g * sigmoid(g)) * u with sigmoid
// 1 / (1 + expf(-g)) and IEEE division, then clip(round(h / down_scale)).
__device__ __forceinline__ int silu_code(int ag, int au, const FusedArgs& a, int f, float hscale) {
  const float g = __fmul_rn(static_cast<float>(ag), a.alpha[f]);
  const float up = __fmul_rn(static_cast<float>(au), a.alpha[a.N / 2 + f]);
  const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-g)));
  const float h = __fmul_rn(__fmul_rn(g, sig), up);
  return clamp_code(__fdiv_rn(h, hscale), -128.0f);
}

// One block: 128 weight columns over the stages [sps blockIdx.y, + sps) of
// K, all M rows, with L::R scale rows a stage and the order of k of the
// Loader L (FusedRowpair<QS>, FusedSpan<QS> or FusedS8): for K4, K5, K12,
// K6's down leg and P2 the columns [128 blockIdx.x, + 128), for K6's gate|up
// leg the gate columns [64 blockIdx.x, + 64) and the up columns F + the
// same.  Each .cu wraps it in a named kernel.
template <int MODE, int BM, class L>
__device__ __forceinline__ void fused_gemv_body(const CUtensorMap& tm_w, const CUtensorMap& tm_shi,
                                                const CUtensorMap& tm_slo,
                                                const CUtensorMap& tm_zhi,
                                                const CUtensorMap& tm_zlo, const FusedArgs& a) {
  constexpr bool GU = MODE == F_GATE_UP, RAW = MODE == F_RAW;
  constexpr int R = L::R;     // scale rows a stage
  constexpr int NA = BM / 2;  // accumulators a thread
  static_assert(BM % 8 == 0 && BM <= 64, "tile");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* codes = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* ring = codes + static_cast<size_t>(BM) * 128 * a.sps;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + F_RING * L::STAGE);
  uint64_t* empty = full + F_RING;
  float* rs = reinterpret_cast<float*>(empty + F_RING);  // RMSNormQ: rsqrt of this block's rows
  uint64_t* coded = reinterpret_cast<uint64_t*>(rs);      // F_RAW: the codes have come

  // the block's first weight column: of the gate half and of the up half (GU)
  const int n0 = blockIdx.x * (GU ? BN / 2 : BN), n_up = a.N / 2 + n0;
  const int st0 = blockIdx.y * a.sps, n_it = min(a.nst - st0, a.sps);
  const int kb = 128 * st0, klen = 128 * n_it;  // this block's K range
  const uint32_t gsm = gs_magic(a.gs);           // FusedSpan's division (FusedRowpair: unused)
  const ClusterPos c = cluster_pos();

  if (threadIdx.x == 0) {
    for (int s = 0; s < F_RING; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], F_CONSUMERS / 32);
    }
    if constexpr (RAW) mbar_init(coded, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= F_CONSUMERS) {
    // ---- producer: one thread issues, the warp joins the cluster barriers ----
    const bool issuer = threadIdx.x == F_CONSUMERS;
    auto issue = [&](int i) {
      const int s = i % F_RING, st = st0 + i;
      uint8_t* base = ring + s * L::STAGE;
      mbar_expect_tx(&full[s], L::W_BYTES + 2 * R * BN);
      tma_load_2d(base, &tm_w, &full[s], L::NIBBLES ? n0 / 2 : n0, L::W_ROWS * st);
      if constexpr (GU) tma_load_2d(base + GU_BOX, &tm_w, &full[s], n_up, 64 * st);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int g = L::scale_group(st, q, a, gsm);
        // compact plane rows, or (K6's down leg) row 8g of the replicated ones
        const int row = MODE == F_DOWN ? 8 * g : g >> 1;
        const CUtensorMap* ms = (g & 1) ? &tm_slo : &tm_shi;
        const CUtensorMap* mz = (g & 1) ? &tm_zlo : &tm_zhi;
        uint8_t* scl = base + L::W_BYTES + 2 * q * BN;
        if constexpr (GU) {
          // the gate and the up columns' 64 bytes side by side in one 128-byte
          // row (TMA writes to 128-byte aligned shared memory only)
          tma_load_3d(scl, ms, &full[s], n0, 0, row);
          tma_load_3d(scl + BN, mz, &full[s], n0, 0, row);
        } else {
          tma_load_2d(scl, ms, &full[s], n0, row);
          tma_load_2d(scl + BN, mz, &full[s], n0, row);
        }
      }
    };
    if constexpr (RAW) {
      // x's rows over the block's K range, one box [BM][64] swizzled 64 bytes
      // a 64-k half, as code_offset lays the codes out (rows past M: zeros)
      if (issuer) {
        mbar_expect_tx(coded, BM * klen);
        for (int h = 0; h < klen / 64; ++h)
          tma_load_2d(codes + h * BM * F_HB, &tm_shi, coded, kb + 64 * h, 0);
      }
    }
    if (issuer)
      for (int i = 0; i < min(n_it, F_RING); ++i) issue(i);
    __syncwarp();
    cluster_sync();  // the consumers': the codes are made

    if (issuer)
      for (int i = F_RING; i < n_it; ++i) {
        mbar_wait(&empty[i % F_RING], ((i / F_RING) + 1) & 1);
        issue(i);
      }
    return;
  }

  // ---- consumers: the codes ----
  if constexpr (RAW) {
    mbar_wait(coded, 0);  // x's rows, put in the fragments' slot order
    L::order_codes(codes, BM * klen);
  } else {
    make_codes<MODE, BM>(a, codes, rs, kb, klen, c);
  }
  fence_async_smem();
  cluster_sync();     // every block's codes are in every block
  fence_async_smem();  // the peers' stores too, for wgmma

  // ---- the main loop ----
  const int ct = threadIdx.x, wg = ct >> 7, warp = (ct >> 5) & 3, lane = ct & 31;
  const int t = lane & 3;
  const int cp = 32 * wg + 8 * warp + (lane >> 2);  // this thread's column pair of the block's 64
  uint32_t off[L::OFFS];
  if constexpr (GU)
    L::offsets_box64(cp & 31, t, off);  // of its warpgroup's box: gate (0) or up (1)
  else
    L::offsets(cp, t, off);
  // the first product writes the accumulators (scale-d 0): no other
  // instruction defines them, which would make ptxas serialise the wgmmas
  int acc[NA];
  // two fragment sets, one per 32-k step of a half: the tensor cores run one
  // step's products while the next step's fragments are built
  Frags fk[2];
  for (int i = 0; i < n_it; ++i) {
    const int s = i % F_RING;
    mbar_wait(&full[s], (i / F_RING) & 1);
    const uint8_t* rows = ring + s * L::STAGE;
    typename L::Scales sc;
    L::scales(rows + L::W_BYTES, cp, sc);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      if constexpr (GU)
        L::frags_box64(rows + wg * GU_BOX + L::T_ROWS * t * 64, off, sc, kk, fk[kk]);
      else
        L::frags_at(rows + L::T_ROWS * t * 128, off, sc, kk, fk[kk]);
#pragma unroll
      for (int h = 0; h < 2; ++h) fence_regs(fk[kk][h]);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h)
        Wgmma<BM>::mma(acc, fk[kk][h],
                       gmma_desc(codes + L::template code_off<BM>(i, st0 + i, kk, h, a, kb, gsm),
                                 F_HB),
                       (i | kk | h) != 0);
      wgmma_commit();
      wgmma_wait<1>();  // the step before is done: its fragment set is free
      fence_regs(acc);
      // the stage's last products are issued, so the loads that built their
      // fragments have returned: release its slot.  (Released right after
      // the fragments were built, ptxas issued the arrive with the generic
      // loads still in flight, and a load queued behind another block's
      // global loads could return the bytes of the stage refilled over it.)
      if (kk == 1 && lane == 0) mbar_arrive(&empty[s]);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // ---- epilogue: accumulator e is column 2 cp + ((e >> 1) & 1) and token row
  // 8 (e >> 2) + 2t + (e & 1); a K split leaves int32 partials ----
  if constexpr (GU) {
    // a tile past F, which rounds the grid up to whole clusters, writes
    // nothing (its gate box holds up columns)
    if (n0 >= a.N / 2) return;
    // column f = n0 + 2 (cp % 32) (+ 1) of the gate half (warpgroup 0) or of
    // the up half (warpgroup 1); the same thread of each holds the same f
    const int f = n0 + 2 * (cp & 31);
    if (a.part) {
      int* pz = a.part + static_cast<size_t>(blockIdx.y) * a.M * a.N + (wg ? n_up - n0 : 0) + f;
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int e0 = 0; e0 < 2; ++e0) {
          const int m = 8 * j + 2 * t + e0;
          if (m < a.M)
            *reinterpret_cast<int2*>(pz + static_cast<size_t>(m) * a.N) =
                make_int2(acc[4 * j + e0], acc[4 * j + 2 + e0]);
        }
      return;
    }
    // warpgroup 1 hands its up sums to warpgroup 0 through the ring, which
    // every consumer has finished reading
    consumers_sync();
    int* ups = reinterpret_cast<int*>(ring) + (ct & 127);
    if (wg == 1) {
#pragma unroll
      for (int e = 0; e < NA; ++e) ups[e * 128] = acc[e];
    }
    consumers_sync();
    if (wg == 1) return;
    const float hscale = *a.down_scale;
    const int F = a.N / 2;
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e0 = 0; e0 < 2; ++e0) {
        const int m = 8 * j + 2 * t + e0;
        if (m >= a.M) continue;
        const int e = 4 * j + e0;
        char2 h;
        h.x = static_cast<int8_t>(silu_code(acc[e], ups[e * 128], a, f, hscale));
        h.y = static_cast<int8_t>(silu_code(acc[e + 2], ups[(e + 2) * 128], a, f + 1, hscale));
        *reinterpret_cast<char2*>(a.h_out + static_cast<size_t>(m) * F + f) = h;
      }
    return;
  }
  if constexpr (L::NIBBLES) {  // int32 sums to the columns of the byte's two nibbles
    if (n0 / 2 + cp >= a.N / 2) return;
    const int c0 = L::column(n0, cp, 0, a), c1 = L::column(n0, cp, 1, a);
    int* dst = a.part ? a.part + static_cast<size_t>(blockIdx.y) * a.M * a.N : a.out_s32;
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e0 = 0; e0 < 2; ++e0) {
        const int m = 8 * j + 2 * t + e0;
        if (m >= a.M) continue;
        dst[static_cast<size_t>(m) * a.N + c0] = acc[4 * j + e0];
        dst[static_cast<size_t>(m) * a.N + c1] = acc[4 * j + 2 + e0];
      }
    return;
  }
  const int n = n0 + 2 * cp;
  if (n >= a.N) return;
#pragma unroll
  for (int j = 0; j < BM / 8; ++j)
#pragma unroll
    for (int e0 = 0; e0 < 2; ++e0) {
      const int m = 8 * j + 2 * t + e0;
      if (m >= a.M) continue;
      const int v0 = acc[4 * j + e0], v1 = acc[4 * j + 2 + e0];
      const size_t o = static_cast<size_t>(m) * a.N + n;
      if (a.part)
        *reinterpret_cast<int2*>(a.part + static_cast<size_t>(blockIdx.y) * a.M * a.N + o) =
            make_int2(v0, v1);
      else if constexpr (RAW)
        *reinterpret_cast<int2*>(a.out_s32 + o) = make_int2(v0, v1);
      else
        *reinterpret_cast<float2*>(a.out + o) =
            make_float2(fused_epilogue(v0, a, m, n), fused_epilogue(v1, a, m, n + 1));
    }
}

// The K splits' int32 partials summed in split order, then the epilogue.
__device__ __forceinline__ void fused_combine_body(const FusedArgs& a, int splits) {
  const size_t total = static_cast<size_t>(a.M) * a.N;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int s = 0;
  for (int z = 0; z < splits; ++z) s += a.part[z * total + i];
  a.out[i] = fused_epilogue(s, a, static_cast<int>(i / a.N), static_cast<int>(i % a.N));
}

// K6's gate|up leg: the splits' gate and up partials of (m, f) summed in
// split order, then its h code.
__device__ __forceinline__ void gate_up_combine_body(const FusedArgs& a, int splits) {
  const int F = a.N / 2;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(a.M) * F) return;
  const size_t total = static_cast<size_t>(a.M) * a.N;
  const int m = static_cast<int>(i / F), f = static_cast<int>(i % F);
  const int* p = a.part + static_cast<size_t>(m) * a.N + f;
  int g = 0, u = 0;
  for (int z = 0; z < splits; ++z) {
    g += p[z * total];
    u += p[z * total + F];
  }
  a.h_out[i] = static_cast<int8_t>(silu_code(g, u, a, f, *a.down_scale));
}

// ---- host side ------------------------------------------------------------------

constexpr int F_BAD_ARGS = -1;  // an entry point's own argument checks

// The plan's arguments, checked: bm one of the tiles and >= M; splits of sps
// stages covering K; clusters of 1, 2, 4 or 8 column tiles; the shapes the plain
// versions take (M 1..64, N % 32, K % 128, groupsize % 32 dividing K / 2).
inline bool fused_args_ok(const FusedArgs& a, int bm, int splits, int cluster) {
  return a.M >= 1 && a.M <= 64 && a.N % 32 == 0 && a.K % 128 == 0 && a.gs > 0 &&
         a.gs % 32 == 0 && a.K % (2 * a.gs) == 0 &&
         (bm == 8 || bm == 16 || bm == 32 || bm == 48 || bm == 64) && bm >= a.M && a.sps >= 1 &&
         splits == (a.nst + a.sps - 1) / a.sps && (splits == 1) == (a.part == nullptr) &&
         (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8) &&
         fused_smem(bm, a.sps) <= F_SMEM_LIMIT;
}

// Launches Kern's kernel of tile BM and QS scale rows a half over the grid
// (column tiles rounded up to the cluster, splits) in clusters of `cluster`
// column tiles and, when K is split, Kern's combine.  The weight box is
// [64 rows][128 columns] swizzled 128 bytes, or K6's gate|up pair of
// [64][64] boxes swizzled 64 bytes; the scale rows are compact planes
// (G / 2 rows each), or K6's down leg's 8x-replicated rows (8 G; planes =
// {s, s, z, z}).  Returns a cudaError_t.
template <class Kern, int BM, int QS>
int launch_fused_tile(const FusedArgs& a, int splits, int cluster, const void* qw,
                      const void* const (&planes)[4], cudaStream_t st) {
  constexpr int MODE = Kern::MODE;
  constexpr uint32_t box = MODE == F_GATE_UP ? BN / 2 : BN;
  const uint64_t scale_rows = MODE == F_DOWN ? 8ull * (a.K / a.gs) : a.K / a.gs / 2;
  CUtensorMap tw, tp[4];
  int rc = tensor_map(&tw, qw, a.N, a.K / 2, box, 64,
                      MODE == F_GATE_UP ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
  // K6's gate|up: a row's gate half and up half in one box (see tensor_map)
  for (int i = 0; i < 4 && !rc; ++i)
    rc = tensor_map(&tp[i], planes[i], a.N, scale_rows, box, 1, CU_TENSOR_MAP_SWIZZLE_NONE,
                    MODE == F_GATE_UP ? a.N / 2 : 0);
  if (rc) return rc;
  auto kernel = Kern::template gemv<BM, QS>();
  // devices whose limit is raised: one set per instantiation, so per kernel
  static uint64_t sized = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(sized >> (dev & 63) & 1)) {
    // the most shared memory a block may take, and an SM's carveout all
    // shared memory, so that two blocks share an SM where the plan says so
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(F_SMEM_LIMIT));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized |= 1ull << (dev & 63);
  }
  const int tiles = ((a.N + BN - 1) / BN + cluster - 1) / cluster * cluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, splits, 1);
  cfg.blockDim = dim3(F_THREADS, 1, 1);
  cfg.dynamicSmemBytes = fused_smem(BM, a.sps);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, tw, tp[0], tp[1], tp[2], tp[3], a);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (splits > 1) {
    // an output a thread: (M, N) sums, or the gate|up leg's (M, N / 2) h codes
    const size_t total = static_cast<size_t>(a.M) * (MODE == F_GATE_UP ? a.N / 2 : a.N);
    Kern::combine()<<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(a, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class Kern, int QS>
int launch_fused_qs(const FusedArgs& a, int bm, int splits, int cluster, const void* qw,
                    const void* const (&planes)[4], cudaStream_t st) {
  switch (bm) {
    case 8:
      return launch_fused_tile<Kern, 8, QS>(a, splits, cluster, qw, planes, st);
    case 16:
      return launch_fused_tile<Kern, 16, QS>(a, splits, cluster, qw, planes, st);
    case 32:
      return launch_fused_tile<Kern, 32, QS>(a, splits, cluster, qw, planes, st);
    case 48:
      return launch_fused_tile<Kern, 48, QS>(a, splits, cluster, qw, planes, st);
    default:
      return launch_fused_tile<Kern, 64, QS>(a, splits, cluster, qw, planes, st);
  }
}

// The host side of the entry points: Kern (a struct with its FusedMode
// `MODE`, `template <int BM, int QS> static auto gemv()` and `static auto
// combine()`, the .cu's kernels) at the plan's tile, with one scale row per
// 64-k half when the groupsize allows it.  Returns a cudaError_t, or
// F_BAD_ARGS.
template <class Kern>
int launch_fused(const FusedArgs& a, int bm, int splits, int cluster, const void* qw,
                 const void* const (&planes)[4], cudaStream_t st) {
  if (!fused_args_ok(a, bm, splits, cluster)) return F_BAD_ARGS;
  if (a.gs % 64 == 0) return launch_fused_qs<Kern, 1>(a, bm, splits, cluster, qw, planes, st);
  return launch_fused_qs<Kern, 2>(a, bm, splits, cluster, qw, planes, st);
}

// A plan of one leg of an MLP: token rows, K splits, stages a split,
// cluster, and the int32 partials of a K split (null unsplit).
struct LegPlan {
  int bm, splits, sps, cluster;
  void* part;
};

// K6's and K12's MLP (fused_mlp_decode_rp.cu, fused_gemv_span_sm90.cu):
// the gate|up leg GU, (M, 2F) over K = D on RMSNormQ codes, writes the
// (M, F) h codes; then the down leg DN, (M, D) over K = F on those codes,
// writes acc * alpha_d (+ beta_d) (+ x).  Both legs' arguments and plans
// pass `ok` (the layout's checks) before either launches.  Returns a
// cudaError_t, or F_BAD_ARGS.
template <class GU, class DN, class Ok>
int launch_mlp(Ok ok, const void* x, const void* ln_w, const void* ln_b, float eps,
               const void* down_scale, const void* gu_qw, const void* const (&gu_planes)[4],
               const void* gu_alpha, const void* d_qw, const void* d_ws, const void* d_wz,
               const void* d_alpha, const void* d_beta, int fuse_residual, void* out,
               void* xq_out, void* h_out, int M, int D, int F, int gs, const LegPlan& p1,
               const LegPlan& p2, cudaStream_t st) {
  if (!ln_w || !down_scale || !h_out || F % 64) return F_BAD_ARGS;
  FusedArgs g{};
  g.x = static_cast<const float*>(x);
  g.lnw = static_cast<const float*>(ln_w);
  g.lnb = static_cast<const float*>(ln_b);
  g.eps = eps;
  g.alpha = static_cast<const float*>(gu_alpha);
  g.codes_out = static_cast<int8_t*>(xq_out);
  g.down_scale = static_cast<const float*>(down_scale);
  g.h_out = static_cast<int8_t*>(h_out);
  g.part = static_cast<int*>(p1.part);
  g.M = M;
  g.N = 2 * F;
  g.K = D;
  g.gs = gs;
  g.nst = D / 128;
  g.sps = p1.sps;
  FusedArgs d{};
  d.h_in = static_cast<const int8_t*>(h_out);
  d.alpha = static_cast<const float*>(d_alpha);
  d.beta = static_cast<const float*>(d_beta);
  d.residual = fuse_residual ? static_cast<const float*>(x) : nullptr;
  d.out = static_cast<float*>(out);
  d.part = static_cast<int*>(p2.part);
  d.M = M;
  d.N = D;
  d.K = F;
  d.gs = gs;
  d.nst = F / 128;
  d.sps = p2.sps;
  if (!ok(g, p1.bm, p1.splits, p1.cluster) || !ok(d, p2.bm, p2.splits, p2.cluster))
    return F_BAD_ARGS;
  const void* const d_planes[4] = {d_ws, d_ws, d_wz, d_wz};
  const int rc = launch_fused<GU>(g, p1.bm, p1.splits, p1.cluster, gu_qw, gu_planes, st);
  if (rc) return rc;
  return launch_fused<DN>(d, p2.bm, p2.splits, p2.cluster, d_qw, d_planes, st);
}

}  // namespace
