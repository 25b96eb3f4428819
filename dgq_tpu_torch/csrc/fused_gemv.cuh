// K12's MLP entry on span weights, for Hopper (sm_90a): the RMSNormQ
// prologue that makes int8 codes from fp32 rows, the warp-level product of 8
// code rows with 32 weight columns, and the MLP body (mlp_body), templated on
// the weight loader Span.  K4-K6 and K12's norm and requant entries run on
// the TMA + wgmma loop of the W4A8 GEMMs instead (fused_gemv_sm90.cuh); they
// take clamp_code, pack4 and gemv_shapes_ok from here.
//
// Span weights (span = 2 gs): byte row t gs + i holds the code c of row t
// span + i (group 2t) in its high nibble and of row t span + gs + i (group
// 2t+1) in its low one, unshifted.  A group g of `gs` rows dequantises to
// int8 as (c - z) * s, and for any run of rows inside one group
//     sum_k x[k] * (c[k] - z) * s = s * (sum_k x[k] * c[k] - z * sum_k x[k]),
// exactly, in int32.  So the kernels multiply raw codes c on the tensor cores
// (mma.sync m16n8k32 s8, c <= 15 fits s8) and apply s and z once per group
// and column with the row sums of the activation codes; the int32 result
// equals the plain version's product with the dequantised weights bit for bit.
//
// The mma runs transposed: its 16 "rows" are weight columns and its 8
// "columns" are activation rows, so a decode step of 4 rows pads to 8, not
// 16.  A lane loads 32-bit words (4 columns each) of the byte rows of a
// 32-deep k step and rearranges the nibbles with byte permutes into the A
// fragments (4 consecutive k of one column per register).  A span k step
// reads 32 byte rows for 32 rows of group 2t and 32 rows of group 2t+1 at
// once, whose activation codes lie gs apart along K.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fgemv {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TILE_N = 32;    // weight columns of one warp unit
constexpr int RED = 8 * 32;   // int32 results of one warp unit (8 rows x 32 columns)
constexpr int XPAD = 16;      // code row padding in bytes: conflict-free B fragments
constexpr size_t SMEM_LIMIT = 200 * 1024;  // dynamic shared memory a block may take

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Group g's scale (or zero) row: (g odd ? odd : even) + (g / 2) * pair_stride.
// Compact plane rows: even = s_hi, odd = s_lo, pair_stride = N.  8x-replicated
// rows: even = s, odd = s + 8 N, pair_stride = 16 N.
struct GroupRows {
  const int8_t* even;
  const int8_t* odd;
  size_t pair_stride;
  __device__ __forceinline__ const int8_t* row(int g) const {
    return ((g & 1) ? odd : even) + static_cast<size_t>(g >> 1) * pair_stride;
  }
};

// r0..r3: 4 columns of 4 rows, one byte each (row i in word i) -> q[j] = the
// 4 rows of column j, one per byte.
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3,
                                           uint32_t (&q)[4]) {
  const uint32_t p01 = __byte_perm(r0, r1, 0x5140), q01 = __byte_perm(r0, r1, 0x7362);
  const uint32_t p23 = __byte_perm(r2, r3, 0x5140), q23 = __byte_perm(r2, r3, 0x7362);
  q[0] = __byte_perm(p01, p23, 0x5410);
  q[1] = __byte_perm(p01, p23, 0x7632);
  q[2] = __byte_perm(q01, q23, 0x5410);
  q[3] = __byte_perm(q01, q23, 0x7632);
}

constexpr uint32_t LO4 = 0x0F0F0F0Fu;

// A weight loader gives, for one 32-deep k step starting at byte row rb, the
// A fragments a[p][h][j] of each of its PLANES groups p: column col + j, rows
// 4t..4t+3 (h = 0) and 16+4t..16+4t+3 (h = 1) of the step.  STEP_BYTES byte
// rows make one k step.  Span: 32 byte rows hold 32 rows of the even group
// (high nibbles, plane 0) and 32 rows of the odd group (low nibbles, plane 1)
// of one span.
struct Span {
  static constexpr int PLANES = 2;
  static constexpr int STEP_BYTES = 32;
  __device__ __forceinline__ static void frags(const uint8_t* __restrict__ qw, int N, size_t rb,
                                               int col, int t, uint32_t (&a)[2][2][4]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint8_t* w = qw + (rb + 16 * h + 4 * t) * N + col;
      const uint32_t r0 = ld32(w), r1 = ld32(w + N), r2 = ld32(w + 2 * N), r3 = ld32(w + 3 * N);
      transpose4((r0 >> 4) & LO4, (r1 >> 4) & LO4, (r2 >> 4) & LO4, (r3 >> 4) & LO4, a[0][h]);
      transpose4(r0 & LO4, r1 & LO4, r2 & LO4, r3 & LO4, a[1][h]);
    }
  }
};

// Where segment s of a warp unit's walk lies, for plane p: its first byte row
// rb, its group grp, the column xc of its first activation code and the index
// sxc of its row sums.
struct SegPos {
  size_t rb;
  int grp, xc, sxc;
};

// Span over the whole K walk (activation codes in K order, row sums per
// group): segment s = span s, plane p = its group 2s + p.
struct SpanWalk {
  int gs;
  __device__ __forceinline__ SegPos operator()(int s, int p) const {
    const int g = 2 * s + p;
    return {static_cast<size_t>(s) * gs, g, g * gs, g};
  }
};

// One warp unit: 8 activation rows (codes in shared memory at xs, row stride
// ldx) times the 32 weight columns [n0, n0 + 32) of qw (row stride N bytes),
// over segments s0, s0 + ds, ... < nseg of `seg` rows per plane (seg % 32 ==
// 0, each plane's segment inside one group) placed by `at`.  sx[r * ldsx + i]
// is the sum of row r's codes over the run with index i.  Adds into tot[p][e]
// the result of column n0 + 4 (lane / 4) + 2p + e / 2 and row 2 (lane % 4) +
// e % 2.
template <class L, class At>
__device__ __forceinline__ void warp_unit(const uint8_t* __restrict__ qw, int N, int n0, At at,
                                          GroupRows sr, GroupRows zr, const int8_t* xs, int ldx,
                                          const int* sx, int ldsx, int seg, int s0, int nseg,
                                          int ds, int (&tot)[2][4]) {
  constexpr int P = L::PLANES;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int col = n0 + 4 * g;
  for (int s = s0; s < nseg; s += ds) {
    SegPos pos[P];
    uint32_t sw[P], zw[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      pos[p] = at(s, p);
      sw[p] = ld32(sr.row(pos[p].grp) + col);
      zw[p] = ld32(zr.row(pos[p].grp) + col);
    }
    int d[P][2][4] = {};
#pragma unroll 4
    for (int kk = 0; kk < seg; kk += 32) {
      uint32_t a[P][2][4];
      L::frags(qw, N, pos[0].rb + kk / 32 * L::STEP_BYTES, col, t, a);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int8_t* xp = xs + g * ldx + pos[p].xc + kk + 4 * t;
        const uint32_t b0 = ld32(xp), b1 = ld32(xp + 16);
        mma_s8(d[p][0], a[p][0][0], a[p][0][1], a[p][1][0], a[p][1][1], b0, b1);
        mma_s8(d[p][1], a[p][0][2], a[p][0][3], a[p][1][2], a[p][1][3], b0, b1);
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int sx0 = sx[(2 * t) * ldsx + pos[p].sxc], sx1 = sx[(2 * t + 1) * ldsx + pos[p].sxc];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 2 * q + (e >> 1);
          const int sc = static_cast<int8_t>(sw[p] >> (8 * j));
          const int z = static_cast<int8_t>(zw[p] >> (8 * j));
          tot[q][e] += sc * (d[p][q][e] - z * ((e & 1) ? sx1 : sx0));
        }
    }
  }
}

// tot of a warp unit -> red (8 rows x 32 columns, row-major)
__device__ __forceinline__ void store_unit(int* red, const int (&tot)[2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(2 * t + (e & 1)) * TILE_N + 4 * g + 2 * p + (e >> 1)] = tot[p][e];
}

__device__ __forceinline__ int clamp_code(float v, float lo) {
  return static_cast<int>(fminf(fmaxf(rintf(v), lo), 127.0f));
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (a & 0xFF) | ((b & 0xFF) << 8) | ((c & 0xFF) << 16) | (static_cast<uint32_t>(d) << 24);
}

// RMSNormQ codes of rows [r0, r0 + rows_pad) of x (M, K) f32 into xs (row
// stride ldx); rows past M get zeros.  One warp per row; every block sums in
// the same fixed order (lane-strided float4 partials, then an xor butterfly),
// so all blocks make identical codes.  Rounding as the plain version: no fma,
// IEEE division for the mean, half-to-even rounding.
__device__ __forceinline__ void rmsnorm_codes(const float* __restrict__ x,
                                              const float* __restrict__ w,
                                              const float* __restrict__ b, float eps, int M,
                                              int K, int r0, int rows_pad, int8_t* xs, int ldx) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows_pad; r += WARPS) {
    int8_t* dst = xs + r * ldx;
    const int m = r0 + r;
    if (m >= M) {
      for (int k = 4 * lane; k < K; k += 128) *reinterpret_cast<uint32_t*>(dst + k) = 0;
      continue;
    }
    const float* xr = x + static_cast<size_t>(m) * K;
    float ss = 0.0f;
    for (int k = 4 * lane; k < K; k += 128) {
      const float4 v = *reinterpret_cast<const float4*>(xr + k);
      ss = __fadd_rn(ss, __fmul_rn(v.x, v.x));
      ss = __fadd_rn(ss, __fmul_rn(v.y, v.y));
      ss = __fadd_rn(ss, __fmul_rn(v.z, v.z));
      ss = __fadd_rn(ss, __fmul_rn(v.w, v.w));
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xFFFFFFFFu, ss, o));
    const float rs = rsqrtf(__fadd_rn(__fdiv_rn(ss, static_cast<float>(K)), eps));
    for (int k = 4 * lane; k < K; k += 128) {
      const float4 v = *reinterpret_cast<const float4*>(xr + k);
      const float4 wv = *reinterpret_cast<const float4*>(w + k);
      float y[4] = {__fmul_rn(__fmul_rn(v.x, rs), wv.x), __fmul_rn(__fmul_rn(v.y, rs), wv.y),
                    __fmul_rn(__fmul_rn(v.z, rs), wv.z), __fmul_rn(__fmul_rn(v.w, rs), wv.w)};
      if (b) {
        const float4 bv = *reinterpret_cast<const float4*>(b + k);
        y[0] = __fadd_rn(y[0], bv.x);
        y[1] = __fadd_rn(y[1], bv.y);
        y[2] = __fadd_rn(y[2], bv.z);
        y[3] = __fadd_rn(y[3], bv.w);
      }
      *reinterpret_cast<uint32_t*>(dst + k) =
          pack4(clamp_code(y[0], -128.0f), clamp_code(y[1], -128.0f),
                clamp_code(y[2], -128.0f), clamp_code(y[3], -128.0f));
    }
  }
}

// sx[r * nseg + s] = sum of row r's codes over segment s (seg bytes each).
__device__ __forceinline__ void segment_sums(const int8_t* xs, int ldx, int rows, int seg,
                                             int nseg, int* sx) {
  for (int i = threadIdx.x; i < rows * nseg; i += THREADS) {
    const int8_t* p = xs + (i / nseg) * ldx + (i % nseg) * seg;
    int acc = 0;
    for (int k = 0; k < seg; k += 4) acc = __dp4a(static_cast<int>(ld32(p + k)), 0x01010101, acc);
    sx[i] = acc;
  }
}

// codes of rows [r0, r0 + rows) from shared memory to out (row stride K)
__device__ __forceinline__ void copy_codes(const int8_t* xs, int ldx, int rows, int K, int r0,
                                           int8_t* out) {
  const int words = K / 4;
  for (int i = threadIdx.x; i < rows * words; i += THREADS) {
    const int r = i / words, k = 4 * (i % words);
    *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(r0 + r) * K + k) =
        ld32(xs + r * ldx + k);
  }
}

__device__ __forceinline__ float epilogue(int acc, float alpha, const float* beta, int n) {
  const float y = __fmul_rn(static_cast<float>(acc), alpha);
  return beta ? __fadd_rn(y, beta[n]) : y;
}

// rows per pass (a multiple of 8) whose shared memory smem(rows) fits; 0 if none
template <typename Smem>
int rows_per_pass(int M, Smem smem) {
  int r = ((M + 7) / 8) * 8;
  while (r > 8 && smem(r) > SMEM_LIMIT) r -= 8;
  return smem(r) <= SMEM_LIMIT ? r : 0;
}

// Lets `kernel` take up to SMEM_LIMIT bytes of dynamic shared memory (the
// default is 48 KB).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(SMEM_LIMIT));
}

// returned by an entry point that rejects its arguments (no CUDA error)
constexpr int BAD_ARGS = -1;

inline bool gemv_shapes_ok(int M, int N, int K, int gs) {
  return M >= 1 && M <= 64 && N % TILE_N == 0 && K % 128 == 0 && gs % 32 == 0 && K % gs == 0;
}

// ---------------------------------------------------------------------------
// K12's MLP body: the whole LLaMA MLP of M <= 64 rows on span weights.  Each
// block takes 64 columns of F: the RMSNormQ codes of all rows, its gate and
// up columns, the SiLU * up codes of its columns, and the (M, D) int32
// partial of the down product over its 64 rows of Wd, added into an int32
// accumulator with atomics (exact in any order); a second small kernel
// applies the fp32 epilogue once.  A block takes the 32 byte rows [32 b, 32 b
// + 32) of Wd, that is F columns f0 .. f0 + 31 of an even group and f0 + gs
// .. f0 + gs + 31 of the odd group beside it (f0 = 2 gs t + o for byte row
// 32 b = gs t + o), so that its down leg reads both nibbles of the bytes it
// loads.
// ---------------------------------------------------------------------------

constexpr int BF = 64;                // F columns per block
constexpr int NCT = 2 * BF / TILE_N;  // gate and up column tiles of a block

struct MlpArgs {
  const float* x;           // (M, D) f32 residual stream
  const float* lnw;         // (D,)
  const float* lnb;         // (D,) or null
  float eps;
  const float* down_scale;  // device scalar
  const uint8_t* gu_qw;     // (D/2, 2F) bytes, [gate | up]
  GroupRows gu_s, gu_z;
  const float* gu_alpha;    // (2F,)
  const uint8_t* d_qw;      // (F/2, D) bytes
  GroupRows d_s, d_z;
  int* acc;                 // (M, D) int32, zeroed
  int8_t* xq_out;           // (M, D) or null
  int8_t* h_out;            // (M, F) or null
  int M, D, F, gs, rows_pass;
};

// rows of one down-leg segment: one group's part of the block
template <class L>
__host__ __device__ inline int seg_down(int) {
  static_assert(L::PLANES == 2, "span weights");
  return BF / 2;
}

struct MlpLayout {
  size_t xs, sx, red, hs, sxh, total;
};

template <class L>
__host__ __device__ inline MlpLayout mlp_layout(int rows, int D, int gs) {
  const int mt = rows / 8;
  const int units = mt * NCT > WARPS ? mt * NCT : WARPS;
  MlpLayout l;
  l.xs = 0;
  l.sx = l.xs + static_cast<size_t>(rows) * (D + XPAD);
  l.red = l.sx + static_cast<size_t>(rows) * (D / gs) * 4;
  l.hs = l.red + static_cast<size_t>(units) * RED * 4;
  l.sxh = l.hs + static_cast<size_t>(rows) * (BF + XPAD);
  l.total = l.sxh + static_cast<size_t>(rows) * (BF / seg_down<L>(gs)) * 4;
  return l;
}

// F index of column c (0 <= c < BF) of block b
template <class L>
__device__ __forceinline__ int block_col(int b, int c, int gs) {
  const int rb = b * (BF / 2), f0 = 2 * gs * (rb / gs) + rb % gs;
  return c < BF / 2 ? f0 + c : f0 + gs + c - BF / 2;
}

// The down leg: one segment, byte rows [rb, rb + 32) holding the even
// group ge's rows (codes in hs columns [0, 32)) and group ge + 1's ([32, 64)).
struct SpanDown {
  size_t rb;
  int ge;
  __device__ __forceinline__ SegPos operator()(int, int p) const {
    return {rb, ge + p, p * (BF / 2), p};
  }
};

// The block body of the MLP kernel (each .cu wraps it in a named kernel)
template <class L>
__device__ __forceinline__ void mlp_body(const MlpArgs& a, uint8_t* smem) {
  const MlpLayout l = mlp_layout<L>(a.rows_pass, a.D, a.gs);
  int8_t* xs = reinterpret_cast<int8_t*>(smem + l.xs);
  int* sx = reinterpret_cast<int*>(smem + l.sx);
  int* red = reinterpret_cast<int*>(smem + l.red);
  int8_t* hs = reinterpret_cast<int8_t*>(smem + l.hs);
  int* sxh = reinterpret_cast<int*>(smem + l.sxh);
  const int ldx = a.D + XPAD, ldh = BF + XPAD, Gd = a.D / a.gs, nsegd = Gd / L::PLANES;
  const int segd = seg_down<L>(a.gs), nsegh = BF / segd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  const float hscale = *a.down_scale;

  for (int r0 = 0; r0 < a.M; r0 += a.rows_pass) {
    const int rows = min(a.rows_pass, a.M - r0), rows_pad = (rows + 7) & ~7, mt = rows_pad / 8;
    rmsnorm_codes(a.x, a.lnw, a.lnb, a.eps, a.M, a.D, r0, rows_pad, xs, ldx);
    __syncthreads();
    segment_sums(xs, ldx, rows_pad, a.gs, Gd, sx);
    if (a.xq_out && blockIdx.x == 0) copy_codes(xs, ldx, rows, a.D, r0, a.xq_out);
    __syncthreads();

    // gate and up columns of this block: units (m tile, column tile, K slice)
    const int ks = min(max(1, WARPS / (mt * NCT)), nsegd);
    const int units = mt * NCT * ks;
    for (int u = warp; u < units; u += WARPS) {
      const int mtile = u % mt, ct = (u / mt) % NCT, kslice = u / (mt * NCT);
      const int n0 = (ct < NCT / 2 ? 0 : a.F) + block_col<L>(b, (ct % (NCT / 2)) * TILE_N, a.gs);
      int tot[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
      warp_unit<L>(a.gu_qw, 2 * a.F, n0, SpanWalk{a.gs}, a.gu_s, a.gu_z, xs + mtile * 8 * ldx,
                   ldx, sx + mtile * 8 * Gd, Gd, a.gs, kslice, nsegd, ks, tot);
      store_unit(red + u * RED, tot);
    }
    __syncthreads();

    // SiLU(gate) * up -> down-proj input codes of this block
    for (int i = threadIdx.x; i < rows_pad * BF; i += THREADS) {
      const int r = i / BF, c = i % BF, m = r0 + r;
      int code = 0;
      if (m < a.M) {
        const int mtile = r / 8, ctg = c / TILE_N, ctu = NCT / 2 + c / TILE_N;
        const int off = (r % 8) * TILE_N + c % TILE_N, f = block_col<L>(b, c, a.gs);
        int ag = 0, au = 0;
        for (int q = 0; q < ks; ++q) {
          ag += red[(mtile + mt * (ctg + NCT * q)) * RED + off];
          au += red[(mtile + mt * (ctu + NCT * q)) * RED + off];
        }
        const float g = __fmul_rn(static_cast<float>(ag), a.gu_alpha[f]);
        const float up = __fmul_rn(static_cast<float>(au), a.gu_alpha[a.F + f]);
        const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-g)));
        const float h = __fmul_rn(__fmul_rn(g, sig), up);
        code = clamp_code(__fdiv_rn(h, hscale), -128.0f);
        if (a.h_out) a.h_out[static_cast<size_t>(m) * a.F + f] = static_cast<int8_t>(code);
      }
      hs[r * ldh + c] = static_cast<int8_t>(code);
    }
    __syncthreads();
    segment_sums(hs, ldh, rows_pad, segd, nsegh, sxh);
    __syncthreads();

    // down product over this block's BF rows of Wd, all D columns
    const int g4 = lane >> 2, t = lane & 3;
    for (int u = warp; u < mt * (a.D / TILE_N); u += WARPS) {
      const int mtile = u % mt, n0 = (u / mt) * TILE_N;
      int tot[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
      // one segment: byte rows [32 b, 32 b + 32), the even group's codes in
      // columns [0, 32) of hs and the odd group's in [32, 64)
      const SpanDown at{static_cast<size_t>(b) * (BF / 2), block_col<L>(b, 0, a.gs) / a.gs};
      warp_unit<L>(a.d_qw, a.D, n0, at, a.d_s, a.d_z, hs + mtile * 8 * ldh, ldh,
                   sxh + mtile * 8 * nsegh, nsegh, segd, 0, 1, 1, tot);
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = r0 + mtile * 8 + 2 * t + (e & 1);
          if (m < a.M)
            atomicAdd(a.acc + static_cast<size_t>(m) * a.D + n0 + 4 * g4 + 2 * p + (e >> 1),
                      tot[p][e]);
        }
    }
    __syncthreads();
  }
}

// The body of the MLP's epilogue kernel: acc * alpha (+ beta) (+ x) -> out
__device__ __forceinline__ void mlp_epilogue_body(const int* __restrict__ acc, int M, int D,
                                                  const float* __restrict__ alpha,
                                                  const float* __restrict__ beta,
                                                  const float* __restrict__ x, int fuse_residual,
                                                  float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * D) return;
  float y = epilogue(acc[i], alpha[i % D], beta, i % D);
  if (fuse_residual) y = __fadd_rn(y, x[i]);
  out[i] = y;
}

// The host side of K12's MLP entry point (arguments as its C signature):
// `kernel` runs mlp_body<L>, `epi` mlp_epilogue_body.  Returns a cudaError_t,
// or BAD_ARGS.
template <class L, typename Kernel, typename Epilogue>
int launch_mlp(Kernel kernel, Epilogue epi, const void* x, const void* ln_w, const void* ln_b,
               float eps, const void* down_scale, const void* gu_qw, const void* gu_s_hi,
               const void* gu_s_lo, const void* gu_z_hi, const void* gu_z_lo,
               const void* gu_alpha, const void* d_qw, const void* d_ws, const void* d_wz,
               const void* d_alpha, const void* d_beta, int fuse_residual, void* acc, void* out,
               void* xq_out, void* h_out, int M, int D, int F, int gs, void* stream) {
  if (!gemv_shapes_ok(M, 2 * F, D, gs) || F % BF || !down_scale || D % TILE_N) return BAD_ARGS;
  if (D % (2 * gs) || F % (2 * gs)) return BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MlpArgs a{};
  a.x = static_cast<const float*>(x);
  a.lnw = static_cast<const float*>(ln_w);
  a.lnb = static_cast<const float*>(ln_b);
  a.eps = eps;
  a.down_scale = static_cast<const float*>(down_scale);
  a.gu_qw = static_cast<const uint8_t*>(gu_qw);
  const size_t n2f = 2 * static_cast<size_t>(F);
  a.gu_s = {static_cast<const int8_t*>(gu_s_hi), static_cast<const int8_t*>(gu_s_lo), n2f};
  a.gu_z = {static_cast<const int8_t*>(gu_z_hi), static_cast<const int8_t*>(gu_z_lo), n2f};
  a.gu_alpha = static_cast<const float*>(gu_alpha);
  a.d_qw = static_cast<const uint8_t*>(d_qw);
  const int8_t* ws = static_cast<const int8_t*>(d_ws);
  const int8_t* wz = static_cast<const int8_t*>(d_wz);
  a.d_s = {ws, ws + 8 * static_cast<size_t>(D), 16 * static_cast<size_t>(D)};
  a.d_z = {wz, wz + 8 * static_cast<size_t>(D), 16 * static_cast<size_t>(D)};
  a.acc = static_cast<int*>(acc);
  a.xq_out = static_cast<int8_t*>(xq_out);
  a.h_out = static_cast<int8_t*>(h_out);
  a.M = M;
  a.D = D;
  a.F = F;
  a.gs = gs;
  a.rows_pass = rows_per_pass(M, [=](int r) { return mlp_layout<L>(r, D, gs).total; });
  if (a.rows_pass == 0) return BAD_ARGS;
  cudaError_t err = cudaMemsetAsync(acc, 0, static_cast<size_t>(M) * D * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = mlp_layout<L>(a.rows_pass, D, gs).total;
  err = allow_smem(kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<F / BF, THREADS, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = M * D;
  epi<<<(total + 255) / 256, 256, 0, st>>>(
      static_cast<const int*>(acc), M, D, static_cast<const float*>(d_alpha),
      static_cast<const float*>(d_beta), static_cast<const float*>(x), fuse_residual,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fgemv
