// Shared pieces of the fused decode kernels K4-K6 (Hopper, sm_90a): the
// prologues that make int8 codes from fp32 rows, and the warp-level product
// of 8 code rows with 32 columns of rowpair-packed int4 weights.
//
// Weights: byte r of column n holds the shifted code (c - 8) & 0xF of row 2r
// in its low nibble and of row 2r+1 in its high one, so nib ^ 8 is the
// unsigned code c in [0, 15].  A group g of `gs` rows dequantises to int8 as
// (c - z) * s (= (c4 - (z - 8)) * s with c4 = c - 8), and for any run of rows
// inside one group
//     sum_k x[k] * (c[k] - z) * s = s * (sum_k x[k] * c[k] - z * sum_k x[k]),
// exactly, in int32.  So the kernels multiply raw codes c on the tensor cores
// (mma.sync m16n8k32 s8, c <= 15 fits s8) and apply s and z once per group
// and column with the row sums of the activation codes; the int32 result
// equals the plain version's product with the dequantised weights bit for bit.
//
// The mma runs transposed: its 16 "rows" are weight columns and its 8
// "columns" are activation rows, so a decode step of 4 rows pads to 8, not
// 16.  A lane loads one 32-bit word (4 columns) from each of 4 byte rows of a
// 32-row k step and rearranges the nibbles with byte permutes into the A
// fragments (4 consecutive k of one column per register).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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

// Words A (byte row r) and B (row r + 1), 4 columns each -> q[j] = the codes
// c of rows 2r, 2r+1, 2r+2, 2r+3 of column j, one per byte.
__device__ __forceinline__ void quads(uint32_t A, uint32_t B, uint32_t (&q)[4]) {
  const uint32_t a = A ^ 0x88888888u, b = B ^ 0x88888888u;
  const uint32_t la = a & 0x0F0F0F0Fu, ha = (a >> 4) & 0x0F0F0F0Fu;
  const uint32_t lb = b & 0x0F0F0F0Fu, hb = (b >> 4) & 0x0F0F0F0Fu;
  const uint32_t pa = __byte_perm(la, ha, 0x5140), qa = __byte_perm(la, ha, 0x7362);
  const uint32_t pb = __byte_perm(lb, hb, 0x5140), qb = __byte_perm(lb, hb, 0x7362);
  q[0] = __byte_perm(pa, pb, 0x5410);
  q[1] = __byte_perm(pa, pb, 0x7632);
  q[2] = __byte_perm(qa, qb, 0x5410);
  q[3] = __byte_perm(qa, qb, 0x7632);
}

// One warp unit: 8 activation rows (codes in shared memory at xs, row stride
// ldx, column 0 = weight row k0) times the 32 weight columns [n0, n0 + 32) of
// qw (row stride N bytes), over segments s0, s0 + ds, ... < nseg of `seg`
// rows each (seg % 32 == 0, each segment inside one group of gs rows).
// sx[r * ldsx + s] is the sum of row r's codes over segment s.  Adds into
// tot[p][e] the result of column n0 + 4 (lane / 4) + 2p + e / 2 and row
// 2 (lane % 4) + e % 2.
__device__ __forceinline__ void warp_unit(const uint8_t* __restrict__ qw, int N, int n0, int k0,
                                          int gs, GroupRows sr, GroupRows zr,
                                          const int8_t* xs, int ldx, const int* sx, int ldsx,
                                          int seg, int s0, int nseg, int ds, int (&tot)[2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int col = n0 + 4 * g;
  for (int s = s0; s < nseg; s += ds) {
    const int kseg = k0 + s * seg;
    const int grp = kseg / gs;
    const uint32_t sw = ld32(sr.row(grp) + col), zw = ld32(zr.row(grp) + col);
    int d[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll 4
    for (int kk = 0; kk < seg; kk += 32) {
      const uint8_t* w = qw + static_cast<size_t>((kseg + kk) / 2 + 2 * t) * N + col;
      const uint32_t A = ld32(w), B = ld32(w + N), C = ld32(w + 8 * N), D = ld32(w + 9 * N);
      uint32_t lo[4], hi[4];
      quads(A, B, lo);
      quads(C, D, hi);
      const int8_t* xp = xs + g * ldx + s * seg + kk + 4 * t;
      const uint32_t b0 = ld32(xp), b1 = ld32(xp + 16);
      mma_s8(d[0], lo[0], lo[1], hi[0], hi[1], b0, b1);
      mma_s8(d[1], lo[2], lo[3], hi[2], hi[3], b0, b1);
    }
    const int sx0 = sx[(2 * t) * ldsx + s], sx1 = sx[(2 * t + 1) * ldsx + s];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 2 * p + (e >> 1);
        const int sc = static_cast<int8_t>(sw >> (8 * j));
        const int z = static_cast<int8_t>(zw >> (8 * j));
        tot[p][e] += sc * (d[p][e] - z * ((e & 1) ? sx1 : sx0));
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

// Requant codes round(x / scale) clipped to [qmin, 127] of rows [r0, r0 +
// rows_pad) of x (M, K) into xs; rows past M get zeros.
__device__ __forceinline__ void requant_codes(const float* __restrict__ x, float scale,
                                              float qmin, int M, int K, int r0, int rows_pad,
                                              int8_t* xs, int ldx) {
  const int words = K / 4;
  for (int i = threadIdx.x; i < rows_pad * words; i += THREADS) {
    const int r = i / words, k = 4 * (i % words), m = r0 + r;
    uint32_t code = 0;
    if (m < M) {
      const float4 v = *reinterpret_cast<const float4*>(x + static_cast<size_t>(m) * K + k);
      code = pack4(clamp_code(__fdiv_rn(v.x, scale), qmin),
                   clamp_code(__fdiv_rn(v.y, scale), qmin),
                   clamp_code(__fdiv_rn(v.z, scale), qmin),
                   clamp_code(__fdiv_rn(v.w, scale), qmin));
    }
    *reinterpret_cast<uint32_t*>(xs + r * ldx + k) = code;
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

// ---------------------------------------------------------------------------
// K4 / K5 body: codes of all rows -> (M, N) f32, one block per group of
// 32-column tiles (persistent over tiles), the K walk split over the block's
// warps and summed exactly in shared memory.
// ---------------------------------------------------------------------------

inline size_t gemv_smem(int rows, int K, int gs) {
  return static_cast<size_t>(rows) * (K + XPAD) + static_cast<size_t>(rows) * (K / gs) * 4 +
         static_cast<size_t>(WARPS) * RED * 4;
}

// rows per pass (a multiple of 8) whose shared memory smem(rows) fits; 0 if none
template <typename Smem>
int rows_per_pass(int M, Smem smem) {
  int r = ((M + 7) / 8) * 8;
  while (r > 8 && smem(r) > SMEM_LIMIT) r -= 8;
  return smem(r) <= SMEM_LIMIT ? r : 0;
}

inline int gemv_rows_per_pass(int M, int K, int gs) {
  return rows_per_pass(M, [=](int r) { return gemv_smem(r, K, gs); });
}

struct GemvArgs {
  const float* x;         // (M, K) f32
  const float* lnw;       // K4: (K,) norm weight
  const float* lnb;       // K4: (K,) norm bias or null
  float eps;
  const float* in_scale;  // K5: device scalar
  float qmin;             // K5
  const uint8_t* qw;      // (K/2, N) rowpair bytes
  GroupRows sr, zr;
  const float* alpha;     // (N,)
  const float* beta;      // (N,) or null
  const float* residual;  // K5: (M, N) or null
  float* out;             // (M, N)
  int8_t* codes_out;      // (M, K) or null
  int M, N, K, gs, rows_pass;
};

template <bool NORM>
__device__ __forceinline__ void gemv_body(const GemvArgs& a, uint8_t* smem) {
  const int ldx = a.K + XPAD, G = a.K / a.gs;
  int8_t* xs = reinterpret_cast<int8_t*>(smem);
  int* sx = reinterpret_cast<int*>(smem + static_cast<size_t>(a.rows_pass) * ldx);
  int* red = sx + a.rows_pass * G;
  const int warp = threadIdx.x >> 5, ntiles = a.N / TILE_N;
  for (int r0 = 0; r0 < a.M; r0 += a.rows_pass) {
    const int rows = min(a.rows_pass, a.M - r0), rows_pad = (rows + 7) & ~7, mt = rows_pad / 8;
    if (NORM)
      rmsnorm_codes(a.x, a.lnw, a.lnb, a.eps, a.M, a.K, r0, rows_pad, xs, ldx);
    else
      requant_codes(a.x, *a.in_scale, a.qmin, a.M, a.K, r0, rows_pad, xs, ldx);
    __syncthreads();
    segment_sums(xs, ldx, rows_pad, a.gs, G, sx);
    if (a.codes_out && blockIdx.x == 0) copy_codes(xs, ldx, rows, a.K, r0, a.codes_out);
    __syncthreads();
    const int ks = min(max(1, WARPS / mt), G);  // K slices per m tile
    for (int jt = blockIdx.x; jt < ntiles; jt += gridDim.x) {
      const int n0 = jt * TILE_N;
      if (warp < mt * ks) {
        const int mtile = warp % mt, kslice = warp / mt;
        int tot[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
        warp_unit(a.qw, a.N, n0, 0, a.gs, a.sr, a.zr, xs + mtile * 8 * ldx, ldx,
                  sx + mtile * 8 * G, G, a.gs, kslice, G, ks, tot);
        store_unit(red + warp * RED, tot);
      }
      __syncthreads();
      for (int i = threadIdx.x; i < rows * TILE_N; i += THREADS) {
        const int r = i / TILE_N, c = i % TILE_N, mtile = r / 8;
        int acc = 0;
        for (int q = 0; q < ks; ++q) acc += red[(mtile + q * mt) * RED + (r % 8) * TILE_N + c];
        const int n = n0 + c;
        const size_t o = static_cast<size_t>(r0 + r) * a.N + n;
        float y = epilogue(acc, a.alpha[n], a.beta, n);
        if (a.residual) y = __fadd_rn(y, a.residual[o]);
        a.out[o] = y;
      }
      __syncthreads();
    }
  }
}

// Blocks for `tiles` units of work: at most `per_sm` per SM, spread evenly.
inline int balanced_grid(int tiles, int sms, int per_sm) {
  const int cap = std::max(1, sms * per_sm);
  const int per_block = (tiles + cap - 1) / cap;
  return (tiles + per_block - 1) / per_block;
}

// Lets `kernel` take up to SMEM_LIMIT bytes of dynamic shared memory (the
// default is 48 KB).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(SMEM_LIMIT));
}

template <typename Kernel>
cudaError_t launch_gemv(Kernel kernel, const GemvArgs& a, int sms, cudaStream_t st) {
  const size_t smem = gemv_smem(a.rows_pass, a.K, a.gs);
  cudaError_t err = allow_smem(kernel);
  if (err != cudaSuccess) return err;
  int per_sm = 0;  // blocks that fit on one SM, used up to 4
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  const int grid = balanced_grid(a.N / TILE_N, sms, std::max(1, std::min(per_sm, 4)));
  kernel<<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

// returned by an entry point that rejects its arguments (no CUDA error)
constexpr int BAD_ARGS = -1;

inline bool gemv_shapes_ok(int M, int N, int K, int gs) {
  return M >= 1 && M <= 64 && N % TILE_N == 0 && K % 128 == 0 && gs % 32 == 0 && K % gs == 0;
}

}  // namespace fgemv
