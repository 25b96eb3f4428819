// K9 and K10: W4A8 GEMMs on span-packed int4 weights, for Hopper (sm_90a).
//
// Replaces the TPU kernels of dgq_tpu/ops/quant_matmul.py:
//   K9  w4a8_matmul_packed (body _kernel), and with it K14 w4a8_matmul_wres
//       and w4a8_matmul_pipe, which compute K9's function with another tiling
//       (dequantise once per weight block; dequantise one block ahead);
//   K10 w4a8_fpscale_matmul_packed (body _fpscale_kernel).
//
// Span layout, span = 2 * gs: packed row p = t * gs + r (span t, row r of its
// gs packed rows) holds in its high nibble the code of logical row
// t * span + r (group 2t) and in its low nibble the code of logical row
// t * span + gs + r (group 2t + 1).  Codes are unsigned 0..15 and the zeros
// are not shifted (the rowpair layout of K1 stores c - 8).
//
// K9:  acc[m, n] = sum_k x[m, k] * w[k, n] in exact int32, w the int8
//      dequantisation (c - z) * s with int8 group scale s and zero z; then
//      y = acc * alpha[n] (+ beta[n]) with __fmul_rn / __fadd_rn (no FMA
//      contraction), stored as f32 or rounded half to even (__float2int_rn, as
//      torch.round) and clamped to int8.  Bit-equal to the plain version.
//      The main loop is w4a8_gemm_sm90.cuh's (TMA ring, wgmma with the weights
//      as register fragments, the K split); SpanLoader below turns a stage of
//      PR packed rows into two halves of PR logical k: the high plane (one
//      group) and the low plane (the next), each with its own x box, gs rows
//      apart in x.  int32 sums do not depend on the order of k, so the
//      permuted order is exact.  PR = 64 when groupsize % 64 == 0, else 32
//      (a stage must lie inside one span).
// K10: fp32 group scales and zeros.  Per group g an exact int32 dot d_g of x
//      with the raw codes, and
//        acc[m, n] = sum_g s_g[n] * (d_g[m, n] - z_g[n] * rowsum_g(x[m])),
//      summed in group order in fp32 (__fmul_rn, __fsub_rn, __fadd_rn), then
//      y = acc * alpha (+ beta).  Unsplit, bit-equal to the plain version,
//      which takes the same steps; when K is split over blocks (small M), each
//      split sums its own groups from 0 and a second kernel adds the splits in
//      order, so the fp32 sum is reassociated at the split boundaries.
//      K10 keeps the mma.sync body of the port's first span kernel: each K
//      tile of 32 packed rows is unpacked into a shared tile of the raw codes,
//      the high plane then the low plane, one int32 accumulator per plane,
//      flushed into the fp32 sum at the end of each span, with the row sums of
//      x over each plane's rows taken from the shared x tile.  Small-M calls
//      take a 16-row tile and split K over blocks (the split comes from
//      fpscale_plan in ops/quant_matmul.py).
//
// What bounds them on this card: at decode (M = batch rows <= 16) the weight
// bytes, K*N/2, over the 3.35 TB/s of device memory; at prefill (M >= 1024)
// the int8 tensor-core rate.

#include "s8_mma.cuh"  // K10's mma.sync step
#include "w4a8_gemm_sm90.cuh"

namespace {

// ---- K9 ----------------------------------------------------------------------

// Stage st: packed rows PR st .. + PR - 1, inside span t at row r0.  Half 0
// is the high plane, x's k 2 t gs + r0 .. + PR - 1 (group 2t); half 1 the low
// plane, gs further (group 2t + 1).  The 32-k step kk of both halves is packed
// rows 32 kk .. + 31, and a thread's k 4t .. 4t + 3 and 16 + 4t .. + 3 are
// rows 32 kk + 4t .. and 32 kk + 16 + 4t ..: two permutes of 4 rows give
// both planes' fragment words of each column.
template <int PR>
struct SpanLoader {
  static constexpr int HB = PR, SRC_ROWS = PR;
  static constexpr bool SCALED = true;
  struct Scales {
    uint32_t s[2][2], b[2][2];  // per plane, per column of the pair
  };

  static __device__ __forceinline__ int x_k(const GemmArgs& a, int st, int h) {
    const int p0 = PR * st, t = p0 / a.gs;
    return 2 * t * a.gs + (p0 - t * a.gs) + h * a.gs;
  }
  static __device__ __forceinline__ int group(const GemmArgs& a, int st, int h) {
    return 2 * (PR * st / a.gs) + h;
  }

  static __device__ __forceinline__ void scales(const uint8_t* scl, int cp, Scales& sc) {
    col_scales(scl, 0, cp, sc.s[0], sc.b[0]);
    col_scales(scl, 1, cp, sc.s[1], sc.b[1]);
  }

  static __device__ __forceinline__ void frags(const uint8_t* rows, const Scales& sc, int cp, int t,
                                               int kk, Frags& a) {
    constexpr uint32_t M4 = 0x000F000F;
    uint32_t c0[2], c16[2];
    quad(rows, cp, 32 * kk + 4 * t, 1, 2, 3, c0);
    quad(rows, cp, 32 * kk + 16 + 4 * t, 1, 2, 3, c16);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      put_col(a[0], j, deq4((c0[j] >> 4) & M4, (c0[j] >> 12) & M4, sc.s[0][j], sc.b[0][j]),
              deq4((c16[j] >> 4) & M4, (c16[j] >> 12) & M4, sc.s[0][j], sc.b[0][j]));
      put_col(a[1], j, deq4(c0[j] & M4, (c0[j] >> 8) & M4, sc.s[1][j], sc.b[1][j]),
              deq4(c16[j] & M4, (c16[j] >> 8) & M4, sc.s[1][j], sc.b[1][j]));
    }
  }
};

template <int PR, int OUT>
int launch_span(const void* x, const void* qw, int K, const GemmArgs& a, int tile, int splits,
                cudaStream_t st) {
  if (tile == 0) return launch_gemm<SpanLoader<PR>, 256, 5, OUT>(x, qw, K / 2, a, splits, st);
  return launch_gemm<SpanLoader<PR>, 16, 16, OUT>(x, qw, K / 2, a, splits, st);
}

// ---- K10 ---------------------------------------------------------------------

constexpr int PT = 32;        // packed rows per K tile: 32 logical rows of each nibble plane
constexpr int BK = 2 * PT;    // logical rows per K tile: [high plane | low plane]
constexpr int LDS = BK + 16;  // shared row stride in bytes: 20 words, conflict-free fragments

__device__ __forceinline__ float fp_epilogue(float acc, const float* alpha, const float* beta, int n) {
  const float y = __fmul_rn(acc, alpha[n]);
  return beta ? __fadd_rn(y, beta[n]) : y;
}

template <int BM, int BN, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
fpscale_gemm_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ qw,
                    const float* __restrict__ scales, const float* __restrict__ zeros, int srep,
                    int M, int N, int K, int gs, int p_split,
                    const float* __restrict__ alpha, const float* __restrict__ beta,
                    float* __restrict__ out, float* __restrict__ part) {
  constexpr int NTHREADS = WARPS_M * WARPS_N * 32;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MT = WM / 16, NT = WN / 8;
  static_assert(WM % 16 == 0 && WN % 8 == 0, "warp tile");
  static_assert(2 * BM <= NTHREADS, "K10 takes one thread per row and plane for row sums");
  __shared__ __align__(16) int8_t sA[BM * LDS];  // x tile [m][k]
  __shared__ __align__(16) int8_t sB[BN * LDS];  // code tile [n][k]
  __shared__ int sRS[2 * BM];                    // row sums of x over each plane's group

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int pb = blockIdx.z * p_split;
  const int pe = min(K / 2, pb + p_split);

  int acc[2][MT][NT][4];  // one accumulator per plane (group)
  float facc[MT][NT][4];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[q][i][j][e] = 0;
          facc[i][j][e] = 0.0f;
        }
  int my_rs = 0;  // this thread's row sum over the current span

  for (int p0 = pb; p0 < pe; p0 += PT) {
    const int span = p0 / gs, r0 = p0 % gs;
    const int khi = 2 * span * gs + r0;  // logical row of the high plane's first row
    const int klo = khi + gs;            // and of the low plane's
    // x tile: BM rows of 32 bytes at khi then 32 bytes at klo; rows past M are zero
    for (int i = tid; i < BM * 4; i += NTHREADS) {
      const int r = i >> 2, c = i & 3;
      int4 val = make_int4(0, 0, 0, 0);
      if (m0 + r < M)
        val = *reinterpret_cast<const int4*>(x + (size_t)(m0 + r) * K + (c < 2 ? khi : klo) +
                                             (c & 1) * 16);
      *reinterpret_cast<int4*>(sA + r * LDS + c * 16) = val;
    }
    // code tile: one packed row of 16 columns per step, both planes, stored
    // transposed: column n's high-plane rows at [0, 32), low-plane rows at [32, 64)
    for (int i = tid; i < PT * (BN / 16); i += NTHREADS) {
      const int r = i / (BN / 16), c = i % (BN / 16);
      const int n = n0 + c * 16;
      uint4 wq = make_uint4(0, 0, 0, 0);
      if (n < N) wq = *reinterpret_cast<const uint4*>(qw + (size_t)(p0 + r) * N + n);
      const uint8_t* wb = reinterpret_cast<const uint8_t*>(&wq);
      int8_t* dst = sB + (c * 16) * LDS + r;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        dst[j * LDS] = static_cast<int8_t>(wb[j] >> 4);
        dst[j * LDS + PT] = static_cast<int8_t>(wb[j] & 0xF);
      }
    }
    __syncthreads();
    if (tid < 2 * BM) {  // row tid % BM of plane tid / BM
      const int8_t* row = sA + (tid % BM) * LDS + (tid / BM) * PT;
#pragma unroll
      for (int j = 0; j < PT; j += 4)
        my_rs = __dp4a(static_cast<int>(ld32(row + j)), 0x01010101, my_rs);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {  // kk 0: the high plane, 32: the low plane
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int8_t* p = sA + (wm * WM + i * 16 + g) * LDS + kk + t * 4;
        a[i][0] = ld32(p);
        a[i][1] = ld32(p + 8 * LDS);
        a[i][2] = ld32(p + 16);
        a[i][3] = ld32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* p = sB + (wn * WN + j * 8 + g) * LDS + kk + t * 4;
        b[j][0] = ld32(p);
        b[j][1] = ld32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[kk / 32][i][j], a[i], b[j]);
    }
    // the span ends with this tile (splits hold whole spans)
    const bool flush = (p0 + PT) % gs == 0;
    if (flush && tid < 2 * BM) {
      sRS[tid] = my_rs;
      my_rs = 0;
    }
    __syncthreads();
    if (flush) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // group 2 * span, then 2 * span + 1
        const float* srow = scales + (size_t)(2 * span + q) * srep * N;
        const float* zrow = zeros + (size_t)(2 * span + q) * srep * N;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int ml = wm * WM + i * 16 + g + (e >> 1) * 8;
              const int n = n0 + wn * WN + j * 8 + t * 2 + (e & 1);
              if (n < N) {
                const float zx = __fmul_rn(zrow[n], static_cast<float>(sRS[q * BM + ml]));
                const float d = __fsub_rn(static_cast<float>(acc[q][i][j][e]), zx);
                facc[i][j][e] = __fadd_rn(facc[i][j][e], __fmul_rn(srow[n], d));
              }
              acc[q][i][j][e] = 0;
            }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * WM + i * 16 + g + (e >> 1) * 8;
        const int n = n0 + wn * WN + j * 8 + t * 2 + (e & 1);
        if (m >= M || n >= N) continue;
        const size_t o = (size_t)m * N + n;
        if (part)
          part[(size_t)blockIdx.z * M * N + o] = facc[i][j][e];
        else
          out[o] = fp_epilogue(facc[i][j][e], alpha, beta, n);
      }
}

// Adds the splits' fp32 partials in split order and applies the epilogue.
__global__ void fpscale_splitk_combine(const float* __restrict__ part, int splits, int M, int N,
                                       const float* __restrict__ alpha,
                                       const float* __restrict__ beta, float* __restrict__ out) {
  const size_t total = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float a = part[i];
  for (int z = 1; z < splits; ++z) a = __fadd_rn(a, part[z * total + i]);
  out[i] = fp_epilogue(a, alpha, beta, static_cast<int>(i % N));
}

}  // namespace

extern "C" {

// K9.  x (M, K) int8; qw (K/2, N) span bytes; scales/zeros: group g at row
// g * srep of a (G * srep, N) int8 array; alpha (N,) f32; beta (N,) f32 or
// null; out (M, N) f32, or int8 when out_s8.  The plan (ops/quant_matmul.py
// gemm_plan): tile 0 the prefill tile (256 rows x 128 columns), 1 the decode
// tile (16 rows); `splits` K splits of `sps` stages of PR packed rows (64
// when groupsize % 64 == 0, else 32); part (splits, M, N) int32 scratch when
// splits > 1.
int w4a8_span_gemm(const void* x, const void* qw, const void* scales, const void* zeros, int srep,
                   int M, int N, int K, int gs, int tile, int splits, int sps, const void* alpha,
                   const void* beta, void* out, void* part, int out_s8, void* stream) {
  const int pr = gs % 64 == 0 ? 64 : 32;
  if (M <= 0 || N <= 0 || N % 16 || gs <= 0 || gs % 32 || K <= 0 || K % (2 * gs) || tile < 0 ||
      tile > 1 || sps <= 0)
    return cudaErrorInvalidValue;
  const int nst = K / 2 / pr;
  if (splits != (nst + sps - 1) / sps || (splits > 1 && !part)) return cudaErrorInvalidValue;
  GemmArgs a{static_cast<const int8_t*>(scales), static_cast<const int8_t*>(zeros), srep, gs,
             M, N, K, nst, sps, static_cast<const float*>(alpha),
             static_cast<const float*>(beta), out, splits > 1 ? static_cast<int*>(part) : nullptr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pr == 64)
    return out_s8 ? launch_span<64, OUT_S8>(x, qw, K, a, tile, splits, st)
                  : launch_span<64, OUT_F32>(x, qw, K, a, tile, splits, st);
  return out_s8 ? launch_span<32, OUT_S8>(x, qw, K, a, tile, splits, st)
                : launch_span<32, OUT_F32>(x, qw, K, a, tile, splits, st);
}

// K10.  As K9 with f32 scales and zeros and f32 out; tile 0 is 16 x 64 (M <=
// 16), 1 is 64 x 128; p_split packed rows per split, a multiple of gs; part
// (K/2 / p_split, M, N) f32 scratch when p_split < K / 2.
int w4a8_fpscale_gemm(const void* x, const void* qw, const void* scales, const void* zeros,
                      int srep, int M, int N, int K, int gs, int tile, int p_split,
                      const void* alpha, const void* beta, void* out, void* part, void* stream) {
  if (M <= 0 || N % 16 || gs % PT || gs <= 0 || K % (2 * gs) || p_split <= 0 || p_split % gs ||
      tile < 0 || tile > 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int splits = (K / 2 + p_split - 1) / p_split;
  float* p = splits > 1 ? static_cast<float*>(part) : nullptr;
  if (splits > 1 && !p) return cudaErrorInvalidValue;
  auto xs = static_cast<const int8_t*>(x);
  auto qs = static_cast<const uint8_t*>(qw);
  auto ss = static_cast<const float*>(scales);
  auto zs = static_cast<const float*>(zeros);
  auto al = static_cast<const float*>(alpha);
  auto be = static_cast<const float*>(beta);
  auto o = static_cast<float*>(out);
  if (tile == 0) {
    const dim3 grid((N + 63) / 64, (M + 15) / 16, splits);
    fpscale_gemm_kernel<16, 64, 1, 4><<<grid, 128, 0, st>>>(xs, qs, ss, zs, srep, M, N, K, gs,
                                                            p_split, al, be, o, p);
  } else {
    const dim3 grid((N + 127) / 128, (M + 63) / 64, splits);
    fpscale_gemm_kernel<64, 128, 2, 4><<<grid, 256, 0, st>>>(xs, qs, ss, zs, srep, M, N, K, gs,
                                                             p_split, al, be, o, p);
  }
  if (splits > 1) {
    const size_t total = (size_t)M * N;
    fpscale_splitk_combine<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(p, splits, M, N, al,
                                                                           be, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
