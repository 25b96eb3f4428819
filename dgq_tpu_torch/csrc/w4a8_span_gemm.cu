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
// K10: fp32 group scales and zeros.  Per group g an exact int32 dot d_g of x
//      with the raw codes, and
//        acc[m, n] = sum_g s_g[n] * (d_g[m, n] - z_g[n] * rowsum_g(x[m])),
//      summed in group order in fp32 (__fmul_rn, __fsub_rn, __fadd_rn), then
//      y = acc * alpha (+ beta).  Unsplit, bit-equal to the plain version,
//      which takes the same steps; when K is split over blocks (small M), each
//      split sums its own groups from 0 and a second kernel adds the splits in
//      order, so the fp32 sum is reassociated at the split boundaries.
//
// What bounds it on this card: at decode (M = batch rows <= 16) the weight
// bytes, K*N/2, over the 3.35 TB/s of device memory; at prefill (M >= 1024)
// the int8 tensor-core rate.  Hopper has no int4 tensor-core operand, so each
// K tile of 32 packed rows is unpacked once per block into a shared int8 tile
// of 64 logical rows, k-contiguous per output column: the 32 rows of the high
// plane (one group) then the 32 rows of the low plane (the next group), each
// exactly one m16n8k32 step of mma.sync s8.  K9 stores the dequantised
// weights; K10 stores the raw codes and keeps one int32 accumulator per plane,
// flushed into the fp32 sum at the end of each span, with the row sums of x
// over each plane's rows taken from the shared x tile.  Small-M calls take a
// 16-row tile and split K over blocks so that the weight stream is spread
// over all SMs.  No TMA or wgmma yet (as K1).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PT = 32;        // packed rows per K tile: 32 logical rows of each nibble plane
constexpr int BK = 2 * PT;    // logical rows per K tile: [high plane | low plane]
constexpr int LDS = BK + 16;  // shared row stride in bytes: 20 words, conflict-free fragments

enum Mode { F32_OUT = 0, S8_OUT = 1, FPSCALE = 2 };

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_s32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float epilogue(float acc, const float* alpha, const float* beta, int n) {
  const float y = __fmul_rn(acc, alpha[n]);
  return beta ? __fadd_rn(y, beta[n]) : y;
}

template <int MODE>
__device__ __forceinline__ void store(void* out, size_t i, float y) {
  if constexpr (MODE == S8_OUT) {
    const int v = min(127, max(-128, __float2int_rn(y)));
    static_cast<int8_t*>(out)[i] = static_cast<int8_t>(v);
  } else {
    static_cast<float*>(out)[i] = y;
  }
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int MODE>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
span_gemm_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ qw,
                 const void* __restrict__ scales, const void* __restrict__ zeros, int srep,
                 int M, int N, int K, int gs, int p_split,
                 const float* __restrict__ alpha, const float* __restrict__ beta,
                 void* __restrict__ out, void* __restrict__ part) {
  constexpr bool FP = MODE == FPSCALE;
  constexpr int NTHREADS = WARPS_M * WARPS_N * 32;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MT = WM / 16, NT = WN / 8;
  constexpr int NACC = FP ? 2 : 1;  // K10: one accumulator per plane (group)
  static_assert(WM % 16 == 0 && WN % 8 == 0, "warp tile");
  static_assert(!FP || 2 * BM <= NTHREADS, "K10 takes one thread per row and plane for row sums");
  __shared__ __align__(16) int8_t sA[BM * LDS];  // x tile [m][k]
  __shared__ __align__(16) int8_t sB[BN * LDS];  // weight tile [n][k]
  __shared__ int sRS[FP ? 2 * BM : 1];           // K10: row sums of x over each plane's group

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int pb = blockIdx.z * p_split;
  const int pe = min(K / 2, pb + p_split);

  int acc[NACC][MT][NT][4];
  float facc[MT][NT][4];
#pragma unroll
  for (int q = 0; q < NACC; ++q)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[q][i][j][e] = 0;
          facc[i][j][e] = 0.0f;
        }
  int my_rs = 0;  // K10: this thread's row sum over the current span

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
    // weight tile: one packed row of 16 columns per step, both planes, stored
    // transposed: column n's high-plane rows at [0, 32), low-plane rows at [32, 64)
    const int8_t* s_hi = nullptr;
    const int8_t* s_lo = nullptr;
    const int8_t* z_hi = nullptr;
    const int8_t* z_lo = nullptr;
    if constexpr (!FP) {
      s_hi = static_cast<const int8_t*>(scales) + (size_t)(2 * span) * srep * N;
      s_lo = s_hi + (size_t)srep * N;
      z_hi = static_cast<const int8_t*>(zeros) + (size_t)(2 * span) * srep * N;
      z_lo = z_hi + (size_t)srep * N;
    }
    for (int i = tid; i < PT * (BN / 16); i += NTHREADS) {
      const int r = i / (BN / 16), c = i % (BN / 16);
      const int n = n0 + c * 16;
      uint4 wq = make_uint4(0, 0, 0, 0);
      if (n < N) wq = *reinterpret_cast<const uint4*>(qw + (size_t)(p0 + r) * N + n);
      const uint8_t* wb = reinterpret_cast<const uint8_t*>(&wq);
      int8_t* dst = sB + (c * 16) * LDS + r;
      if constexpr (FP) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          dst[j * LDS] = static_cast<int8_t>(wb[j] >> 4);
          dst[j * LDS + PT] = static_cast<int8_t>(wb[j] & 0xF);
        }
      } else {
        uint4 sh = make_uint4(0, 0, 0, 0), sl = sh, zh = sh, zl = sh;
        if (n < N) {
          sh = *reinterpret_cast<const uint4*>(s_hi + n);
          sl = *reinterpret_cast<const uint4*>(s_lo + n);
          zh = *reinterpret_cast<const uint4*>(z_hi + n);
          zl = *reinterpret_cast<const uint4*>(z_lo + n);
        }
        const int8_t* shb = reinterpret_cast<const int8_t*>(&sh);
        const int8_t* slb = reinterpret_cast<const int8_t*>(&sl);
        const int8_t* zhb = reinterpret_cast<const int8_t*>(&zh);
        const int8_t* zlb = reinterpret_cast<const int8_t*>(&zl);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int hi = wb[j] >> 4, lo = wb[j] & 0xF;
          dst[j * LDS] = static_cast<int8_t>((hi - zhb[j]) * shb[j]);
          dst[j * LDS + PT] = static_cast<int8_t>((lo - zlb[j]) * slb[j]);
        }
      }
    }
    __syncthreads();
    if constexpr (FP) {
      if (tid < 2 * BM) {  // row tid % BM of plane tid / BM
        const int8_t* row = sA + (tid % BM) * LDS + (tid / BM) * PT;
#pragma unroll
        for (int j = 0; j < PT; j += 4)
          my_rs = __dp4a(static_cast<int>(ld_s32(row + j)), 0x01010101, my_rs);
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {  // kk 0: the high plane, 32: the low plane
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int8_t* p = sA + (wm * WM + i * 16 + g) * LDS + kk + t * 4;
        a[i][0] = ld_s32(p);
        a[i][1] = ld_s32(p + 8 * LDS);
        a[i][2] = ld_s32(p + 16);
        a[i][3] = ld_s32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* p = sB + (wn * WN + j * 8 + g) * LDS + kk + t * 4;
        b[j][0] = ld_s32(p);
        b[j][1] = ld_s32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[FP ? kk / 32 : 0][i][j], a[i], b[j]);
    }
    // K10: the span ends with this tile (splits hold whole spans)
    const bool flush = FP && (p0 + PT) % gs == 0;
    if constexpr (FP) {
      if (flush && tid < 2 * BM) {
        sRS[tid] = my_rs;
        my_rs = 0;
      }
    }
    __syncthreads();
    if constexpr (FP) {
      if (flush) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {  // group 2 * span, then 2 * span + 1
          const float* srow = static_cast<const float*>(scales) + (size_t)(2 * span + q) * srep * N;
          const float* zrow = static_cast<const float*>(zeros) + (size_t)(2 * span + q) * srep * N;
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
        if (part) {
          const size_t pi = (size_t)blockIdx.z * M * N + o;
          if constexpr (FP)
            static_cast<float*>(part)[pi] = facc[i][j][e];
          else
            static_cast<int*>(part)[pi] = acc[0][i][j][e];
        } else {
          const float a = FP ? facc[i][j][e] : static_cast<float>(acc[0][i][j][e]);
          store<MODE>(out, o, epilogue(a, alpha, beta, n));
        }
      }
}

// Sums the splits' partials in split order (int32 exactly for K9, fp32 for
// K10) and applies the epilogue.
template <int MODE>
__global__ void span_splitk_combine(const void* __restrict__ part, int splits, int M, int N,
                                const float* __restrict__ alpha, const float* __restrict__ beta,
                                void* __restrict__ out) {
  const size_t total = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float a;
  if constexpr (MODE == FPSCALE) {
    const float* p = static_cast<const float*>(part);
    a = p[i];
    for (int z = 1; z < splits; ++z) a = __fadd_rn(a, p[z * total + i]);
  } else {
    const int* p = static_cast<const int*>(part);
    int s = 0;
    for (int z = 0; z < splits; ++z) s += p[z * total + i];
    a = static_cast<float>(s);
  }
  store<MODE>(out, i, epilogue(a, alpha, beta, static_cast<int>(i % N)));
}

struct Tile {
  int bm, bn;
};

// K10 carries two int32 and one fp32 accumulator per output: at most 64 rows
Tile tile_for(int M, int mode) {
  if (M <= 16) return {16, 64};
  if (M <= 64 || mode == FPSCALE) return {64, 128};
  return {128, 128};
}

template <int MODE>
void launch(dim3 grid, int bm, cudaStream_t st, const int8_t* x, const uint8_t* qw,
            const void* s, const void* z, int srep, int M, int N, int K, int gs, int p_split,
            const float* alpha, const float* beta, void* out, void* part) {
  if (bm == 16) {
    span_gemm_kernel<16, 64, 1, 4, MODE><<<grid, 128, 0, st>>>(
        x, qw, s, z, srep, M, N, K, gs, p_split, alpha, beta, out, part);
  } else if (bm == 64) {
    span_gemm_kernel<64, 128, 2, 4, MODE><<<grid, 256, 0, st>>>(
        x, qw, s, z, srep, M, N, K, gs, p_split, alpha, beta, out, part);
  } else if constexpr (MODE != FPSCALE) {
    span_gemm_kernel<128, 128, 2, 4, MODE><<<grid, 256, 0, st>>>(
        x, qw, s, z, srep, M, N, K, gs, p_split, alpha, beta, out, part);
  }
}

}  // namespace

extern "C" {

// Packed rows per split for an (M, N, K) call in `mode` (0 K9 f32 out, 1 K9
// int8 out, 2 K10) on a card with `sms` SMs: all K / 2 unless the output
// tiles alone leave SMs idle.  K9 splits at 32-row tiles, K10 at whole spans
// (gs packed rows).
int w4a8_span_gemm_p_split(int M, int N, int K, int gs, int mode, int sms) {
  const Tile tl = tile_for(M, mode);
  const int blocks = ((M + tl.bm - 1) / tl.bm) * ((N + tl.bn - 1) / tl.bn);
  const int kp = K / 2;
  if (blocks >= sms) return kp;
  const int unit = mode == FPSCALE ? gs : PT;
  const int units = kp / unit;
  int splits = (2 * sms + blocks - 1) / blocks;
  if (splits > units) splits = units;
  return ((units + splits - 1) / splits) * unit;
}

// x (M, K) int8; qw (K/2, N) span bytes; scales/zeros: group g at row g * srep
// of a (G * srep, N) array, int8 (K9) or f32 (K10); alpha (N,) f32; beta (N,)
// f32 or null; out (M, N) f32, or int8 for mode 1; part (K/2 / p_split, M, N)
// int32 (K9) or f32 (K10) scratch when p_split < K / 2.
int w4a8_span_gemm(const void* x, const void* qw, const void* scales, const void* zeros, int srep,
                   int M, int N, int K, int gs, int p_split, const void* alpha, const void* beta,
                   void* out, void* part, int mode, void* stream) {
  if (M <= 0 || N % 16 || gs % PT || gs <= 0 || K % (2 * gs) || p_split <= 0 ||
      p_split % (mode == FPSCALE ? gs : PT) || mode < 0 || mode > 2)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int splits = (K / 2 + p_split - 1) / p_split;
  void* p = splits > 1 ? part : nullptr;
  if (splits > 1 && !p) return cudaErrorInvalidValue;
  const Tile tl = tile_for(M, mode);
  const dim3 grid((N + tl.bn - 1) / tl.bn, (M + tl.bm - 1) / tl.bm, splits);
  auto xs = static_cast<const int8_t*>(x);
  auto qs = static_cast<const uint8_t*>(qw);
  auto al = static_cast<const float*>(alpha);
  auto be = static_cast<const float*>(beta);
  const size_t total = (size_t)M * N;
  const unsigned eblocks = (unsigned)((total + 255) / 256);
  if (mode == F32_OUT) {
    launch<F32_OUT>(grid, tl.bm, st, xs, qs, scales, zeros, srep, M, N, K, gs, p_split, al, be,
                    out, p);
    if (splits > 1) span_splitk_combine<F32_OUT><<<eblocks, 256, 0, st>>>(p, splits, M, N, al, be, out);
  } else if (mode == S8_OUT) {
    launch<S8_OUT>(grid, tl.bm, st, xs, qs, scales, zeros, srep, M, N, K, gs, p_split, al, be,
                   out, p);
    if (splits > 1) span_splitk_combine<S8_OUT><<<eblocks, 256, 0, st>>>(p, splits, M, N, al, be, out);
  } else {
    launch<FPSCALE>(grid, tl.bm, st, xs, qs, scales, zeros, srep, M, N, K, gs, p_split, al, be,
                    out, p);
    if (splits > 1) span_splitk_combine<FPSCALE><<<eblocks, 256, 0, st>>>(p, splits, M, N, al, be, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
