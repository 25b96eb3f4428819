// K9 and K10: W4A8 GEMMs on span-packed int4 weights, for Hopper (sm_90a).
//
// Replaces the TPU kernels of dgq_tpu/ops/quant_matmul.py:
//   K9  w4a8_matmul_packed (body _kernel), and with it K14 w4a8_matmul_wres
//       and w4a8_matmul_pipe, which compute K9's function with another tiling
//       (dequantise once per weight block; dequantise one block ahead);
//   K10 w4a8_fpscale_matmul_packed (body _fpscale_kernel).
//
// The span layout (span = 2 * gs, unsigned codes, zeros not shifted) is
// described beside SpanLoader in w4a8_gemm_sm90.cuh.
//
// K9:  acc[m, n] = sum_k x[m, k] * w[k, n] in exact int32, w the int8
//      dequantisation (c - z) * s with int8 group scale s and zero z; then
//      y = acc * alpha[n] (+ beta[n]) with __fmul_rn / __fadd_rn (no FMA
//      contraction), stored as f32 or rounded half to even (__float2int_rn, as
//      torch.round) and clamped to int8.  Bit-equal to the plain version.
//      The main loop is w4a8_gemm_sm90.cuh's (TMA ring, wgmma with the weights
//      as register fragments, the K split); its SpanLoader turns a stage of
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
//      K10 runs K9's TMA + wgmma loop (w4a8_gemm_sm90.cuh) in its FP mode
//      with SpanCodesLoader below: the same x and span-row boxes, the raw
//      codes 0..15 unpacked straight into wgmma A fragments, one int32
//      accumulator set per nibble plane (each span's first product writes it
//      with scale-d 0), and at the end of each span a flush into one fp32
//      sum per output, high plane then low plane, with the groups' fp32 scale
//      and zero rows brought by TMA on the span's last stage and the row
//      sums by the producer warpgroup's idle warps (exact integers in any
//      order).  Three accumulator sets a thread bound the tile: 128 token
//      rows at prefill (192 registers), 16 at decode with K split in whole
//      spans (the plan is fpscale_plan in ops/quant_matmul.py).
//
// What bounds them on this card: at decode (M = batch rows <= 16) the weight
// bytes, K*N/2, over the 3.35 TB/s of device memory; at prefill (M >= 1024)
// the int8 tensor-core rate, and for K10 beside it the flush: five fp32
// steps per output and group (int-to-float, z * rowsum, the difference, the
// scale, the sum), which run while no product is in flight (ptxas
// serialises the wgmmas when an accumulator register is read with one in
// flight), so a warpgroup's flush and its products alternate.

#include "w4a8_gemm_sm90.cuh"

namespace {

// ---- K9: SpanLoader (w4a8_gemm_sm90.cuh, beside the rowpair loader) -----------

template <int PR, int OUT>
int launch_span(const void* x, const void* qw, int K, const GemmArgs& a, int tile, int splits,
                cudaStream_t st) {
  if (tile == 0) return launch_gemm<SpanLoader<PR>, 256, 5, OUT>(x, qw, K / 2, a, splits, st);
  return launch_gemm<SpanLoader<PR>, 16, 16, OUT>(x, qw, K / 2, a, splits, st);
}

// ---- K10 ---------------------------------------------------------------------

// K9's stages with the raw codes (0..15) as fragments and no int8 scale rows:
// half 0 (the high nibbles) is group 2t, half 1 (the low nibbles) group 2t + 1,
// and the loop's FP mode keeps one int32 set per half and flushes the span
// into fp32 with the groups' fp32 scale and zero rows (w4a8_gemm_sm90.cuh).
template <int PR>
struct SpanCodesLoader {
  static constexpr int HB = PR, SRC_ROWS = PR;
  static constexpr bool SCALED = false, FP = true;
  struct Scales {};

  static __device__ __forceinline__ int x_k(const GemmArgs& a, int st, int h) {
    return SpanLoader<PR>::x_k(a, st, h);
  }
  static __device__ __forceinline__ int group(const GemmArgs& a, int st, int h) {
    return SpanLoader<PR>::group(a, st, h);
  }
  static __device__ __forceinline__ void scales(const uint8_t*, int, Scales&) {}

  // SpanLoader::frags without the dequantisation
  static __device__ __forceinline__ void frags(const uint8_t* rows, const Scales&, int cp, int t,
                                               int kk, Frags& a) {
    constexpr uint32_t M4 = 0x0F0F0F0F;
    uint32_t c0[2], c16[2];
    quad(rows, cp, 32 * kk + 4 * t, 1, 2, 3, c0);
    quad(rows, cp, 32 * kk + 16 + 4 * t, 1, 2, 3, c16);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      put_col(a[0], j, (c0[j] >> 4) & M4, (c16[j] >> 4) & M4);
      put_col(a[1], j, c0[j] & M4, c16[j] & M4);
    }
  }
};

// Three accumulator sets a thread (two int32 planes and the fp32 sum) bound
// the tile: 128 token rows at prefill (192 registers), 16 at decode.
template <int PR>
int launch_fpscale(const void* x, const void* qw, int K, const GemmArgs& a, int tile, int splits,
                   cudaStream_t st) {
  if (tile == 0) return launch_gemm<SpanCodesLoader<PR>, 16, 16, OUT_F32>(x, qw, K / 2, a, splits, st);
  return launch_gemm<SpanCodesLoader<PR>, 128, PR == 64 ? 8 : 12, OUT_F32>(x, qw, K / 2, a, splits,
                                                                            st);
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
  GemmArgs a{scales, zeros, srep, gs, M, N, K, nst, sps, static_cast<const float*>(alpha),
             static_cast<const float*>(beta), out, splits > 1 ? part : nullptr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pr == 64)
    return out_s8 ? launch_span<64, OUT_S8>(x, qw, K, a, tile, splits, st)
                  : launch_span<64, OUT_F32>(x, qw, K, a, tile, splits, st);
  return out_s8 ? launch_span<32, OUT_S8>(x, qw, K, a, tile, splits, st)
                : launch_span<32, OUT_F32>(x, qw, K, a, tile, splits, st);
}

// K10.  As K9 with f32 scales and zeros (group g at row g * srep of (G * srep,
// N)) and f32 out; the plan (ops/quant_matmul.py fpscale_plan): tile 0 16
// token rows (M <= 16), 1 128 rows, each x 128 columns; p_split packed rows
// per split, a multiple of gs; part (K/2 / p_split, M, N) f32 scratch when
// p_split < K / 2.
int w4a8_fpscale_gemm(const void* x, const void* qw, const void* scales, const void* zeros,
                      int srep, int M, int N, int K, int gs, int tile, int p_split,
                      const void* alpha, const void* beta, void* out, void* part, void* stream) {
  if (M <= 0 || N <= 0 || N % 16 || gs <= 0 || gs % 32 || K <= 0 || K % (2 * gs) ||
      tile < 0 || tile > 1 || p_split <= 0 || p_split % gs || srep <= 0)
    return cudaErrorInvalidValue;
  const int pr = gs % 64 == 0 ? 64 : 32;
  const int splits = (K / 2 + p_split - 1) / p_split;
  if (splits > 1 && !part) return cudaErrorInvalidValue;
  const GemmArgs a{scales, zeros, srep, gs, M, N, K, K / 2 / pr, p_split / pr,
                   static_cast<const float*>(alpha), static_cast<const float*>(beta), out,
                   splits > 1 ? part : nullptr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pr == 64) return launch_fpscale<64>(x, qw, K, a, tile, splits, st);
  return launch_fpscale<32>(x, qw, K, a, tile, splits, st);
}

}  // extern "C"
