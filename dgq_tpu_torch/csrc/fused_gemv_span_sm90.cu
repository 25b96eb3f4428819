// K12's norm and requant entries: RMSNormQ + W4A8 GEMV, and requant + W4A8
// GEMV (+ residual), on span-packed int4 weights, for Hopper (sm_90a).
//
// Replaces the TPU kernels dgq_tpu/ops/fused_decode.py::fused_norm_gemv
// (body _norm_gemv_kernel) and ::fused_requant_gemv (body
// _requant_gemv_kernel), which the JAX engine takes for decode steps and
// speculative-verification windows (M <= 64 rows) when a layer has no
// rowpair copy.  The names fused_norm_gemv_s4 and fused_requant_gemv_s4
// (K13) compute the same bit for bit and run these entry points
// (ops/fused_decode.py).  They compute what K4 and K5 compute:
//   norm:    out = float(RMSNormQ(x) @ W) * alpha (+ beta)
//   requant: out = float(clip(round(x / in_scale), qmin, 127) @ W) * alpha
//                  (+ beta) (+ residual)
// with W dequantised to int8 as (c - z) * s, c the unsigned span nibble
// codes: byte row t gs + i holds row t span + i (group 2t) in its high nibble
// and row t span + gs + i (group 2t + 1) in its low one.  The int32
// accumulators equal the plain versions' and K4's and K5's on
// pack_rowpair_s4 of the same weights, bit for bit; each fp32 step of the
// epilogue is rounded on its own, as the plain versions round.
//
// What bounds it on this card: the weight bytes, K*N/2 (25 MB for LLaMA-7B's
// qkv, 8.4 MB for its o_proj), over the 3.35 TB/s of device memory; the rows
// are few.  The design is K4's and K5's (fused_gemv_sm90.cuh: a TMA ring of
// 64 packed rows x 128 columns a stage, the codes of the block's K range made
// in shared memory as wgmma's B operand and shared across a cluster, the
// weights unpacked straight into wgmma A fragments, a K split summed by a
// second kernel) with the Loader FusedSpan: a stage's 64 packed rows feed
// both nibble planes, whose codes lie gs apart in K, and K9's span unpack
// turns each 32-row step into the fragments of both planes at once.  The
// plan (ops/fused_decode.py fused_plan, layout "span") splits K in whole
// spans, so a block's stages only read codes of its own K range.

#include "fused_gemv_sm90.cuh"

namespace {

template <int BM, int QS>
__global__ void __launch_bounds__(F_THREADS, 1)
norm_gemv_span_sm90(const __grid_constant__ CUtensorMap tm_w,
                    const __grid_constant__ CUtensorMap tm_shi,
                    const __grid_constant__ CUtensorMap tm_slo,
                    const __grid_constant__ CUtensorMap tm_zhi,
                    const __grid_constant__ CUtensorMap tm_zlo,
                    const __grid_constant__ FusedArgs a) {
  fused_gemv_body<F_NORM, BM, FusedSpan<QS>>(tm_w, tm_shi, tm_slo, tm_zhi, tm_zlo, a);
}

__global__ void norm_gemv_span_combine(const FusedArgs a, int splits) {
  fused_combine_body(a, splits);
}

template <int BM, int QS>
__global__ void __launch_bounds__(F_THREADS, 1)
requant_gemv_span_sm90(const __grid_constant__ CUtensorMap tm_w,
                       const __grid_constant__ CUtensorMap tm_shi,
                       const __grid_constant__ CUtensorMap tm_slo,
                       const __grid_constant__ CUtensorMap tm_zhi,
                       const __grid_constant__ CUtensorMap tm_zlo,
                       const __grid_constant__ FusedArgs a) {
  fused_gemv_body<F_REQUANT, BM, FusedSpan<QS>>(tm_w, tm_shi, tm_slo, tm_zhi, tm_zlo, a);
}

__global__ void requant_gemv_span_combine(const FusedArgs a, int splits) {
  fused_combine_body(a, splits);
}

struct NormKernels {
  static constexpr int MODE = F_NORM;
  template <int BM, int QS>
  static auto gemv() { return norm_gemv_span_sm90<BM, QS>; }
  static auto combine() { return norm_gemv_span_combine; }
};

struct RequantKernels {
  static constexpr int MODE = F_REQUANT;
  template <int BM, int QS>
  static auto gemv() { return requant_gemv_span_sm90<BM, QS>; }
  static auto combine() { return requant_gemv_span_combine; }
};

// The arguments both entries share.
FusedArgs span_args(const void* x, const void* alpha, const void* beta, void* out,
                    void* codes_out, int M, int N, int K, int gs, int sps, void* part) {
  FusedArgs a{};
  a.x = static_cast<const float*>(x);
  a.alpha = static_cast<const float*>(alpha);
  a.beta = static_cast<const float*>(beta);
  a.out = static_cast<float*>(out);
  a.codes_out = static_cast<int8_t*>(codes_out);
  a.part = static_cast<int*>(part);
  a.M = M;
  a.N = N;
  a.K = K;
  a.gs = gs;
  a.nst = K / 128;
  a.sps = sps;
  return a;
}

// K4's and K5's checks (launch_fused), a K split in whole spans (sps stages
// of 64 packed rows a whole number of spans of gs rows), and packed rows p <
// K / 2 that gs_magic divides exactly (p < 2^32 / gs).
template <class Kern>
int launch_span(const FusedArgs& a, int bm, int splits, int cluster, const void* qw,
                const void* const (&planes)[4], cudaStream_t st) {
  if (a.gs <= 0 || (splits > 1 && (64 * a.sps) % a.gs) ||
      static_cast<uint64_t>(a.K / 2) * static_cast<uint64_t>(a.gs) >= (1ull << 32))
    return F_BAD_ARGS;
  return launch_fused<Kern>(a, bm, splits, cluster, qw, planes, st);
}

}  // namespace

extern "C" {

// x (M, K) f32; ln_w (K,) f32; ln_b (K,) f32 or null; qw (K/2, N) span
// bytes; s_hi/s_lo/z_hi/z_lo (G/2, N) int8 compact plane rows (G = K / gs;
// even groups in *_hi, odd in *_lo); alpha (N,) f32; beta (N,) f32 or null;
// out (M, N) f32; codes_out (M, K) int8 or null (receives the RMSNormQ
// codes).  The plan (ops/fused_decode.py fused_plan, layout "span"): bm
// token rows (8, 16, 32, 48 or 64), `splits` K splits of `sps` stages of 128
// k (whole spans), clusters of `cluster` column tiles; part (splits, M, N)
// int32 scratch when splits > 1, summed by a second launch.  Returns a
// cudaError_t, or -1 when it rejects its arguments.
int fused_norm_gemv(const void* x, const void* ln_w, const void* ln_b, float eps, const void* qw,
                    const void* s_hi, const void* s_lo, const void* z_hi, const void* z_lo,
                    const void* alpha, const void* beta, void* out, void* codes_out, int M,
                    int N, int K, int gs, int bm, int splits, int sps, int cluster, void* part,
                    void* stream) {
  if (!ln_w) return F_BAD_ARGS;
  FusedArgs a = span_args(x, alpha, beta, out, codes_out, M, N, K, gs, sps, part);
  a.lnw = static_cast<const float*>(ln_w);
  a.lnb = static_cast<const float*>(ln_b);
  a.eps = eps;
  const void* const planes[4] = {s_hi, s_lo, z_hi, z_lo};
  return launch_span<NormKernels>(a, bm, splits, cluster, qw, planes,
                                  static_cast<cudaStream_t>(stream));
}

// x (M, K) f32; in_scale one f32 on the device; qw and the plane rows as
// above; residual (M, N) f32 or null; codes_out receives the requant codes.
// The plan as the norm entry's.
int fused_requant_gemv(const void* x, const void* in_scale, float qmin, const void* qw,
                       const void* s_hi, const void* s_lo, const void* z_hi, const void* z_lo,
                       const void* alpha, const void* beta, const void* residual, void* out,
                       void* codes_out, int M, int N, int K, int gs, int bm, int splits, int sps,
                       int cluster, void* part, void* stream) {
  if (!in_scale) return F_BAD_ARGS;
  FusedArgs a = span_args(x, alpha, beta, out, codes_out, M, N, K, gs, sps, part);
  a.in_scale = static_cast<const float*>(in_scale);
  a.qmin = qmin;
  a.residual = static_cast<const float*>(residual);
  const void* const planes[4] = {s_hi, s_lo, z_hi, z_lo};
  return launch_span<RequantKernels>(a, bm, splits, cluster, qw, planes,
                                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
