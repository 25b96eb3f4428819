// K12: RMSNormQ + W4A8 GEMV, requant + W4A8 GEMV (+ residual), and the whole
// LLaMA MLP of a decode step, on span-packed int4 weights, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels dgq_tpu/ops/fused_decode.py::fused_norm_gemv
// (body _norm_gemv_kernel), ::fused_requant_gemv (body _requant_gemv_kernel)
// and ::fused_mlp_decode (body _mlp_kernel), which the JAX engine takes for
// decode steps and speculative-verification windows (M <= 64 rows) when a
// layer has no rowpair copy.  The names fused_norm_gemv_s4 and
// fused_requant_gemv_s4 (K13) compute the same bit for bit and run the first
// two entry points (ops/fused_decode.py).  They compute what K4, K5 and K6
// compute:
//   norm:    out = float(RMSNormQ(x) @ W) * alpha (+ beta)
//   requant: out = float(clip(round(x / in_scale), qmin, 127) @ W) * alpha
//                  (+ beta) (+ residual)
//   mlp:     q = RMSNormQ(x); g = float(q @ Wg) * alpha_g, u = float(q @ Wu)
//            * alpha_u; hq = clip(round(((g * sigmoid(g)) * u) / down_scale));
//            out = float(hq @ Wd) * alpha_d (+ beta_d) (+ x)
// with W dequantised to int8 as (c - z) * s, c the unsigned span nibble
// codes: byte row t gs + i holds row t span + i (group 2t) in its high nibble
// and row t span + gs + i (group 2t + 1) in its low one.  The int32
// accumulators equal the plain versions' and K4's, K5's and K6's on
// pack_rowpair_s4 of the same weights, bit for bit; each fp32 step of the
// epilogue is rounded on its own, as the plain versions round.
//
// What bounds it on this card: the weight bytes, K*N/2 (25 MB for LLaMA-7B's
// qkv, 8.4 MB for its o_proj, 69 MB for its MLP), over the 3.35 TB/s of
// device memory; the rows are few.  The design is K4's, K5's and K6's
// (fused_gemv_sm90.cuh: a TMA ring of 64 packed rows x 128 columns a stage,
// the codes of the block's K range made in shared memory as wgmma's B
// operand and shared across a cluster, the weights unpacked straight into
// wgmma A fragments, a K split summed by a second kernel; the MLP as two
// legs, gate|up with its SiLU codes, then down) with the Loader FusedSpan: a
// stage's 64 packed rows feed both nibble planes, whose codes lie gs apart
// in K, and K9's span unpack turns each 32-row step into the fragments of
// both planes at once (in the gate|up leg from its two boxes of 64-byte
// rows, whose swizzle differs).  The plan (ops/fused_decode.py fused_plan
// and mlp_plan, layout "span") splits K in whole spans, so a block's stages
// only read codes of its own K range.

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

template <int BM, int QS>
__global__ void __launch_bounds__(F_THREADS, 1)
mlp_gate_up_span_sm90(const __grid_constant__ CUtensorMap tm_w,
                      const __grid_constant__ CUtensorMap tm_shi,
                      const __grid_constant__ CUtensorMap tm_slo,
                      const __grid_constant__ CUtensorMap tm_zhi,
                      const __grid_constant__ CUtensorMap tm_zlo,
                      const __grid_constant__ FusedArgs a) {
  fused_gemv_body<F_GATE_UP, BM, FusedSpan<QS>>(tm_w, tm_shi, tm_slo, tm_zhi, tm_zlo, a);
}

__global__ void mlp_gate_up_span_combine(const FusedArgs a, int splits) {
  gate_up_combine_body(a, splits);
}

template <int BM, int QS>
__global__ void __launch_bounds__(F_THREADS, 1)
mlp_down_span_sm90(const __grid_constant__ CUtensorMap tm_w,
                   const __grid_constant__ CUtensorMap tm_shi,
                   const __grid_constant__ CUtensorMap tm_slo,
                   const __grid_constant__ CUtensorMap tm_zhi,
                   const __grid_constant__ CUtensorMap tm_zlo,
                   const __grid_constant__ FusedArgs a) {
  fused_gemv_body<F_DOWN, BM, FusedSpan<QS>>(tm_w, tm_shi, tm_slo, tm_zhi, tm_zlo, a);
}

__global__ void mlp_down_span_combine(const FusedArgs a, int splits) {
  fused_combine_body(a, splits);
}

struct GateUp {
  static constexpr int MODE = F_GATE_UP;
  template <int BM, int QS>
  static auto gemv() { return mlp_gate_up_span_sm90<BM, QS>; }
  static auto combine() { return mlp_gate_up_span_combine; }
};

struct Down {
  static constexpr int MODE = F_DOWN;
  template <int BM, int QS>
  static auto gemv() { return mlp_down_span_sm90<BM, QS>; }
  static auto combine() { return mlp_down_span_combine; }
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

// K4's and K5's checks (fused_args_ok), a K split in whole spans (sps
// stages of 64 packed rows a whole number of spans of gs rows), and packed
// rows p < K / 2 that gs_magic divides exactly (p < 2^32 / gs).
bool span_args_ok(const FusedArgs& a, int bm, int splits, int cluster) {
  return a.gs > 0 && !(splits > 1 && (64 * a.sps) % a.gs) &&
         static_cast<uint64_t>(a.K / 2) * static_cast<uint64_t>(a.gs) < (1ull << 32) &&
         fused_args_ok(a, bm, splits, cluster);
}

template <class Kern>
int launch_span(const FusedArgs& a, int bm, int splits, int cluster, const void* qw,
                const void* const (&planes)[4], cudaStream_t st) {
  if (!span_args_ok(a, bm, splits, cluster)) return F_BAD_ARGS;
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

// x (M, D) f32; ln_w (D,) f32; ln_b (D,) f32 or null; down_scale one f32 on
// the device; gu_qw (D/2, 2F) span bytes [gate | up] with (Gd/2, 2F) int8
// plane rows and gu_alpha (2F,) f32; d_qw (F/2, D) span bytes with (8 Gf, D)
// int8 replicated scales and zeros (row 8g is read), d_alpha (D,) f32,
// d_beta (D,) f32 or null; out (M, D) f32; xq_out (M, D) int8 or null
// (receives the norm codes); h_out (M, F) int8 (receives the down-input
// codes; the down leg reads them).  Each leg's plan (ops/fused_decode.py
// mlp_plan, layout "span"): bm token rows, `splits` K splits of `sps`
// stages of 128 k (whole spans), clusters of `cluster` column tiles, and its
// int32 scratch when splits > 1: part1 (splits1, M, 2F), part2 (splits2, M,
// D).  Returns a cudaError_t, or -1 when it rejects its arguments (F % 64,
// F % 128 or D % 128 not 0, F or D no multiple of 2 gs, a split of no whole
// spans, or the checks of the norm entry).
int fused_mlp_decode(const void* x, const void* ln_w, const void* ln_b, float eps,
                     const void* down_scale, const void* gu_qw, const void* gu_s_hi,
                     const void* gu_s_lo, const void* gu_z_hi, const void* gu_z_lo,
                     const void* gu_alpha, const void* d_qw, const void* d_ws, const void* d_wz,
                     const void* d_alpha, const void* d_beta, int fuse_residual, void* out,
                     void* xq_out, void* h_out, int M, int D, int F, int gs, int bm1,
                     int splits1, int sps1, int cluster1, void* part1, int bm2, int splits2,
                     int sps2, int cluster2, void* part2, void* stream) {
  const void* const gu_planes[4] = {gu_s_hi, gu_s_lo, gu_z_hi, gu_z_lo};
  return launch_mlp<GateUp, Down>(span_args_ok, x, ln_w, ln_b, eps, down_scale, gu_qw,
                                  gu_planes, gu_alpha, d_qw, d_ws, d_wz, d_alpha, d_beta,
                                  fuse_residual, out, xq_out, h_out, M, D, F, gs,
                                  {bm1, splits1, sps1, cluster1, part1},
                                  {bm2, splits2, sps2, cluster2, part2},
                                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"
