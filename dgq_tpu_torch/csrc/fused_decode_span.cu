// K12: the fused decode kernels on span-layout int4 weights, for Hopper
// (sm_90a): RMSNormQ + GEMV, requant + GEMV (+ residual), and the whole
// LLaMA MLP, each in one call.
//
// Replaces the TPU kernels dgq_tpu/ops/fused_decode.py::fused_norm_gemv
// (body _norm_gemv_kernel), ::fused_requant_gemv (body _requant_gemv_kernel)
// and ::fused_mlp_decode (body _mlp_kernel), which the JAX engine takes for
// decode steps and speculative-verification windows (M <= 64 rows) when a
// layer has no rowpair copy.  The names fused_norm_gemv_s4 and
// fused_requant_gemv_s4 (K13) compute the first two bit for bit and run the
// same entry points (ops/fused_decode.py).  They compute what K4-K6 compute:
//   norm:    out = float(RMSNormQ(x) @ W) * alpha (+ beta)
//   requant: out = float(clip(round(x / in_scale), qmin, 127) @ W) * alpha
//                  (+ beta) (+ residual)
//   mlp:     K6's chain (RMSNormQ, gate|up, SiLU(g) * u, requant, down,
//            acc * alpha_d (+ beta_d) (+ x))
// with W dequantised to int8 as (c - z) * s, c the unsigned span nibble codes:
// byte row t gs + i holds row t span + i (group 2t) in its high nibble and
// row t span + gs + i (group 2t+1) in its low one.  The int32 accumulators
// equal K4-K6's on pack_rowpair_s4 of the same weights bit for bit.
//
// What bounds it on this card: the weight bytes (K*N/2; 25 MB for LLaMA-7B's
// qkv, 69 MB for its MLP) over the 3.35 TB/s of device memory; the rows are
// few.  The design is the first one of K4-K6 (fused_gemv.cuh; they have
// since moved to TMA + wgmma): every block makes the codes of all rows in
// the same fixed order, then its warps stream 32-column weight tiles through
// mma.sync on raw codes with the scale and zero applied once per group.  A
// span k step loads 32
// byte rows and feeds both nibbles to two mma streams, one per group of the
// span, whose activation codes and row sums lie gs apart along K; the MLP's
// blocks take the 32 byte rows of Wd that hold 32 columns of F of an even
// group and the 32 of the odd group beside it, so no loaded nibble is wasted.

#include "fused_gemv.cuh"

namespace {

__global__ void __launch_bounds__(fgemv::THREADS) norm_gemv_span_kernel(fgemv::GemvArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  fgemv::gemv_body<true, fgemv::Span>(a, smem);
}

__global__ void __launch_bounds__(fgemv::THREADS) requant_gemv_span_kernel(fgemv::GemvArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  fgemv::gemv_body<false, fgemv::Span>(a, smem);
}

__global__ void __launch_bounds__(fgemv::THREADS) mlp_decode_span_kernel(fgemv::MlpArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  fgemv::mlp_body<fgemv::Span>(a, smem);
}

__global__ void mlp_decode_span_epilogue(const int* __restrict__ acc, int M, int D,
                                         const float* __restrict__ alpha,
                                         const float* __restrict__ beta,
                                         const float* __restrict__ x, int fuse_residual,
                                         float* __restrict__ out) {
  fgemv::mlp_epilogue_body(acc, M, D, alpha, beta, x, fuse_residual, out);
}

bool span_shapes_ok(int M, int N, int K, int gs) {
  return fgemv::gemv_shapes_ok(M, N, K, gs) && K % (2 * gs) == 0;
}

fgemv::GemvArgs gemv_args(const void* x, const void* qw, const void* s_hi, const void* s_lo,
                          const void* z_hi, const void* z_lo, const void* alpha,
                          const void* beta, void* out, void* codes_out, int M, int N, int K,
                          int gs) {
  fgemv::GemvArgs a{};
  a.x = static_cast<const float*>(x);
  a.qw = static_cast<const uint8_t*>(qw);
  a.sr = {static_cast<const int8_t*>(s_hi), static_cast<const int8_t*>(s_lo),
          static_cast<size_t>(N)};
  a.zr = {static_cast<const int8_t*>(z_hi), static_cast<const int8_t*>(z_lo),
          static_cast<size_t>(N)};
  a.alpha = static_cast<const float*>(alpha);
  a.beta = static_cast<const float*>(beta);
  a.out = static_cast<float*>(out);
  a.codes_out = static_cast<int8_t*>(codes_out);
  a.M = M;
  a.N = N;
  a.K = K;
  a.gs = gs;
  a.rows_pass = fgemv::gemv_rows_per_pass(M, K, gs);
  return a;
}

}  // namespace

extern "C" {

// x (M, K) f32; ln_w (K,) f32; ln_b (K,) f32 or null; qw (K/2, N) span bytes;
// s_hi/s_lo/z_hi/z_lo (G/2, N) int8 compact plane rows (G = K / gs; even
// groups in *_hi, odd in *_lo); alpha (N,) f32; beta (N,) f32 or null; out
// (M, N) f32; codes_out (M, K) int8 or null (receives the RMSNormQ codes).
int fused_norm_gemv(const void* x, const void* ln_w, const void* ln_b, float eps, const void* qw,
                    const void* s_hi, const void* s_lo, const void* z_hi, const void* z_lo,
                    const void* alpha, const void* beta, void* out, void* codes_out, int M,
                    int N, int K, int gs, int sms, void* stream) {
  if (!span_shapes_ok(M, N, K, gs)) return fgemv::BAD_ARGS;
  fgemv::GemvArgs a =
      gemv_args(x, qw, s_hi, s_lo, z_hi, z_lo, alpha, beta, out, codes_out, M, N, K, gs);
  a.lnw = static_cast<const float*>(ln_w);
  a.lnb = static_cast<const float*>(ln_b);
  a.eps = eps;
  if (a.rows_pass == 0) return fgemv::BAD_ARGS;
  return static_cast<int>(
      fgemv::launch_gemv(norm_gemv_span_kernel, a, sms, static_cast<cudaStream_t>(stream)));
}

// x (M, K) f32; in_scale one f32 on the device; qw and the plane rows as
// above; residual (M, N) f32 or null; codes_out receives the requant codes.
int fused_requant_gemv(const void* x, const void* in_scale, float qmin, const void* qw,
                       const void* s_hi, const void* s_lo, const void* z_hi, const void* z_lo,
                       const void* alpha, const void* beta, const void* residual, void* out,
                       void* codes_out, int M, int N, int K, int gs, int sms, void* stream) {
  if (!span_shapes_ok(M, N, K, gs) || !in_scale) return fgemv::BAD_ARGS;
  fgemv::GemvArgs a =
      gemv_args(x, qw, s_hi, s_lo, z_hi, z_lo, alpha, beta, out, codes_out, M, N, K, gs);
  a.in_scale = static_cast<const float*>(in_scale);
  a.qmin = qmin;
  a.residual = static_cast<const float*>(residual);
  if (a.rows_pass == 0) return fgemv::BAD_ARGS;
  return static_cast<int>(
      fgemv::launch_gemv(requant_gemv_span_kernel, a, sms, static_cast<cudaStream_t>(stream)));
}

// x (M, D) f32; ln_w/ln_b as above; down_scale one f32 on the device; gu_qw
// (D/2, 2F) span bytes [gate | up] with (Gd/2, 2F) int8 plane rows and
// gu_alpha (2F,) f32; d_qw (F/2, D) span bytes with (8 Gf, D) int8 replicated
// scales and zeros, d_alpha (D,) f32, d_beta (D,) f32 or null; acc (M, D)
// int32 scratch (zeroed here); out (M, D) f32; xq_out (M, D) and h_out (M, F)
// int8 or null (receive the norm and down-input codes).
int fused_mlp_decode(const void* x, const void* ln_w, const void* ln_b, float eps,
                     const void* down_scale, const void* gu_qw, const void* gu_s_hi,
                     const void* gu_s_lo, const void* gu_z_hi, const void* gu_z_lo,
                     const void* gu_alpha, const void* d_qw, const void* d_ws, const void* d_wz,
                     const void* d_alpha, const void* d_beta, int fuse_residual, void* acc,
                     void* out, void* xq_out, void* h_out, int M, int D, int F, int gs, int sms,
                     void* stream) {
  return fgemv::launch_mlp<fgemv::Span>(
      mlp_decode_span_kernel, mlp_decode_span_epilogue, x, ln_w, ln_b, eps, down_scale, gu_qw,
      gu_s_hi, gu_s_lo, gu_z_hi, gu_z_lo, gu_alpha, d_qw, d_ws, d_wz, d_alpha, d_beta,
      fuse_residual, acc, out, xq_out, h_out, M, D, F, gs, stream);
}

}  // extern "C"
