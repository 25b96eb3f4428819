// K12's MLP entry: the whole LLaMA MLP of a decode step on span-layout int4
// weights in one call, for Hopper (sm_90a).
//
// Replaces the TPU kernel dgq_tpu/ops/fused_decode.py::fused_mlp_decode (body
// _mlp_kernel), which the JAX engine takes for decode steps and
// speculative-verification windows (M <= 64 rows) when a layer has no rowpair
// copy.  It computes K6's chain (RMSNormQ, gate|up, SiLU(g) * u, requant,
// down, acc * alpha_d (+ beta_d) (+ x)) with W dequantised to int8 as
// (c - z) * s, c the unsigned span nibble codes: byte row t gs + i holds row
// t span + i (group 2t) in its high nibble and row t span + gs + i (group
// 2t+1) in its low one.  The int32 accumulators equal K6's on pack_rowpair_s4
// of the same weights bit for bit.  K12's norm and requant entries live in
// fused_gemv_span_sm90.cu, on K4's and K5's TMA + wgmma loop.
//
// What bounds it on this card: the weight bytes (K*N/2; 69 MB for LLaMA-7B's
// MLP) over the 3.35 TB/s of device memory; the rows are few.  The design is
// the first one of K6 (fused_gemv.cuh; K6 has since moved to TMA + wgmma):
// every block makes the codes of all rows in the same fixed order, then its
// warps stream 32-column weight tiles through mma.sync on raw codes with the
// scale and zero applied once per group.  The blocks take the 32 byte rows of
// Wd that hold 32 columns of F of an even group and the 32 of the odd group
// beside it, so no loaded nibble is wasted.

#include "fused_gemv.cuh"

namespace {

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

}  // namespace

extern "C" {

// x (M, D) f32; ln_w (D,) f32; ln_b (D,) f32 or null; down_scale one f32 on
// the device; gu_qw (D/2, 2F) span bytes [gate | up] with (Gd/2, 2F) int8
// plane rows and gu_alpha (2F,) f32; d_qw (F/2, D) span bytes with (8 Gf, D) int8 replicated
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
