// K6: the whole LLaMA MLP of a decode step, for Hopper (sm_90a).
//
// Replaces the TPU kernel dgq_tpu/ops/fused_decode.py::fused_mlp_decode_rp
// (body _mlp_rp_kernel).  For the M <= 64 rows of a decode step or a short
// verify window:
//   q  = RMSNormQ(x)                                   (as K4)
//   g  = float(q @ Wg) * alpha_g,  u = float(q @ Wu) * alpha_u
//   hq = clip(round(((g * sigmoid(g)) * u) / down_scale), -128, 127)
//   out = float(hq @ Wd) * alpha_d (+ beta_d) (+ x)
// with all three weights rowpair-packed int4, gate|up with compact plane
// rows and down with 8x-replicated scale and zero rows (row 8g is read).
// sigmoid is 1 / (1 + expf(-g)) with IEEE division, as torch computes it.
//
// What bounds it on this card: the weight bytes, 3*D*F/2 (69 MB for
// LLaMA-7B), over the 3.35 TB/s of device memory.  The TPU kernel walks F in
// 512-column blocks in order, carrying the down product in VMEM scratch.
// Here each block takes one 64-column F block (176 blocks at F = 11264 for
// 132 SMs): it makes the RMSNormQ codes of all rows, its gate and up columns,
// the SiLU * up codes of its block, and the (M, D) int32 partial of the down
// product over its 64 rows of Wd, which it adds into an int32 accumulator
// with atomics.  int32 addition is exact in any order, so the sum is
// deterministic; a second small kernel then applies the fp32 epilogue once.
// The body (fgemv::mlp_body) is shared with K12's MLP on span weights.

#include "fused_gemv.cuh"

namespace {

__global__ void __launch_bounds__(fgemv::THREADS) mlp_decode_rp_kernel(fgemv::MlpArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  fgemv::mlp_body<fgemv::Rowpair>(a, smem);
}

__global__ void mlp_decode_rp_epilogue(const int* __restrict__ acc, int M, int D,
                                       const float* __restrict__ alpha,
                                       const float* __restrict__ beta,
                                       const float* __restrict__ x, int fuse_residual,
                                       float* __restrict__ out) {
  fgemv::mlp_epilogue_body(acc, M, D, alpha, beta, x, fuse_residual, out);
}

}  // namespace

extern "C" {

// x (M, D) f32; ln_w (D,) f32; ln_b (D,) f32 or null; down_scale one f32 on
// the device; gu_qw (D/2, 2F) rowpair bytes with (Gd/2, 2F) int8 plane rows
// and gu_alpha (2F,) f32; d_qw (F/2, D) rowpair bytes with (8 Gf, D) int8
// replicated scales and zeros, d_alpha (D,) f32, d_beta (D,) f32 or null;
// acc (M, D) int32 scratch (zeroed here); out (M, D) f32; xq_out (M, D) and
// h_out (M, F) int8 or null (receive the norm and down-input codes).
int fused_mlp_decode_rp(const void* x, const void* ln_w, const void* ln_b, float eps,
                        const void* down_scale, const void* gu_qw, const void* gu_s_hi,
                        const void* gu_s_lo, const void* gu_z_hi, const void* gu_z_lo,
                        const void* gu_alpha, const void* d_qw, const void* d_ws,
                        const void* d_wz, const void* d_alpha, const void* d_beta,
                        int fuse_residual, void* acc, void* out, void* xq_out, void* h_out,
                        int M, int D, int F, int gs, int sms, void* stream) {
  return fgemv::launch_mlp<fgemv::Rowpair>(
      mlp_decode_rp_kernel, mlp_decode_rp_epilogue, x, ln_w, ln_b, eps, down_scale, gu_qw,
      gu_s_hi, gu_s_lo, gu_z_hi, gu_z_lo, gu_alpha, d_qw, d_ws, d_wz, d_alpha, d_beta,
      fuse_residual, acc, out, xq_out, h_out, M, D, F, gs, stream);
}

}  // extern "C"
