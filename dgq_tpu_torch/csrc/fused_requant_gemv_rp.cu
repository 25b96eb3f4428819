// K5: requant + W4A8 GEMV + residual on rowpair-packed int4 weights, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel dgq_tpu/ops/fused_decode.py::fused_requant_gemv_rp
// (body _requant_gemv_rp_kernel).  Computes, for the M <= 64 rows of a decode
// step or a short verify window,
//   out[m, n] = float(sum_k q[m, k] * w[k, n]) * alpha[n] (+ beta[n]) (+ res[m, n]),
//   q = clip(round(x / in_scale), qmin, 127)   (qmin = -127 for o_proj),
// with the weights as in K4 and each fp32 step rounded separately, as the
// plain version rounds them.  in_scale is read on the device: no host sync.
//
// What bounds it on this card: the weight bytes, K*N/2 (8.4 MB for
// LLaMA-7B's o_proj), over the 3.35 TB/s of device memory.  The TPU kernel
// requantises once at grid step 0; here every block requantises all M rows
// into shared memory (an elementwise map, so all blocks agree), then streams
// its 32-column tiles as K4 does (fused_gemv.cuh).

#include "fused_gemv.cuh"

namespace {

__global__ void __launch_bounds__(fgemv::THREADS) requant_gemv_rp_kernel(fgemv::GemvArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  fgemv::gemv_body<false, fgemv::Rowpair>(a, smem);
}

}  // namespace

extern "C" {

// x (M, K) f32; in_scale one f32 on the device; qw (K/2, N) rowpair bytes;
// s_hi/s_lo/z_hi/z_lo (G/2, N) int8 compact plane rows; alpha (N,) f32; beta
// (N,) f32 or null; residual (M, N) f32 or null; out (M, N) f32; codes_out
// (M, K) int8 or null (receives the requant codes).
int fused_requant_gemv_rp(const void* x, const void* in_scale, float qmin, const void* qw,
                          const void* s_hi, const void* s_lo, const void* z_hi, const void* z_lo,
                          const void* alpha, const void* beta, const void* residual, void* out,
                          void* codes_out, int M, int N, int K, int gs, int sms, void* stream) {
  if (!fgemv::gemv_shapes_ok(M, N, K, gs) || !in_scale) return fgemv::BAD_ARGS;
  fgemv::GemvArgs a{};
  a.x = static_cast<const float*>(x);
  a.in_scale = static_cast<const float*>(in_scale);
  a.qmin = qmin;
  a.qw = static_cast<const uint8_t*>(qw);
  a.sr = {static_cast<const int8_t*>(s_hi), static_cast<const int8_t*>(s_lo),
          static_cast<size_t>(N)};
  a.zr = {static_cast<const int8_t*>(z_hi), static_cast<const int8_t*>(z_lo),
          static_cast<size_t>(N)};
  a.alpha = static_cast<const float*>(alpha);
  a.beta = static_cast<const float*>(beta);
  a.residual = static_cast<const float*>(residual);
  a.out = static_cast<float*>(out);
  a.codes_out = static_cast<int8_t*>(codes_out);
  a.M = M;
  a.N = N;
  a.K = K;
  a.gs = gs;
  a.rows_pass = fgemv::gemv_rows_per_pass(M, K, gs);
  if (a.rows_pass == 0) return fgemv::BAD_ARGS;
  return static_cast<int>(
      fgemv::launch_gemv(requant_gemv_rp_kernel, a, sms, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
