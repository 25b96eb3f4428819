// K4: RMSNormQ + W4A8 GEMV on rowpair-packed int4 weights, for Hopper (sm_90a).
//
// Replaces the TPU kernel dgq_tpu/ops/fused_decode.py::fused_norm_gemv_rp
// (body _norm_gemv_rp_kernel).  Computes, for the M <= 64 rows of a decode
// step or a short verify window,
//   out[m, n] = float(sum_k q[m, k] * w[k, n]) * alpha[n] (+ beta[n]),
//   q = clip(round(x * rsqrt(mean(x * x) + eps) * ln_w (+ ln_b)), -128, 127),
// with w the int8 dequantisation (c4 - (z - 8)) * s of the compact even/odd
// group plane rows s_hi/s_lo/z_hi/z_lo, and the qkv projection's fp32
// epilogue rounded as the plain version (no fma contraction).
//
// What bounds it on this card: the weight bytes, K*N/2 (25 MB for LLaMA-7B's
// qkv), over the 3.35 TB/s of device memory; the rows are few.  The TPU
// kernel normalises once at grid step 0 into VMEM scratch and reuses it,
// which works because a TPU grid runs in order.  Here blocks run at once, so
// every block makes the codes of all M rows itself, in the same fixed
// reduction order (fgemv::rmsnorm_codes), and keeps them in shared memory;
// then its warps stream 32-column weight tiles, split over K, through
// mma.sync with the scale and zero applied once per group (fused_gemv.cuh).

#include "fused_gemv.cuh"

namespace {

__global__ void __launch_bounds__(fgemv::THREADS) norm_gemv_rp_kernel(fgemv::GemvArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  fgemv::gemv_body<true, fgemv::Rowpair>(a, smem);
}

}  // namespace

extern "C" {

// x (M, K) f32; ln_w (K,) f32; ln_b (K,) f32 or null; qw (K/2, N) rowpair
// bytes; s_hi/s_lo/z_hi/z_lo (G/2, N) int8 compact plane rows (G = K / gs);
// alpha (N,) f32; beta (N,) f32 or null; out (M, N) f32; codes_out (M, K)
// int8 or null (receives the RMSNormQ codes).
int fused_norm_gemv_rp(const void* x, const void* ln_w, const void* ln_b, float eps,
                       const void* qw, const void* s_hi, const void* s_lo, const void* z_hi,
                       const void* z_lo, const void* alpha, const void* beta, void* out,
                       void* codes_out, int M, int N, int K, int gs, int sms, void* stream) {
  if (!fgemv::gemv_shapes_ok(M, N, K, gs)) return fgemv::BAD_ARGS;
  fgemv::GemvArgs a{};
  a.x = static_cast<const float*>(x);
  a.lnw = static_cast<const float*>(ln_w);
  a.lnb = static_cast<const float*>(ln_b);
  a.eps = eps;
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
  if (a.rows_pass == 0) return fgemv::BAD_ARGS;
  return static_cast<int>(
      fgemv::launch_gemv(norm_gemv_rp_kernel, a, sms, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
