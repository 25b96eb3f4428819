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
// every block makes the codes of its own K range itself, each row's sum of
// squares over all of K in the same fixed order, while its first weight
// stages are in flight; the body is fused_gemv_sm90.cuh's (the TMA ring and
// wgmma loop of K1, one token-row tile for all rows, a K split summed by a
// second kernel).

#include "fused_gemv_sm90.cuh"

namespace {

template <int BM, int QS>
__global__ void __launch_bounds__(F_THREADS, 1)
norm_gemv_rp_sm90(const __grid_constant__ CUtensorMap tm_w,
                  const __grid_constant__ CUtensorMap tm_shi,
                  const __grid_constant__ CUtensorMap tm_slo,
                  const __grid_constant__ CUtensorMap tm_zhi,
                  const __grid_constant__ CUtensorMap tm_zlo, const __grid_constant__ FusedArgs a) {
  fused_gemv_body<F_NORM, BM, FusedRowpair<QS>>(tm_w, tm_shi, tm_slo, tm_zhi, tm_zlo, a);
}

__global__ void norm_gemv_rp_combine(const FusedArgs a, int splits) {
  fused_combine_body(a, splits);
}

struct Kernels {
  static constexpr int MODE = F_NORM;
  template <int BM, int QS>
  static auto gemv() { return norm_gemv_rp_sm90<BM, QS>; }
  static auto combine() { return norm_gemv_rp_combine; }
};

}  // namespace

extern "C" {

// x (M, K) f32; ln_w (K,) f32; ln_b (K,) f32 or null; qw (K/2, N) rowpair
// bytes; s_hi/s_lo/z_hi/z_lo (G/2, N) int8 compact plane rows (G = K / gs);
// alpha (N,) f32; beta (N,) f32 or null; out (M, N) f32; codes_out (M, K)
// int8 or null (receives the RMSNormQ codes).  The plan
// (ops/fused_decode.py fused_plan): bm token rows (8, 16, 32, 48 or 64),
// `splits` K splits of `sps` stages of 128 k, clusters of `cluster` column
// tiles; part (splits, M, N) int32 scratch when splits > 1, summed by a
// second launch.  Returns a cudaError_t, or -1 when it rejects its
// arguments.
int fused_norm_gemv_rp(const void* x, const void* ln_w, const void* ln_b, float eps,
                       const void* qw, const void* s_hi, const void* s_lo, const void* z_hi,
                       const void* z_lo, const void* alpha, const void* beta, void* out,
                       void* codes_out, int M, int N, int K, int gs, int bm, int splits, int sps,
                       int cluster, void* part, void* stream) {
  if (!ln_w) return F_BAD_ARGS;
  FusedArgs a{};
  a.x = static_cast<const float*>(x);
  a.lnw = static_cast<const float*>(ln_w);
  a.lnb = static_cast<const float*>(ln_b);
  a.eps = eps;
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
  const void* const planes[4] = {s_hi, s_lo, z_hi, z_lo};
  return launch_fused<Kernels>(a, bm, splits, cluster, qw, planes,
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
