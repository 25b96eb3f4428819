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
// requantises once at grid step 0; here every block requantises its own K
// range of all rows (an elementwise map, so all blocks agree) while its
// first weight stages are in flight, and K is split so that the 32 column
// tiles of o_proj still cover the card; the body is K4's
// (fused_gemv_sm90.cuh).

#include "fused_gemv_sm90.cuh"

namespace {

template <int BM, int QS>
__global__ void __launch_bounds__(F_THREADS, 1)
requant_gemv_rp_sm90(const __grid_constant__ CUtensorMap tm_w,
                     const __grid_constant__ CUtensorMap tm_shi,
                     const __grid_constant__ CUtensorMap tm_slo,
                     const __grid_constant__ CUtensorMap tm_zhi,
                     const __grid_constant__ CUtensorMap tm_zlo,
                     const __grid_constant__ FusedArgs a) {
  fused_gemv_body<F_REQUANT, BM, FusedRowpair<QS>>(tm_w, tm_shi, tm_slo, tm_zhi, tm_zlo, a);
}

__global__ void requant_gemv_rp_combine(const FusedArgs a, int splits) {
  fused_combine_body(a, splits);
}

struct Kernels {
  static constexpr int MODE = F_REQUANT;
  template <int BM, int QS>
  static auto gemv() { return requant_gemv_rp_sm90<BM, QS>; }
  static auto combine() { return requant_gemv_rp_combine; }
};

}  // namespace

extern "C" {

// x (M, K) f32; in_scale one f32 on the device; qw (K/2, N) rowpair bytes;
// s_hi/s_lo/z_hi/z_lo (G/2, N) int8 compact plane rows; alpha (N,) f32; beta
// (N,) f32 or null; residual (M, N) f32 or null; out (M, N) f32; codes_out
// (M, K) int8 or null (receives the requant codes).  The plan as K4's.
// Returns a cudaError_t, or -1 when it rejects its arguments.
int fused_requant_gemv_rp(const void* x, const void* in_scale, float qmin, const void* qw,
                          const void* s_hi, const void* s_lo, const void* z_hi, const void* z_lo,
                          const void* alpha, const void* beta, const void* residual, void* out,
                          void* codes_out, int M, int N, int K, int gs, int bm, int splits,
                          int sps, int cluster, void* part, void* stream) {
  if (!in_scale) return F_BAD_ARGS;
  FusedArgs a{};
  a.x = static_cast<const float*>(x);
  a.in_scale = static_cast<const float*>(in_scale);
  a.qmin = qmin;
  a.alpha = static_cast<const float*>(alpha);
  a.beta = static_cast<const float*>(beta);
  a.residual = static_cast<const float*>(residual);
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
