// K1: W4A8 GEMM on rowpair-packed int4 weights, for Hopper (sm_90a).
//
// Replaces the TPU kernel dgq_tpu/ops/quant_matmul.py::w4a8_matmul_rp_pipe
// (body _rp_pipe_kernel, dequant _rp_deq).  Computes
//   out[m, n] = float(sum_k x[m, k] * w[k, n]) * alpha[n] (+ beta[n])
// with x int8 (M, K), w the int8 dequantisation (c4 - (z - 8)) * s of the
// sign-extended nibble c4 (byte r of qw holds row 2r in its low nibble and
// row 2r+1 in its high nibble), exact s8 x s8 -> s32 accumulation and an fp32
// epilogue rounded exactly as the plain version (no fma contraction).
//
// What bounds it on this card: at decode (M = batch rows <= 16) the weight
// bytes, K*N/2, over the 3.35 TB/s of device memory; at prefill (M = 1024) the
// int8 tensor-core rate.  Hopper has no int4 tensor-core operand.  The main
// loop (TMA ring, wgmma with the weights as register fragments, the K split)
// and the loader that turns a stage of 64 packed rows (128 logical k, two
// 64-k halves of x) into int8 fragments (RowpairLoader<1>, shared with K4
// and K5) are w4a8_gemm_sm90.cuh's.

#include "w4a8_gemm_sm90.cuh"

extern "C" {

// x (M, K) int8; qw (K/2, N) rowpair bytes; scales/zeros: group g at row
// g * srep of an (G * srep, N) int8 array; alpha (N,) f32; beta (N,) f32 or
// null; out (M, N) f32.  The plan (ops/quant_matmul.py gemm_plan): tile 0 the
// prefill tile (256 rows x 128 columns), 1 the decode tile (16 rows);
// `splits` K splits of `sps` stages of 128 k; part (splits, M, N) int32
// scratch when splits > 1.
int w4a8_rp_gemm(const void* x, const void* qw, const void* scales, const void* zeros, int srep,
                 int M, int N, int K, int gs, int tile, int splits, int sps, const void* alpha,
                 const void* beta, void* out, void* part, void* stream) {
  const int nst = (K + 127) / 128;
  if (M <= 0 || N <= 0 || N % 16 || K <= 0 || K % 64 || gs <= 0 || gs % 64 || K % gs ||
      sps <= 0 || splits != (nst + sps - 1) / sps || (splits > 1 && !part) || tile < 0 || tile > 1)
    return cudaErrorInvalidValue;
  GemmArgs a{static_cast<const int8_t*>(scales), static_cast<const int8_t*>(zeros), srep, gs,
             M, N, K, nst, sps, static_cast<const float*>(alpha),
             static_cast<const float*>(beta), out, splits > 1 ? static_cast<int*>(part) : nullptr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile == 0) return launch_gemm<RowpairLoader<1>, 256, 5, OUT_F32>(x, qw, K / 2, a, splits, st);
  return launch_gemm<RowpairLoader<1>, 16, 16, OUT_F32>(x, qw, K / 2, a, splits, st);
}

}  // extern "C"
