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
// is w4a8_gemm_sm90.cuh's; this file holds the loader that turns a stage of 64
// packed rows (128 logical k, two 64-k halves of x) into int8 fragments.

#include "w4a8_gemm_sm90.cuh"

namespace {

// Stage st: packed rows 64 st .. 64 st + 63, logical k 128 st .. 128 st + 127
// in order (row r: k 2r low nibble, 2r + 1 high nibble); half h is x's
// k 128 st + 64 h .. + 63, one group (groupsize % 64 == 0).  The 32-k step kk
// of half h is packed rows 32 h + 16 kk .. + 15, and a thread's k 4t .. 4t + 3
// and 16 + 4t .. + 3 of it are rows 2t, 2t + 1 and 8 + 2t, 9 + 2t: one
// permute of 4 rows gives both fragment words of each column.
struct RowpairLoader {
  static constexpr int HB = 64, SRC_ROWS = 64;
  static constexpr bool SCALED = true;
  struct Scales {
    uint32_t s[2][2], b[2][2];  // per half, per column of the pair
  };

  static __device__ __forceinline__ int x_k(const GemmArgs&, int st, int h) { return 128 * st + 64 * h; }
  // past K (a last stage of 64 k) the group is past the scale rows: TMA fills zeros
  static __device__ __forceinline__ int group(const GemmArgs& a, int st, int h) {
    return (128 * st + 64 * h) / a.gs;
  }

  static __device__ __forceinline__ void scales(const uint8_t* scl, int cp, Scales& sc) {
    col_scales(scl, 0, cp, sc.s[0], sc.b[0]);
    col_scales(scl, 1, cp, sc.s[1], sc.b[1]);
  }

  static __device__ __forceinline__ void frags(const uint8_t* rows, const Scales& sc, int cp, int t,
                                               int kk, Frags& a) {
    constexpr uint32_t M4 = 0x000F000F;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t c[2];
      quad(rows, cp, 32 * h + 16 * kk + 2 * t, 1, 8, 9, c);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint32_t w = c[j] ^ 0x88888888u;  // codes c4 + 8 in 0..15
        // low nibbles: k 4t, 4t + 2, 16 + 4t, 16 + 4t + 2; high nibbles one further
        const uint32_t lo = deq4(w & M4, (w >> 8) & M4, sc.s[h][j], sc.b[h][j]);
        const uint32_t hi = deq4((w >> 4) & M4, (w >> 12) & M4, sc.s[h][j], sc.b[h][j]);
        put_col(a[h], j, __byte_perm(lo, hi, 0x5140), __byte_perm(lo, hi, 0x7362));
      }
    }
  }
};

}  // namespace

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
  if (tile == 0) return launch_gemm<RowpairLoader, 256, 5, OUT_F32>(x, qw, K / 2, a, splits, st);
  return launch_gemm<RowpairLoader, 16, 16, OUT_F32>(x, qw, K / 2, a, splits, st);
}

}  // extern "C"
