// P1: the pure s8 x s8 -> s32 GEMM of the INT8 ceiling probe, for Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/roofline_probe.py::s8_matmul (body
// _s8_kernel): out (M, N) f32 = float(x (M, K) int8 . w (K, N) int8), the
// int32 accumulator converted with __int2float_rn (round to nearest even, as
// the plain version's .float(): the sums reach ~6.6e7 > 2^24 at K = 4096).
// No unpack and no dequantisation: it runs the main loop of the fused W4A8
// GEMMs K1 and K9 (w4a8_gemm_sm90.cuh: TMA ring, wgmma, the consumers'
// 4x4 byte transpose of n-contiguous weight rows into K-major fragments)
// with a loader that only transposes into the register fragments, so beside
// K1 and K9 it says how much of their gap to the int8 peak is the nibble unpack
// and how much the loop.
//
// What bounds it on this card: at M = 2048, N = K = 4096 the 2MNK int8
// operations over the 1979 TOP/s of the tensor cores (0.035 ms), not the
// 44 MB moved.

#include "w4a8_gemm_sm90.cuh"

namespace {

// Stage st: rows 128 st .. + 127 of w, x's k 128 st + 64 h .. + 63 in half h;
// the 32-k step kk of half h is rows 64 h + 32 kk .. + 31.
struct S8Loader {
  static constexpr int HB = 64, SRC_ROWS = 128;
  static constexpr bool SCALED = false, FP = false;
  struct Scales {};

  static __device__ __forceinline__ int x_k(const GemmArgs&, int st, int h) { return 128 * st + 64 * h; }
  static __device__ __forceinline__ int group(const GemmArgs&, int, int) { return 0; }
  static __device__ __forceinline__ void scales(const uint8_t*, int, Scales&) {}

  static __device__ __forceinline__ void frags(const uint8_t* rows, const Scales&, int cp, int t,
                                               int kk, Frags& a) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t c0[2], c16[2];
      quad(rows, cp, 64 * h + 32 * kk + 4 * t, 1, 2, 3, c0);
      quad(rows, cp, 64 * h + 32 * kk + 16 + 4 * t, 1, 2, 3, c16);
#pragma unroll
      for (int j = 0; j < 2; ++j) put_col(a[h], j, c0[j], c16[j]);
    }
  }
};

}  // namespace

extern "C" {

// x (M, K) int8, w (K, N) int8, out (M, N) f32; tiling 0: 256 rows x 128
// columns (K1's and K9's prefill tile), 1: 128 x 128.  K a multiple of 128.
int s8_gemm(const void* x, const void* w, void* out, int M, int N, int K, int tiling,
            void* stream) {
  if (M <= 0 || N <= 0 || N % 16 || K <= 0 || K % 128) return cudaErrorInvalidValue;
  const int nst = K / 128;
  GemmArgs a{nullptr, nullptr, 0, 0, M, N, K, nst, nst, nullptr, nullptr, out, nullptr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tiling == 0) return launch_gemm<S8Loader, 256, 4, OUT_RAW>(x, w, K, a, 1, st);
  if (tiling == 1) return launch_gemm<S8Loader, 128, 5, OUT_RAW>(x, w, K, a, 1, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
