// P1: the pure s8 x s8 -> s32 GEMM of the INT8 ceiling probe, for Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/roofline_probe.py::s8_matmul (body
// _s8_kernel): out (M, N) f32 = float(x (M, K) int8 . w (K, N) int8), the
// int32 accumulator converted with __int2float_rn (round to nearest even, as
// the plain version's .float(): the sums reach ~6.6e7 > 2^24 at K = 4096).
// No unpack and no dequantisation: beside the fused W4A8 GEMMs (K1, K9) it
// says how much of their gap to the int8 peak is the nibble unpack and how
// much the mma.sync main loop itself.
//
// What bounds it on this card: at M = 2048, N = K = 4096 the 2MNK int8
// operations over the 1979 TOP/s of the tensor cores (0.035 ms), not the
// 44 MB moved.  Design: BM x BN output tiles (template parameters, the
// probe's tilings), K in chunks of 128; x rows are copied to shared memory
// as they are, w rows (n-contiguous) are turned into k-contiguous columns by
// a 4x4 byte transpose on the way in; the next chunk is loaded into
// registers while the current one feeds mma.sync m16n8k32.  No TMA, wgmma
// or shared-memory pipeline: the probe measures this main loop, the one K1
// and K9 use.

#include "s8_mma.cuh"

namespace {

constexpr int BK = 128;
constexpr int LDS = BK + 16;

template <int BM, int BN, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
s8_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               float* __restrict__ out, int M, int N, int K) {
  constexpr int NTHREADS = WARPS_M * WARPS_N * 32;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MT = WM / 16, NT = WN / 8;
  constexpr int A_UNITS = BM * BK / 16 / NTHREADS;         // 16-byte pieces of x per thread
  constexpr int B_UNITS = (BK / 4) * (BN / 16) / NTHREADS;  // 4 x 16-byte units of w per thread
  static_assert(WM % 16 == 0 && WN % 8 == 0, "warp tile");
  static_assert(A_UNITS * NTHREADS * 16 == BM * BK, "x chunk");
  static_assert(B_UNITS * NTHREADS == (BK / 4) * (BN / 16), "w chunk");
  __shared__ __align__(16) int8_t sA[BM * LDS];  // [m][k]
  __shared__ __align__(16) int8_t sB[BN * LDS];  // [n][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  uint4 ra[A_UNITS];
  uint4 rb[B_UNITS][4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_UNITS; ++i) {
      const int u = tid + i * NTHREADS, r = u / (BK / 16), c = u % (BK / 16);
      ra[i] = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k0 + c * 16);
    }
#pragma unroll
    for (int i = 0; i < B_UNITS; ++i) {
      const int u = tid + i * NTHREADS, kr = u / (BN / 16), cg = u % (BN / 16);
      const int8_t* p = w + (size_t)(k0 + 4 * kr) * N + n0 + cg * 16;
#pragma unroll
      for (int r = 0; r < 4; ++r) rb[i][r] = *reinterpret_cast<const uint4*>(p + (size_t)r * N);
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < A_UNITS; ++i) {
      const int u = tid + i * NTHREADS, r = u / (BK / 16), c = u % (BK / 16);
      *reinterpret_cast<uint4*>(sA + r * LDS + c * 16) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_UNITS; ++i) {
      const int u = tid + i * NTHREADS, kr = u / (BN / 16), cg = u % (BN / 16);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t c[4];
        transpose4x4(u4_word(rb[i][0], q), u4_word(rb[i][1], q), u4_word(rb[i][2], q),
                     u4_word(rb[i][3], q), c);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<uint32_t*>(sB + (cg * 16 + q * 4 + j) * LDS + 4 * kr) = c[j];
      }
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    stage();
    __syncthreads();
    if (k0 + BK < K) fetch(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int8_t* p = sA + (wm * WM + i * 16 + g) * LDS + kk + t * 4;
        a[i][0] = ld32(p);
        a[i][1] = ld32(p + 8 * LDS);
        a[i][2] = ld32(p + 16);
        a[i][3] = ld32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* p = sB + (wn * WN + j * 8 + g) * LDS + kk + t * 4;
        b[j][0] = ld32(p);
        b[j][1] = ld32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * WM + i * 16 + g + h * 8;
        const int n = n0 + wn * WN + j * 8 + t * 2;
        *reinterpret_cast<float2*>(out + (size_t)m * N + n) =
            make_float2(__int2float_rn(acc[i][j][2 * h]), __int2float_rn(acc[i][j][2 * h + 1]));
      }
}

template <int BM, int BN, int WARPS_M, int WARPS_N>
int launch(const int8_t* x, const int8_t* w, float* out, int M, int N, int K, cudaStream_t st) {
  if (M % BM || N % BN) return cudaErrorInvalidValue;
  const dim3 grid(N / BN, M / BM);
  s8_gemm_kernel<BM, BN, WARPS_M, WARPS_N><<<grid, WARPS_M * WARPS_N * 32, 0, st>>>(x, w, out, M, N, K);
  return 0;
}

}  // namespace

extern "C" {

// x (M, K) int8, w (K, N) int8, out (M, N) f32; tiling 0: 128 x 128 output
// tiles, 8 warps; 1: 64 x 128, 4 warps.  M and N multiples of the tile, K of
// 128.
int s8_gemm(const void* x, const void* w, void* out, int M, int N, int K, int tiling,
            void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % BK) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto xs = static_cast<const int8_t*>(x);
  auto ws = static_cast<const int8_t*>(w);
  auto o = static_cast<float*>(out);
  int rc;
  if (tiling == 0)
    rc = launch<128, 128, 2, 4>(xs, ws, o, M, N, K, st);
  else if (tiling == 1)
    rc = launch<64, 128, 2, 2>(xs, ws, o, M, N, K, st);
  else
    rc = cudaErrorInvalidValue;
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
