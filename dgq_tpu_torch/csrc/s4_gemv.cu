// P3 and P4: the s4 GEMV of the native-int4 probes, for Hopper (sm_90a).
//
// Replaces the TPU kernels of scripts/probe_native_s4.py:
//   pallas_s4          (body _s4_kernel): out (M, N) int32 = x (M, K) . W (K, N)
//                      with W an int4 array, here packed two per byte in XLA's
//                      order: W[k, 2j] is the low nibble of byte (k, j), W[k, 2j+1]
//                      its high nibble;
//   pallas_s4_bitcast  (body _s4_bitcast_kernel): the same dot from (K, N/2)
//                      bytes bitcast to int4 inside the kernel.  The bitcast of a
//                      (K, bn/2) block gives 2K rows, row 2r the low nibbles of
//                      byte row r and 2r+1 its high nibbles (the on-chip finding
//                      recorded at dgq_tpu/ops/fused_decode.py:158-161); the
//                      probe's reshape(K, bn) then makes each bn columns of W
//                      [low nibbles | high nibbles] of their bn/2 bytes.
// and the two of scripts/probe_s4_bitcast_numerics.py, kern (the bitcast dot
// at K 256 on one 256-column block) and pl_bitcast (pallas_s4_bitcast's body
// again), which run pallas_s4_bitcast's kernel.  x holds int4 codes in
// [-8, 8) as int8.
//
// Hopper's tensor cores take no int4 operand, so the kernel reads the packed
// bytes, sign-extends the nibbles to int8 in registers and runs s8 mma.sync:
// it measures the nibble-unpack cost that K1, K4-K6 and K12 pay on their
// weights.  What bounds it on this card: the K * N / 2 weight bytes (25.2 MB
// at K 4096, N 12288) over the 3.35 TB/s of device memory.  One body for
// both column maps (s8_mma.cuh's skinny tensor-core block, K split over
// blocks that add into a zeroed output).

#include "s8_mma.cuh"

namespace {

template <int MODE>
__global__ void __launch_bounds__(SK_THREADS)
s4_gemv_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ wb, int* __restrict__ out,
               int M, int N, int K, int bn) {
  __shared__ __align__(16) SkinnySmem sm;
  skinny_mma_block<MODE>(x, M, K, wb, N / 2, blockIdx.x, bn, out, N, sm);
}

}  // namespace

extern "C" {

// x (M, K) int8 codes with M <= 16; wb (K, N / 2) bytes; out (M, N) int32
// (zeroed when ksplit > 1).  halves 0: XLA's pair order (pallas_s4); 1: [low |
// high] per bn columns (pallas_s4_bitcast), bn a multiple of 64 dividing N.
// N % 64 == 0, K % 128 == 0, 1 <= ksplit <= K / 128.
int s4_gemv(const void* x, const void* wb, void* out, int M, int N, int K, int halves, int bn,
            int ksplit, void* stream) {
  if (M <= 0 || M > 16 || N <= 0 || N % SK_BN || K <= 0 || K % SK_BK || ksplit < 1 ||
      ksplit > K / SK_BK)
    return cudaErrorInvalidValue;
  if (halves && (bn <= 0 || bn % 64 || N % bn)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto xs = static_cast<const int8_t*>(x);
  auto ws = static_cast<const uint8_t*>(wb);
  auto o = static_cast<int*>(out);
  const dim3 grid(N / SK_BN, ksplit);
  if (halves)
    s4_gemv_kernel<W_S4_HALVES><<<grid, SK_THREADS, 0, st>>>(xs, ws, o, M, N, K, bn);
  else
    s4_gemv_kernel<W_S4_PAIRS><<<grid, SK_THREADS, 0, st>>>(xs, ws, o, M, N, K, bn);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
