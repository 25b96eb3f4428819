// P2: the raw int8 GEMV engines at decode shapes, for Hopper (sm_90a).
//
// Replaces the TPU kernels of scripts/probe_gemv_engines.py, which set the
// TPU's matrix unit (MXU) against its vector unit (VPU) at M = 8:
//   mxu_gemv  (body _mxu_kernel): out (M, N) int32 = x (M, K) . w (K, N), here
//             on the tensor cores, mma.sync m16n8k32 with the M <= 8 rows padded
//             to 16 in registers (the padding rows are zero and never stored);
//   vpu_gemv  (body _vpu_kernel): row 0 only, here on the CUDA cores with
//             __dp4a, the weights transposed in registers and never staged;
//   mix_gemv  (body kern): one launch whose first nm / 64 blocks run the
//             tensor-core body on columns [0, nm) for every row and whose other
//             blocks run the dp4a body on [nm, N) for row 0: two outputs,
//             (M, nm) and (1, N - nm), as the TPU kernel's.
// Hopper's tensor cores and CUDA cores are the analogues of the MXU and the
// VPU: the engines the fused decode kernels K4-K6 and K12 choose between.
//
// What bounds them on this card: the K * N weight bytes (50.3 MB at K 4096,
// N 12288) over the 3.35 TB/s of device memory; the operations are 8 (or 1)
// rows' worth.  Both bodies read each weight byte once, 16 bytes per thread
// per row, and load the next 128-row chunk while they consume the current one;
// K is split over ksplit blocks per column block (atomicAdd into a zeroed
// output) so that enough loads are in flight.

#include "s8_mma.cuh"

namespace {

__global__ void __launch_bounds__(SK_THREADS)
mxu_gemv_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w, int* __restrict__ out,
                int M, int N, int K) {
  __shared__ __align__(16) SkinnySmem sm;
  skinny_mma_block<W_S8>(x, M, K, w, N, blockIdx.x, SK_BN, out, N, sm);
}

__global__ void __launch_bounds__(SK_THREADS)
vpu_gemv_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w, int* __restrict__ out,
                int N, int K) {
  __shared__ int red[SK_THREADS / 32][SK_BN];
  skinny_dp4a_block(x, K, w, N, blockIdx.x, out, red);
}

__global__ void __launch_bounds__(SK_THREADS)
mix_gemv_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w, int* __restrict__ om,
                int* __restrict__ ov, int M, int N, int K, int nm) {
  __shared__ __align__(16) SkinnySmem sm;
  const int mblocks = nm / SK_BN;
  if (static_cast<int>(blockIdx.x) < mblocks)
    skinny_mma_block<W_S8>(x, M, K, w, N, blockIdx.x, SK_BN, om, nm, sm);
  else
    skinny_dp4a_block(x, K, w + nm, N, blockIdx.x - mblocks, ov,
                      *reinterpret_cast<int (*)[SK_THREADS / 32][SK_BN]>(&sm));
}

}  // namespace

extern "C" {

// x (M, K) int8 with M <= 16, w (K, N) int8, out (M, N) int32 (zeroed when
// ksplit > 1); N % 64 == 0, K % 128 == 0, 1 <= ksplit <= K / 128.
int mxu_gemv(const void* x, const void* w, void* out, int M, int N, int K, int ksplit,
             void* stream) {
  if (M <= 0 || M > 16 || N <= 0 || N % SK_BN || K <= 0 || K % SK_BK || ksplit < 1 ||
      ksplit > K / SK_BK)
    return cudaErrorInvalidValue;
  mxu_gemv_kernel<<<dim3(N / SK_BN, ksplit), SK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const uint8_t*>(w), static_cast<int*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// row 0 of x (., K) int8, w (K, N) int8, out (1, N) int32 (zeroed when ksplit > 1).
int vpu_gemv(const void* x, const void* w, void* out, int N, int K, int ksplit, void* stream) {
  if (N <= 0 || N % SK_BN || K <= 0 || K % SK_BK || ksplit < 1 || ksplit > K / SK_BK)
    return cudaErrorInvalidValue;
  vpu_gemv_kernel<<<dim3(N / SK_BN, ksplit), SK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const uint8_t*>(w), static_cast<int*>(out), N, K);
  return static_cast<int>(cudaGetLastError());
}

// om (M, nm) int32 from columns [0, nm) of w, ov (1, N - nm) int32 from row 0
// and the rest (both zeroed when ksplit > 1).
int mix_gemv(const void* x, const void* w, void* om, void* ov, int M, int N, int K, int nm,
             int ksplit, void* stream) {
  if (M <= 0 || M > 16 || N <= 0 || N % SK_BN || K <= 0 || K % SK_BK || nm < 0 || nm > N ||
      nm % SK_BN || ksplit < 1 || ksplit > K / SK_BK)
    return cudaErrorInvalidValue;
  static_assert(sizeof(SkinnySmem) >= sizeof(int) * (SK_THREADS / 32) * SK_BN, "dp4a scratch");
  mix_gemv_kernel<<<dim3(N / SK_BN, ksplit), SK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const uint8_t*>(w), static_cast<int*>(om),
      static_cast<int*>(ov), M, N, K, nm);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
