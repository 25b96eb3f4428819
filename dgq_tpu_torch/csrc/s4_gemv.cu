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
// bytes, sign-extends the nibbles to int8 in registers and runs s8 wgmma:
// it measures the nibble-unpack cost that K1, K4-K6 and K12 pay on their
// weights.  What bounds it on this card: the K * N / 2 weight bytes (25.2 MB
// at K 4096, N 12288) over the 3.35 TB/s of device memory.  So it runs the
// loop of P2 (int8_gemv_engines.cu) and of K4-K6 and K12
// (fused_gemv_sm90.cuh's body in its raw mode: one producer thread keeps
// four stages in flight by TMA, x's 16 rows by TMA as the wgmma B operand)
// with the nibble Loader FusedS4: a block owns 128 columns, 64 bytes of
// each weight row, in stages of 128 rows x 64 bytes (8 KB); a thread owns a
// byte column, whose low nibble and high nibble are its two columns, so
// each byte is read once in both column maps (the bitcast map's two
// columns of a byte lie bn / 2 apart, which only the epilogue's addresses
// see).  K is split over blockIdx.y by the plan (probe_gemv_engines.gemv_plan
// at this stage's bytes), the int32 partials summed in split order by
// raw_gemv.cuh's second kernel, as P2's.

#include "raw_gemv.cuh"

namespace {

constexpr int S4_BM = 16;  // the token-row tile: wgmma N = 16, the probe's 16 rows of codes

// grid (ceil(N / 128), splits); HALVES: the bitcast map, bn in a.gs
template <bool HALVES>
__global__ void __launch_bounds__(F_THREADS, 3)
s4_gemv_sm90(const __grid_constant__ CUtensorMap tm_w, const __grid_constant__ CUtensorMap tm_x,
             const __grid_constant__ FusedArgs a) {
  fused_gemv_body<F_RAW, S4_BM, FusedS4<HALVES>>(tm_w, tm_x, tm_x, tm_x, tm_x, a);
  let_dependents_start();
}

}  // namespace

extern "C" {

// x (M, K) int8 codes with M <= 16; wb (K, N / 2) bytes; out (M, N) int32;
// the plan: `splits` (at most 8) K splits of `sps` stages of 128 k, part
// (splits, M, N) int32 scratch when splits > 1 (summed by a second launch),
// else null.  halves 0: XLA's pair order (pallas_s4); 1: [low | high] per
// bn columns (pallas_s4_bitcast), bn a multiple of 64 dividing N.  N % 64
// == 0, K % 128 == 0.  Returns a cudaError_t, or -1 when it rejects its
// arguments.
int s4_gemv(const void* x, const void* wb, void* out, void* part, int M, int N, int K,
            int halves, int bn, int splits, int sps, void* stream) {
  if (M < 1 || M > S4_BM || N <= 0 || N % 64 || K <= 0 || K % 128 || splits < 1 || splits > 8 || sps < 1 || splits * sps != K / 128 ||
      (splits > 1) != (part != nullptr) ||
      fused_smem(S4_BM, sps, FusedS4<false>::STAGE) > F_SMEM_LIMIT ||
      (halves && (bn <= 0 || bn % 64 || N % bn)))
    return F_BAD_ARGS;
  CUtensorMap tw, tx;
  int rc = tensor_map(&tw, wb, N / 2, K, 64, 128, CU_TENSOR_MAP_SWIZZLE_64B);
  if (!rc) rc = tensor_map(&tx, x, K, M, F_HB, S4_BM, CU_TENSOR_MAP_SWIZZLE_64B);
  if (rc) return rc;
  FusedArgs a{};
  a.M = M;
  a.N = N;
  a.K = K;
  a.gs = halves ? bn : 0;
  a.nst = K / 128;
  a.sps = sps;
  a.out_s32 = static_cast<int*>(out);
  a.part = static_cast<int*>(part);
  static uint64_t sized[2] = {0, 0};  // devices whose limits are raised, per map
  const dim3 grid((N + BN - 1) / BN, splits, 1);
  const size_t smem = fused_smem(S4_BM, sps, FusedS4<false>::STAGE);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (halves)
    return launch_raw_gemv(s4_gemv_sm90<true>, sized[1], grid, smem, st, a.part, a.out_s32, M * N,
                           nullptr, nullptr, 0, splits, tw, tx, a);
  return launch_raw_gemv(s4_gemv_sm90<false>, sized[0], grid, smem, st, a.part, a.out_s32, M * N,
                         nullptr, nullptr, 0, splits, tw, tx, a);
}

}  // extern "C"
