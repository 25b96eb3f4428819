// K3: single-token decode attention over the INT8 KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel dgq_tpu/ops/attention.py::int8_decode_attention
// (body _decode_kernel).  For slot b and kv head g it serves the rep = H / Hkv
// query heads of g: scores s8 q.k^T -> s32 times scales[0] = (q_scale *
// k_scale) / sqrt(Dh) over the valid length lengths[b]; m is the GLOBAL row
// max and e = exp(s - m).  With quant_pv the exp-weights become int8 codes
// trunc(127 e + 0.5) (__fmul_rn/__fadd_rn: an fma would move codes across
// the .5 boundary), p @ V is an exact integer sum and out = acc * ((v_scale
// / 127) / denom); without it, out = sum e (v * v_scale) / denom in fp32.
// With ALiBi (BLOOM, MPT: the kernel decode_attn_alibi_cluster), slopes[h]
// times the position is added to query head h's scaled scores before the
// mask, as the TPU kernel's slope_ref gathers it (h = g rep + r, right under
// GQA): the body's bias policy Alibi.  The TPU kernel takes any rep; the
// kernels below are compiled for rep 1, 2, 4 and 8, and any other rep
// (Falcon-7B's 71 query heads on one kv head) runs the split kernels of
// decode_attention_rows.cu: one cluster a (slot, kv head) with every query
// row of the kv head in the block, both products on the tensor cores
// (mma.sync), K and V read once a call (its header gives the bounds at
// Falcon-7B's shapes and why the design; ops/attention.py rows_plan).
//
// What bounds it on this card: the valid K and V bytes, 2 * len * Dh per
// (slot, kv head), over the 3.35 TB/s of device memory: 9.4 MB, 2.8 us, at
// 7B batch 4 and ~285 positions.  So what counts is the bytes in flight and
// the serial steps, not the arithmetic.  The design:
//   * a cluster of C blocks (C = 2, 4 or 8, the caller's plan from Smax,
//     the slots and the heads) per (slot, kv head): rank r takes the
//     positions [r per, (r + 1) per) of the slot's valid length, per =
//     ceil(len / C) rounded up to 16, read on the device (no host sync, so a
//     CUDA graph can capture a call); a rank past the length has no work
//     but joins both cluster barriers;
//   * the rank's K and V stream into shared memory through a ring of RING
//     tiles of T positions with cp.async (16-byte copies; 4-byte ones for
//     K when Smax % 16 != 0), issued by all threads at entry: the K tiles
//     first, then the V tiles, so V arrives while the scores are computed;
//     a rank of up to 2 tiles has all its bytes in flight at once.  Not
//     cp.async.bulk from one thread or warp: a tile's V is one range, but
//     its K is Dh rows of at most T bytes, Smax apart in the d-major cache,
//     so a 1-D bulk copy moves one row; with a warp issuing those row copies
//     on an mbarrier a slot, K3 took 1.67x this design's time on an H100
//     (PERF.md).  A 2-D TMA box would write the rows unpadded, and
//     the KS pad below is what keeps the q.k loop's half-warps, 4 rows
//     apart, on different banks; bulk copies also need 16-byte aligned
//     rows, which Smax % 16 != 0 does not give;
//   * scores stay in shared memory (no scratch in device memory) and exp
//     runs once per position.  q.k: each thread scores 4 positions over a
//     slice of Dh with dp4a on a 4x4 byte transpose of the d-major K tile,
//     the slices summed through shared memory;
//   * the row max over the cluster: each block's max, a cluster barrier,
//     every block reads the others' maxima from distributed shared memory;
//   * p @ V with dp4a on packed int8 codes, four positions a word, V turned
//     position-major by the same 4x4 transpose (dp4a rather than mma.sync:
//     rep is 1 at MHA, where an m16 tile would be 15/16 padding, and the
//     bytes, not the multiply-adds, bound the kernel); fp32 fma without
//     quant_pv;
//   * every rank stores its int32 p @ V sums (exact, so order-free) and its
//     fp32 exp sum into rank 0's shared memory, a second cluster barrier,
//     and rank 0 adds them in rank order (deterministic) and writes out.
// One launch, no scratch in device memory.  The body lives in
// decode_attention.cuh, which P5 (quant_pv_parts_attention.cu) runs too,
// with its p @ V rule a template parameter.

#include "decode_attention.cuh"

namespace {

// grid (C, Hkv, B) in clusters of C along x; K16: Smax % 16 == 0
template <int DH, int REP, bool QPV, bool K16>
__global__ void __launch_bounds__(NT)
decode_attn_cluster(const int8_t* __restrict__ q, const int8_t* __restrict__ kt,
                    const int8_t* __restrict__ v, const int* __restrict__ lengths,
                    const float* __restrict__ scales, float* __restrict__ out, int Hkv, int Smax,
                    int chmax) {
  decode_attn_body<DH, REP, QPV ? PV_QUANT_FAST : PV_FP, K16, false>(q, kt, v, lengths, scales,
                                                                     out, Hkv, Smax, chmax);
}

// K3 with ALiBi: slopes (H,) f32, a slope a query head
template <int DH, int REP, bool QPV, bool K16>
__global__ void __launch_bounds__(NT)
decode_attn_alibi_cluster(const int8_t* __restrict__ q, const int8_t* __restrict__ kt,
                          const int8_t* __restrict__ v, const int* __restrict__ lengths,
                          const float* __restrict__ scales, float* __restrict__ out, int Hkv,
                          int Smax, int chmax, const float* __restrict__ slopes) {
  decode_attn_core<DH, REP, QPV ? PV_QUANT_FAST : PV_FP, K16, false>(
      DenseKV<DH>{kt, v, Smax, nullptr, nullptr}, q, lengths, scales, out, Hkv, Smax, chmax,
      SmemScores{}, Alibi{slopes});
}

template <int DH, int REP, bool QPV, bool K16>
int launch(const Call& c, const float* slopes, cudaStream_t st) {
  if (slopes) {
    static Sized sized_alibi = {};
    return launch_cluster<DH, REP>(decode_attn_alibi_cluster<DH, REP, QPV, K16>, sized_alibi, c,
                                   st, slopes);
  }
  static Sized sized = {};  // what its launches have set, per device
  return launch_cluster<DH, REP>(decode_attn_cluster<DH, REP, QPV, K16>, sized, c, st);
}

template <int DH, int REP>
int launch_mode(const Call& c, bool qpv, const float* sl, cudaStream_t st) {
  const bool k16 = c.Smax % 16 == 0;
  if (qpv)
    return k16 ? launch<DH, REP, true, true>(c, sl, st) : launch<DH, REP, true, false>(c, sl, st);
  return k16 ? launch<DH, REP, false, true>(c, sl, st) : launch<DH, REP, false, false>(c, sl, st);
}

template <int DH>
int launch_rep(int rep, const Call& c, bool qpv, const float* sl, cudaStream_t st) {
  switch (rep) {
    case 1: return launch_mode<DH, 1>(c, qpv, sl, st);
    case 2: return launch_mode<DH, 2>(c, qpv, sl, st);
    case 4: return launch_mode<DH, 4>(c, qpv, sl, st);
    case 8: return launch_mode<DH, 8>(c, qpv, sl, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, H, Dh) int8; kt (B, Hkv, Dh, Smax) int8; v (B, Hkv, Smax, Dh) int8;
// lengths (B,) int32 valid positions per slot, each in [1, Smax]; scales f32
// [qk_scale, v_scale, v_scale / 127] on the device; slopes (H,) f32 ALiBi
// slopes on the device, or null (no ALiBi); out (B, H, Dh) f32; cluster (2, 4
// or 8) blocks per (slot, kv head), the caller's plan.
int int8_decode_attention(const void* q, const void* kt, const void* v, const void* lengths,
                          const void* scales, const void* slopes, void* out, int B, int H,
                          int Hkv, int Dh, int Smax, int quant_pv, int cluster, void* stream) {
  Call c;
  if (!make_call(c, q, kt, v, lengths, scales, out, B, H, Hkv, Smax, cluster))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto sl = static_cast<const float*>(slopes);
  if (Dh == 128) return launch_rep<128>(H / Hkv, c, quant_pv != 0, sl, st);
  if (Dh == 64) return launch_rep<64>(H / Hkv, c, quant_pv != 0, sl, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
