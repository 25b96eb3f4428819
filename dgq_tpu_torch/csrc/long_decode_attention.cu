// K7: single-token decode attention over a long INT8 KV cache, for Hopper
// (sm_90a), on K3's body (decode_attention.cuh) over the dense cache.
//
// Replaces the TPU kernel dgq_tpu/ops/attention.py::int8_decode_attention_chunked
// (bodies _chunk_max_kernel, _chunk_pv_kernel, _decode_chunk_kernel), which
// walks a dense (B, Hkv, Dh, Smax) K / (B, Hkv, Smax, Dh) V INT8 cache past
// 8192 positions in chunks its VMEM holds.  The function is K3's: for slot b
// and kv head g it serves the rep = H / Hkv query heads of g, scores s8
// q.k^T -> s32 times scales[0] over the valid length lengths[b], m the
// GLOBAL row max; with quant_pv int8 codes trunc(127 e + 0.5) and an exact
// integer p @ V, out = acc * ((v_scale / 127) / denom); without it out =
// sum e (v * v_scale) / denom in fp32.  The call's chunk is the TPU's and
// does not reach this kernel.
//
// What bounds it on this card: the valid K and V bytes, 2 * len * Dh per
// (slot, kv head), over the 3.35 TB/s of device memory: 344 MB, 103 us, for
// 4 slots of 5000-16000 positions at 7B MHA.  The design is K3's
// (int8_decode_attention.cu): a cluster of C blocks per (slot, kv head),
// each rank streaming a contiguous share of the valid positions through a
// cp.async ring, K then V, the row max and the sums over distributed shared
// memory; one launch, K read once (a walk over chunks reads K twice under
// quant_pv, for the global max).  What differs, in the kernel's policies
// and its plan (ops/attention.py chunked_plan, swept on the card):
//   * past 8192 positions, clusters of 16 blocks, Hopper's non-portable
//     size: a long rank's serial tiles, not the launch's waves, set the
//     time (on the caches K3 takes, K3's cluster);
//   * where the slots and kv heads are few, a kv head's rep query heads are
//     split over `split` virtual kv heads, each served by clusters of its
//     own over the same K and V (SplitKV): one slot at 8 query heads a kv
//     head runs 4 groups of 2, 512 blocks where it had 128, and the second
//     read of a tile comes mostly from L2;
//   * a rank's scores and codes take 5 rep Smax / C bytes of its block's
//     shared memory, or a device-memory scratch of the wrapper's, (B, Hkv,
//     C) runs of 5 rep chmax bytes (LongScores<false>), where no block of
//     16 holds them or where the smaller block lets more blocks share an SM;
//   * blockIdx.z takes the slots longest first, so that the longest slot's
//     blocks, which set the call's time, start first;
//   * fp p @ V converts the V codes through the exponent bits (DenseKV's
//     FAST), as K8 does.
// Its ALiBi kernels, which the BLOOM and MPT engines take past 8192
// positions, are built from long_decode_attention_alibi.cu.  A rep = H / Hkv
// outside 1, 2, 4 and 8 (Falcon-7B's 71 query heads on one kv head) runs
// K3's split kernels (decode_attention_rows.cu: one cluster a (slot, kv
// head), every query row of the kv head in an mma.sync tile for both
// products; fp p @ V in one pass against a running max; with quant_pv, past
// 8192 positions, the scores recomputed from the rank's K tiles kept in
// shared memory, since 71 rows x 1024 positions of scores a rank fit no
// block).

#include "decode_attention.cuh"

namespace {

// grid (C, Hkv split, B) in clusters of C along x, REP the query heads of a
// virtual kv head; K16: Smax % 16 == 0; SCR: the scores in `scratch` (else
// null)
template <int DH, int REP, bool QPV, bool K16, bool SCR>
__global__ void __launch_bounds__(NT)
long_attn_cluster(const int8_t* __restrict__ q, const int8_t* __restrict__ kt,
                  const int8_t* __restrict__ v, const int* __restrict__ lengths,
                  const float* __restrict__ scales, float* __restrict__ out, int Hkv, int Smax,
                  int chmax, uint8_t* __restrict__ scratch, int split) {
  decode_attn_core<DH, REP, QPV ? PV_QUANT_FAST : PV_FP, K16, false>(
      SplitKV<DH>{{kt, v, Smax, nullptr, nullptr}, split}, q, lengths, scales, out, Hkv, Smax,
      chmax, LongScores<!SCR>{scratch});
}

template <int DH, int REP, bool QPV, bool K16, bool SCR>
int launch(const Call& c, uint8_t* scratch, int split, cudaStream_t st) {
  static Sized sized = {};  // what its launches have set, per device
  return launch_cluster<DH, REP>(long_attn_cluster<DH, REP, QPV, K16, SCR>, sized, c, st,
                                 scratch, split);
}

template <int DH, int REP, bool SCR>
int launch_mode(const Call& c, bool qpv, uint8_t* scratch, int split, cudaStream_t st) {
  const bool k16 = c.Smax % 16 == 0;
  if (qpv)
    return k16 ? launch<DH, REP, true, true, SCR>(c, scratch, split, st)
               : launch<DH, REP, true, false, SCR>(c, scratch, split, st);
  return k16 ? launch<DH, REP, false, true, SCR>(c, scratch, split, st)
             : launch<DH, REP, false, false, SCR>(c, scratch, split, st);
}

// c.Hkv: the virtual kv heads, Hkv split
template <bool SCR>
int dispatch(const Call& c, int H, int Dh, bool qpv, uint8_t* scratch, int split,
             cudaStream_t st) {
  const int rep = H / c.Hkv;
#define DGQ_REP(D, R) \
  if (Dh == D && rep == R) return launch_mode<D, R, SCR>(c, qpv, scratch, split, st);
  DGQ_REP(128, 1) DGQ_REP(128, 2) DGQ_REP(128, 4) DGQ_REP(128, 8)
  DGQ_REP(64, 1) DGQ_REP(64, 2) DGQ_REP(64, 4) DGQ_REP(64, 8)
#undef DGQ_REP
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (B, H, Dh) int8; kt (B, Hkv, Dh, Smax) int8; v (B, Hkv, Smax, Dh) int8;
// lengths (B,) int32 valid positions per slot, each in [1, Smax]; scales f32
// [qk_scale, v_scale, v_scale / 127] on the device; out (B, H, Dh) f32;
// The caller's plan: cluster (2, 4, 8 or 16) blocks per (slot, virtual kv
// head); split (1, 2, 4 or 8, dividing H / Hkv) virtual kv heads a kv head;
// scratch null, or (B, Hkv split, cluster, 5 (H / Hkv / split) chmax) bytes
// for the ranks' scores and codes, chmax = ceil(ceil(Smax / cluster) / 64) 64.
int int8_decode_attention_chunked(const void* q, const void* kt, const void* v,
                                  const void* lengths, const void* scales, void* out,
                                  void* scratch, int B, int H, int Hkv, int Dh, int Smax,
                                  int quant_pv, int cluster, int split, void* stream) {
  Call c;
  if (Hkv <= 0 || H % Hkv || (split != 1 && split != 2 && split != 4 && split != 8) ||
      (H / Hkv) % split ||
      !make_call(c, q, kt, v, lengths, scales, out, B, H, Hkv * split, Smax, cluster))
    return cudaErrorInvalidValue;
  c.scratch = scratch != nullptr;
  auto sp = static_cast<uint8_t*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return c.scratch ? dispatch<true>(c, H, Dh, quant_pv != 0, sp, split, st)
                   : dispatch<false>(c, H, Dh, quant_pv != 0, sp, split, st);
}

}  // extern "C"
