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
// outside 1, 2, 4 and 8 (Falcon-7B's 71 query heads on one kv head) runs the
// split kernels long_attn_split_cluster: K3's split (int8_decode_attention.cu),
// the kv head's query heads over `split` virtual kv heads of 4 or 8 rows, the
// last with the rows it has (the body's address policy RaggedKV).

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

// K7 at any rep: grid (C, Hkv nv, B), REP query heads a virtual kv head, the
// kv head's rep over nv of them (RaggedKV)
template <int DH, int REP, bool QPV, bool K16, bool SCR>
__global__ void __launch_bounds__(NT)
long_attn_split_cluster(const int8_t* __restrict__ q, const int8_t* __restrict__ kt,
                        const int8_t* __restrict__ v, const int* __restrict__ lengths,
                        const float* __restrict__ scales, float* __restrict__ out, int Hkv,
                        int Smax, int chmax, uint8_t* __restrict__ scratch, int nv, int rep) {
  decode_attn_core<DH, REP, QPV ? PV_QUANT_FAST : PV_FP, K16, false>(
      RaggedKV<DH>{{kt, v, Smax, nullptr, nullptr}, nv, rep}, q, lengths, scales, out, Hkv,
      Smax, chmax, LongScores<!SCR>{scratch});
}

template <int DH, int REP, bool QPV, bool K16, bool SCR>
int launch_split(const Call& c, uint8_t* scratch, int nv, int rep, cudaStream_t st) {
  static Sized sized = {};
  return launch_cluster<DH, REP>(long_attn_split_cluster<DH, REP, QPV, K16, SCR>, sized, c, st,
                                 scratch, nv, rep);
}

template <int DH, int REP, bool SCR>
int split_mode(const Call& c, bool qpv, uint8_t* scratch, int nv, int rep, cudaStream_t st) {
  const bool k16 = c.Smax % 16 == 0;
  if (qpv)
    return k16 ? launch_split<DH, REP, true, true, SCR>(c, scratch, nv, rep, st)
               : launch_split<DH, REP, true, false, SCR>(c, scratch, nv, rep, st);
  return k16 ? launch_split<DH, REP, false, true, SCR>(c, scratch, nv, rep, st)
             : launch_split<DH, REP, false, false, SCR>(c, scratch, nv, rep, st);
}

// c.Hkv: the virtual kv heads, Hkv nv; vrep 4 or 8
template <bool SCR>
int dispatch_split(const Call& c, int Dh, int vrep, bool qpv, uint8_t* scratch, int nv, int rep,
                   cudaStream_t st) {
#define DGQ_REP(D, R) \
  if (Dh == D && vrep == R) return split_mode<D, R, SCR>(c, qpv, scratch, nv, rep, st);
  DGQ_REP(128, 4) DGQ_REP(128, 8) DGQ_REP(64, 4) DGQ_REP(64, 8)
#undef DGQ_REP
  return cudaErrorInvalidValue;
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
// H / Hkv outside (1, 2, 4, 8): the split kernels, over split virtual kv heads
// a kv head of vrep = 4 rows where split of them cover H / Hkv, else 8, and a
// scratch of 5 vrep chmax bytes a rank.
int int8_decode_attention_chunked(const void* q, const void* kt, const void* v,
                                  const void* lengths, const void* scales, void* out,
                                  void* scratch, int B, int H, int Hkv, int Dh, int Smax,
                                  int quant_pv, int cluster, int split, void* stream) {
  Call c;
  auto sp = static_cast<uint8_t*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hkv > 0 && H % Hkv == 0 && !whole_rep(H / Hkv)) {
    const int rep = H / Hkv, vrep = split > 0 ? split_vrep(rep, split) : 0;
    // the virtual kv heads stand for H's check, which the head map replaces
    if (!vrep || !make_call(c, q, kt, v, lengths, scales, out, B, Hkv * split, Hkv * split,
                            Smax, cluster))
      return cudaErrorInvalidValue;
    c.scratch = scratch != nullptr;
    return c.scratch ? dispatch_split<true>(c, Dh, vrep, quant_pv != 0, sp, split, rep, st)
                     : dispatch_split<false>(c, Dh, vrep, quant_pv != 0, sp, split, rep, st);
  }
  if (Hkv <= 0 || H % Hkv || (split != 1 && split != 2 && split != 4 && split != 8) ||
      (H / Hkv) % split ||
      !make_call(c, q, kt, v, lengths, scales, out, B, H, Hkv * split, Smax, cluster))
    return cudaErrorInvalidValue;
  c.scratch = scratch != nullptr;
  return c.scratch ? dispatch<true>(c, H, Dh, quant_pv != 0, sp, split, st)
                   : dispatch<false>(c, H, Dh, quant_pv != 0, sp, split, st);
}

}  // extern "C"
