// K7 with ALiBi: single-token decode attention over a long INT8 KV cache
// with a slope a query head (BLOOM and MPT past 8192 positions), for Hopper
// (sm_90a), on K3's body (decode_attention.cuh).
//
// The TPU engines call their whole-cache K3 with `alibi_slopes` at any cache
// length (dgq_tpu/ops/attention.py::int8_decode_attention, _decode_kernel
// :92-102: slope[g rep + r] * pos added to the scaled scores before the
// mask); K3 on this card takes caches up to 8192 positions, so the ported
// engines take K7 past that, as the LLaMA engine does.  The function is K3's
// with ALiBi; the kernel is K7's (long_decode_attention.cu: clusters of up
// to 16 blocks, the scores in a device-memory scratch where its plan says,
// a kv head's query heads split over virtual kv heads (SplitKV), slots
// longest first) with the body's bias policy Alibi: virtual kv head g's row
// r is query head g (rep / split) + r, whose slope it takes.  What bounds it
// is K7's: the valid K and V bytes over 3.35 TB/s; ALiBi adds a load from
// L1, a multiply and an add a score.  Its own source so that nvcc builds it
// beside K7's, in parallel.

#include "decode_attention.cuh"

namespace {

// grid (C, Hkv split, B) in clusters of C along x, REP the query heads of a
// virtual kv head; K16: Smax % 16 == 0; SCR: the scores in `scratch` (else
// null); slopes (H,) f32, a slope a query head
template <int DH, int REP, bool QPV, bool K16, bool SCR>
__global__ void __launch_bounds__(NT)
long_attn_alibi_cluster(const int8_t* __restrict__ q, const int8_t* __restrict__ kt,
                        const int8_t* __restrict__ v, const int* __restrict__ lengths,
                        const float* __restrict__ scales, float* __restrict__ out, int Hkv,
                        int Smax, int chmax, uint8_t* __restrict__ scratch, int split,
                        const float* __restrict__ slopes) {
  decode_attn_core<DH, REP, QPV ? PV_QUANT_FAST : PV_FP, K16, false>(
      SplitKV<DH>{{kt, v, Smax, nullptr, nullptr}, split}, q, lengths, scales, out, Hkv, Smax,
      chmax, LongScores<!SCR>{scratch}, Alibi{slopes});
}

template <int DH, int REP, bool QPV, bool K16, bool SCR>
int launch(const Call& c, uint8_t* scratch, int split, const float* slopes, cudaStream_t st) {
  static Sized sized = {};  // what its launches have set, per device
  return launch_cluster<DH, REP>(long_attn_alibi_cluster<DH, REP, QPV, K16, SCR>, sized, c, st,
                                 scratch, split, slopes);
}

template <int DH, int REP, bool SCR>
int launch_mode(const Call& c, bool qpv, uint8_t* scratch, int split, const float* sl,
                cudaStream_t st) {
  const bool k16 = c.Smax % 16 == 0;
  if (qpv)
    return k16 ? launch<DH, REP, true, true, SCR>(c, scratch, split, sl, st)
               : launch<DH, REP, true, false, SCR>(c, scratch, split, sl, st);
  return k16 ? launch<DH, REP, false, true, SCR>(c, scratch, split, sl, st)
             : launch<DH, REP, false, false, SCR>(c, scratch, split, sl, st);
}

// c.Hkv: the virtual kv heads, Hkv split
template <bool SCR>
int dispatch(const Call& c, int H, int Dh, bool qpv, uint8_t* scratch, int split,
             const float* sl, cudaStream_t st) {
  const int rep = H / c.Hkv;
#define DGQ_REP(D, R) \
  if (Dh == D && rep == R) return launch_mode<D, R, SCR>(c, qpv, scratch, split, sl, st);
  DGQ_REP(128, 1) DGQ_REP(128, 2) DGQ_REP(128, 4) DGQ_REP(128, 8)
  DGQ_REP(64, 1) DGQ_REP(64, 2) DGQ_REP(64, 4) DGQ_REP(64, 8)
#undef DGQ_REP
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// int8_decode_attention_chunked's arguments (long_decode_attention.cu) and
// slopes (H,) f32 ALiBi slopes on the device, a slope a query head.
int int8_decode_attention_chunked_alibi(const void* q, const void* kt, const void* v,
                                        const void* lengths, const void* scales,
                                        const void* slopes, void* out, void* scratch, int B,
                                        int H, int Hkv, int Dh, int Smax, int quant_pv,
                                        int cluster, int split, void* stream) {
  Call c;
  if (slopes == nullptr || Hkv <= 0 || H % Hkv ||
      (split != 1 && split != 2 && split != 4 && split != 8) || (H / Hkv) % split ||
      !make_call(c, q, kt, v, lengths, scales, out, B, H, Hkv * split, Smax, cluster))
    return cudaErrorInvalidValue;
  c.scratch = scratch != nullptr;
  auto sp = static_cast<uint8_t*>(scratch);
  auto sl = static_cast<const float*>(slopes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return c.scratch ? dispatch<true>(c, H, Dh, quant_pv != 0, sp, split, sl, st)
                   : dispatch<false>(c, H, Dh, quant_pv != 0, sp, split, sl, st);
}

}  // extern "C"
