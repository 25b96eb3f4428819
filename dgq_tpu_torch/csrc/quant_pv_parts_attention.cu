// P5: decode attention in the six p @ V variants of the quant_pv cost probe,
// for Hopper (sm_90a), on K3's own kernel body.
//
// Replaces the TPU kernel scripts/probe_quant_pv_parts.py::attn (body _body),
// which splits what K3's INT8 p @ V (quant_pv) costs.  For slot b and kv head
// g it serves the rep = H / Hkv query heads of g: int32 scores q . k over the
// (Dh, Smax) transposed K cache times qk_scale in f32; positions at or past
// length[b] masked to finfo(f32).min; m the row max, e = exp(s - m) (expf,
// not __expf), denom = sum e.  Then per mode (decode_attention.cuh PvRule):
//   fp          out = (sum e (v * v_scale)) / denom                 f32
//   nodeq       out = ((sum e v) / denom) * v_scale                  f32
//   quant       c = rint(127 e) (half to even, as jnp.round); acc = sum c v (int32);
//               out = acc * ((v_scale / 127) / denom)
//   quant_fast  c = trunc(127 e + 0.5), then as quant (K3's shipped rule)
//   noround     c = trunc(127 e), then as quant
//   s32dot      c = trunc(127 e); out = float(acc) (no epilogue)
// The codes are the plain version's exactly.  fp and nodeq divide by the exp
// sum once, at the end, as K3 does; the TPU probe divides each e first, so
// their f32 sums are taken in another order than the plain version's.  With
// no valid position every score is finfo.min and every e is 1 (over all Smax
// positions), as in the TPU kernel, and no K is read.
//
// What bounds it on this card: the K and V codes of the valid positions,
// 2 * len * Dh bytes per (slot, kv head), over the 3.35 TB/s of device memory
// (16.8 MB at the probe's 32 heads x 2048 positions).  The design is K3's:
// the probe measures what quant_pv costs inside the kernel the engine runs,
// so it runs K3's body (decode_attention.cuh: a cluster of blocks per (slot,
// kv head), each streaming its share of the positions through a cp.async
// ring, the row max and the sums over distributed shared memory), with the
// p @ V rule a template parameter.  Its cluster comes from the caller's plan
// (ops/attention.py decode_plan).

#include "decode_attention.cuh"

namespace {

// grid (C, Hkv, B) in clusters of C along x; K16: Smax % 16 == 0
template <int REP, int RULE, bool K16>
__global__ void __launch_bounds__(NT)
pv_parts_cluster(const int8_t* __restrict__ q, const int8_t* __restrict__ kt,
                 const int8_t* __restrict__ v, const int* __restrict__ lengths,
                 const float* __restrict__ scales, float* __restrict__ out, int Hkv, int Smax,
                 int chmax) {
  decode_attn_body<128, REP, RULE, K16, true>(q, kt, v, lengths, scales, out, Hkv, Smax, chmax);
}

template <int REP, int RULE, bool K16>
int launch(const Call& c, cudaStream_t st) {
  static Sized sized = {};  // what its launches have set, per device
  return launch_cluster<128, REP>(pv_parts_cluster<REP, RULE, K16>, sized, c, st);
}

template <int REP, int RULE>
int launch_k16(const Call& c, cudaStream_t st) {
  return c.Smax % 16 == 0 ? launch<REP, RULE, true>(c, st) : launch<REP, RULE, false>(c, st);
}

template <int REP>
int launch_mode(int mode, const Call& c, cudaStream_t st) {
  switch (mode) {
    case PV_FP: return launch_k16<REP, PV_FP>(c, st);
    case PV_NODEQ: return launch_k16<REP, PV_NODEQ>(c, st);
    case PV_QUANT: return launch_k16<REP, PV_QUANT>(c, st);
    case PV_QUANT_FAST: return launch_k16<REP, PV_QUANT_FAST>(c, st);
    case PV_NOROUND: return launch_k16<REP, PV_NOROUND>(c, st);
    case PV_S32DOT: return launch_k16<REP, PV_S32DOT>(c, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, H, 128) int8; kt (B, Hkv, 128, Smax) int8; v (B, Hkv, Smax, 128)
// int8; lengths (B,) int32 on the device, each in [0, Smax] (0: no valid
// position); scales f32 [qk_scale, v_scale, v_scale / 127] on the device;
// out (B, H, 128) f32; mode 0-5 as PvRule (the probe's MODES order); H /
// Hkv in {1, 2, 4, 8}; Smax % 4 == 0; cluster (2, 4 or 8) blocks per (slot,
// kv head), the caller's plan.
int quant_pv_parts_attention(const void* q, const void* kt, const void* v, const void* lengths,
                             const void* scales, void* out, int B, int H, int Hkv, int Dh,
                             int Smax, int mode, int cluster, void* stream) {
  Call c;
  if (Dh != 128 || !make_call(c, q, kt, v, lengths, scales, out, B, H, Hkv, Smax, cluster))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H / Hkv) {
    case 1: return launch_mode<1>(mode, c, st);
    case 2: return launch_mode<2>(mode, c, st);
    case 4: return launch_mode<4>(mode, c, st);
    case 8: return launch_mode<8>(mode, c, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
