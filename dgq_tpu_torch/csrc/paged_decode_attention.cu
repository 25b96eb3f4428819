// K8 and K11: single-token decode attention over a paged KV pool, for
// Hopper (sm_90a), on K3's body (decode_attention.cuh) with a paged address.
//
// Replaces the TPU kernels
//   K8  dgq_tpu/ops/attention.py::int8_paged_decode_attention (bodies
//       _chunk_max_kernel, _chunk_pv_kernel, _decode_chunk_kernel), over a
//       (P, Hkv, Dh, ps) / (P, Hkv, ps, Dh) INT8 page pool whose logical page
//       c of slot b is pool page table[b, c];
//   K11 dgq_tpu/ops/attention.py::int4_paged_decode_attention (body
//       _decode_chunk_kernel_kv4), over INT4 nibble pages (P, Hkv, Dh/2, ps)
//       / (P, Hkv, ps, Dh/2): two signed codes a byte along Dh, the even dim
//       in the low nibble (ops/kv4.py).
// For slot b and kv head g it serves the rep = H / Hkv query heads of g:
// scores s8 q.k^T -> s32 times scales[0] = (q_scale * k_scale) / sqrt(Dh)
// over the valid length (clamped to the table's NP * ps positions: an
// inactive slot's may run past it); m is the GLOBAL row max.  With quant_pv
// (K8) the exp-weights become int8 codes trunc(127 e + 0.5), p @ V is an
// exact integer sum and out = acc * ((v_scale / 127) / denom); without it
// (K11 always, as JAX's kernel) out = sum e (v * v_scale) / denom in fp32.
//
// What bounds it on this card: the valid K and V bytes, 2 * len * Dh per
// (slot, kv head) for INT8 and half that for K11, over the 3.35 TB/s of
// device memory (46 MB, 13.9 us, for 8 serving slots of 1-2048 positions at
// 7B MHA).  The design is K3's (int8_decode_attention.cu): a cluster of C
// blocks per (slot, kv head), each rank streaming a contiguous share of the
// valid positions through a cp.async ring, K then V, the row max and the
// sums taken over distributed shared memory; one launch, no scratch, K read
// once.  The page address (PagedKV) looks each copy's page up in the slot's
// table row: a K copy of 16 positions (4 when ps % 16 != 0) or a V copy of
// 16 bytes never leaves its page, so any page size that is a multiple of 4
// works.  Measured on the card first (PERF.md), this beat a split of
// each slot into spans of a fixed count of positions, one block a span,
// chained through a scratch: each such block waits out a whole memory
// latency before it computes anything, where a rank's ring keeps its next
// tiles in flight.  Nibble pages (K11) are unpacked in the q.k loop and in
// the fp32 p @ V.

#include "decode_attention.cuh"

namespace {

// grid (C, Hkv, B) in clusters of C along x; K16: ps % 16 == 0; KV4: nibble pages
template <int DH, int REP, bool QPV, bool K16, bool KV4>
__global__ void __launch_bounds__(NT)
paged_attn_cluster(const int8_t* __restrict__ q, const int8_t* __restrict__ kt,
                   const int8_t* __restrict__ v, const int* __restrict__ lengths,
                   const float* __restrict__ scales, float* __restrict__ out, int Hkv, int Smax,
                   int chmax, const int* __restrict__ table, int ps, int np) {
  decode_attn_core<DH, REP, QPV ? PV_QUANT_FAST : PV_FP, K16, false>(
      PagedKV<DH, KV4>{kt, v, table, ps, np, nullptr, 0, 0, 0u}, q, lengths, scales, out, Hkv,
      Smax, chmax);
}

struct Pages {
  const int* table;
  int ps, np;
};

template <int DH, int REP, bool QPV, bool K16, bool KV4>
int launch(const Call& c, const Pages& p, cudaStream_t st) {
  static Sized sized = {};  // what its launches have set, per device
  return launch_cluster<DH, REP>(paged_attn_cluster<DH, REP, QPV, K16, KV4>, sized, c, st,
                                 p.table, p.ps, p.np);
}

template <int DH, int REP, bool KV4>
int launch_mode(const Call& c, const Pages& p, bool qpv, cudaStream_t st) {
  const bool k16 = p.ps % 16 == 0;
  if (qpv) {
    if (KV4) return cudaErrorInvalidValue;  // nibble pages have no quant_pv pass
    return k16 ? launch<DH, REP, true, true, false>(c, p, st)
               : launch<DH, REP, true, false, false>(c, p, st);
  }
  return k16 ? launch<DH, REP, false, true, KV4>(c, p, st)
             : launch<DH, REP, false, false, KV4>(c, p, st);
}

template <bool KV4>
int dispatch(const Call& c, const Pages& p, int H, int Dh, bool qpv, cudaStream_t st) {
  const int rep = H / c.Hkv;
#define DGQ_REP(D, R) \
  if (Dh == D && rep == R) return launch_mode<D, R, KV4>(c, p, qpv, st);
  DGQ_REP(128, 1) DGQ_REP(128, 2) DGQ_REP(128, 4) DGQ_REP(128, 8)
  DGQ_REP(64, 1) DGQ_REP(64, 2) DGQ_REP(64, 4) DGQ_REP(64, 8)
#undef DGQ_REP
  return cudaErrorInvalidValue;
}

// The call's checks: K3's (the slot's positions Smax = NP * ps) and the pages'.
bool make_paged(Call& c, Pages& p, const void* q, const void* kt_pool, const void* v_pool,
                const void* table, const void* lengths, const void* scales, void* out, int B,
                int H, int Hkv, int ps, int np, int cluster, bool kv4) {
  if (ps <= 0 || ps % 4 || np <= 0) return false;
  p = Pages{static_cast<const int*>(table), ps, np};
  if (!make_call(c, q, kt_pool, v_pool, lengths, scales, out, B, H, Hkv, np * ps, cluster))
    return false;
  if (kv4) {  // nibble tiles of 2 T positions, and a rank's positions rounded up to them
    c.tile = 2 * T;
    c.chmax = ((np * ps + cluster - 1) / cluster + c.tile - 1) / c.tile * c.tile;
  }
  c.pages = rank_pages(c.chmax, ps);
  return true;
}

}  // namespace

extern "C" {

// K8.  q (B, H, Dh) int8; kt_pool (P, Hkv, Dh, ps) and v_pool (P, Hkv, ps, Dh)
// int8; table (B, NP) int32 pool page of each logical page (entries at or
// past a slot's length are not read); lengths (B,) int32, each >= 1 (clamped
// to NP * ps); scales f32 [qk_scale, v_scale, v_scale / 127]; out (B, H, Dh)
// f32; ps a multiple of 4; cluster (2, 4 or 8) blocks per (slot, kv head),
// the caller's plan.
int int8_paged_decode_attention(const void* q, const void* kt_pool, const void* v_pool,
                                const void* table, const void* lengths, const void* scales,
                                void* out, int B, int H, int Hkv, int Dh, int ps, int np,
                                int cluster, int quant_pv, void* stream) {
  Call c;
  Pages p;
  if (!make_paged(c, p, q, kt_pool, v_pool, table, lengths, scales, out, B, H, Hkv, ps, np,
                  cluster, false))
    return cudaErrorInvalidValue;
  return dispatch<false>(c, p, H, Dh, quant_pv != 0, static_cast<cudaStream_t>(stream));
}

// K11.  q (B, H, Dh) int8; kt_pool (P, Hkv, Dh / 2, ps) and v_pool (P, Hkv,
// ps, Dh / 2) int8 nibble pages; table, lengths, ps and cluster as K8;
// scales [qk_scale, v_scale, unused] with the effective int4 scales (int8
// scales x 127 / 7) folded in by the caller; out (B, H, Dh) f32.  fp p @ V
// (no quant_pv), as JAX's kernel.
int int4_paged_decode_attention(const void* q, const void* kt_pool, const void* v_pool,
                                const void* table, const void* lengths, const void* scales,
                                void* out, int B, int H, int Hkv, int Dh, int ps, int np,
                                int cluster, void* stream) {
  Call c;
  Pages p;
  if (!make_paged(c, p, q, kt_pool, v_pool, table, lengths, scales, out, B, H, Hkv, ps, np,
                  cluster, true))
    return cudaErrorInvalidValue;
  return dispatch<true>(c, p, H, Dh, false, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
