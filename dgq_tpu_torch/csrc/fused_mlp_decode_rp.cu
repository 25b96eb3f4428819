// K6: the whole LLaMA MLP of a decode step, for Hopper (sm_90a).
//
// Replaces the TPU kernel dgq_tpu/ops/fused_decode.py::fused_mlp_decode_rp
// (body _mlp_rp_kernel).  For the M <= 64 rows of a decode step or a short
// verify window:
//   q  = RMSNormQ(x)                                   (as K4)
//   g  = float(q @ Wg) * alpha_g,  u = float(q @ Wu) * alpha_u
//   hq = clip(round(((g * sigmoid(g)) * u) / down_scale), -128, 127)
//   out = float(hq @ Wd) * alpha_d (+ beta_d) (+ x)
// with all three weights rowpair-packed int4, gate|up with compact plane
// rows and down with 8x-replicated scale and zero rows (row 8g is read).
// sigmoid is 1 / (1 + expf(-g)) with IEEE division, as torch computes it.
//
// What bounds it on this card: the weight bytes, 3*D*F/2 (69 MB for
// LLaMA-7B), over the 3.35 TB/s of device memory.  The TPU kernel walks F in
// 512-column blocks in order, carrying the down product in VMEM scratch.
// Here blocks run at once and nothing carries over between them, so the MLP
// is two legs on the TMA + wgmma loop of K4 and K5 (fused_gemv_sm90.cuh),
// launched one after the other on the stream from this one entry point:
//   1. gate|up with K4's block shape: each block makes the RMSNormQ codes of
//      its K range (K4's order, so they equal K4's codes) and streams 64
//      gate columns and the same 64 up columns, two TMA boxes a stage; one
//      tile of token rows holds all M rows, so every weight byte is read
//      once; its epilogue pairs gate column f with up column F + f and writes
//      the (M, F) int8 h codes (a K split leaves int32 partials, which a
//      second kernel sums in split order before it makes the codes);
//   2. down with K5's block shape: the h codes, copied into shared memory in
//      place of K5's requant, against the down weights and their replicated
//      scale rows; a K split is summed in split order by the combine kernel,
//      which also applies acc * alpha_d (+ beta_d) (+ x).
// No block adds into another's sums: there are no atomics, and the int32
// sums equal the plain version's bit for bit.  The plan of each leg (tile,
// cluster, split) comes from ops/fused_decode.py mlp_plan.

#include "fused_gemv_sm90.cuh"

namespace {

template <int BM, int QS>
__global__ void __launch_bounds__(F_THREADS, 1)
mlp_gate_up_rp_sm90(const __grid_constant__ CUtensorMap tm_w,
                    const __grid_constant__ CUtensorMap tm_shi,
                    const __grid_constant__ CUtensorMap tm_slo,
                    const __grid_constant__ CUtensorMap tm_zhi,
                    const __grid_constant__ CUtensorMap tm_zlo,
                    const __grid_constant__ FusedArgs a) {
  fused_gemv_body<F_GATE_UP, BM, FusedRowpair<QS>>(tm_w, tm_shi, tm_slo, tm_zhi, tm_zlo, a);
}

__global__ void mlp_gate_up_rp_combine(const FusedArgs a, int splits) {
  gate_up_combine_body(a, splits);
}

template <int BM, int QS>
__global__ void __launch_bounds__(F_THREADS, 1)
mlp_down_rp_sm90(const __grid_constant__ CUtensorMap tm_w,
                 const __grid_constant__ CUtensorMap tm_shi,
                 const __grid_constant__ CUtensorMap tm_slo,
                 const __grid_constant__ CUtensorMap tm_zhi,
                 const __grid_constant__ CUtensorMap tm_zlo,
                 const __grid_constant__ FusedArgs a) {
  fused_gemv_body<F_DOWN, BM, FusedRowpair<QS>>(tm_w, tm_shi, tm_slo, tm_zhi, tm_zlo, a);
}

__global__ void mlp_down_rp_combine(const FusedArgs a, int splits) {
  fused_combine_body(a, splits);
}

struct GateUp {
  static constexpr int MODE = F_GATE_UP;
  template <int BM, int QS>
  static auto gemv() { return mlp_gate_up_rp_sm90<BM, QS>; }
  static auto combine() { return mlp_gate_up_rp_combine; }
};

struct Down {
  static constexpr int MODE = F_DOWN;
  template <int BM, int QS>
  static auto gemv() { return mlp_down_rp_sm90<BM, QS>; }
  static auto combine() { return mlp_down_rp_combine; }
};

}  // namespace

extern "C" {

// x (M, D) f32; ln_w (D,) f32; ln_b (D,) f32 or null; down_scale one f32 on
// the device; gu_qw (D/2, 2F) rowpair bytes with (Gd/2, 2F) int8 plane rows
// and gu_alpha (2F,) f32; d_qw (F/2, D) rowpair bytes with (8 Gf, D) int8
// replicated scales and zeros, d_alpha (D,) f32, d_beta (D,) f32 or null;
// out (M, D) f32; xq_out (M, D) int8 or null (receives the norm codes);
// h_out (M, F) int8 (receives the down-input codes; the down leg reads them).
// Each leg's plan (ops/fused_decode.py mlp_plan): bm token rows, `splits` K
// splits of `sps` stages of 128 k, clusters of `cluster` column tiles, and
// its int32 scratch when splits > 1: part1 (splits1, M, 2F), part2
// (splits2, M, D).  Returns a cudaError_t, or -1 when it rejects its
// arguments.
int fused_mlp_decode_rp(const void* x, const void* ln_w, const void* ln_b, float eps,
                        const void* down_scale, const void* gu_qw, const void* gu_s_hi,
                        const void* gu_s_lo, const void* gu_z_hi, const void* gu_z_lo,
                        const void* gu_alpha, const void* d_qw, const void* d_ws,
                        const void* d_wz, const void* d_alpha, const void* d_beta,
                        int fuse_residual, void* out, void* xq_out, void* h_out, int M, int D,
                        int F, int gs, int bm1, int splits1, int sps1, int cluster1, void* part1,
                        int bm2, int splits2, int sps2, int cluster2, void* part2,
                        void* stream) {
  if (!ln_w || !down_scale || !h_out || F % 64) return F_BAD_ARGS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  FusedArgs g{};
  g.x = static_cast<const float*>(x);
  g.lnw = static_cast<const float*>(ln_w);
  g.lnb = static_cast<const float*>(ln_b);
  g.eps = eps;
  g.alpha = static_cast<const float*>(gu_alpha);
  g.codes_out = static_cast<int8_t*>(xq_out);
  g.down_scale = static_cast<const float*>(down_scale);
  g.h_out = static_cast<int8_t*>(h_out);
  g.part = static_cast<int*>(part1);
  g.M = M;
  g.N = 2 * F;
  g.K = D;
  g.gs = gs;
  g.nst = D / 128;
  g.sps = sps1;
  FusedArgs d{};
  d.h_in = static_cast<const int8_t*>(h_out);
  d.alpha = static_cast<const float*>(d_alpha);
  d.beta = static_cast<const float*>(d_beta);
  d.residual = fuse_residual ? static_cast<const float*>(x) : nullptr;
  d.out = static_cast<float*>(out);
  d.part = static_cast<int*>(part2);
  d.M = M;
  d.N = D;
  d.K = F;
  d.gs = gs;
  d.nst = F / 128;
  d.sps = sps2;
  if (!fused_args_ok(g, bm1, splits1, cluster1) || !fused_args_ok(d, bm2, splits2, cluster2))
    return F_BAD_ARGS;
  const void* const gu_planes[4] = {gu_s_hi, gu_s_lo, gu_z_hi, gu_z_lo};
  const void* const d_planes[4] = {d_ws, d_ws, d_wz, d_wz};
  const int rc = launch_fused<GateUp>(g, bm1, splits1, cluster1, gu_qw, gu_planes, st);
  if (rc) return rc;
  return launch_fused<Down>(d, bm2, splits2, cluster2, d_qw, d_planes, st);
}

}  // extern "C"
