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
// Here each block takes one 64-column F block (176 blocks at F = 11264 for
// 132 SMs): it makes the RMSNormQ codes of all rows, its gate and up columns,
// the SiLU * up codes of its block, and the (M, D) int32 partial of the down
// product over its 64 rows of Wd, which it adds into an int32 accumulator
// with atomics.  int32 addition is exact in any order, so the sum is
// deterministic; a second small kernel then applies the fp32 epilogue once.

#include "fused_gemv.cuh"

namespace {

using fgemv::RED;
using fgemv::THREADS;
using fgemv::TILE_N;
using fgemv::WARPS;
using fgemv::XPAD;

constexpr int BF = 64;               // F columns per block
constexpr int NCT = 2 * BF / TILE_N;  // gate and up column tiles of a block

struct MlpArgs {
  const float* x;           // (M, D) f32 residual stream
  const float* lnw;         // (D,)
  const float* lnb;         // (D,) or null
  float eps;
  const float* down_scale;  // device scalar
  const uint8_t* gu_qw;     // (D/2, 2F) rowpair bytes, [gate | up]
  fgemv::GroupRows gu_s, gu_z;
  const float* gu_alpha;    // (2F,)
  const uint8_t* d_qw;      // (F/2, D) rowpair bytes
  fgemv::GroupRows d_s, d_z;
  int* acc;                 // (M, D) int32, zeroed
  int8_t* xq_out;           // (M, D) or null
  int8_t* h_out;            // (M, F) or null
  int M, D, F, gs, rows_pass;
};

struct Layout {
  size_t xs, sx, red, hs, sxh, total;
};

__host__ __device__ inline int seg_down(int gs) { return gs < BF ? gs : BF; }

__host__ __device__ inline Layout layout(int rows, int D, int gs) {
  const int mt = rows / 8;
  const int units = mt * NCT > WARPS ? mt * NCT : WARPS;
  Layout l;
  l.xs = 0;
  l.sx = l.xs + static_cast<size_t>(rows) * (D + XPAD);
  l.red = l.sx + static_cast<size_t>(rows) * (D / gs) * 4;
  l.hs = l.red + static_cast<size_t>(units) * RED * 4;
  l.sxh = l.hs + static_cast<size_t>(rows) * (BF + XPAD);
  l.total = l.sxh + static_cast<size_t>(rows) * (BF / seg_down(gs)) * 4;
  return l;
}

__global__ void __launch_bounds__(THREADS) mlp_decode_rp_kernel(MlpArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout l = layout(a.rows_pass, a.D, a.gs);
  int8_t* xs = reinterpret_cast<int8_t*>(smem + l.xs);
  int* sx = reinterpret_cast<int*>(smem + l.sx);
  int* red = reinterpret_cast<int*>(smem + l.red);
  int8_t* hs = reinterpret_cast<int8_t*>(smem + l.hs);
  int* sxh = reinterpret_cast<int*>(smem + l.sxh);
  const int ldx = a.D + XPAD, ldh = BF + XPAD, Gd = a.D / a.gs;
  const int segd = seg_down(a.gs), nsegh = BF / segd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f0 = blockIdx.x * BF;
  const float hscale = *a.down_scale;

  for (int r0 = 0; r0 < a.M; r0 += a.rows_pass) {
    const int rows = min(a.rows_pass, a.M - r0), rows_pad = (rows + 7) & ~7, mt = rows_pad / 8;
    fgemv::rmsnorm_codes(a.x, a.lnw, a.lnb, a.eps, a.M, a.D, r0, rows_pad, xs, ldx);
    __syncthreads();
    fgemv::segment_sums(xs, ldx, rows_pad, a.gs, Gd, sx);
    if (a.xq_out && blockIdx.x == 0) fgemv::copy_codes(xs, ldx, rows, a.D, r0, a.xq_out);
    __syncthreads();

    // gate and up columns of this block: units (m tile, column tile, K slice)
    const int ks = min(max(1, WARPS / (mt * NCT)), Gd);
    const int units = mt * NCT * ks;
    for (int u = warp; u < units; u += WARPS) {
      const int mtile = u % mt, ct = (u / mt) % NCT, kslice = u / (mt * NCT);
      const int n0 = ct < NCT / 2 ? f0 + ct * TILE_N : a.F + f0 + (ct - NCT / 2) * TILE_N;
      int tot[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
      fgemv::warp_unit(a.gu_qw, 2 * a.F, n0, 0, a.gs, a.gu_s, a.gu_z, xs + mtile * 8 * ldx, ldx,
                       sx + mtile * 8 * Gd, Gd, a.gs, kslice, Gd, ks, tot);
      fgemv::store_unit(red + u * RED, tot);
    }
    __syncthreads();

    // SiLU(gate) * up -> down-proj input codes of this block
    for (int i = threadIdx.x; i < rows_pad * BF; i += THREADS) {
      const int r = i / BF, c = i % BF, m = r0 + r;
      int code = 0;
      if (m < a.M) {
        const int mtile = r / 8, ctg = c / TILE_N, ctu = NCT / 2 + c / TILE_N;
        const int off = (r % 8) * TILE_N + c % TILE_N;
        int ag = 0, au = 0;
        for (int q = 0; q < ks; ++q) {
          ag += red[(mtile + mt * (ctg + NCT * q)) * RED + off];
          au += red[(mtile + mt * (ctu + NCT * q)) * RED + off];
        }
        const float g = __fmul_rn(static_cast<float>(ag), a.gu_alpha[f0 + c]);
        const float up = __fmul_rn(static_cast<float>(au), a.gu_alpha[a.F + f0 + c]);
        const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-g)));
        const float h = __fmul_rn(__fmul_rn(g, sig), up);
        code = fgemv::clamp_code(__fdiv_rn(h, hscale), -128.0f);
        if (a.h_out) a.h_out[static_cast<size_t>(m) * a.F + f0 + c] = static_cast<int8_t>(code);
      }
      hs[r * ldh + c] = static_cast<int8_t>(code);
    }
    __syncthreads();
    fgemv::segment_sums(hs, ldh, rows_pad, segd, nsegh, sxh);
    __syncthreads();

    // down product over this block's BF rows of Wd, all D columns
    const int g4 = lane >> 2, t = lane & 3;
    for (int u = warp; u < mt * (a.D / TILE_N); u += WARPS) {
      const int mtile = u % mt, n0 = (u / mt) * TILE_N;
      int tot[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
      fgemv::warp_unit(a.d_qw, a.D, n0, f0, a.gs, a.d_s, a.d_z, hs + mtile * 8 * ldh, ldh,
                       sxh + mtile * 8 * nsegh, nsegh, segd, 0, nsegh, 1, tot);
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = r0 + mtile * 8 + 2 * t + (e & 1);
          if (m < a.M)
            atomicAdd(a.acc + static_cast<size_t>(m) * a.D + n0 + 4 * g4 + 2 * p + (e >> 1),
                      tot[p][e]);
        }
    }
    __syncthreads();
  }
}

__global__ void mlp_decode_rp_epilogue(const int* __restrict__ acc, int M, int D,
                                       const float* __restrict__ alpha,
                                       const float* __restrict__ beta,
                                       const float* __restrict__ x, int fuse_residual,
                                       float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * D) return;
  float y = fgemv::epilogue(acc[i], alpha[i % D], beta, i % D);
  if (fuse_residual) y = __fadd_rn(y, x[i]);
  out[i] = y;
}

}  // namespace

extern "C" {

// x (M, D) f32; ln_w (D,) f32; ln_b (D,) f32 or null; down_scale one f32 on
// the device; gu_qw (D/2, 2F) rowpair bytes with (Gd/2, 2F) int8 plane rows
// and gu_alpha (2F,) f32; d_qw (F/2, D) rowpair bytes with (8 Gf, D) int8
// replicated scales and zeros, d_alpha (D,) f32, d_beta (D,) f32 or null;
// acc (M, D) int32 scratch (zeroed here); out (M, D) f32; xq_out (M, D) and
// h_out (M, F) int8 or null (receive the norm and down-input codes).
int fused_mlp_decode_rp(const void* x, const void* ln_w, const void* ln_b, float eps,
                        const void* down_scale, const void* gu_qw, const void* gu_s_hi,
                        const void* gu_s_lo, const void* gu_z_hi, const void* gu_z_lo,
                        const void* gu_alpha, const void* d_qw, const void* d_ws,
                        const void* d_wz, const void* d_alpha, const void* d_beta,
                        int fuse_residual, void* acc, void* out, void* xq_out, void* h_out,
                        int M, int D, int F, int gs, int sms, void* stream) {
  if (!fgemv::gemv_shapes_ok(M, 2 * F, D, gs) || F % BF || (gs % BF && BF % gs) || !down_scale ||
      D % TILE_N)
    return fgemv::BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MlpArgs a{};
  a.x = static_cast<const float*>(x);
  a.lnw = static_cast<const float*>(ln_w);
  a.lnb = static_cast<const float*>(ln_b);
  a.eps = eps;
  a.down_scale = static_cast<const float*>(down_scale);
  a.gu_qw = static_cast<const uint8_t*>(gu_qw);
  const size_t n2f = 2 * static_cast<size_t>(F);
  a.gu_s = {static_cast<const int8_t*>(gu_s_hi), static_cast<const int8_t*>(gu_s_lo), n2f};
  a.gu_z = {static_cast<const int8_t*>(gu_z_hi), static_cast<const int8_t*>(gu_z_lo), n2f};
  a.gu_alpha = static_cast<const float*>(gu_alpha);
  a.d_qw = static_cast<const uint8_t*>(d_qw);
  const int8_t* ws = static_cast<const int8_t*>(d_ws);
  const int8_t* wz = static_cast<const int8_t*>(d_wz);
  a.d_s = {ws, ws + 8 * static_cast<size_t>(D), 16 * static_cast<size_t>(D)};
  a.d_z = {wz, wz + 8 * static_cast<size_t>(D), 16 * static_cast<size_t>(D)};
  a.acc = static_cast<int*>(acc);
  a.xq_out = static_cast<int8_t*>(xq_out);
  a.h_out = static_cast<int8_t*>(h_out);
  a.M = M;
  a.D = D;
  a.F = F;
  a.gs = gs;
  a.rows_pass = fgemv::rows_per_pass(M, [=](int r) { return layout(r, D, gs).total; });
  if (a.rows_pass == 0) return fgemv::BAD_ARGS;
  cudaError_t err = cudaMemsetAsync(acc, 0, static_cast<size_t>(M) * D * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = layout(a.rows_pass, D, gs).total;
  err = fgemv::allow_smem(mlp_decode_rp_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  mlp_decode_rp_kernel<<<F / BF, THREADS, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = M * D;
  mlp_decode_rp_epilogue<<<(total + 255) / 256, 256, 0, st>>>(
      static_cast<const int*>(acc), M, D, static_cast<const float*>(d_alpha),
      static_cast<const float*>(d_beta), static_cast<const float*>(x), fuse_residual,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
