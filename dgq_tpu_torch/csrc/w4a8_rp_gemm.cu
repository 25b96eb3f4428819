// K1: W4A8 GEMM on rowpair-packed int4 weights, for Hopper (sm_90a).
//
// Replaces the TPU kernel dgq_tpu/ops/quant_matmul.py::w4a8_matmul_rp_pipe
// (body _rp_pipe_kernel, dequant _rp_deq).  Computes
//   out[m, n] = float(sum_k x[m, k] * w[k, n]) * alpha[n] (+ beta[n])
// with x int8 (M, K), w the int8 dequantisation (c4 - (z - 8)) * s of the
// sign-extended nibble c4 (byte r of qw holds row 2r in its low nibble and
// row 2r+1 in its high nibble), exact s8 x s8 -> s32 accumulation and an fp32
// epilogue rounded exactly as the plain version (no fma contraction).
//
// What bounds it on this card: at decode (M = batch rows <= 16) the weight
// bytes, K*N/2, over the 3.35 TB/s of device memory; at prefill (M = 1024) the
// int8 tensor-core rate.  Hopper has no int4 tensor-core operand, so each
// K-tile of packed bytes is dequantised once per block into an int8 tile in
// shared memory, laid out k-contiguous per output column, and multiplied with
// mma.sync m16n8k32 s8.  Small-M calls take a 16-row tile and split K over
// blocks (int32 partials, summed exactly by a second kernel) so that the
// weight stream is spread over all SMs.  No TMA or wgmma yet.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;        // K per tile; lies inside one group (groupsize % 64 == 0)
constexpr int LDS = BK + 16;  // shared row stride in bytes: 20 words, conflict-free fragments

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_s32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float epilogue(int acc, const float* alpha, const float* beta, int n) {
  float y = __fmul_rn(static_cast<float>(acc), alpha[n]);
  return beta ? __fadd_rn(y, beta[n]) : y;
}

template <int BM, int BN, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
rp_gemm_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ qw,
               const int8_t* __restrict__ scales, const int8_t* __restrict__ zeros,
               int srep, int M, int N, int K, int gs, int k_split,
               const float* __restrict__ alpha, const float* __restrict__ beta,
               float* __restrict__ out, int* __restrict__ part) {
  constexpr int NTHREADS = WARPS_M * WARPS_N * 32;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MT = WM / 16, NT = WN / 8;
  static_assert(WM % 16 == 0 && WN % 8 == 0, "warp tile");
  __shared__ __align__(16) int8_t sA[BM * LDS];  // x tile [m][k]
  __shared__ __align__(16) int8_t sB[BN * LDS];  // dequantised w tile [n][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * k_split;
  const int ke = min(K, kb + k_split);

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = kb; k0 < ke; k0 += BK) {
    // x tile: BM rows of 64 bytes, 16-byte chunks; rows past M are zero
    for (int i = tid; i < BM * (BK / 16); i += NTHREADS) {
      const int r = i / (BK / 16), c = i % (BK / 16);
      int4 val = make_int4(0, 0, 0, 0);
      if (m0 + r < M)
        val = *reinterpret_cast<const int4*>(x + (size_t)(m0 + r) * K + k0 + c * 16);
      *reinterpret_cast<int4*>(sA + r * LDS + c * 16) = val;
    }
    // w tile: 32 packed rows x BN columns, 16 columns per chunk, dequantised
    // with the group's scale and zero rows and stored transposed
    const int grp = k0 / gs;
    const int8_t* srow = scales + (size_t)grp * srep * N;
    const int8_t* zrow = zeros + (size_t)grp * srep * N;
    for (int i = tid; i < (BK / 2) * (BN / 16); i += NTHREADS) {
      const int r = i / (BN / 16), c = i % (BN / 16);
      const int n = n0 + c * 16;
      uint4 wq = make_uint4(0, 0, 0, 0), sv = wq, zv = wq;
      if (n < N) {
        wq = *reinterpret_cast<const uint4*>(qw + (size_t)(k0 / 2 + r) * N + n);
        sv = *reinterpret_cast<const uint4*>(srow + n);
        zv = *reinterpret_cast<const uint4*>(zrow + n);
      }
      const uint8_t* wb = reinterpret_cast<const uint8_t*>(&wq);
      const int8_t* sb = reinterpret_cast<const int8_t*>(&sv);
      const int8_t* zb = reinterpret_cast<const int8_t*>(&zv);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int s = sb[j], zs = zb[j] - 8;
        const int lo = static_cast<int>((wb[j] & 0xF) ^ 8) - 8;
        const int hi = static_cast<int>((wb[j] >> 4) ^ 8) - 8;
        const uint32_t w0 = static_cast<uint8_t>((lo - zs) * s);
        const uint32_t w1 = static_cast<uint8_t>((hi - zs) * s);
        *reinterpret_cast<uint16_t*>(sB + (c * 16 + j) * LDS + 2 * r) =
            static_cast<uint16_t>(w0 | (w1 << 8));
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int8_t* p = sA + (wm * WM + i * 16 + g) * LDS + kk + t * 4;
        a[i][0] = ld_s32(p);
        a[i][1] = ld_s32(p + 8 * LDS);
        a[i][2] = ld_s32(p + 16);
        a[i][3] = ld_s32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* p = sB + (wn * WN + j * 8 + g) * LDS + kk + t * 4;
        b[j][0] = ld_s32(p);
        b[j][1] = ld_s32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm * WM + i * 16 + g + half * 8;
        const int n = n0 + wn * WN + j * 8 + t * 2;
        if (m >= M || n >= N) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = acc[i][j][half * 2 + e];
          if (part)
            part[((size_t)blockIdx.z * M + m) * N + n + e] = v;
          else
            out[(size_t)m * N + n + e] = epilogue(v, alpha, beta, n + e);
        }
      }
}

__global__ void splitk_epilogue(const int* __restrict__ part, int splits, int M, int N,
                                const float* __restrict__ alpha, const float* __restrict__ beta,
                                float* __restrict__ out) {
  const size_t total = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int acc = 0;
  for (int z = 0; z < splits; ++z) acc += part[z * total + i];
  out[i] = epilogue(acc, alpha, beta, static_cast<int>(i % N));
}

struct Tile {
  int bm, bn;
};

Tile tile_for(int M) {
  if (M <= 16) return {16, 64};
  if (M <= 64) return {64, 128};
  return {128, 128};
}

template <int BM, int BN, int WARPS_M, int WARPS_N>
void launch(dim3 grid, cudaStream_t st, const int8_t* x, const uint8_t* qw, const int8_t* s,
            const int8_t* z, int srep, int M, int N, int K, int gs, int k_split,
            const float* alpha, const float* beta, float* out, int* part) {
  rp_gemm_kernel<BM, BN, WARPS_M, WARPS_N><<<grid, WARPS_M * WARPS_N * 32, 0, st>>>(
      x, qw, s, z, srep, M, N, K, gs, k_split, alpha, beta, out, part);
}

}  // namespace

extern "C" {

// K per split for an (M, N, K) call on a card with `sms` SMs: the whole K
// unless the output tiles alone leave SMs idle.
int w4a8_rp_gemm_k_split(int M, int N, int K, int sms) {
  const Tile tl = tile_for(M);
  const int blocks = ((M + tl.bm - 1) / tl.bm) * ((N + tl.bn - 1) / tl.bn);
  if (blocks >= sms) return K;
  const int ktiles = K / BK;
  int splits = (2 * sms + blocks - 1) / blocks;
  if (splits > ktiles) splits = ktiles;
  return ((ktiles + splits - 1) / splits) * BK;
}

// x (M, K) int8; qw (K/2, N) rowpair bytes; scales/zeros: group g at row
// g * srep of an (G * srep, N) int8 array; alpha (N,) f32; beta (N,) f32 or
// null; out (M, N) f32; part (K / k_split, M, N) int32 scratch when k_split < K.
int w4a8_rp_gemm(const void* x, const void* qw, const void* scales, const void* zeros, int srep,
                 int M, int N, int K, int gs, int k_split, const void* alpha, const void* beta,
                 void* out, void* part, void* stream) {
  if (M <= 0 || N % 16 || K % BK || gs % BK || K % gs || k_split % BK || k_split <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int splits = (K + k_split - 1) / k_split;
  int* p = splits > 1 ? static_cast<int*>(part) : nullptr;
  if (splits > 1 && !p) return cudaErrorInvalidValue;
  const Tile tl = tile_for(M);
  const dim3 grid((N + tl.bn - 1) / tl.bn, (M + tl.bm - 1) / tl.bm, splits);
  auto xs = static_cast<const int8_t*>(x);
  auto qs = static_cast<const uint8_t*>(qw);
  auto ss = static_cast<const int8_t*>(scales);
  auto zs = static_cast<const int8_t*>(zeros);
  auto al = static_cast<const float*>(alpha);
  auto be = static_cast<const float*>(beta);
  auto o = static_cast<float*>(out);
  if (tl.bm == 16)
    launch<16, 64, 1, 4>(grid, st, xs, qs, ss, zs, srep, M, N, K, gs, k_split, al, be, o, p);
  else if (tl.bm == 64)
    launch<64, 128, 2, 4>(grid, st, xs, qs, ss, zs, srep, M, N, K, gs, k_split, al, be, o, p);
  else
    launch<128, 128, 2, 4>(grid, st, xs, qs, ss, zs, srep, M, N, K, gs, k_split, al, be, o, p);
  if (splits > 1) {
    const size_t total = (size_t)M * N;
    splitk_epilogue<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(p, splits, M, N, al, be, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
