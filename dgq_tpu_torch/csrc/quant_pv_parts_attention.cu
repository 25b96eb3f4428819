// P5: decode attention in the six p @ V variants of the quant_pv cost probe,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/probe_quant_pv_parts.py::attn (body _body),
// which splits what K3's INT8 p @ V (quant_pv) costs.  One block per (slot b,
// kv head) serves its rep = H / Hkv query rows.  Shared prologue, as the TPU
// kernel: int32 scores q . k over the (Dh, Smax) transposed K cache, times
// qk_scale in f32; positions at or past length[b] masked to finfo(f32).min;
// m the row max, e = exp(s - m) (expf, not __expf), denom = sum e.  Then per
// mode (MODE below):
//   fp          out = sum (e / denom) * (v * v_scale)               f32
//   nodeq       out = (sum (e / denom) * v) * v_scale                f32
//   quant       c = rint(127 e) (half to even, as jnp.round); acc = sum c * v (int32);
//               out = acc * ((v_scale / 127) / denom)
//   quant_fast  c = trunc(127 e + 0.5), then as quant (K3's shipped rule)
//   noround     c = trunc(127 e), then as quant
//   s32dot      c = trunc(127 e); out = float(acc) (no epilogue)
// The f32 products and sums that decide a code are taken one rounding at a
// time (__fmul_rn, __fsub_rn, __fadd_rn): an fma would move codes across the
// .5 boundary.  Codes past the valid length are exactly 0 and their positions
// are not read; with no valid position every score is finfo.min and every e
// is 1, as in the TPU kernel.
//
// What bounds it on this card: the K and V codes of the valid positions,
// 2 * len * Dh bytes per (slot, kv head), over the 3.35 TB/s of device memory
// (16.8 MB at the probe's 32 heads x 2048 positions).  Design: K3's three
// passes (csrc/int8_decode_attention.cu): scores with dp4a after a 4x4 byte
// transpose of the d-major K cache into an f32 scratch row, with the row max;
// the exp sum; then a tile of weights (codes or probabilities) at a time in
// shared memory against V rows read 4 dims a thread.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int DH = 128;
constexpr int DQ = DH / 4;          // d quads
constexpr int JS = NTHREADS / DQ;   // position slices in p @ V
constexpr int TILE = 256;           // positions per p @ V tile
constexpr float NEG = -3.4028234663852886e38f;  // finfo(float32).min

enum Mode { FP = 0, NODEQ = 1, QUANT = 2, QUANT_FAST = 3, NOROUND = 4, S32DOT = 5 };

__device__ __forceinline__ uint32_t ld32(const int8_t* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ void transpose4x4(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3,
                                             uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t2 = __byte_perm(r0, r1, 0x7362), t3 = __byte_perm(r2, r3, 0x7362);
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

template <int REP, bool MAX>
__device__ __forceinline__ void block_reduce(float (&val)[REP], float (*red)[REP], float* dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < REP; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, val[r], off);
      val[r] = MAX ? fmaxf(val[r], o) : val[r] + o;
    }
    if (lane == 0) red[warp][r] = val[r];
  }
  __syncthreads();
  if (threadIdx.x < REP) {
    float a = red[0][threadIdx.x];
    for (int w = 1; w < NWARPS; ++w) a = MAX ? fmaxf(a, red[w][threadIdx.x]) : a + red[w][threadIdx.x];
    dst[threadIdx.x] = a;
  }
  __syncthreads();
}

// the weight of one position: a probability, or an int8 code held exactly in an f32
template <int MODE>
__device__ __forceinline__ float weight(float e, float denom) {
  if constexpr (MODE == FP || MODE == NODEQ) {
    return __fdiv_rn(e, denom);
  } else {
    const float e127 = __fmul_rn(e, 127.f);
    if constexpr (MODE == QUANT) return rintf(e127);
    if constexpr (MODE == QUANT_FAST) return static_cast<float>(static_cast<int>(__fadd_rn(e127, 0.5f)));
    return static_cast<float>(static_cast<int>(e127));
  }
}

template <int REP, int MODE>
__global__ void __launch_bounds__(NTHREADS)
pv_parts_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ kt,
                const int8_t* __restrict__ v, const int* __restrict__ lengths,
                float qk_scale, float v_scale, float* __restrict__ sbuf,
                float* __restrict__ out, int Hkv, int Smax) {
  constexpr bool INT = MODE >= QUANT;
  using acc_t = typename std::conditional<INT, int, float>::type;
  __shared__ uint32_t sQ[REP][DQ];
  __shared__ float sRed[NWARPS][REP];
  __shared__ float sM[REP], sDen[REP];
  __shared__ float sW[REP][TILE];
  __shared__ acc_t sAcc[JS][REP][DH];

  const int tid = threadIdx.x;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int H = Hkv * REP;
  const int valid = min(max(lengths[b], 0), Smax);
  const int len = valid > 0 ? valid : Smax;  // positions whose e can be non-zero
  const int8_t* kth = kt + ((size_t)b * Hkv + hk) * DH * Smax;
  const int8_t* vh = v + ((size_t)b * Hkv + hk) * (size_t)Smax * DH;
  const int8_t* qg = q + ((size_t)b * H + hk * REP) * DH;
  float* srow = sbuf + ((size_t)b * H + hk * REP) * Smax;

  for (int i = tid; i < REP * DQ; i += NTHREADS) sQ[i / DQ][i % DQ] = ld32(qg + i * 4);
  __syncthreads();

  // pass 1: scores for 4 positions per thread, and the row max
  float mx[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) mx[r] = NEG;
  for (int j0 = tid * 4; j0 < len; j0 += NTHREADS * 4) {
    int acc[REP][4];
#pragma unroll
    for (int r = 0; r < REP; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0;
    if (valid > 0) {
#pragma unroll 4
      for (int dq = 0; dq < DQ; ++dq) {
        const int8_t* src = kth + (size_t)(dq * 4) * Smax + j0;
        uint32_t c[4];
        transpose4x4(ld32(src), ld32(src + Smax), ld32(src + 2 * Smax), ld32(src + 3 * Smax), c);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          const int qw = static_cast<int>(sQ[r][dq]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][e] = __dp4a(static_cast<int>(c[e]), qw, acc[r][e]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (j0 + e >= len) break;
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float s = valid > 0 ? __fmul_rn(static_cast<float>(acc[r][e]), qk_scale) : NEG;
        srow[(size_t)r * Smax + j0 + e] = s;
        mx[r] = fmaxf(mx[r], s);
      }
    }
  }
  block_reduce<REP, true>(mx, sRed, sM);

  // pass 2: denom = sum exp(s - m)
  float den[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) den[r] = 0.f;
  for (int j = tid; j < len; j += NTHREADS)
#pragma unroll
    for (int r = 0; r < REP; ++r) den[r] += expf(__fsub_rn(srow[(size_t)r * Smax + j], sM[r]));
  block_reduce<REP, false>(den, sRed, sDen);

  // pass 3: weights of a tile of positions, then their dot with V
  const int dcol = tid % DQ, js = tid / DQ;
  acc_t acc[REP][4];
#pragma unroll
  for (int r = 0; r < REP; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0;
  for (int t0 = 0; t0 < len; t0 += TILE) {
    __syncthreads();
    for (int i = tid; i < REP * TILE; i += NTHREADS) {
      const int r = i / TILE, jj = i % TILE, j = t0 + jj;
      sW[r][jj] = j < len ? weight<MODE>(expf(__fsub_rn(srow[(size_t)r * Smax + j], sM[r])), sDen[r])
                          : 0.f;
    }
    __syncthreads();
    const int jn = min(TILE, len - t0);
    for (int jj = js; jj < jn; jj += JS) {
      const uint32_t vw = ld32(vh + (size_t)(t0 + jj) * DH + dcol * 4);
      int vb[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) vb[e] = static_cast<int8_t>((vw >> (8 * e)) & 0xFF);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float w = sW[r][jj];
        if constexpr (INT) {
          const int c = static_cast<int>(w);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][e] += c * vb[e];
        } else if constexpr (MODE == FP) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[r][e] = fmaf(w, __fmul_rn(static_cast<float>(vb[e]), v_scale), acc[r][e]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][e] = fmaf(w, static_cast<float>(vb[e]), acc[r][e]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) sAcc[js][r][dcol * 4 + e] = acc[r][e];
  __syncthreads();
  float* og = out + ((size_t)b * H + hk * REP) * DH;
  for (int i = tid; i < REP * DH; i += NTHREADS) {
    const int r = i / DH, d = i % DH;
    acc_t a = 0;
    for (int s = 0; s < JS; ++s) a += sAcc[s][r][d];
    float o;
    if constexpr (MODE == FP) o = a;
    else if constexpr (MODE == NODEQ) o = __fmul_rn(a, v_scale);
    else if constexpr (MODE == S32DOT) o = __int2float_rn(a);
    else o = __fmul_rn(__int2float_rn(a), __fdiv_rn(__fdiv_rn(v_scale, 127.f), sDen[r]));
    og[i] = o;
  }
}

template <int REP>
int launch_mode(int mode, dim3 grid, cudaStream_t st, const int8_t* q, const int8_t* kt,
                const int8_t* v, const int* len, float qks, float vs, float* sbuf, float* out,
                int Hkv, int Smax) {
#define PV_PARTS_CASE(M)                                                                      \
  case M:                                                                                     \
    pv_parts_kernel<REP, M><<<grid, NTHREADS, 0, st>>>(q, kt, v, len, qks, vs, sbuf, out, Hkv, \
                                                       Smax);                                 \
    return 0;
  switch (mode) {
    PV_PARTS_CASE(FP)
    PV_PARTS_CASE(NODEQ)
    PV_PARTS_CASE(QUANT)
    PV_PARTS_CASE(QUANT_FAST)
    PV_PARTS_CASE(NOROUND)
    PV_PARTS_CASE(S32DOT)
    default: return cudaErrorInvalidValue;
  }
#undef PV_PARTS_CASE
}

}  // namespace

extern "C" {

// q (B, H, 128) int8; kt (B, Hkv, 128, Smax) int8; v (B, Hkv, Smax, 128) int8;
// lengths (B,) int32 on the device; sbuf (B, H, Smax) f32 scratch; out (B, H,
// 128) f32; mode 0-5 as Mode; H / Hkv in {1, 2, 4, 8}; Smax % 4 == 0.
int quant_pv_parts_attention(const void* q, const void* kt, const void* v, const void* lengths,
                             float qk_scale, float v_scale, void* sbuf, void* out, int B, int H,
                             int Hkv, int Dh, int Smax, int mode, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv || Dh != DH || Smax <= 0 || Smax % 4) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(Hkv, B);
  auto qs = static_cast<const int8_t*>(q);
  auto ks = static_cast<const int8_t*>(kt);
  auto vs = static_cast<const int8_t*>(v);
  auto ln = static_cast<const int*>(lengths);
  auto sb = static_cast<float*>(sbuf);
  auto o = static_cast<float*>(out);
  int rc;
  switch (H / Hkv) {
    case 1: rc = launch_mode<1>(mode, grid, st, qs, ks, vs, ln, qk_scale, v_scale, sb, o, Hkv, Smax); break;
    case 2: rc = launch_mode<2>(mode, grid, st, qs, ks, vs, ln, qk_scale, v_scale, sb, o, Hkv, Smax); break;
    case 4: rc = launch_mode<4>(mode, grid, st, qs, ks, vs, ln, qk_scale, v_scale, sb, o, Hkv, Smax); break;
    case 8: rc = launch_mode<8>(mode, grid, st, qs, ks, vs, ln, qk_scale, v_scale, sb, o, Hkv, Smax); break;
    default: rc = cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
