// K3: single-token decode attention over the INT8 KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel dgq_tpu/ops/attention.py::int8_decode_attention
// (body _decode_kernel).  One block per (batch slot, kv head) serves the rep
// = H / Hkv query heads of that kv head.  Scores s8 q.k^T -> s32 times
// scales[0] = (q_scale * k_scale) / sqrt(Dh) over the valid length
// lengths[b]; m is the GLOBAL row max and e = exp(s - m).  With quant_pv the
// exp-weights become int8 codes trunc(127 e + 0.5) (computed with
// __fmul_rn/__fadd_rn: an fma would move codes across the .5 boundary), p @ V
// is an exact integer sum and out = acc * ((v_scale / 127) / denom); without
// it, out = sum (e / denom) * (v * v_scale) in fp32.
//
// What bounds it on this card: the cache bytes, 2 * len * Dh per (slot, kv
// head), over the 3.35 TB/s of device memory.  The TPU kernel holds the whole
// (Dh, Smax) slice in VMEM; a block here cannot (2 MB at Smax 8192), so it
// tiles over positions in three passes: scores and the row max (K read once,
// 4 positions per thread with dp4a after a 4x4 byte transpose of the
// d-major K cache; scores kept in an fp32 scratch row), then the exp sum,
// then the codes (or probabilities) and the dot with V.  Only positions below
// the valid length are read: codes past it are exactly 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int TILE = 256;  // positions per p @ V tile
constexpr float NEG = -3.4028234663852886e38f;  // finfo(float32).min

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

// reduce REP per-thread values over the block (max or sum) into dst[REP]
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

template <int DH, int REP, bool QPV>
__global__ void __launch_bounds__(NTHREADS)
decode_attn_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ kt,
                   const int8_t* __restrict__ v, const int* __restrict__ lengths,
                   const float* __restrict__ scales, float* __restrict__ sbuf,
                   float* __restrict__ out, int Hkv, int Smax) {
  using acc_t = typename std::conditional<QPV, int, float>::type;
  constexpr int DQ = DH / 4;          // d quads
  constexpr int JS = NTHREADS / DQ;   // position slices in p @ V
  __shared__ uint32_t sQ[REP][DQ];
  __shared__ float sRed[NWARPS][REP];
  __shared__ float sM[REP], sDen[REP];
  __shared__ float sW[REP][TILE];     // codes (exact small integers) or probabilities
  __shared__ acc_t sAcc[JS][REP][DH];

  const int tid = threadIdx.x;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int H = Hkv * REP;
  const int len = lengths[b];
  const float qk_scale = scales[0], v_scale = scales[1], vs127 = scales[2];
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
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (j0 + e >= len) break;
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float s = __fmul_rn(static_cast<float>(acc[r][e]), qk_scale);
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
      float w = 0.f;
      if (j < len) {
        const float e = expf(__fsub_rn(srow[(size_t)r * Smax + j], sM[r]));
        if (QPV)
          w = static_cast<float>(static_cast<int>(__fadd_rn(__fmul_rn(e, 127.f), 0.5f)));
        else
          w = __fdiv_rn(e, sDen[r]);
      }
      sW[r][jj] = w;
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
        if (QPV) {
          const int c = static_cast<int>(w);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][e] += c * vb[e];
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[r][e] = fmaf(w, __fmul_rn(static_cast<float>(vb[e]), v_scale), acc[r][e]);
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
    og[i] = QPV ? __fmul_rn(static_cast<float>(a), __fdiv_rn(vs127, sDen[r])) : static_cast<float>(a);
  }
}

template <int DH, int REP>
void launch(bool qpv, dim3 grid, cudaStream_t st, const int8_t* q, const int8_t* kt,
            const int8_t* v, const int* len, const float* sc, float* sbuf, float* out, int Hkv,
            int Smax) {
  if (qpv)
    decode_attn_kernel<DH, REP, true><<<grid, NTHREADS, 0, st>>>(q, kt, v, len, sc, sbuf, out, Hkv, Smax);
  else
    decode_attn_kernel<DH, REP, false><<<grid, NTHREADS, 0, st>>>(q, kt, v, len, sc, sbuf, out, Hkv, Smax);
}

template <int DH>
int launch_rep(int rep, bool qpv, dim3 grid, cudaStream_t st, const int8_t* q, const int8_t* kt,
               const int8_t* v, const int* len, const float* sc, float* sbuf, float* out, int Hkv,
               int Smax) {
  switch (rep) {
    case 1: launch<DH, 1>(qpv, grid, st, q, kt, v, len, sc, sbuf, out, Hkv, Smax); return 0;
    case 2: launch<DH, 2>(qpv, grid, st, q, kt, v, len, sc, sbuf, out, Hkv, Smax); return 0;
    case 4: launch<DH, 4>(qpv, grid, st, q, kt, v, len, sc, sbuf, out, Hkv, Smax); return 0;
    case 8: launch<DH, 8>(qpv, grid, st, q, kt, v, len, sc, sbuf, out, Hkv, Smax); return 0;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, H, Dh) int8; kt (B, Hkv, Dh, Smax) int8; v (B, Hkv, Smax, Dh) int8;
// lengths (B,) int32 valid positions per slot, each in [1, Smax]; scales f32
// [qk_scale, v_scale, v_scale / 127] on the device; sbuf (B, H, Smax) f32
// scratch; out (B, H, Dh) f32.
int int8_decode_attention(const void* q, const void* kt, const void* v, const void* lengths,
                          const void* scales, void* sbuf, void* out, int B, int H, int Hkv,
                          int Dh, int Smax, int quant_pv, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv || Smax % 4) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(Hkv, B);
  auto qs = static_cast<const int8_t*>(q);
  auto ks = static_cast<const int8_t*>(kt);
  auto vs = static_cast<const int8_t*>(v);
  auto ln = static_cast<const int*>(lengths);
  auto sc = static_cast<const float*>(scales);
  auto sb = static_cast<float*>(sbuf);
  auto o = static_cast<float*>(out);
  int rc;
  if (Dh == 128)
    rc = launch_rep<128>(H / Hkv, quant_pv != 0, grid, st, qs, ks, vs, ln, sc, sb, o, Hkv, Smax);
  else if (Dh == 64)
    rc = launch_rep<64>(H / Hkv, quant_pv != 0, grid, st, qs, ks, vs, ln, sc, sb, o, Hkv, Smax);
  else
    rc = cudaErrorInvalidValue;
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
