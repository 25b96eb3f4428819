// K2: causal flash attention over the INT8 KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel dgq_tpu/ops/attention.py::int8_prefill_attention
// (body _prefill_kernel).  For each query row: scores s8 q.k^T -> s32, times
// scales[0] = (q_scale * k_scale) / sqrt(Dh); mask kpos <= q_offset + row and
// kpos < plen (masked scores are finfo(f32).min, not -inf); online fp32
// softmax; p @ V in fp32 on CUDA cores with V dequantised as v * v_scale (no
// TF32); out = acc / max(l, 1e-20).  GQA: kv head = h / (H / Hkv).  The K
// cache is stored transposed, (B, Hkv, Dh, Smax).
//
// What bounds it on this card: at the main path's prefill (Sp 256) neither
// bytes nor tensor-core operations; the fp32 p @ V on CUDA cores (67 TFLOP/s
// peak) dominates, and the score product runs on int8 tensor cores (mma.sync
// m16n8k32).  A block takes 64 query rows (16 per warp) and walks the kv
// blocks only up to the last causal and valid one (skipping fully masked
// blocks is exact: alpha = 1, p = 0).  The transposed K tile is turned into
// a k-contiguous [kpos][d] shared tile with 4x4 byte transposes so the
// tensor-core fragments load as 32-bit words.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BKV = 64;   // keys per kv block
constexpr int WARPS = 4;  // 16 query rows per warp
constexpr float NEG = -3.4028234663852886e38f;  // finfo(float32).min

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) { return *reinterpret_cast<const uint32_t*>(p); }

// rows r0..r3 of a 4x4 byte block -> its columns
__device__ __forceinline__ void transpose4x4(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3,
                                             uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t2 = __byte_perm(r0, r1, 0x7362), t3 = __byte_perm(r2, r3, 0x7362);
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

template <int DH>
__global__ void __launch_bounds__(WARPS * 32)
prefill_attn_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ kt,
                    const int8_t* __restrict__ v, const float* __restrict__ scales,
                    float* __restrict__ out, int H, int Hkv, int Sp, int Smax, int plen,
                    int q_offset) {
  constexpr int LDK = DH + 16;  // [kpos][d] row stride in bytes
  constexpr int KS = DH / 32;   // k32 steps of the score product
  constexpr int NTL = BKV / 8;  // n8 tiles of keys
  constexpr int PVD = DH / 32;  // output dims per lane in p @ V
  __shared__ __align__(16) int8_t sK[BKV * LDK];
  __shared__ __align__(16) int8_t sV[BKV * DH];
  __shared__ float sP[WARPS][16][BKV];
  __shared__ float sAlpha[WARPS][16];
  __shared__ float sL[WARPS][16];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, hk = h / (H / Hkv);
  const int row0 = blockIdx.x * BQ + warp * 16;
  const float qk_scale = scales[0], v_scale = scales[1];

  const int8_t* qh = q + ((size_t)b * H + h) * Sp * DH;
  const int8_t* kth = kt + ((size_t)b * Hkv + hk) * DH * Smax;
  const int8_t* vh = v + ((size_t)b * Hkv + hk) * (size_t)Smax * DH;

  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int8_t* p = qh + (size_t)(row0 + g) * DH + ks * 32 + t * 4;
    qa[ks][0] = ld32(p);
    qa[ks][1] = ld32(p + 8 * DH);
    qa[ks][2] = ld32(p + 16);
    qa[ks][3] = ld32(p + 8 * DH + 16);
  }

  float m_r[2] = {NEG, NEG}, l_r[2] = {0.f, 0.f};  // rows g and g + 8
  float acc[16][PVD];                              // rows 0..15, dims lane*PVD..
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int e = 0; e < PVD; ++e) acc[r][e] = 0.f;

  const int kv_end = min(plen, q_offset + (int)blockIdx.x * BQ + BQ);
  const int nkv = (kv_end + BKV - 1) / BKV;
  for (int kb = 0; kb < nkv; ++kb) {
    const int kv0 = kb * BKV;
    __syncthreads();
    for (int i = tid; i < (DH / 4) * (BKV / 4); i += WARPS * 32) {
      const int dq = i / (BKV / 4), kq = i % (BKV / 4);
      const int8_t* src = kth + (size_t)(dq * 4) * Smax + kv0 + kq * 4;
      uint32_t c[4];
      transpose4x4(ld32(src), ld32(src + Smax), ld32(src + 2 * Smax), ld32(src + 3 * Smax), c);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        *reinterpret_cast<uint32_t*>(sK + (kq * 4 + e) * LDK + dq * 4) = c[e];
    }
    for (int i = tid; i < BKV * DH / 16; i += WARPS * 32)
      *reinterpret_cast<int4*>(sV + i * 16) =
          *reinterpret_cast<const int4*>(vh + (size_t)kv0 * DH + i * 16);
    __syncthreads();

    int sc[NTL][4];
#pragma unroll
    for (int j = 0; j < NTL; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int8_t* p = sK + (j * 8 + g) * LDK + ks * 32 + t * 4;
        mma_s8(sc[j], qa[ks], ld32(p), ld32(p + 16));
      }
    }

    float s[NTL][4];
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = kv0 + j * 8 + t * 2 + (i & 1);
        const int qpos = q_offset + row0 + g + (i >> 1) * 8;
        const float x = __fmul_rn(static_cast<float>(sc[j][i]), qk_scale);
        s[j][i] = (kpos <= qpos && kpos < plen) ? x : NEG;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float m_new = fmaxf(m_r[hr], mx[hr]);
      alpha[hr] = expf(m_r[hr] - m_new);
      m_r[hr] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(s[j][i] - m_r[i >> 1]);
        sum[i >> 1] += p;
        sP[warp][g + (i >> 1) * 8][j * 8 + t * 2 + (i & 1)] = p;
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 1);
      sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 2);
      l_r[hr] = l_r[hr] * alpha[hr] + sum[hr];
      if (t == 0) sAlpha[warp][g + hr * 8] = alpha[hr];
    }
    __syncwarp();

#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float a = sAlpha[warp][r];
#pragma unroll
      for (int e = 0; e < PVD; ++e) acc[r][e] *= a;
    }
    for (int j = 0; j < BKV; ++j) {
      float vf[PVD];
#pragma unroll
      for (int e = 0; e < PVD; ++e)
        vf[e] = __fmul_rn(static_cast<float>(sV[j * DH + lane * PVD + e]), v_scale);
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float p = sP[warp][r][j];
#pragma unroll
        for (int e = 0; e < PVD; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
      }
    }
  }

  if (t == 0) {
    sL[warp][g] = l_r[0];
    sL[warp][g + 8] = l_r[1];
  }
  __syncwarp();
  float* oh = out + ((size_t)b * H + h) * Sp * DH;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const float l = fmaxf(sL[warp][r], 1e-20f);
#pragma unroll
    for (int e = 0; e < PVD; ++e)
      oh[(size_t)(row0 + r) * DH + lane * PVD + e] = __fdiv_rn(acc[r][e], l);
  }
}

}  // namespace

extern "C" {

// q (B, H, Sp, Dh) int8; kt (B, Hkv, Dh, Smax) int8; v (B, Hkv, Smax, Dh) int8;
// scales f32 [qk_scale, v_scale] on the device; out (B, H, Sp, Dh) f32.
int int8_prefill_attention(const void* q, const void* kt, const void* v, const void* scales,
                           void* out, int B, int H, int Hkv, int Sp, int Dh, int Smax, int plen,
                           int q_offset, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv || Sp % BQ || Smax % BKV || plen < 1 || plen > Smax ||
      q_offset < 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(Sp / BQ, H, B);
  auto qs = static_cast<const int8_t*>(q);
  auto ks = static_cast<const int8_t*>(kt);
  auto vs = static_cast<const int8_t*>(v);
  auto sc = static_cast<const float*>(scales);
  auto o = static_cast<float*>(out);
  if (Dh == 128)
    prefill_attn_kernel<128><<<grid, WARPS * 32, 0, st>>>(qs, ks, vs, sc, o, H, Hkv, Sp, Smax, plen, q_offset);
  else if (Dh == 64)
    prefill_attn_kernel<64><<<grid, WARPS * 32, 0, st>>>(qs, ks, vs, sc, o, H, Hkv, Sp, Smax, plen, q_offset);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
