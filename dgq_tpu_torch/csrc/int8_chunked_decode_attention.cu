// K7: single-token decode attention over chunks of the KV cache, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel dgq_tpu/ops/attention.py::int8_decode_attention_chunked
// (bodies _chunk_max_kernel, _chunk_pv_kernel, _decode_chunk_kernel), over a
// dense (B, Hkv, Dh, Smax) K / (B, Hkv, Smax, Dh) V INT8 cache in chunks.
// The block body is templated on the address (DenseAddr); K8 and K11, which
// ran it over page pools until the page-span body took them
// (paged_decode_attention.cu), computed the same function.
//
// Work: one block per (tile, kv head, slot); a tile is TILE <= 128
// consecutive logical positions (the chunk itself, or 128-position slices of
// a longer one), one thread per position.  A tile that starts at or
// past the slot's valid length exits at once and reads nothing; lengths are
// read on the device, so a call needs no host sync.  A block stages its (Dh,
// TILE) K tile transposed into shared memory (4x4 byte permutes, as K3
// does), scores the rep = H / Hkv query heads of its kv head with dp4a,
// scales by qk_scale and masks positions past the length, then:
//   quant_pv, pass 1 (MAXPASS): the tile's raw row max;
//   quant_pv, pass 2 (QPV): the GLOBAL row max M over all valid tiles of the
//     slot (JAX's gmax), e = exp(s - M), codes trunc(127 e + 0.5) made with
//     __fmul_rn/__fadd_rn (an fma would move codes across .5), the exact
//     int32 codes . V and l = sum e;
//   quant_pv off (FP): flash partials acc = sum e (v * v_scale),
//     m, l with e = exp(s - m) against the tile's own max.
// A third small kernel (COMBINE) merges the tiles per (slot, head): the int32
// partials summed in int32 (equal to the plain version's single int32
// product) then acc * ((v_scale / 127) / sum l) as K3's epilogue; or the
// logsumexp merge.  The P.V codes equal K3's and the plain version's wherever
// the scores do; the exp sum l is taken in another order than K3's, so
// outputs differ from K3's by float rounding (about 1e-6), and a requant code
// downstream may flip.
//
// What bounds it on this card: the valid K and V bytes, 2 * len * Dh per
// (slot, kv head), over the 3.35 TB/s of device memory (quant_pv reads K
// twice, the price of the global max).  Tiles of 128 positions give the card
// many blocks (4 slots x 32 heads x 128 tiles at 7B and a cache of 16384).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 128;  // threads per block, one position of the tile each
constexpr int NWARPS = NT / 32;
constexpr int MAXTILE = NT;
constexpr float NEG = -3.4028234663852886e38f;  // finfo(float32).min

enum Mode { MAXPASS = 0, QPV = 1, FP = 2 };

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

// K7: tile t of slot b at positions [t * tile, (t + 1) * tile) of the dense cache
struct DenseAddr {
  const int8_t* kt;
  const int8_t* v;
  int smax;
  __device__ __forceinline__ void locate(int b, int g, int hkv, int t, int tile, int dh,
                                         const int8_t*& kp, const int8_t*& vp, int& kstride) const {
    const size_t bg = (size_t)b * hkv + g;
    kp = kt + bg * dh * smax + (size_t)t * tile;
    vp = v + (bg * smax + (size_t)t * tile) * dh;
    kstride = smax;
  }
};

struct Args {
  const int8_t* q;       // (B, H, Dh)
  const int* lengths;    // (B,) valid positions, each >= 1
  const float* scales;   // [qk_scale, v_scale, v_scale / 127]
  float* mpart;          // (B, ntiles, H) row max per tile
  float* lpart;          // (B, ntiles, H) exp sum per tile
  void* accpart;         // (B, ntiles, H, Dh) int32 (quant_pv) or f32 numerators
  float* out;            // (B, H, Dh)
  int hkv, tile, ntiles;
};

template <int DH, int REP, int MODE, class Addr>
__global__ void __launch_bounds__(NT) chunk_attn_kernel(Addr addr, Args a) {
  using acc_t = typename std::conditional<MODE == QPV, int, float>::type;
  constexpr int DQ = DH / 4;   // d quads
  constexpr int JS = NT / DQ;  // position slices in p @ V
  __shared__ uint32_t sQ[REP][DQ];
  __shared__ union {
    uint32_t k[MAXTILE][DQ + 1];  // K tile [position][d quad]; +1 word: no bank conflicts
    acc_t acc[JS][REP][DH];       // p @ V partials, once the scores are done
  } sm;
  __shared__ float sW[REP][MAXTILE];  // codes (exact small integers) or exp-weights
  __shared__ float sRed[NWARPS][REP];
  __shared__ float sM[REP], sL[REP];

  const int t = blockIdx.x, g = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int H = a.hkv * REP;
  const int tile = a.tile;
  const int len = min(a.lengths[b], a.ntiles * tile);
  const int t0 = t * tile;
  if (t0 >= len) return;  // past the valid length: nothing to read or write
  const int n = min(tile, len - t0);  // valid positions in this tile
  const float qk_scale = a.scales[0], v_scale = a.scales[1];
  const int8_t *kp, *vp;
  int ks;
  addr.locate(b, g, a.hkv, t, tile, DH, kp, vp, ks);

  const int8_t* qg = a.q + ((size_t)b * H + g * REP) * DH;
  for (int i = tid; i < REP * DQ; i += NT) sQ[i / DQ][i % DQ] = ld32(qg + i * 4);
  // stage the K tile, transposed 4x4 bytes at a time (whole quads: tiles are
  // multiples of 4 positions, so the quad holding position n-1 lies in the tile)
  const int nq = (n + 3) / 4;
  for (int i = tid; i < DQ * nq; i += NT) {
    const int dq = i / nq, j0 = (i % nq) * 4;
    const int8_t* src = kp + (size_t)(dq * 4) * ks + j0;
    uint32_t c[4];
    transpose4x4(ld32(src), ld32(src + ks), ld32(src + 2 * ks), ld32(src + 3 * ks), c);
#pragma unroll
    for (int e = 0; e < 4; ++e) sm.k[j0 + e][dq] = c[e];
  }
  __syncthreads();

  // scores of position tid for the REP heads
  float s[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) s[r] = NEG;
  if (tid < n) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      int acc = 0;
#pragma unroll 8
      for (int dq = 0; dq < DQ; ++dq)
        acc = __dp4a(static_cast<int>(sm.k[tid][dq]), static_cast<int>(sQ[r][dq]), acc);
      s[r] = __fmul_rn(static_cast<float>(acc), qk_scale);
    }
  }
  const size_t prow = ((size_t)b * a.ntiles + t) * H + g * REP;  // partial row (b, t, head)

  if (MODE == MAXPASS) {
    block_reduce<REP, true>(s, sRed, sM);
    if (tid < REP) a.mpart[prow + tid] = sM[tid];
    return;
  }
  if (MODE == QPV) {
    // the global row max over every valid tile of the slot (pass 1's output)
    if (tid < REP) {
      const int nt = (len + tile - 1) / tile;
      float m = NEG;
      for (int u = 0; u < nt; ++u) m = fmaxf(m, a.mpart[((size_t)b * a.ntiles + u) * H + g * REP + tid]);
      sM[tid] = m;
    }
    __syncthreads();
  } else {
    float mx[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) mx[r] = s[r];
    block_reduce<REP, true>(mx, sRed, sM);
  }
  float e[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    e[r] = tid < n ? expf(__fsub_rn(s[r], sM[r])) : 0.f;
    sW[r][tid] = MODE == QPV ? static_cast<float>(static_cast<int>(__fadd_rn(__fmul_rn(e[r], 127.f), 0.5f)))
                             : e[r];
  }
  block_reduce<REP, false>(e, sRed, sL);  // also publishes sW, and ends the reads of sm.k

  // p @ V: thread (dcol, js) owns 4 d columns over every JS-th position
  const int dcol = tid % DQ, js = tid / DQ;
  acc_t acc[REP][4];
#pragma unroll
  for (int r = 0; r < REP; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0;
  for (int jj = js; jj < n; jj += JS) {
    int vb[4];
    const uint32_t vw = ld32(vp + (size_t)jj * DH + dcol * 4);
#pragma unroll
    for (int q = 0; q < 4; ++q) vb[q] = static_cast<int8_t>((vw >> (8 * q)) & 0xFF);
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float w = sW[r][jj];
      if (MODE == QPV) {
        const int c = static_cast<int>(w);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] += c * vb[q];
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[r][q] = fmaf(w, __fmul_rn(static_cast<float>(vb[q]), v_scale), acc[r][q]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) sm.acc[js][r][dcol * 4 + q] = acc[r][q];
  __syncthreads();
  acc_t* ap = static_cast<acc_t*>(a.accpart) + prow * DH;
  for (int i = tid; i < REP * DH; i += NT) {
    const int r = i / DH, d = i % DH;
    acc_t sum = 0;
    for (int u = 0; u < JS; ++u) sum += sm.acc[u][r][d];
    ap[i] = sum;
  }
  if (tid < REP) {
    a.lpart[prow + tid] = sL[tid];
    if (MODE == FP) a.mpart[prow + tid] = sM[tid];
  }
}

// merge the tiles of one (head, slot); one thread per d
template <bool QPV_>
__global__ void combine_kernel(Args a, int H, int DH) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int len = min(a.lengths[b], a.ntiles * a.tile);
  const int nt = (len + a.tile - 1) / a.tile;
  float* o = a.out + ((size_t)b * H + h) * DH + d;
  if (QPV_) {
    const int* ap = static_cast<const int*>(a.accpart);
    int acc = 0;
    float l = 0.f;
    for (int u = 0; u < nt; ++u) {
      const size_t row = ((size_t)b * a.ntiles + u) * H + h;
      acc += ap[row * DH + d];
      l += a.lpart[row];
    }
    *o = __fmul_rn(static_cast<float>(acc), __fdiv_rn(a.scales[2], l));
  } else {
    const float* ap = static_cast<const float*>(a.accpart);
    float mg = NEG;
    for (int u = 0; u < nt; ++u) mg = fmaxf(mg, a.mpart[((size_t)b * a.ntiles + u) * H + h]);
    float num = 0.f, den = 0.f;
    for (int u = 0; u < nt; ++u) {
      const size_t row = ((size_t)b * a.ntiles + u) * H + h;
      const float w = expf(__fsub_rn(a.mpart[row], mg));
      num = fmaf(ap[row * DH + d], w, num);
      den = fmaf(a.lpart[row], w, den);
    }
    *o = __fdiv_rn(num, fmaxf(den, 1e-20f));
  }
}

template <int DH, int REP, class Addr>
int run(const Addr& addr, const Args& a, int B, bool qpv, cudaStream_t st) {
  const dim3 grid(a.ntiles, a.hkv, B), cgrid(a.hkv * REP, B);
  cudaError_t err;
  if (qpv) {
    chunk_attn_kernel<DH, REP, MAXPASS, Addr><<<grid, NT, 0, st>>>(addr, a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    chunk_attn_kernel<DH, REP, QPV, Addr><<<grid, NT, 0, st>>>(addr, a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    combine_kernel<true><<<cgrid, DH, 0, st>>>(a, a.hkv * REP, DH);
  } else {
    chunk_attn_kernel<DH, REP, FP, Addr><<<grid, NT, 0, st>>>(addr, a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    combine_kernel<false><<<cgrid, DH, 0, st>>>(a, a.hkv * REP, DH);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class Addr>
int dispatch(const Addr& addr, const Args& a, int B, int H, int Dh, bool qpv, cudaStream_t st) {
  const int rep = H / a.hkv;
#define DGQ_REP(D, R) \
  if (Dh == D && rep == R) return run<D, R>(addr, a, B, qpv, st);
  DGQ_REP(128, 1) DGQ_REP(128, 2) DGQ_REP(128, 4) DGQ_REP(128, 8)
  DGQ_REP(64, 1) DGQ_REP(64, 2) DGQ_REP(64, 4) DGQ_REP(64, 8)
#undef DGQ_REP
  return cudaErrorInvalidValue;
}

bool bad_shape(int B, int H, int Hkv, int tile, int ntiles) {
  return B <= 0 || Hkv <= 0 || H % Hkv || tile <= 0 || tile > MAXTILE || tile % 4 || ntiles <= 0;
}

}  // namespace

extern "C" {

// K7.  q (B, H, Dh) int8; kt (B, Hkv, Dh, Smax) and v (B, Hkv, Smax, Dh)
// int8; lengths (B,) int32 valid positions, each in [1, Smax]; scales f32
// [qk_scale, v_scale, v_scale / 127]; mpart, lpart (B, Smax / tile, H) f32,
// accpart (B, Smax / tile, H, Dh) int32 scratch; out (B, H, Dh) f32.  tile
// (positions per block) divides Smax: the chunk up to 128, else 128.
int int8_decode_attention_chunked(const void* q, const void* kt, const void* v,
                                  const void* lengths, const void* scales, void* mpart,
                                  void* lpart, void* accpart, void* out, int B, int H, int Hkv,
                                  int Dh, int Smax, int tile, int quant_pv, void* stream) {
  if (tile <= 0 || Smax % tile || bad_shape(B, H, Hkv, tile, Smax / tile)) return cudaErrorInvalidValue;
  const DenseAddr addr{static_cast<const int8_t*>(kt), static_cast<const int8_t*>(v), Smax};
  const Args a{static_cast<const int8_t*>(q), static_cast<const int*>(lengths),
               static_cast<const float*>(scales), static_cast<float*>(mpart),
               static_cast<float*>(lpart), accpart, static_cast<float*>(out), Hkv, tile,
               Smax / tile};
  return dispatch(addr, a, B, H, Dh, quant_pv != 0, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
