// K3's block body, decode attention over the INT8 KV cache, for Hopper
// (sm_90a): int8_decode_attention.cu (K3) and quant_pv_parts_attention.cu
// (P5, the quant_pv parts probe, in six p @ V rules) wrap it in kernels of
// their own.
//
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 128;     // threads a block
constexpr int NWARPS = NT / 32;
constexpr int T = 64;       // positions a tile
constexpr int KS = T + 16;  // bytes a K tile row: the q.k loop's two half-warps read rows
                            // 4 apart, which the 16 spare bytes put on different banks
constexpr int RING = 4;     // tiles in flight
constexpr int SMEM_LIMIT = 232448;
constexpr float NEG = -3.4028234663852886e38f;  // finfo(float32).min

// Byte offsets of a block's dynamic shared memory, on the host (its size) and
// in the kernel.  chmax is the most positions a rank takes (a multiple of T).
struct Layout {
  int slot, scores, codes, part, kpart, total;
  __host__ __device__ Layout(int dh, int rep, int chmax, int cluster) {
    slot = dh * KS;                              // a K tile [dh][KS], or a V tile [T][dh]
    scores = RING * slot;                        // f32 [rep][chmax]: scores, then exp-weights
    codes = scores + 4 * rep * chmax;            // u8 [rep][chmax]: the int8 codes (quant_pv)
    part = codes + rep * chmax;                  // u32 [cluster][rep][dh + 1]: rank 0 gathers
                                                 // every rank's p @ V sums and exp sum
    kpart = part + 4 * cluster * rep * (dh + 1); // int [NWARPS][rep][T]: q.k partial sums
    total = kpart + 4 * NWARPS * rep * T;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t lds32(const uint8_t* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// all but this thread's N most recent groups have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
// every thread of every block of the cluster; orders shared memory writes
// before it against reads after it, across the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
// the address of `local`'s offset in the shared memory of block `rank` of the cluster
__device__ __forceinline__ uint32_t peer_addr(const void* local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(local)), "r"(rank));
  return remote;
}
__device__ __forceinline__ float ld_peer(uint32_t remote) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}
__device__ __forceinline__ void st_peer(uint32_t remote, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(remote), "r"(v) : "memory");
}

// rows r0..r3 of 4 bytes -> c[e] = byte e of each row, in row order
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

template <class A>
__device__ __forceinline__ uint32_t bits(A a) {
  if constexpr (std::is_same<A, float>::value) return __float_as_uint(a);
  else return static_cast<uint32_t>(a);
}
template <class A>
__device__ __forceinline__ A from_bits(uint32_t u) {
  if constexpr (std::is_same<A, float>::value) return __uint_as_float(u);
  else return static_cast<A>(u);
}

// The p @ V rules of the body: K3's two (PV_FP without quant_pv,
// PV_QUANT_FAST with it) and P5's other four, which differ from them only
// in the code rule and the epilogue (quant_pv_parts_attention.cu):
//   PV_FP          out = (sum e (v * v_scale)) / denom                   f32
//   PV_NODEQ       out = ((sum e v) / denom) * v_scale                    f32
//   PV_QUANT       c = rint(127 e), half to even; out = acc * ((v_scale / 127) / denom)
//   PV_QUANT_FAST  c = trunc(127 e + 0.5); out as PV_QUANT (K3's quant_pv)
//   PV_NOROUND     c = trunc(127 e); out as PV_QUANT
//   PV_S32DOT      c = trunc(127 e); out = float(acc), no epilogue
// with acc = sum c v, exact in int32.  The fp32 rules divide by the exp sum
// once, at the end (the TPU probe divides each e first).
enum PvRule { PV_FP = 0, PV_NODEQ = 1, PV_QUANT = 2, PV_QUANT_FAST = 3, PV_NOROUND = 4,
              PV_S32DOT = 5 };

__host__ __device__ constexpr bool int_rule(int rule) { return rule >= PV_QUANT; }

// int8 code of exp-weight e in [0, 1] under an integer rule; the f32 product
// and sum rounded one at a time (an fma would move codes across the .5 boundary)
template <int RULE>
__device__ __forceinline__ int exp_code(float e) {
  if constexpr (RULE == PV_QUANT_FAST) return static_cast<int>(__fadd_rn(__fmul_rn(e, 127.f), 0.5f));
  if constexpr (RULE == PV_QUANT) return __float2int_rn(__fmul_rn(e, 127.f));
  return static_cast<int>(__fmul_rn(e, 127.f));
}

// One block of the grid (C, Hkv, B) in clusters of C along x, under p @ V
// rule RULE; K16: Smax % 16 == 0.  PROBE (P5): a slot's length may be 0,
// and then every position scores finfo.min, so every e is 1 over all Smax
// positions, and no K is read (K3's lengths are at least 1).  Each .cu wraps
// it in a named kernel.
template <int DH, int REP, int RULE, bool K16, bool PROBE>
__device__ __forceinline__ void decode_attn_body(const int8_t* __restrict__ q,
                                                 const int8_t* __restrict__ kt,
                                                 const int8_t* __restrict__ v,
                                                 const int* __restrict__ lengths,
                                                 const float* __restrict__ scales,
                                                 float* __restrict__ out, int Hkv, int Smax,
                                                 int chmax) {
  constexpr bool QPV = int_rule(RULE);
  using acc_t = typename std::conditional<QPV, int, float>::type;
  constexpr int DQ = DH / 4;    // d quads
  constexpr int KDS = NT / 16;  // d slices of the q.k loop (16 position quads of a tile each)
  constexpr int JS = NT / DQ;   // position-quad slices of the p @ V loop
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint32_t sQ[REP][DQ];
  __shared__ float sRed[NWARPS][REP];
  __shared__ float sMax[REP], sM[REP], sDen[REP];

  const uint32_t rank = cluster_rank(), ncl = cluster_size();
  const int g = blockIdx.y, b = blockIdx.z, tid = threadIdx.x, warp = tid >> 5;
  const int H = Hkv * REP;
  const Layout lay(DH, REP, chmax, ncl);
  uint8_t* ring = smem;
  float* sS = reinterpret_cast<float*>(smem + lay.scores);
  uint8_t* sC = smem + lay.codes;
  uint32_t* sPart = reinterpret_cast<uint32_t*>(smem + lay.part);
  int* sKP = reinterpret_cast<int*>(smem + lay.kpart);

  int len = min(lengths[b], Smax);
  bool empty = false;  // PROBE: no valid position
  if constexpr (PROBE) {
    len = min(max(lengths[b], 0), Smax);
    empty = len == 0;
    if (empty) len = Smax;
  }
  const int per = ((len + ncl - 1) / ncl + 15) & ~15;  // positions a rank
  const int p0 = rank * per;
  const int n = max(0, min(per, len - p0));  // this rank's valid positions
  const int ntile = (n + T - 1) / T;
  const size_t bg = (size_t)b * Hkv + g;
  const int8_t* kg = kt + bg * DH * Smax + p0;
  const int8_t* vg = v + (bg * Smax + p0) * DH;
  const float qk_scale = scales[0], v_scale = scales[1], vs127 = scales[2];

  // item u of the rank's stream: K tile u, then V tile u - ntile; one copy
  // group a call (empty past the stream), so the waits count items
  auto issue = [&](int u) {
    if (u < 2 * ntile) {
      uint8_t* dst = ring + (u % RING) * lay.slot;
      const int t0 = (u < ntile ? u : u - ntile) * T, nt = min(T, n - t0);
      if (u < ntile) {  // K^T rows d: nt bytes at d * Smax (rounded up, inside the row)
        if (PROBE && empty) {
        } else if (K16) {
          const int w = (nt + 15) >> 4;
          for (int i = tid; i < DH * w; i += NT)
            cp_async16(dst + (i / w) * KS + 16 * (i % w), kg + (size_t)(i / w) * Smax + t0 + 16 * (i % w));
        } else {
          const int w = (nt + 3) >> 2;
          for (int i = tid; i < DH * w; i += NT)
            cp_async4(dst + (i / w) * KS + 4 * (i % w), kg + (size_t)(i / w) * Smax + t0 + 4 * (i % w));
        }
      } else {  // V rows t0 .. t0 + nt - 1: one contiguous range
        for (int i = tid; i < nt * DH / 16; i += NT) cp_async16(dst + 16 * i, vg + (size_t)t0 * DH + 16 * i);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int u = 0; u < RING; ++u) issue(u);
  const int8_t* qg = q + ((size_t)b * H + g * REP) * DH;  // after the copies are in flight
  for (int i = tid; i < REP * DQ; i += NT) sQ[i / DQ][i % DQ] = *reinterpret_cast<const uint32_t*>(qg + 4 * i);

  // ---- scores of the K tiles ----
  const int pq = tid & 15, ds = tid >> 4;
  for (int u = 0; u < ntile; ++u) {
    cp_async_wait<RING - 1>();
    __syncthreads();  // tile u has landed for every thread; sQ is written
    const uint8_t* ktile = ring + (u % RING) * lay.slot;
    int acc[REP][4];
#pragma unroll
    for (int r = 0; r < REP; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0;
#pragma unroll
    for (int i = 0; i < DQ / KDS; ++i) {
      const int dq = ds + KDS * i;
      const uint8_t* src = ktile + 4 * dq * KS + 4 * pq;
      uint32_t c[4];
      transpose4x4(lds32(src), lds32(src + KS), lds32(src + 2 * KS), lds32(src + 3 * KS), c);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const int qw = static_cast<int>(sQ[r][dq]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][e] = __dp4a(static_cast<int>(c[e]), qw, acc[r][e]);
      }
    }
    // the warp's two d slices, then the four warps' through shared memory
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], 16);
    if ((tid & 16) == 0)
#pragma unroll
      for (int r = 0; r < REP; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) sKP[(warp * REP + r) * T + 4 * pq + e] = acc[r][e];
    __syncthreads();  // also: every thread is done with tile u's slot
    const int t0 = u * T, nt = min(T, n - t0);
    for (int i = tid; i < REP * T; i += NT) {
      const int r = i / T, j = i % T;
      if (j < nt) {
        int s = 0;
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) s += sKP[(w * REP + r) * T + j];
        sS[r * chmax + t0 + j] = PROBE && empty ? NEG : __fmul_rn(static_cast<float>(s), qk_scale);
      }
    }
    issue(u + RING);
  }
  __syncthreads();  // the scores are written

  // ---- the row max over the cluster ----
  float mx[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    mx[r] = NEG;
    for (int j = tid; j < n; j += NT) mx[r] = fmaxf(mx[r], sS[r * chmax + j]);
  }
  block_reduce<REP, true>(mx, sRed, sMax);
  cluster_sync();  // every block's max is written (and every block has started)
  if (tid < REP) {
    float m = NEG;
    for (uint32_t k = 0; k < ncl; ++k) m = fmaxf(m, ld_peer(peer_addr(&sMax[tid], k)));
    sM[tid] = m;
  }
  __syncthreads();

  // ---- exp-weights once per position: codes (quant_pv) or e in place of s ----
  float den[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) den[r] = 0.f;
  for (int j = tid; j < ntile * T; j += NT) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float e = j < n ? expf(__fsub_rn(sS[r * chmax + j], sM[r])) : 0.f;
      den[r] += e;
      if (QPV)
        sC[r * chmax + j] = static_cast<uint8_t>(exp_code<RULE>(e));
      else
        sS[r * chmax + j] = e;
    }
  }
  block_reduce<REP, false>(den, sRed, sDen);  // also publishes the codes

  // ---- p @ V over the V tiles: thread (dq, js) owns d 4 dq .. 4 dq + 3 over
  // every JS-th position quad; codes past the length are 0 ----
  const int dq = tid % DQ, js = tid / DQ;
  acc_t acc[REP][4];
#pragma unroll
  for (int r = 0; r < REP; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0;
  for (int u = ntile; u < 2 * ntile; ++u) {
    cp_async_wait<RING - 1>();
    __syncthreads();
    const uint8_t* vtile = ring + (u % RING) * lay.slot;
    const int t0 = (u - ntile) * T;
    const int nq = (min(T, n - t0) + 3) / 4;
    for (int p = js; p < nq; p += JS) {
      const uint8_t* src = vtile + 4 * p * DH + 4 * dq;
      uint32_t c[4];  // c[e]: the 4 positions' bytes of d = 4 dq + e
      transpose4x4(lds32(src), lds32(src + DH), lds32(src + 2 * DH), lds32(src + 3 * DH), c);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        if constexpr (QPV) {
          const int cw = static_cast<int>(lds32(sC + r * chmax + t0 + 4 * p));
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][e] = __dp4a(static_cast<int>(c[e]), cw, acc[r][e]);
        } else {
          const float4 w = *reinterpret_cast<const float4*>(sS + r * chmax + t0 + 4 * p);
          const float ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float vf = static_cast<float>(static_cast<int8_t>(c[e] >> (8 * k)));
              acc[r][e] = fmaf(ws[k], RULE == PV_NODEQ ? vf : __fmul_rn(vf, v_scale), acc[r][e]);
            }
        }
      }
    }
    __syncthreads();
    issue(u + RING);
  }
  cp_async_wait<0>();  // the stream's last groups are empty
  __syncthreads();

  // ---- this block's sums over its slices (the ring is free), then into rank 0 ----
  acc_t* sAcc = reinterpret_cast<acc_t*>(ring);  // [JS][REP][DH]
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) sAcc[(js * REP + r) * DH + 4 * dq + e] = acc[r][e];
  __syncthreads();
  for (int i = tid; i < REP * DH; i += NT) {
    acc_t a = 0;
#pragma unroll
    for (int s = 0; s < JS; ++s) a += sAcc[s * REP * DH + i];
    const int r = i / DH, d = i % DH;
    st_peer(peer_addr(sPart + (rank * REP + r) * (DH + 1) + d, 0), bits(a));
  }
  if (tid < REP) st_peer(peer_addr(sPart + (rank * REP + tid) * (DH + 1) + DH, 0), __float_as_uint(sDen[tid]));
  cluster_sync();  // rank 0 holds every rank's sums

  if (rank == 0) {
    float* og = out + ((size_t)b * H + g * REP) * DH;
    for (int i = tid; i < REP * DH; i += NT) {
      const int r = i / DH, d = i % DH;
      acc_t a = 0;
      float dn = 0.f;
      for (uint32_t k = 0; k < ncl; ++k) {  // rank order
        const uint32_t* row = sPart + (k * REP + r) * (DH + 1);
        a += from_bits<acc_t>(row[d]);
        dn = __fadd_rn(dn, __uint_as_float(row[DH]));
      }
      if constexpr (RULE == PV_S32DOT)
        og[i] = static_cast<float>(a);
      else if constexpr (RULE == PV_NODEQ)
        og[i] = __fmul_rn(__fdiv_rn(a, dn), v_scale);
      else
        og[i] = QPV ? __fmul_rn(static_cast<float>(a), __fdiv_rn(vs127, dn)) : __fdiv_rn(static_cast<float>(a), dn);
    }
  }
}

struct Call {
  const int8_t *q, *kt, *v;
  const int* lengths;
  const float* scales;
  float* out;
  int B, Hkv, Smax, cluster, chmax;
};

// Launches `kernel`, a wrapper of decode_attn_body<DH, REP, ...>, over the
// grid (C, Hkv, B) in clusters of C; `sized` holds the dynamic shared memory
// limit set so far, per device (one array per kernel).
template <int DH, int REP, class Kernel>
int launch_cluster(Kernel kernel, int (&sized)[64], const Call& c, cudaStream_t st) {
  const Layout lay(DH, REP, c.chmax, c.cluster);
  if (lay.total > SMEM_LIMIT) return cudaErrorInvalidValue;
  int dev = 0;
  cudaGetDevice(&dev);
  if (lay.total > 48 * 1024 && lay.total > sized[dev & 63]) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized[dev & 63] = lay.total;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c.cluster, c.Hkv, c.B);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = lay.total;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, c.q, c.kt, c.v, c.lengths, c.scales, c.out,
                                           c.Hkv, c.Smax, c.chmax);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The call's checks and the most positions a rank takes (a multiple of T);
// false when it rejects them.
inline bool make_call(Call& c, const void* q, const void* kt, const void* v, const void* lengths,
                      const void* scales, void* out, int B, int H, int Hkv, int Smax,
                      int cluster) {
  if (B <= 0 || Hkv <= 0 || H % Hkv || Smax <= 0 || Smax % 4 ||
      (cluster != 2 && cluster != 4 && cluster != 8))
    return false;
  c = Call{static_cast<const int8_t*>(q), static_cast<const int8_t*>(kt),
           static_cast<const int8_t*>(v), static_cast<const int*>(lengths),
           static_cast<const float*>(scales), static_cast<float*>(out), B, Hkv, Smax, cluster,
           ((Smax + cluster - 1) / cluster + T - 1) / T * T};
  return true;
}

}  // namespace
