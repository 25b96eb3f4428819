// K3: single-token decode attention over the INT8 KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel dgq_tpu/ops/attention.py::int8_decode_attention
// (body _decode_kernel).  For slot b and kv head g it serves the rep = H / Hkv
// query heads of g: scores s8 q.k^T -> s32 times scales[0] = (q_scale *
// k_scale) / sqrt(Dh) over the valid length lengths[b]; m is the GLOBAL row
// max and e = exp(s - m).  With quant_pv the exp-weights become int8 codes
// trunc(127 e + 0.5) (__fmul_rn/__fadd_rn: an fma would move codes across
// the .5 boundary), p @ V is an exact integer sum and out = acc * ((v_scale
// / 127) / denom); without it, out = sum e (v * v_scale) / denom in fp32.
//
// What bounds it on this card: the valid K and V bytes, 2 * len * Dh per
// (slot, kv head), over the 3.35 TB/s of device memory: 9.4 MB, 2.8 us, at
// 7B batch 4 and ~285 positions.  So what counts is the bytes in flight and
// the serial steps, not the arithmetic.  The design:
//   * a cluster of C blocks (C = 2, 4 or 8, the caller's plan from Smax,
//     the slots and the heads) per (slot, kv head): rank r takes the
//     positions [r per, (r + 1) per) of the slot's valid length, per =
//     ceil(len / C) rounded up to 16, read on the device (no host sync, so a
//     CUDA graph can capture a call); a rank past the length has no work
//     but joins both cluster barriers;
//   * the rank's K and V stream into shared memory through a ring of RING
//     tiles of T positions with cp.async (16-byte copies; 4-byte ones for
//     K when Smax % 16 != 0), issued by all threads at entry: the K tiles
//     first, then the V tiles, so V arrives while the scores are computed;
//     a rank of up to 2 tiles has all its bytes in flight at once.  Not
//     cp.async.bulk from one thread or warp: a tile's V is one range, but
//     its K is Dh rows of at most T bytes, Smax apart in the d-major cache,
//     so a 1-D bulk copy moves one row; with a warp issuing those row copies
//     on an mbarrier a slot, K3 took 1.67x this design's time on an H100
//     (PERF.md).  A 2-D TMA box would write the rows unpadded, and
//     the KS pad below is what keeps the q.k loop's half-warps, 4 rows
//     apart, on different banks; bulk copies also need 16-byte aligned
//     rows, which Smax % 16 != 0 does not give;
//   * scores stay in shared memory (no scratch in device memory) and exp
//     runs once per position.  q.k: each thread scores 4 positions over a
//     slice of Dh with dp4a on a 4x4 byte transpose of the d-major K tile,
//     the slices summed through shared memory;
//   * the row max over the cluster: each block's max, a cluster barrier,
//     every block reads the others' maxima from distributed shared memory;
//   * p @ V with dp4a on packed int8 codes, four positions a word, V turned
//     position-major by the same 4x4 transpose (dp4a rather than mma.sync:
//     rep is 1 at MHA, where an m16 tile would be 15/16 padding, and the
//     bytes, not the multiply-adds, bound the kernel); fp32 fma without
//     quant_pv;
//   * every rank stores its int32 p @ V sums (exact, so order-free) and its
//     fp32 exp sum into rank 0's shared memory, a second cluster barrier,
//     and rank 0 adds them in rank order (deterministic) and writes out.
// One launch, no scratch in device memory.

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

// grid (C, Hkv, B) in clusters of C along x; K16: Smax % 16 == 0
template <int DH, int REP, bool QPV, bool K16>
__global__ void __launch_bounds__(NT)
decode_attn_cluster(const int8_t* __restrict__ q, const int8_t* __restrict__ kt,
                    const int8_t* __restrict__ v, const int* __restrict__ lengths,
                    const float* __restrict__ scales, float* __restrict__ out, int Hkv, int Smax,
                    int chmax) {
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

  const int len = min(lengths[b], Smax);
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
        if (K16) {
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
        sS[r * chmax + t0 + j] = __fmul_rn(static_cast<float>(s), qk_scale);
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
        sC[r * chmax + j] = static_cast<uint8_t>(static_cast<int>(__fadd_rn(__fmul_rn(e, 127.f), 0.5f)));
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
            for (int k = 0; k < 4; ++k)
              acc[r][e] = fmaf(ws[k], __fmul_rn(static_cast<float>(static_cast<int8_t>(c[e] >> (8 * k))), v_scale),
                               acc[r][e]);
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

template <int DH, int REP, bool QPV, bool K16>
int launch(const Call& c, cudaStream_t st) {
  auto kernel = decode_attn_cluster<DH, REP, QPV, K16>;
  const Layout lay(DH, REP, c.chmax, c.cluster);
  if (lay.total > SMEM_LIMIT) return cudaErrorInvalidValue;
  static int sized[64] = {};  // the dynamic shared memory limit set, per device
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

template <int DH, int REP>
int launch_mode(const Call& c, bool qpv, cudaStream_t st) {
  const bool k16 = c.Smax % 16 == 0;
  if (qpv) return k16 ? launch<DH, REP, true, true>(c, st) : launch<DH, REP, true, false>(c, st);
  return k16 ? launch<DH, REP, false, true>(c, st) : launch<DH, REP, false, false>(c, st);
}

template <int DH>
int launch_rep(int rep, const Call& c, bool qpv, cudaStream_t st) {
  switch (rep) {
    case 1: return launch_mode<DH, 1>(c, qpv, st);
    case 2: return launch_mode<DH, 2>(c, qpv, st);
    case 4: return launch_mode<DH, 4>(c, qpv, st);
    case 8: return launch_mode<DH, 8>(c, qpv, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, H, Dh) int8; kt (B, Hkv, Dh, Smax) int8; v (B, Hkv, Smax, Dh) int8;
// lengths (B,) int32 valid positions per slot, each in [1, Smax]; scales f32
// [qk_scale, v_scale, v_scale / 127] on the device; out (B, H, Dh) f32;
// cluster (2, 4 or 8) blocks per (slot, kv head), the caller's plan.
int int8_decode_attention(const void* q, const void* kt, const void* v, const void* lengths,
                          const void* scales, void* out, int B, int H, int Hkv, int Dh, int Smax,
                          int quant_pv, int cluster, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv || Smax <= 0 || Smax % 4 ||
      (cluster != 2 && cluster != 4 && cluster != 8))
    return cudaErrorInvalidValue;
  const int chmax = ((Smax + cluster - 1) / cluster + T - 1) / T * T;
  const Call c{static_cast<const int8_t*>(q), static_cast<const int8_t*>(kt),
               static_cast<const int8_t*>(v), static_cast<const int*>(lengths),
               static_cast<const float*>(scales), static_cast<float*>(out), B, Hkv, Smax, cluster,
               chmax};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 128) return launch_rep<128>(H / Hkv, c, quant_pv != 0, st);
  if (Dh == 64) return launch_rep<64>(H / Hkv, c, quant_pv != 0, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
