// K3's block body, decode attention over the INT8 KV cache, for Hopper
// (sm_90a): int8_decode_attention.cu (K3), long_decode_attention.cu (K7)
// and quant_pv_parts_attention.cu (P5, the quant_pv parts probe, in six
// p @ V rules) wrap it in kernels of their own over the dense cache
// (DenseKV), and paged_decode_attention.cu (K8, K11) over a page pool
// (PagedKV), INT8 or INT4 nibble pages.  A rank keeps its scores and codes
// in its block's shared memory, or (K7, where its plan says so) in a
// device-memory scratch: the scores policy.  K3's and K7's ALiBi kernels
// add slope x position to the scaled scores: the bias policy.
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
constexpr int KS4 = 2 * T + 32;  // bytes a nibble K tile row (2 T positions; dh / 2 rows of
                                 // them fill a slot): rows 2 apart land 16 banks apart
constexpr int SMEM_LIMIT = 232448;
constexpr float NEG = -3.4028234663852886e38f;  // finfo(float32).min

// Byte offsets of a block's dynamic shared memory, on the host (its size) and
// in the kernel.  chmax is the most positions a rank takes (a multiple of the
// tile); npages the entries of a rank's page cache and tile the positions of
// a tile (paged pools only: 2 T for nibble pages).
struct Layout {
  int slot, scores, codes, part, kpart, pages, total;
  __host__ __device__ Layout(int dh, int rep, int chmax, int cluster, int npages = 0,
                             int tile = T) {
    // a K tile [dh][KS], or a V tile [T][dh]; nibble tiles [dh / 2][KS4], [2 T][dh / 2]
    slot = dh * KS;
    scores = RING * slot;                        // f32 [rep][chmax]: scores, then exp-weights
    codes = scores + 4 * rep * chmax;            // u8 [rep][chmax]: the int8 codes (quant_pv)
    part = codes + rep * chmax;                  // u32 [cluster][rep][dh + 1]: rank 0 gathers
                                                 // every rank's p @ V sums and exp sum
    kpart = part + 4 * cluster * rep * (dh + 1); // int [NWARPS][rep][tile]: q.k partial sums
    pages = kpart + 4 * NWARPS * rep * tile;     // int [npages]: the rank's pages
    total = pages + 4 * npages;
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

// sign-extend the 4-bit code in the low nibble of each byte (0..15) to int8,
// four at once without a carry between the bytes
__device__ __forceinline__ uint32_t sext_nibbles(uint32_t x) {
  return ((x ^ 0x08080808u) + 0x78787878u) ^ 0x80808080u;
}

// nibble rows r0 (dims 4 dq, 4 dq + 1 a byte, low nibble first) and r1 (dims
// 4 dq + 2, 4 dq + 3) of 4 positions -> c[e] = position e's four int8 codes
// in dim order
__device__ __forceinline__ void unpack_nibble_rows(uint32_t r0, uint32_t r1, uint32_t (&c)[4]) {
  transpose4x4(sext_nibbles(r0 & 0x0F0F0F0Fu), sext_nibbles((r0 >> 4) & 0x0F0F0F0Fu),
               sext_nibbles(r1 & 0x0F0F0F0Fu), sext_nibbles((r1 >> 4) & 0x0F0F0F0Fu), c);
}

// Where a rank's tiles live.  start() takes the rank's (slot, kv head) and
// first position p0; k(row, t0, off) is the address of K row `row` (a dim,
// or a pair of dims in nibble pages) at the rank's position t0 + off (a
// copy of 16 or 4 bytes never leaves the row's page); v(t0, off) that of
// byte `off` of the rank's V from position t0 on (a 16-byte copy never
// leaves one position's row).
// K3's dense cache: (B, Hkv, Dh, Smax) K rows Smax apart, (B, Hkv, Smax, Dh) V;
// FAST: PagedKV's fp p @ V conversion (K7).
template <int DH, bool FAST = false>
struct DenseKV {
  static constexpr bool PAGED = false;
  static constexpr bool NIBBLES = false;
  static constexpr bool FAST_FP = FAST;
  const int8_t* kt;
  const int8_t* vc;
  int smax;
  const int8_t* kg;
  const int8_t* vg;
  __device__ __forceinline__ void start(int b, int g, int Hkv, int p0, int, uint8_t*) {
    const size_t bg = (size_t)b * Hkv + g;
    kg = kt + bg * DH * smax + p0;
    vg = vc + (bg * smax + p0) * DH;
  }
  __device__ __forceinline__ const int8_t* k(int row, int t0, int off) const {
    return kg + (size_t)row * smax + t0 + off;
  }
  __device__ __forceinline__ const int8_t* v(int t0, int off) const {
    return vg + (size_t)t0 * DH + off;
  }
};

// K8's and K11's page pool: logical position p of slot b at pool page
// table[b, p / ps], offset p % ps; (P, Hkv, ROWB, ps) K pages and (P, Hkv,
// ps, ROWB) V pages, ROWB = Dh, or Dh / 2 nibble bytes (KV4).  start() puts
// the rank's pages (pool page x Hkv + kv head) in shared memory at `spare`
// once, so a copy's address takes a shared load; p / ps is a multiply-high
// by ceil(2^32 / ps), exact while p ps < 2^32.  A thread's K copies of a
// tile share one column, so it looks its page up once a tile.  Its fp p @ V
// turns codes into floats through the exponent bits (FAST_FP: a byte
// permute and an add; the int-to-float unit runs at a sixteenth of the fma
// rate), the same values.
template <int DH, bool KV4>
struct PagedKV {
  static constexpr bool PAGED = true;
  static constexpr bool NIBBLES = KV4;
  static constexpr bool FAST_FP = true;
  static constexpr int ROWB = KV4 ? DH / 2 : DH;
  const int8_t* kt;
  const int8_t* vc;
  const int* table;
  int ps, np;
  const int* pg;  // the rank's pages, from logical page lo on
  int p0, lo;     // the rank's first position and page
  uint32_t mg;    // ceil(2^32 / ps)
  __device__ __forceinline__ int page_of(int p) const { return static_cast<int>(__umulhi(p, mg)); }
  __device__ __forceinline__ int in_page(int p) const { return p - page_of(p) * ps; }
  __device__ __forceinline__ void start(int b, int g, int Hkv, int p0_, int n, uint8_t* spare) {
    p0 = p0_;
    mg = 0xFFFFFFFFu / static_cast<uint32_t>(ps) + 1u;
    lo = page_of(p0);
    const int cnt = n > 0 ? page_of(p0 + n - 1) - lo + 1 : 0;
    int* s = reinterpret_cast<int*>(spare);
    const int* trow = table + (size_t)b * np + lo;
    for (int i = threadIdx.x; i < cnt; i += NT) s[i] = __ldg(trow + i) * Hkv + g;
    pg = s;
    __syncthreads();
  }
  __device__ __forceinline__ const int8_t* k(int row, int t0, int off) const {
    const int p = p0 + t0 + off;
    return kt + ((size_t)pg[page_of(p) - lo] * ROWB + row) * ps + in_page(p);
  }
  __device__ __forceinline__ const int8_t* v(int t0, int off) const {
    const int p = p0 + t0 + off / ROWB;
    return vc + ((size_t)pg[page_of(p) - lo] * ps + in_page(p)) * ROWB + off % ROWB;
  }
};

// Where a rank keeps its scores (f32 [rep][chmax], then its exp-weights) and
// codes (u8 [rep][chmax], quant_pv), and which slot a block serves.
// SmemScores (K3, P5, K8, K11): in its block's shared memory at the Layout's
// `scores` and `codes`; slot blockIdx.z.  LongScores<SMEM> (K7): in shared
// memory too, or (SMEM false: where even a cluster of 16 blocks cannot hold
// a rank's positions, or where a smaller block lets more blocks share an
// SM) at the rank's own 5 rep chmax bytes of a device-memory scratch of
// (B, Hkv, cluster) such runs, which the block's Layout then leaves out;
// the scratch is written and read by the rank's block alone, between its
// barriers, so it stays in L1 and L2.  And the
// slots longest first: blockIdx.z is the rank of a slot in the order of
// its length (descending, ties by index), so that the blocks of the
// longest slot, which set the call's time, are scheduled first.
struct SmemScores {
  static constexpr bool SMEM = true, LONGEST_FIRST = false;
};
template <bool SMEM_>
struct LongScores {
  static constexpr bool SMEM = SMEM_, LONGEST_FIRST = true;
  uint8_t* scratch;
  __device__ __forceinline__ uint8_t* rank_scores(int b, int g, int Hkv, uint32_t rank,
                                                  uint32_t ncl, int bytes) const {
    return scratch + (((size_t)b * Hkv + g) * ncl + rank) * bytes;
  }
};

// K7's address (long_decode_attention.cu and its ALiBi kernels): the dense cache, with the grid's Hkv * split virtual kv
// heads, virtual head g serving query heads g (rep / split) .. of kv head
// g / split
template <int DH>
struct SplitKV : DenseKV<DH, true> {
  int split;
  __device__ __forceinline__ void start(int b, int g, int Hkv, int p0, int n, uint8_t* spare) {
    DenseKV<DH, true>::start(b, g / split, Hkv / split, p0, n, spare);
  }
};

// What a rank adds to its scaled scores: nothing (NoBias: K3, K7, K8, K11,
// P5), or ALiBi (Alibi: K3's and K7's ALiBi kernels, BLOOM and MPT), the
// slope of query head h times the absolute position, h = g REP + r for row
// r of (virtual) kv head g: a virtual head of K7's split serves the query
// heads g REP .. g REP + REP - 1, as the q and out rows it reads and writes.
// The product and the sum are rounded one at a time, as the plain version
// computes them (an fma would round once), so the scores are the plain
// version's bit for bit.
struct NoBias {
  static constexpr bool ON = false;
};
struct Alibi {
  static constexpr bool ON = true;
  const float* slopes;  // (H,) f32, a slope a query head
};

// The slot of rank z in the order of the B slots' lengths, longest first
// (ties: the lower index first), found by every block for itself.
__device__ __forceinline__ int longest_first(const int* __restrict__ lengths, int z, int B) {
  __shared__ int slot;
  for (int s = threadIdx.x; s < B; s += NT) {
    const int ls = lengths[s];
    int r = 0;
    for (int j = 0; j < B; ++j) {
      const int lj = lengths[j];
      r += lj > ls || (lj == ls && j < s);
    }
    if (r == z) slot = s;
  }
  __syncthreads();
  return slot;
}

// the slot this block serves under the scores policy Sc
template <class Sc>
__device__ __forceinline__ int slot_of(const int* __restrict__ lengths) {
  if constexpr (Sc::LONGEST_FIRST)
    return longest_first(lengths, blockIdx.z, gridDim.z);
  else
    return blockIdx.z;
}

// the most entries of a rank's page cache: its positions (at most chmax) over
// pages of ps, and one more where they start inside a page
__host__ __device__ inline int rank_pages(int chmax, int ps) { return (chmax + ps - 1) / ps + 1; }

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
// rule RULE, its tiles found through `addr` (a DenseKV or a PagedKV; Smax is
// the slot's positions, NP * ps for pages), its scores kept and its slot
// chosen by `sc` (a SmemScores or a LongScores), its scores' bias by `bias` (a
// NoBias or an Alibi); K16: K copies of 16 bytes
// (Smax % 16 == 0 dense, ps % 16 == 0 paged), else of 4.  PROBE (P5): a
// slot's length may be 0, and then every position scores finfo.min, so
// every e is 1 over all Smax positions, and no K is read (K3's lengths are
// at least 1).  Nibble pages (K11): K rows 2 dq and 2 dq + 1 sign-extended
// into dims 4 dq .. 4 dq + 3, so q needs no permutation and the int32
// scores equal the plain version's; fp p @ V only.  Each .cu wraps it in a
// named kernel.
template <int DH, int REP, int RULE, bool K16, bool PROBE, class Addr, class Sc = SmemScores,
          class Bias = NoBias>
__device__ __forceinline__ void decode_attn_core(Addr addr, const int8_t* __restrict__ q,
                                                 const int* __restrict__ lengths,
                                                 const float* __restrict__ scales,
                                                 float* __restrict__ out, int Hkv, int Smax,
                                                 int chmax, Sc sc = Sc{}, Bias bias = Bias{}) {
  static_assert(!(PROBE && Bias::ON), "the probe takes no bias");
  constexpr bool QPV = int_rule(RULE);
  constexpr bool NIB = Addr::NIBBLES;
  static_assert(!NIB || RULE == PV_FP, "nibble pages take fp p @ V only");
  constexpr int KROWS = NIB ? DH / 2 : DH;  // rows of a K tile
  constexpr int KROW = NIB ? KS4 : KS;      // their stride in the ring
  constexpr int VROWB = NIB ? DH / 2 : DH;  // bytes of a V row
  constexpr int TT = NIB ? 2 * T : T;       // positions a tile: a slot's bytes either way
  using acc_t = typename std::conditional<QPV, int, float>::type;
  constexpr int DQ = DH / 4;    // d quads
  constexpr int KDS = NT / 16;  // d slices of the q.k loop (16 position quads of a tile each)
  constexpr int JS = NT / DQ;   // position-quad slices of the p @ V loop
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint32_t sQ[REP][DQ];
  __shared__ float sRed[NWARPS][REP];
  __shared__ float sMax[REP], sM[REP], sDen[REP];

  const uint32_t rank = cluster_rank(), ncl = cluster_size();
  const int g = blockIdx.y, tid = threadIdx.x, warp = tid >> 5;
  const int b = slot_of<Sc>(lengths);
  const int H = Hkv * REP;
  const Layout lay(DH, REP, Sc::SMEM ? chmax : 0, ncl, 0, TT);
  uint8_t* ring = smem;
  float* sS;
  uint8_t* sC;
  if constexpr (Sc::SMEM) {
    sS = reinterpret_cast<float*>(smem + lay.scores);
    sC = smem + lay.codes;
  } else {
    uint8_t* mine = sc.rank_scores(b, g, Hkv, rank, ncl, 5 * REP * chmax);
    sS = reinterpret_cast<float*>(mine);
    sC = mine + 4 * REP * chmax;
  }
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
  const int ntile = (n + TT - 1) / TT;
  addr.start(b, g, Hkv, p0, n, smem + lay.pages);
  const float qk_scale = scales[0], v_scale = scales[1], vs127 = scales[2];

  // item u of the rank's stream: K tile u, then V tile u - ntile; one copy
  // group a call (empty past the stream), so the waits count items
  auto issue = [&](int u) {
    if (u < 2 * ntile) {
      uint8_t* dst = ring + (u % RING) * lay.slot;
      const int t0 = (u < ntile ? u : u - ntile) * TT, nt = min(TT, n - t0);
      if (u < ntile) {  // K^T rows d: nt bytes at d * Smax (rounded up, inside the row)
        if (PROBE && empty) {
        } else if constexpr (Addr::PAGED) {  // column c of W >= w: one page lookup a tile
          constexpr int CW = K16 ? 16 : 4;
          const int w = (nt + CW - 1) / CW;
          const int W = w <= 1 ? 1 : w <= 2 ? 2 : w <= 4 ? 4 : w <= 8 ? 8 : w <= 16 ? 16 : 32;
          const int c = tid & (W - 1);
          if (c < w) {
            const int8_t* src = addr.k(0, t0, CW * c);
            for (int row = tid / W; row < KROWS; row += NT / W) {
              if (K16)
                cp_async16(dst + row * KROW + CW * c, src + (size_t)row * addr.ps);
              else
                cp_async4(dst + row * KROW + CW * c, src + (size_t)row * addr.ps);
            }
          }
        } else if (K16) {
          const int w = (nt + 15) >> 4;
          for (int i = tid; i < KROWS * w; i += NT)
            cp_async16(dst + (i / w) * KROW + 16 * (i % w), addr.k(i / w, t0, 16 * (i % w)));
        } else {
          const int w = (nt + 3) >> 2;
          for (int i = tid; i < KROWS * w; i += NT)
            cp_async4(dst + (i / w) * KROW + 4 * (i % w), addr.k(i / w, t0, 4 * (i % w)));
        }
      } else {  // V rows t0 .. t0 + nt - 1: one contiguous range (dense), a row a page
        for (int i = tid; i < nt * VROWB / 16; i += NT) cp_async16(dst + 16 * i, addr.v(t0, 16 * i));
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
#pragma unroll
    for (int hf = 0; hf < TT / T; ++hf) {  // the tile's T-position halves (nibble tiles: two)
      int acc[REP][4];
#pragma unroll
      for (int r = 0; r < REP; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0;
#pragma unroll
      for (int i = 0; i < DQ / KDS; ++i) {
        const int dq = ds + KDS * i;
        uint32_t c[4];
        if constexpr (NIB) {
          const uint8_t* src = ktile + 2 * dq * KROW + T * hf + 4 * pq;
          unpack_nibble_rows(lds32(src), lds32(src + KROW), c);
        } else {
          const uint8_t* src = ktile + 4 * dq * KS + 4 * pq;
          transpose4x4(lds32(src), lds32(src + KS), lds32(src + 2 * KS), lds32(src + 3 * KS), c);
        }
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
          for (int e = 0; e < 4; ++e)
            sKP[(warp * REP + r) * TT + T * hf + 4 * pq + e] = acc[r][e];
    }
    __syncthreads();  // also: every thread is done with tile u's slot
    const int t0 = u * TT, nt = min(TT, n - t0);
    for (int i = tid; i < REP * TT; i += NT) {
      const int r = i / TT, j = i % TT;
      if (j < nt) {
        int s = 0;
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) s += sKP[(w * REP + r) * TT + j];
        if constexpr (Bias::ON)
          sS[r * chmax + t0 + j] =
              __fadd_rn(__fmul_rn(static_cast<float>(s), qk_scale),
                        __fmul_rn(__ldg(bias.slopes + g * REP + r), static_cast<float>(p0 + t0 + j)));
        else
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
  for (int j = tid; j < ntile * TT; j += NT) {
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
    const int t0 = (u - ntile) * TT;
    const int nq = (min(TT, n - t0) + 3) / 4;
    for (int p = js; p < nq; p += JS) {
      if constexpr (NIB) {  // d 4 dq .. 4 dq + 3: two bytes of each position's row
        uint32_t h[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          h[k] = *reinterpret_cast<const uint16_t*>(vtile + (4 * p + k) * VROWB + 2 * dq);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          const float4 w = *reinterpret_cast<const float4*>(sS + r * chmax + t0 + 4 * p);
          const float ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int k = 0; k < 4; ++k) {  // 2^23 + (nibble ^ 8) - (2^23 + 8): the signed code
              const float vf =
                  __int_as_float(0x4B000000u | (((h[k] >> (4 * e)) & 0xFu) ^ 8u)) - 8388616.0f;
              acc[r][e] = fmaf(ws[k], __fmul_rn(vf, v_scale), acc[r][e]);
            }
        }
        continue;
      }
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
              float vf;
              if constexpr (Addr::FAST_FP)  // 2^23 + (byte ^ 0x80) - (2^23 + 128): the code
                vf = __int_as_float(__byte_perm(c[e] ^ 0x80808080u, 0x4B000000u, 0x7540 + k)) -
                     8388736.0f;
              else
                vf = static_cast<float>(static_cast<int8_t>(c[e] >> (8 * k)));
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

// K3's and P5's body over the dense cache
template <int DH, int REP, int RULE, bool K16, bool PROBE>
__device__ __forceinline__ void decode_attn_body(const int8_t* __restrict__ q,
                                                 const int8_t* __restrict__ kt,
                                                 const int8_t* __restrict__ v,
                                                 const int* __restrict__ lengths,
                                                 const float* __restrict__ scales,
                                                 float* __restrict__ out, int Hkv, int Smax,
                                                 int chmax) {
  decode_attn_core<DH, REP, RULE, K16, PROBE>(DenseKV<DH>{kt, v, Smax, nullptr, nullptr}, q,
                                              lengths, scales, out, Hkv, Smax, chmax);
}

struct Call {
  const int8_t *q, *kt, *v;
  const int* lengths;
  const float* scales;
  float* out;
  int B, Hkv, Smax, cluster, chmax;
  int pages = 0;         // a rank's page cache (paged pools)
  int tile = T;          // positions a tile (2 T for nibble pages)
  bool scratch = false;  // the scores in a device-memory scratch (LongScores<false>)
};

// What a kernel's launches have set so far, per device: the dynamic shared
// memory limit, and whether it may run in clusters of 16 (Hopper's
// non-portable cluster size).  One per kernel.
struct Sized {
  int smem[64];
  bool wide[64];
};

// Launches `kernel`, a wrapper of decode_attn_core<DH, REP, ...>, over the
// grid (C, Hkv, B) in clusters of C, with the arguments of Call and then
// `extra`.
template <int DH, int REP, class Kernel, class... Extra>
int launch_cluster(Kernel kernel, Sized& sized, const Call& c, cudaStream_t st,
                   Extra... extra) {
  const Layout lay(DH, REP, c.scratch ? 0 : c.chmax, c.cluster, c.pages, c.tile);
  if (lay.total > SMEM_LIMIT) return cudaErrorInvalidValue;
  int dev = 0;
  cudaGetDevice(&dev);
  if (lay.total > 48 * 1024 && lay.total > sized.smem[dev & 63]) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized.smem[dev & 63] = lay.total;
  }
  if (c.cluster > 8 && !sized.wide[dev & 63]) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized.wide[dev & 63] = true;
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
                                           c.Hkv, c.Smax, c.chmax, extra...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The call's checks and the most positions a rank takes (a multiple of T);
// false when it rejects them.  Clusters of 2, 4 or 8 blocks, or 16 (K7).
inline bool make_call(Call& c, const void* q, const void* kt, const void* v, const void* lengths,
                      const void* scales, void* out, int B, int H, int Hkv, int Smax,
                      int cluster) {
  if (B <= 0 || Hkv <= 0 || H % Hkv || Smax <= 0 || Smax % 4 ||
      (cluster != 2 && cluster != 4 && cluster != 8 && cluster != 16))
    return false;
  c = Call{static_cast<const int8_t*>(q), static_cast<const int8_t*>(kt),
           static_cast<const int8_t*>(v), static_cast<const int*>(lengths),
           static_cast<const float*>(scales), static_cast<float*>(out), B, Hkv, Smax, cluster,
           ((Smax + cluster - 1) / cluster + T - 1) / T * T};
  return true;
}

}  // namespace
