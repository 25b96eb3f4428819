// K2: causal flash attention over the INT8 KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel dgq_tpu/ops/attention.py::int8_prefill_attention
// (body _prefill_kernel).  For each query row: scores s8 q.k^T -> s32, times
// scales[0] = (q_scale * k_scale) / sqrt(Dh); with ALiBi (BLOOM, MPT: the
// kernel's ALIBI instantiation, prefill_attn_sm90<DH, true>) plus slopes[h]
// kpos, taken as slopes[h] (kpos - qpos), the same softmax (a row's bias
// moves by a constant) with the bias near 0 where the row's weights are, so
// that its rounding stays far below the scores'; mask kpos <= q_offset + row and
// kpos < plen (masked scores are finfo(f32).min, not -inf); online fp32
// softmax; p @ (v * v_scale) with fp32 sums; out = acc / max(l, 1e-20).  GQA:
// kv head = h / (H / Hkv).  The K cache is stored transposed, (B, Hkv, Dh,
// Smax), and V as (B, Hkv, Smax, Dh).
//
// What bounds it on this card: at the main path's prefill (B 4, H 32, Sp
// 256, Dh 128) the bytes, q 4.2 MB + the valid K and V 8.4 MB + the fp32
// output 16.8 MB over 3.35 TB/s (8.8 us); the int8 score product (1979
// TOP/s) and the two 16-bit p @ V products (989 TFLOP/s) take less.  The
// design:
//   * both products run on wgmma.  A consumer warpgroup owns 64 query rows:
//     its Q rows are the int8 A operand in registers (K-major, as stored),
//     and the score accumulators, 64 rows x 64 keys, are laid out as the
//     A-register fragments of a 16-bit wgmma, so p never leaves registers;
//   * s8 wgmma takes its B operand K-major only, and the cache holds K^T
//     (keys contiguous).  A producer warpgroup brings each tile of 64 keys
//     in by TMA (a ring of RAW_STAGES: the K^T box [Dh][64] and the V box
//     [64][Dh]) and turns it once, for every query warpgroup of the block,
//     into the K tile [64 keys][Dh] K-major swizzled Dh bytes (4x4 byte
//     transposes) and V^T [Dh][64 keys] in fp16 swizzled 128 bytes (int8
//     codes are exact in fp16), the K-major B operand of the p @ V product;
//     a ring of KV_STAGES such tiles, behind mbarriers, keeps it ahead;
//   * p @ V is p_hi @ V + p_lo @ V into one fp32 accumulator, with p_hi =
//     half(p) and p_lo = half(p - p_hi), and v_scale applied in the
//     epilogue: p_hi + p_lo is p to a relative 2^-22 (the rounding of p_lo,
//     2^-11 of p_lo <= 2^-11 p), and to an absolute 2^-25 where p_lo is an
//     fp16 subnormal (p < 2^-3); V and the products are exact and the sums
//     fp32.  So the output is the reference's fp32 product to ~2^-22 of
//     sum |p v| / l, far inside the card's gate of 3e-4 of the largest
//     output.  (bf16 pieces would give ~2^-17; one 16-bit p, or TF32, ~2^-11
//     and would no longer be the reference's fp32 product);
//   * a block takes the query tiles of one (b, h) that its slot of G blocks
//     a head is dealt (heaviest first, dealt in a snake over the blocks, so
//     the causal triangle is balanced), two at a time, one a warpgroup: each
//     K and V tile is loaded and turned once per pair of query tiles, not
//     once per 64 rows.  G is the fewest blocks a head that still fill the
//     SMs (1 at the main shape: 128 blocks);
//   * in a warpgroup the score product of kv tile j is issued behind p @ V
//     of tile j - 1; the softmax runs in log2 units (scores times qk_scale
//     log2 e, one ex2 a score), masks only the tiles that reach a row's
//     causal end or plen, and skips the rescale of o where no row's max moved;
//   * kv tiles past a tile's causal end or past plen are skipped (exact:
//     alpha = 1 and p = 0 there).
// What it reaches is in PERF.md (chip_smoke.py): at the main shape it is
// still bound by latency, not by either bound above: a block's first
// warpgroup walks 6 kv tiles one after another (4 in its first pass, 2 in
// its second), and development runs with the products, the turning and the
// stores compiled out left about half the time to the TMA, barrier and
// Q-load chain alone.

#include <cuda_fp16.h>

#include "w4a8_gemm_sm90.cuh"

namespace {

constexpr int BQ = 64;                       // query rows of a warpgroup's tile
constexpr int BKV = 64;                      // keys of a kv tile
constexpr int QWG = 2;                       // consumer warpgroups
constexpr int A_THREADS = 128 * (QWG + 1);   // and the producer warpgroup
constexpr int RAW_STAGES = 3;                // TMA ring of kv tiles as stored
constexpr int KV_STAGES = 4;                 // ring of turned kv tiles
// registers a thread after setmaxnreg: 128 x 72 + 256 x 216 = 384 x 168
constexpr int PRODUCER_REGS = 72, CONSUMER_REGS = 216;
constexpr float NEG = -3.4028234663852886e38f;  // finfo(float32).min
constexpr float LOG2E = 1.4426950408889634f;

template <int N>
struct WgmmaF16;

template <>
struct WgmmaF16<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaF16<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// 2^x, one MUFU instruction (relative error ~2^-22; 2^-inf and underflow give 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void fence_f32(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

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

// c[e] of a 4-word array with e known only at run time, without local memory
__device__ __forceinline__ uint32_t pick(const uint32_t (&c)[4], int e) {
  return e == 0 ? c[0] : e == 1 ? c[1] : e == 2 ? c[2] : c[3];
}

// Two int8 codes (bytes 2i, 2i + 1 of w) as an fp16 pair, exactly: byte b +
// 128 as the low mantissa bits of 1024, less 1152.
__device__ __forceinline__ uint32_t s8x2_to_h2(uint32_t w, int i) {
  const uint32_t biased = __byte_perm(w ^ 0x80808080u, 0x64646464u, i ? 0x4342 : 0x4140);
  const __half2 h = __hsub2(*reinterpret_cast<const __half2*>(&biased),
                            __halves2half2(__ushort_as_half(0x6480), __ushort_as_half(0x6480)));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// byte offset off of a K-major tile with rows of ROW bytes, swizzled ROW
// bytes (the 16-byte chunk index XOR the row's bits above it), as wgmma reads it
template <int ROW>
__device__ __forceinline__ int swizzle(int off) {
  return off ^ ((off >> 3) & (ROW == 128 ? 0x70 : 0x30));
}

// the producer warpgroup alone
__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

template <int DH>
struct AttnSmem {
  static constexpr int RAW_KT = DH * BKV;               // K^T box [DH][64 keys]
  static constexpr int RAW = round1k(RAW_KT + BKV * DH);  // + the V box [64 keys][DH]
  static constexpr int VT_OFF = BKV * DH;               // after the K tile [64 keys][DH]
  static constexpr int STAGE = round1k(VT_OFF + DH * BKV * 2);  // + V^T [DH][64 keys] fp16
  static constexpr int KV_BASE = RAW_STAGES * RAW;
  static constexpr int BAR = KV_BASE + KV_STAGES * STAGE;
  static constexpr int TOTAL = BAR + 8 * (RAW_STAGES + 2 * KV_STAGES) + 1024;
  static constexpr uint32_t RAW_TX = 2 * DH * BKV;      // bytes TMA brings a kv tile
  static_assert(TOTAL <= 232448, "shared memory");
};

struct AttnArgs {
  const int8_t* q;       // (B, H, Sp, DH)
  const float* scales;   // [qk_scale, v_scale]
  float* out;            // (B, H, Sp, DH)
  int H, Hkv, Sp, Smax, plen, q_offset;
  int G;                 // blocks a head
  const float* slopes;   // (H,) ALiBi slopes, a query head each (the ALIBI instantiation)
};

// The query tiles of block g of a head's G: tile k of the block is the one
// at place p_k = k G + (k even ? g : G - 1 - g) of the head's tiles sorted
// heaviest (last) first, while p_k < nq.  Pass i runs its tiles 2i (the
// heavier) and 2i + 1 on the two consumer warpgroups.
struct Deal {
  int nq, G, g;
  __device__ __forceinline__ int place(int k) const { return k * G + ((k & 1) ? G - 1 - g : g); }
  __device__ __forceinline__ int count() const {
    int n = 0;
    while (place(n) < nq) ++n;
    return n;
  }
  __device__ __forceinline__ int tile(int k) const { return nq - 1 - place(k); }
};

// kv tiles that query tile t attends: to its last row's causal end, or plen
__device__ __forceinline__ int kv_tiles(const AttnArgs& a, int t) {
  return (min(a.plen, a.q_offset + BQ * (t + 1)) + BKV - 1) / BKV;
}

// The producer warpgroup turns a kv tile as stored (raw: the K^T box, then
// the V box) into the K tile and V^T of a stage (st), thread pt of 128.
template <int DH>
__device__ __forceinline__ void turn_tile(const uint8_t* raw, uint8_t* st, int pt) {
  // K: a thread takes dims [16c, 16c + 16) of keys [4kq, 4kq + 4): 16 words
  // of K^T rows (rows of odd c in the other order, so that a warp's loads
  // take all 32 banks), four 4x4 transposes, then one 16-byte chunk a key
  // (keys in an order that spreads a quarter warp's stores over the banks)
  if (pt < DH) {
    const int c = pt >> 4, kq = pt & 15, odd = c & 1;
    uint32_t r[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      r[i] = *reinterpret_cast<const uint32_t*>(raw + (16 * c + (i ^ odd)) * BKV + 4 * kq);
    uint32_t tk[4][4];  // tk[m][e]: key 4kq + e, dims 16c + 4m ..
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = odd ? r[(4 * m + i) ^ 1] : r[4 * m + i];
      transpose4x4(w[0], w[1], w[2], w[3], tk[m]);
    }
#pragma unroll
    for (int ep = 0; ep < 4; ++ep) {
      const int e = (ep + (kq >> 1)) & 3, key = 4 * kq + e;
      const uint4 v = make_uint4(pick(tk[0], e), pick(tk[1], e), pick(tk[2], e), pick(tk[3], e));
      *reinterpret_cast<uint4*>(st + swizzle<DH>(key * DH + 16 * c)) = v;
    }
  }
  // V: a thread takes keys [8kg, 8kg + 8) of dims [4dq, 4dq + 4): 8 words
  // of V rows, two 4x4 transposes, then per dim 8 fp16 keys, one 16-byte
  // chunk of a V^T row (dims in an order that spreads the stores)
  const uint8_t* v = raw + AttnSmem<DH>::RAW_KT;
  uint8_t* vt = st + AttnSmem<DH>::VT_OFF;
  constexpr int DQ = DH / 4;
#pragma unroll
  for (int unit = pt; unit < 8 * DQ; unit += 128) {
    const int dq = unit % DQ, kg = unit / DQ;
    uint32_t r[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      r[i] = *reinterpret_cast<const uint32_t*>(v + (8 * kg + i) * DH + 4 * dq);
    uint32_t lo[4], hi[4];  // dim 4dq + e: keys 8kg .. + 3, 8kg + 4 .. + 7
    transpose4x4(r[0], r[1], r[2], r[3], lo);
    transpose4x4(r[4], r[5], r[6], r[7], hi);
#pragma unroll
    for (int ep = 0; ep < 4; ++ep) {
      const int e = (ep + (dq >> 1)) & 3, d = 4 * dq + e;
      const uint32_t wl = pick(lo, e), wh = pick(hi, e);
      const uint4 h = make_uint4(s8x2_to_h2(wl, 0), s8x2_to_h2(wl, 1), s8x2_to_h2(wh, 0),
                                 s8x2_to_h2(wh, 1));
      *reinterpret_cast<uint4*>(vt + swizzle<128>(d * 128 + 16 * kg)) = h;
    }
  }
}

template <int DH, bool ALIBI>
__global__ void __launch_bounds__(A_THREADS, 1)
prefill_attn_sm90(const __grid_constant__ CUtensorMap tm_kt,
                  const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ AttnArgs a) {
  using S = AttnSmem<DH>;
  constexpr int KS = DH / 32;  // 32-k steps of the score product
  constexpr int NO = DH / 2;   // output accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* rawfull = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* ready = rawfull + RAW_STAGES;
  uint64_t* empty = ready + KV_STAGES;

  const int b = blockIdx.z, h = blockIdx.y, hk = h / (a.H / a.Hkv);
  const Deal deal{a.Sp / BQ, a.G, static_cast<int>(blockIdx.x)};
  const int count = deal.count(), passes = (count + 1) / 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < RAW_STAGES; ++s) mbar_init(&rawfull[s], 1);
    for (int s = 0; s < KV_STAGES; ++s) {
      mbar_init(&ready[s], 128);        // every producer thread
      mbar_init(&empty[s], QWG * 4);    // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * QWG) {
    // ---- producer warpgroup: thread 0 issues the TMA loads, all turn tiles ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int pt = threadIdx.x - 128 * QWG;
    const int krow = (b * a.Hkv + hk) * DH, vrow = (b * a.Hkv + hk) * a.Smax;
    int ip = 0, ij = 0;  // the next kv tile to load: pass, tile
    auto load_next = [&](int slot) {
      while (ip < passes && ij >= kv_tiles(a, deal.tile(2 * ip))) {
        ++ip;
        ij = 0;
      }
      if (ip >= passes) return;
      uint8_t* raw = smem + slot * S::RAW;
      mbar_expect_tx(&rawfull[slot], S::RAW_TX);
      tma_load_2d(raw, &tm_kt, &rawfull[slot], BKV * ij, krow);
      tma_load_2d(raw + S::RAW_KT, &tm_v, &rawfull[slot], 0, vrow + BKV * ij);
      ++ij;
    };
    if (pt == 0)
      for (int r = 0; r < RAW_STAGES; ++r) load_next(r);
    int u = 0;  // kv tiles so far
    for (int i = 0; i < passes; ++i) {
      const int nkv = kv_tiles(a, deal.tile(2 * i));
      for (int j = 0; j < nkv; ++j, ++u) {
        const int rs = u % RAW_STAGES, s = u % KV_STAGES;
        mbar_wait(&rawfull[rs], (u / RAW_STAGES) & 1);
        if (u >= KV_STAGES) mbar_wait(&empty[s], ((u / KV_STAGES) + 1) & 1);
        turn_tile<DH>(smem + rs * S::RAW, smem + S::KV_BASE + s * S::STAGE, pt);
        fence_async_smem();  // the turned tile, visible to wgmma
        mbar_arrive(&ready[s]);
        producers_sync();  // every producer thread has read the raw slot
        if (pt == 0) {
          fence_async_smem();
          load_next(rs);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  // the warpgroup's index through a shuffle, so that ptxas sees every branch
  // around the wgmmas as uniform (a divergent path around them makes it
  // serialise them, C7520)
  const int ct = threadIdx.x, wg = __shfl_sync(0xFFFFFFFFu, ct >> 7, 0);
  const int warp = (ct >> 5) & 3, lane = ct & 31, gq = lane >> 2, t = lane & 3;
  const float qkl = a.scales[0] * LOG2E;  // scores in log2 units
  float sl = 0.0f;                         // ALiBi: the head's slope in log2 units
  if constexpr (ALIBI) sl = a.slopes[h] * LOG2E;
  const int8_t* qh = a.q + (static_cast<size_t>(b) * a.H + h) * a.Sp * DH;
  float* oh = a.out + (static_cast<size_t>(b) * a.H + h) * a.Sp * DH;
  auto stage = [&](int s) { return smem + S::KV_BASE + s * S::STAGE; };
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
  };
  int u = 0;
  for (int i = 0; i < passes; ++i) {
    const int k = 2 * i + wg;
    const bool has = k < count;  // the last pass of an odd count has one tile
    const int tq = has ? deal.tile(k) : 0;
    const int nkv = kv_tiles(a, deal.tile(2 * i)), mine = has ? kv_tiles(a, tq) : 0;
    // this thread's rows of the tile: 16 warp + gq and + 8
    const int row = BQ * tq + 16 * warp + gq, qbase = a.q_offset + BQ * tq;
    // Q as the s8 A fragments: rows gq / gq + 8, k 4t .. and 16 + 4t .. of each step
    uint32_t qa[KS][4];
    if (has) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int8_t* p = qh + static_cast<size_t>(row) * DH + 32 * ks + 4 * t;
        qa[ks][0] = *reinterpret_cast<const uint32_t*>(p);
        qa[ks][1] = *reinterpret_cast<const uint32_t*>(p + 8 * DH);
        qa[ks][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        qa[ks][3] = *reinterpret_cast<const uint32_t*>(p + 8 * DH + 16);
      }
    }
    float m_r[2] = {NEG, NEG}, l_r[2] = {0.0f, 0.0f};  // rows gq, gq + 8; m in log2 units
    // o[4n + e]: row gq + 8 (e >> 1), column 8n + 2t + (e & 1); the first
    // product writes it (scale-d 0).  sc[4n + e]: the scores of row gq + 8
    // (e >> 1), key 8n + 2t + (e & 1).  ph / pl: p of the tile before as the
    // fp16 A fragments of the 16-key steps kk: register r of step kk holds
    // keys 16kk + 2t (+ 8 for r >= 2) of row gq (+ 8 for odd r).
    float o[NO], p[32];
    int sc[32];
    uint32_t ph[4][4], pl[4][4];
    int s_prev = 0;
    // p @ V of the tile in stage s_prev from ph / pl into o (issued, not waited)
    auto issue_pv = [&](bool first) {
      const uint8_t* vt = stage(s_prev) + S::VT_OFF;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t vd = gmma_desc(vt + 32 * kk, 128);
        WgmmaF16<DH>::mma(o, ph[kk], vd, !(first && kk == 0));
        WgmmaF16<DH>::mma(o, pl[kk], vd, 1);
      }
      wgmma_commit();
    };
    auto fence_operands = [&]() {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(ph[kk]);
        fence_regs(pl[kk]);
      }
      fence_f32(o);
    };
    // Two tiles in flight: the score product of tile j runs behind p @ V of
    // tile j - 1, and the softmax of tile j while p @ V of j - 1 finishes.
    for (int j = 0; j < mine; ++j, ++u) {
      const int s = u % KV_STAGES;
      mbar_wait(&ready[s], (u / KV_STAGES) & 1);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) fence_regs(qa[ks]);
      fence_regs(sc);
      if (j > 0) fence_operands();
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        Wgmma<64>::mma(sc, qa[ks], gmma_desc(stage(s) + 32 * ks, DH), ks);
      wgmma_commit();
      if (j > 0) {
        issue_pv(j == 1);
        wgmma_wait<1>();  // the scores are in; p @ V of tile j - 1 may still run
      } else {
        wgmma_wait<0>();
      }
      fence_regs(sc);

      // the online softmax of the tile, in log2 units (p = 2^(s log2 e - m));
      // only tiles that reach a row's causal end or plen need the mask
      const int kv0 = BKV * j;
      const bool edge = kv0 + BKV - 1 > qbase || kv0 + BKV > a.plen;
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float y;
          if constexpr (ALIBI) {  // every tile: the bias is on every position
            const int kpos = kv0 + 8 * n + 2 * t + (e & 1), qpos = a.q_offset + row + 8 * (e >> 1);
            y = fmaf(static_cast<float>(sc[4 * n + e]), qkl, sl * static_cast<float>(kpos - qpos));
            if (edge) y = (kpos <= qpos && kpos < a.plen) ? y : NEG;
          } else {
            y = static_cast<float>(sc[4 * n + e]) * qkl;
            if (edge) {
              const int kpos = kv0 + 8 * n + 2 * t + (e & 1);
              y = (kpos <= a.q_offset + row + 8 * (e >> 1) && kpos < a.plen) ? y : NEG;
            }
          }
          p[4 * n + e] = y;
          mx[e >> 1] = fmaxf(mx[e >> 1], y);
        }
      float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xFFFFFFFFu, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xFFFFFFFFu, mx[hr], 2));
        const float m_new = fmaxf(m_r[hr], mx[hr]);
        alpha[hr] = ex2(m_r[hr] - m_new);
        m_r[hr] = m_new;
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        p[e] = ex2(p[e] - m_r[(e >> 1) & 1]);
        sum[(e >> 1) & 1] += p[e];
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        sum[hr] += __shfl_xor_sync(0xFFFFFFFFu, sum[hr], 1);
        sum[hr] += __shfl_xor_sync(0xFFFFFFFFu, sum[hr], 2);
        l_r[hr] = __fadd_rn(__fmul_rn(l_r[hr], alpha[hr]), sum[hr]);
      }
      if (j > 0) {
        wgmma_wait<0>();  // p @ V of tile j - 1 is done: its stage, ph / pl and o are free
        fence_operands();
        release(s_prev);
        if (__any_sync(0xFFFFFFFFu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
          for (int e = 0; e < NO; ++e) o[e] *= alpha[(e >> 1) & 1];
        }
      }
      // p in two fp16 pieces, p_hi = half(p) and p_lo = half(p - p_hi)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x0 = p[8 * kk + 2 * r], x1 = p[8 * kk + 2 * r + 1];
          const __half2 hi = __floats2half2_rn(x0, x1);
          const float2 back = __half22float2(hi);
          const __half2 lo = __floats2half2_rn(x0 - back.x, x1 - back.y);
          ph[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
          pl[kk][r] = *reinterpret_cast<const uint32_t*>(&lo);
        }
      s_prev = s;
    }
    if (has) {  // p @ V of the last tile
      fence_operands();
      wgmma_fence();
      issue_pv(mine == 1);
      wgmma_wait<0>();
      fence_f32(o);
      release(s_prev);
    }
    // the kv tiles past this tile's causal end that the other tile of the pass needs
    for (int j = mine; j < nkv; ++j, ++u) {
      const int s = u % KV_STAGES;
      mbar_wait(&ready[s], (u / KV_STAGES) & 1);
      release(s);
    }
    if (!has) continue;
    // ---- epilogue: out = o * v_scale / max(l, 1e-20) ----
    const float vs = a.scales[1];
    float w[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) w[hr] = __fdiv_rn(vs, fmaxf(l_r[hr], 1e-20f));
    float* orow = oh + static_cast<size_t>(row) * DH + 2 * t;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(o[4 * n] * w[0], o[4 * n + 1] * w[0]);
      *reinterpret_cast<float2*>(orow + 8 * DH + 8 * n) =
          make_float2(o[4 * n + 2] * w[1], o[4 * n + 3] * w[1]);
    }
  }
}

template <int DH, bool ALIBI>
int launch_prefill(const void* kt, const void* v, const AttnArgs& a, int B, cudaStream_t st) {
  using S = AttnSmem<DH>;
  CUtensorMap tk, tv;
  // K^T as (B Hkv Dh rows, Smax bytes), boxes [Dh][64 keys]; V as (B Hkv Smax
  // rows, Dh bytes), boxes [64 keys][Dh]
  int rc = tensor_map(&tk, kt, a.Smax, static_cast<uint64_t>(B) * a.Hkv * DH, BKV, DH,
                      CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!rc)
    rc = tensor_map(&tv, v, DH, static_cast<uint64_t>(B) * a.Hkv * a.Smax, DH, BKV,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc) return rc;
  auto kernel = prefill_attn_sm90<DH, ALIBI>;
  static uint64_t sized = 0;  // devices whose limit is raised, one set per instantiation
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(sized >> (dev & 63) & 1)) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::TOTAL);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized |= 1ull << (dev & 63);
  }
  kernel<<<dim3(a.G, a.H, B), A_THREADS, S::TOTAL, st>>>(tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (B, H, Sp, Dh) int8; kt (B, Hkv, Dh, Smax) int8; v (B, Hkv, Smax, Dh) int8;
// scales f32 [qk_scale, v_scale] on the device; slopes (H,) f32 ALiBi slopes on
// the device, or null (no ALiBi); out (B, H, Sp, Dh) f32.
int int8_prefill_attention(const void* q, const void* kt, const void* v, const void* scales,
                           const void* slopes, void* out, int B, int H, int Hkv, int Sp, int Dh,
                           int Smax, int plen, int q_offset, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv || Sp % BQ || Smax % BKV || plen < 1 || plen > Smax ||
      q_offset < 0 || (Dh != 64 && Dh != 128))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  const cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  AttnArgs a{};
  a.q = static_cast<const int8_t*>(q);
  a.scales = static_cast<const float*>(scales);
  a.out = static_cast<float*>(out);
  a.H = H;
  a.Hkv = Hkv;
  a.Sp = Sp;
  a.Smax = Smax;
  a.plen = plen;
  a.q_offset = q_offset;
  a.slopes = static_cast<const float*>(slopes);
  // the fewest blocks a head that fill the SMs, each with at least two tiles
  const int nq = Sp / BQ;
  a.G = max(1, min((nq + 1) / 2, sms / (B * H)));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (slopes)
    return Dh == 128 ? launch_prefill<128, true>(kt, v, a, B, st)
                     : launch_prefill<64, true>(kt, v, a, B, st);
  return Dh == 128 ? launch_prefill<128, false>(kt, v, a, B, st)
                   : launch_prefill<64, false>(kt, v, a, B, st);
}

}  // extern "C"
