// K3's and K7's split kernels: single-token decode attention over the INT8 KV
// cache at any number of query heads a kv head (rep = H / Hkv outside 1, 2, 4
// and 8: Falcon-7B's 71 on one kv head, 48 on 8), for Hopper (sm_90a).
//
// Replaces, at those reps, the TPU kernels dgq_tpu/ops/attention.py::
// int8_decode_attention (K3, grid (b, hk) at :156, a block of all rep query
// rows of the kv head, BlockSpec((1, 1, rep, dh)) at :158, :162) and
// int8_decode_attention_chunked (K7, the same per chunk, :520-531): one grid
// step a (slot, kv head) reads K and V once and runs both products on the
// matrix unit.  The function is K3's: for slot b and kv head g the kernel
// serves query heads g rep .. g rep + rep - 1; scores s8 q.k^T -> s32 times
// scales[0] over the valid length lengths[b] (plus slopes[h] x position with
// ALiBi, the product and the sum rounded one at a time, as the plain
// version); m is the GLOBAL row max and e = exp(s - m); with quant_pv the
// codes trunc(127 e + 0.5) and an exact int32 p @ V, out = acc * ((v_scale /
// 127) / denom); without it out = sum e (v * v_scale) / denom in fp32.
//
// What bounds it on this card, at the shapes chip_smoke.py times (fp p @ V):
// Falcon-7B's serving decode (8 slots of 1-2048 positions, 71:1, Dh 64) moves
// 1.36 MB (K and V, q, out: 0.41 us at 3.35 TB/s) and does 2 x 71 x 9178 x
// 64 operations of q.k and twice that of p @ V (0.21 us on the int8 and
// fp16 tensor cores); at 16,384 positions (4 slots of 5000-16000) 5.5 MB
// (1.6 us) and 1.1 us.  Either is a few microseconds of serial steps a
// rank: the kernel is bound by latency, and its design keeps the steps few
// and the bytes read once:
//   * one cluster of C blocks a (slot, kv head), grid (C, Hkv, B): rank r
//     streams the positions [r per, (r + 1) per) of the slot's valid length,
//     per = ceil(len / C) rounded up to 16, so every K and V byte is read
//     from device memory once a call (K twice where the plan streams it
//     again to recompute the scores, the second time mostly from L2);
//   * every query row of the kv head is in the block: rep rows padded to MT
//     = ceil(rep / 16) m16 tiles, two warps a tile, each warp taking 32 of a
//     tile's 64 positions (at least 256 threads: the warps past the rows'
//     help copy the tiles).  Both products run on mma.sync (not wgmma: its
//     64-row tiles pad 71 rows to 128, 45% dead, against 80, 11%);
//   * K and V tiles come by TMA (one thread, an mbarrier a ring slot; 4- and
//     16-byte cp.async where Smax % 16 != 0) into a 32 KB ring of raw tiles,
//     and each is converted once a block to fp16 in its own layout (int8
//     codes are exact in fp16): K^T [Dh][64] and V [64][Dh], 16-byte chunks
//     swizzled by row.  ldmatrix (.trans) then reads the mma fragments
//     straight from them, so no byte transposes (the first design's, K2's,
//     took a quarter of K7's time);
//   * q.k on m16n8k16 f16 with fp32 sums, q's rows in fp16 as A: every
//     product and partial sum is an integer below 2^24, so exact, and the
//     scores are the plain version's bit for bit;
//   * p @ V on the tensor cores too, the scores' accumulator layout taken as
//     the A operand in registers (no trip through shared memory):
//       - quant_pv: the codes times V on m16n8k32 s8 (exact int32); the A
//         fragment's k slots 4t .. 4t + 3 hold positions 2t, 2t + 1, 8 + 2t,
//         9 + 2t of the 16 (the scores' n8 tiles), so the V tile is turned
//         into V^T int8 with its positions in that order (4x4 byte
//         transposes);
//       - fp: p_hi @ V + p_lo @ V on m16n8k16 f16 into a tile's fp32
//         accumulator, added to the running sums a tile (a rank's thousands
//         of positions: fewer large additions), p_hi = half(P), p_lo =
//         half(P - p_hi) with P = 4096 e (exact: a power of two), v_scale /
//         4096 in the epilogue, K2's scheme: P to a relative 2^-22, and the
//         4096 keeps p_lo out of fp16's subnormals down to e = 2^-15; e =
//         2^(s log2 e - m log2 e) on the MUFU unit (quant_pv's codes take
//         expf, the plain version's exp to the bit);
//   * fp p @ V runs in one pass over K and V (online): each warp keeps a
//     running max of its rows over its positions, and rescales its sums
//     when a tile raises it; the two warps of a row tile, then the ranks,
//     are added rescaled to the larger max (2^(m_k log2 e - m log2 e)), so
//     no cluster barrier sits between the max and the exp;
//   * quant_pv's codes need the slot's max before any exp: a first pass
//     takes it, and between the max and the exp the scores stay where the
//     plan says: in the block's shared memory (f32 [rows][chmax + 8]) where
//     they fit (K3's caches), else recomputed in a second pass from the
//     rank's K tiles kept in shared memory in fp16 (K7 past 8192 positions:
//     71 rows x 1024 positions of scores would take 330 KB a rank, its K
//     tiles 128 KB), else from K streamed again; exp runs once a (row,
//     position) either way;
//   * the row max over the cluster through distributed shared memory, and
//     the sums reduced and scattered: each rank adds every rank's p @ V sums
//     and exp sums of the rows r, r + C, .. in rank order (deterministic)
//     and writes them.
// One launch, no scratch in device memory.

#include <cuda_fp16.h>

#include <type_traits>

#include "w4a8_gemm_sm90.cuh"  // TMA, mbarrier and tensor-map helpers, as K2 takes them

namespace {
namespace rows {

constexpr int TP = 64;        // positions a tile
constexpr int RING_BYTES = 32768;  // raw tiles in flight: 8 of Dh 64, 4 of Dh 128
constexpr int MAX_REP = 128;  // rows of the block: 8 m16 tiles
constexpr int MAX_THREADS = 512;  // two warps a 16-row tile
constexpr int MIN_THREADS = 256;  // and more warps to copy the tiles of fewer rows
constexpr int MAX_CLUSTER = 16;
constexpr int SMEM_LIMIT = 232448;
constexpr float NEG = -3.4028234663852886e38f;  // finfo(float32).min
constexpr float PSCALE = 4096.f;  // fp p @ V: P = 4096 e, split into two fp16 pieces
constexpr float LOG2E = 1.4426950408889634f;

// byte offset `off` of a tile of ROW-byte rows, its 16-byte chunk index XOR
// the row's bits above it (int8_prefill_attention.cu's swizzle)
template <int ROW>
__device__ __forceinline__ int swz(int off) {
  return off ^ ((off >> 3) & (ROW == 128 ? 0x70 : 0x30));
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) { return *reinterpret_cast<const uint32_t*>(p); }

// c[e] of a 4-word array with e known only at run time, without local memory
__device__ __forceinline__ uint32_t pick(const uint32_t (&c)[4], int e) {
  return e == 0 ? c[0] : e == 1 ? c[1] : e == 2 ? c[2] : c[3];
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

// two int8 codes (bytes 2i, 2i + 1 of w) as an fp16 pair, exactly: byte + 128
// as the low mantissa bits of 1024, less 1152
__device__ __forceinline__ uint32_t s8x2_to_h2(uint32_t w, int i) {
  const uint32_t biased = __byte_perm(w ^ 0x80808080u, 0x64646464u, i ? 0x4342 : 0x4140);
  const __half2 h = __hsub2(*reinterpret_cast<const __half2*>(&biased),
                            __halves2half2(__ushort_as_half(0x6480), __ushort_as_half(0x6480)));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 2^x, one MUFU instruction (relative error ~2^-22; underflow gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

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
__device__ __forceinline__ uint32_t ld_peer(uint32_t remote) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(remote) : "memory");
  return v;
}

// four 8x8 b16 matrices from shared memory, lane l giving row l % 8 of
// matrix l / 8; .trans: each transposed
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// the byte offset of 16-byte chunk c of row r in an fp16 tile of ROWB-byte
// rows, the chunk's low three bits XOR the row's (ldmatrix's 8 rows, and a
// quarter warp's 16-byte stores, on other banks)
template <int ROWB>
__device__ __forceinline__ int chunk16(int r, int c) {
  return r * ROWB + ((c ^ (r & 7)) << 4);
}

// 16 int8 codes (w) as 16 fp16 values, exactly, into chunks 2c and 2c + 1
// of row r of an fp16 tile of ROWB-byte rows
template <int ROWB>
__device__ __forceinline__ void put16_h(uint8_t* tile, int r, int c, uint4 w) {
  *reinterpret_cast<uint4*>(tile + chunk16<ROWB>(r, 2 * c)) =
      make_uint4(s8x2_to_h2(w.x, 0), s8x2_to_h2(w.x, 1), s8x2_to_h2(w.y, 0), s8x2_to_h2(w.y, 1));
  *reinterpret_cast<uint4*>(tile + chunk16<ROWB>(r, 2 * c + 1)) =
      make_uint4(s8x2_to_h2(w.z, 0), s8x2_to_h2(w.z, 1), s8x2_to_h2(w.w, 0), s8x2_to_h2(w.w, 1));
}

// a raw tile of R rows of W int8 bytes (K^T [Dh][64] or V [64][Dh]) -> the
// same layout in fp16 (int8 codes are exact in fp16), rows of 2 W bytes
template <int R, int W>
__device__ __forceinline__ void to_f16(const uint8_t* raw, uint8_t* tile, int tid, int nthr) {
  for (int i = tid; i < R * (W / 16); i += nthr) {
    const int r = i / (W / 16), c = i % (W / 16);
    put16_h<2 * W>(tile, r, c, *reinterpret_cast<const uint4*>(raw + r * W + 16 * c));
  }
}

// d += a b, m16n8k32, int8 in, int32 out (exact)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a b, m16n8k16, fp16 in, fp32 out
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <class A>
__device__ __forceinline__ A from_bits(uint32_t u) {
  if constexpr (std::is_same<A, float>::value) return __uint_as_float(u);
  else return static_cast<A>(u);
}

// Byte offsets of a block's dynamic shared memory (ops/attention.py
// rows_smem_bytes): the ring of raw tiles (K^T [Dh][64] or V [64][Dh]), the
// K tile in fp16 (K^T [Dh][64]), the V tile in fp16 ([64][Dh]; under
// quant_pv V^T int8 [Dh][64], in the same room), q's rows in fp16 [rp][Dh],
// and quant_pv's scores f32 [rp][chmax + 8] unless they are recomputed (the
// K tiles in fp16 then stay in shared memory where the plan says).  The p @
// V sums [rp][Dh + 8] (f32 or int32) take the ring's and the tiles' room at
// the end.
struct Layout {
  int tk, tv, q, scores, total, rs;
  // recompute (quant_pv; 0 without it): 0 the scores kept; 1 recomputed
  // from K streamed again; 2 recomputed from the rank's K tiles, kept in
  // fp16 (chmax / 64 of them)
  __host__ __device__ Layout(int dh, int rp, int chmax, bool qpv, int recompute) {
    const int slot = TP * dh;
    tk = RING_BYTES;
    tv = tk + (recompute == 2 ? chmax / TP : 1) * 2 * slot;
    q = tv + 2 * slot;
    if (q < 4 * rp * (dh + 8)) q = 4 * rp * (dh + 8);  // the p @ V sums take the room below q
    scores = q + 2 * rp * dh;
    rs = chmax + 8;  // a row of scores: 8 floats past the tile grid, so rows gq 0..7 take other banks
    total = scores + (qpv && recompute == 0 ? 4 * rp * rs : 0);
  }
};

struct Args {
  const int8_t* q;  // (B, Hkv rep, Dh)
  const int8_t* kt;  // (B, Hkv, Dh, Smax)
  const int8_t* v;   // (B, Hkv, Smax, Dh)
  const int* lengths;
  const float* scales;  // [qk_scale, v_scale, v_scale / 127]
  const float* slopes;  // (Hkv rep,) ALiBi slopes (the ALiBi kernels), else null
  float* out;           // (B, Hkv rep, Dh)
  int Hkv, rep, Smax, chmax;
  int recompute;  // quant_pv's scores: 0 kept in shared memory, recomputed in the second pass
                  // from K streamed again (1) or from the rank's K tiles kept in fp16 (2); 0
                  // without quant_pv (one pass against a running max)
  int tma;        // Smax % 16 == 0: K and V tiles by TMA, else by 4- and 16-byte cp.async
};

// V tile [64][DH] (raw) -> V^T [DH][64 slots] int8, rows of 64 bytes
// swizzled 64 bytes, the positions of each 16 in the scores' fragment order:
// slot 4t + e holds position 8 (e >> 1) + 2t + (e & 1).  Unit (kp, dq) takes
// positions [16kp, 16kp + 16) of dims [4dq, 4dq + 4): 16 words (rows of odd kp
// in the other order), four 4x4 transposes, then a dim's 16 slots, one
// 16-byte chunk: slot word t = positions 2t, 2t + 1 (word t / 2 of the
// transposes) and 8 + 2t, 9 + 2t (word 2 + t / 2).
template <int DH>
__device__ __forceinline__ void turn_v_s8(const uint8_t* raw, uint8_t* tv, int tid, int nthr) {
  constexpr int DQ = DH / 4;
  for (int unit = tid; unit < 4 * DQ; unit += nthr) {
    const int dq = unit % DQ, kp = unit / DQ, odd = kp & 1;
    uint32_t r[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) r[i] = lds32(raw + (16 * kp + (i ^ odd)) * DH + 4 * dq);
    uint32_t w[4][4];  // w[m][e]: dim 4dq + e, positions 16kp + 4m ..
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      uint32_t x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = r[(4 * m + i) ^ odd];
      transpose4x4(x[0], x[1], x[2], x[3], w[m]);
    }
#pragma unroll
    for (int ep = 0; ep < 4; ++ep) {
      const int e = (ep + (dq >> 1)) & 3, d = 4 * dq + e;
      uint32_t s[4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        s[t] = __byte_perm(pick(w[t >> 1], e), pick(w[2 + (t >> 1)], e), (t & 1) ? 0x7632 : 0x5410);
      *reinterpret_cast<uint4*>(tv + swz<64>(d * 64 + 16 * kp)) = make_uint4(s[0], s[1], s[2], s[3]);
    }
  }
}

// The body: one block of the grid (C, Hkv, B) in clusters of C along x, a
// cluster a (slot, kv head), two warps a 16-row tile (64 MT threads, at
// least MIN_THREADS: the warps past 2 MT only copy and convert tiles).  Warp w serves
// rows 16 (w / 2) .. + 15 (m16 tile mt) at positions 32 (w % 2) .. + 31 of
// each tile; lane (gq, t) = (lane / 4, lane % 4) holds, of its n8 tile j,
// rows gq and gq + 8 at positions 8j + 2t, + 1.
template <int DH, bool QPV, bool ALIBI>
__device__ __forceinline__ void core(const CUtensorMap& tm_k, const CUtensorMap& tm_v,
                                     const Args& a) {
  constexpr int SLOT = TP * DH;
  constexpr int RING = RING_BYTES / SLOT;
  constexpr int NJD = DH / 8;  // n8 tiles of p @ V's output dims
  constexpr int DQ = DH / 4;
  constexpr int QS = 2 * DH;  // bytes a row of q in fp16
  constexpr int OS = DH + 8;   // elements a row of the p @ V sums
  using acc_t = typename std::conditional<QPV, int, float>::type;
  extern __shared__ __align__(128) uint8_t rows_smem[];
  uint8_t* smem = rows_smem;
  __shared__ float sMaxW[2][MAX_REP], sM[MAX_REP], sDenW[MAX_REP], sDen[MAX_REP], sDenT[MAX_REP];
  // online: the weights exp(m_k - m) of rank k's sums of this rank's row j
  __shared__ float sWt[MAX_REP / 2][MAX_CLUSTER];
  __shared__ __align__(8) uint64_t bars[RING_BYTES / (TP * 64)];

  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int rep = a.rep, rp = 16 * ((rep + 15) >> 4);
  // warps past the 2 MT that serve rows (a block has at least MIN_THREADS)
  // only copy and convert tiles
  const bool rows_warp = warp < rp / 8;
  const int gq = lane >> 2, t = lane & 3, mt = rows_warp ? warp >> 1 : 0, wp = warp & 1;
  const int row0 = 16 * mt + gq, row1 = row0 + 8;
  const uint32_t rank = cluster_rank(), ncl = cluster_size();
  const int g = blockIdx.y, b = blockIdx.z, Hkv = a.Hkv;
  constexpr bool online = !QPV;  // fp p @ V: one pass against a running max
  const bool recompute = QPV && a.recompute != 0, reload = QPV && a.recompute == 1;
  const bool tma = a.tma != 0;
  const bool paired = reload || online;  // a tile's K and V streamed in one step
  const Layout lay(DH, rp, a.chmax, QPV, a.recompute);
  uint8_t* ring = smem;
  uint8_t* tK = smem + lay.tk;
  uint8_t* tV = smem + lay.tv;
  uint8_t* sQ = smem + lay.q;
  float* sS = reinterpret_cast<float*>(smem + lay.scores);

  if (tma && tid == 0) {
    for (int s = 0; s < RING; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int len = min(a.lengths[b], a.Smax);
  const int per = ((len + ncl - 1) / ncl + 15) & ~15;  // positions a rank
  const int p0 = rank * per;
  const int n = max(0, min(per, len - p0));  // this rank's valid positions
  const int ntile = (n + TP - 1) / TP;
  const size_t bg = (size_t)b * Hkv + g;
  const int8_t* kg = a.kt + bg * DH * a.Smax + p0;
  const int8_t* vg = a.v + (bg * a.Smax + p0) * DH;
  // the rank's stream: K tiles 0 .. ntile - 1 (the first pass), then (scores
  // recomputed from K streamed again) K and V of tile i as items ntile + 2i
  // and + 1, or V tile i
  const int np1 = online ? 0 : ntile;  // the first pass's items
  const int nitems = (reload ? 3 : 2) * ntile;
  __syncthreads();  // the barriers are initialised
  // item u into ring slot u % RING: by TMA (one thread; a slot's earlier
  // reads ordered before the async proxy's writes), else by cp.async, one
  // copy group a call (empty past the stream)
  auto issue = [&](int u) {
    const int r = u - np1;
    const bool is_k = u < np1 || (paired && !(r & 1));
    const int tile = u < np1 ? u : paired ? r >> 1 : r;
    uint8_t* dst = ring + (u % RING) * SLOT;
    const int t0 = tile * TP, nt = min(TP, n - t0);
    if (tma) {
      if (tid == 0 && u < nitems) {
        if (u >= RING) fence_async_smem();
        mbar_expect_tx(&bars[u % RING], SLOT);
        if (is_k)  // K^T box [Dh][64] at column p0 + t0 of rows bg Dh ..
          tma_load_2d(dst, &tm_k, &bars[u % RING], p0 + t0, static_cast<int>(bg * DH));
        else  // V box [64][Dh] at row bg Smax + p0 + t0
          tma_load_2d(dst, &tm_v, &bars[u % RING], 0, static_cast<int>(bg * a.Smax + p0 + t0));
      }
      return;
    }
    if (u < nitems) {
      if (is_k) {  // K^T rows d: nt bytes at d Smax (rounded up to 4, inside the row)
        const int w = (nt + 3) >> 2;
        for (int i = tid; i < DH * w; i += nthr)
          cp_async4(dst + (i / w) * TP + 4 * (i % w), kg + (size_t)(i / w) * a.Smax + t0 + 4 * (i % w));
      } else {  // V rows t0 .. t0 + nt - 1: one contiguous range
        for (int i = tid; i < nt * DH / 16; i += nthr)
          cp_async16(dst + 16 * i, vg + (size_t)t0 * DH + 16 * i);
      }
    }
    cp_async_commit();
  };
  // wait for items u .. u + W - 1 (W = 1 or 2, the most recent issued u + RING - 1)
  auto landed = [&](int u, int w) {
    if (tma) {
      for (int k = 0; k < w; ++k) mbar_wait(&bars[(u + k) % RING], ((u + k) / RING) & 1);
    } else if (w == 1) {
      cp_async_wait<RING - 1>();
    } else {
      cp_async_wait<RING - 2>();
    }
  };
  for (int u = 0; u < RING; ++u) issue(u);

  // q's rows of the kv head in fp16, zeros past rep (the last m16 tile's dead rows)
  const int8_t* qg = a.q + bg * rep * DH;
  for (int i = tid; i < rp * (DH / 16); i += nthr) {
    const int r = i / (DH / 16), c = i % (DH / 16);
    uint4 w = make_uint4(0, 0, 0, 0);
    if (r < rep) {  // q's base is 4-byte aligned
      const uint32_t* src = reinterpret_cast<const uint32_t*>(qg + r * DH + 16 * c);
      w = make_uint4(src[0], src[1], src[2], src[3]);
    }
    put16_h<QS>(sQ, r, c, w);
  }
  const float qk_scale = a.scales[0];
  float sl[2] = {0.f, 0.f};  // ALiBi: rows gq and gq + 8's slopes (0 for a dead row)
  if constexpr (ALIBI) {
    if (row0 < rep) sl[0] = __ldg(a.slopes + (size_t)g * rep + row0);
    if (row1 < rep) sl[1] = __ldg(a.slopes + (size_t)g * rep + row1);
  }
  // the V tile's conversion (quant_pv: turn) starts at thread DH, the K
  // tile's at thread 0 (both in one step where K is streamed again)
  const int vtid = paired ? ((tid - DH) % nthr + nthr) % nthr : tid;
  auto prep_v = [&](const uint8_t* raw) {
    if constexpr (QPV)
      turn_v_s8<DH>(raw, tV, vtid, nthr);
    else
      to_f16<TP, DH>(raw, tV, vtid, nthr);
  };

  // the scores of the fp16 K^T tile at tK at the rank's position t0:
  // sf[jj][e] is row gq (e < 2) or gq + 8, position 32 wp + 8 jj + 2t + (e &
  // 1).  q.k on m16n8k16 f16 with fp32 sums: codes of at most 127 in
  // magnitude, so every product and partial sum (below 2^24) is an exact
  // integer, the int32 dot of the plain version
  float sf[4][4];
  auto scores = [&](const uint8_t* tK, int t0) {
    float acc[4][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[jj][0] = acc[jj][1] = acc[jj][2] = acc[jj][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      uint32_t qa[4];  // rows 16 mt + lane % 16, dims 16 ks + 8 (lane / 16) ..
      ldsm_x4(qa, sQ + chunk16<QS>(16 * mt + (lane & 15), 2 * ks + (lane >> 4)));
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {  // n8 tiles 2 jp, 2 jp + 1: K^T rows 16 ks .. + 15
        uint32_t kb[4];
        const int d = 16 * ks + 8 * ((lane >> 3) & 1) + (lane & 7);
        ldsm_x4_t(kb, tK + chunk16<128>(d, 4 * wp + 2 * jp + (lane >> 4)));
        mma_f16(acc[2 * jp], qa, kb[0], kb[1]);
        mma_f16(acc[2 * jp + 1], qa, kb[2], kb[3]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = __fmul_rn(acc[jj][e], qk_scale);
        if constexpr (ALIBI)
          s = __fadd_rn(s, __fmul_rn(sl[e >> 1], static_cast<float>(
                                                     p0 + t0 + 32 * wp + 8 * jj + 2 * t + (e & 1))));
        sf[jj][e] = s;
      }
  };

  // ---- first pass: the scores and the row max ----
  float mx[2] = {NEG, NEG};
  int u = 0;
  for (; u < np1; ++u) {
    landed(u, 1);
    __syncthreads();  // tile u has landed for every thread; every warp is done with tK
    // K tile u in fp16: the one buffer, or (recompute 2) the rank's u-th
    uint8_t* const ktile = tK + (a.recompute == 2 ? 2 * u * SLOT : 0);
    to_f16<DH, TP>(ring + (u % RING) * SLOT, ktile, tid, nthr);
    __syncthreads();
    issue(u + RING);
    if (!rows_warp) continue;
    const int t0 = u * TP, nt = min(TP, n - t0);
    scores(ktile, t0);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = 32 * wp + 8 * jj + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + (e & 1) < nt) mx[e >> 1] = fmaxf(mx[e >> 1], sf[jj][e]);
      if (!recompute) {
        *reinterpret_cast<float2*>(sS + row0 * lay.rs + t0 + c) = make_float2(sf[jj][0], sf[jj][1]);
        *reinterpret_cast<float2*>(sS + row1 * lay.rs + t0 + c) = make_float2(sf[jj][2], sf[jj][3]);
      }
    }
  }

  // ---- the row max over the cluster: the quad's, then every warp's of
  // every rank, read at once through distributed shared memory ----
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
  if (rows_warp && t == 0) {
    sMaxW[wp][row0] = mx[0];
    sMaxW[wp][row1] = mx[1];
  }
  if (!online) cluster_sync();  // every block's maxima are written (and every block has started)
  if (tid < rp && !online) {
    uint32_t pm[2 * MAX_CLUSTER];
#pragma unroll
    for (int k = 0; k < 2 * MAX_CLUSTER; ++k)
      pm[k] = k < 2 * static_cast<int>(ncl) ? ld_peer(peer_addr(&sMaxW[k & 1][tid], k >> 1))
                                            : __float_as_uint(NEG);
    float m = NEG;
#pragma unroll
    for (int k = 0; k < 2 * MAX_CLUSTER; ++k) m = fmaxf(m, __uint_as_float(pm[k]));
    sM[tid] = m;
  }
  __syncthreads();
  // the rows' max: the cluster's, or (online) this warp's running one over
  // its positions so far, NEG before any
  float m[2] = {online ? NEG : sM[row0], online ? NEG : sM[row1]};
  // fp p @ V: e = 2^(s log2 e - m log2 e) on the MUFU unit (relative 2^-22);
  // the codes of quant_pv take expf, the plain version's exp to the bit
  float ml2[2] = {__fmul_rn(m[0], LOG2E), __fmul_rn(m[1], LOG2E)};

  // ---- second pass: exp-weights once a (row, position), p @ V on the tensor cores ----
  acc_t o[NJD][4];
#pragma unroll
  for (int j = 0; j < NJD; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0;
  float den[2] = {0.f, 0.f};
  for (int i = 0; i < ntile; ++i) {
    const int t0 = i * TP, nt = min(TP, n - t0);
    if (paired) {  // K and V of tile i: items u, u + 1
      landed(u, 2);
      __syncthreads();
      to_f16<DH, TP>(ring + (u % RING) * SLOT, tK, tid, nthr);
      prep_v(ring + ((u + 1) % RING) * SLOT);
      __syncthreads();
      issue(u + RING);
      issue(u + RING + 1);
      u += 2;
      if (!rows_warp) continue;
      scores(tK, t0);
    } else {  // V of tile i; its scores from the kept K tile i, or from shared memory
      landed(u, 1);
      __syncthreads();
      prep_v(ring + (u % RING) * SLOT);
      __syncthreads();
      issue(u + RING);
      u += 1;
      if (!rows_warp) continue;
      if (recompute) {
        scores(tK + 2 * i * SLOT, t0);
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int c = 32 * wp + 8 * jj + 2 * t;
          const float2 s0 = *reinterpret_cast<const float2*>(sS + row0 * lay.rs + t0 + c);
          const float2 s1 = *reinterpret_cast<const float2*>(sS + row1 * lay.rs + t0 + c);
          sf[jj][0] = s0.x;
          sf[jj][1] = s0.y;
          sf[jj][2] = s1.x;
          sf[jj][3] = s1.y;
        }
      }
    }
    if (online) {  // the running max takes the tile's; the sums so far are rescaled to it
      float tm[2] = {NEG, NEG};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (32 * wp + 8 * jj + 2 * t + (e & 1) < nt) tm[e >> 1] = fmaxf(tm[e >> 1], sf[jj][e]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tm[h] = fmaxf(tm[h], __shfl_xor_sync(0xffffffffu, tm[h], 1));
        tm[h] = fmaxf(tm[h], __shfl_xor_sync(0xffffffffu, tm[h], 2));
        if (tm[h] > m[h]) {
          const float ml2n = __fmul_rn(tm[h], LOG2E);
          const float alpha = m[h] == NEG ? 0.f : ex2(__fsub_rn(ml2[h], ml2n));
          den[h] *= alpha;
#pragma unroll
          for (int jd = 0; jd < NJD; ++jd) {
            o[jd][2 * h] *= alpha;
            o[jd][2 * h + 1] *= alpha;
          }
          m[h] = tm[h];
          ml2[h] = ml2n;
        }
      }
    }
    // e = exp(s - m) at the valid positions, 0 past them; the tile's exp
    // sums, then the running ones (fewer large additions: a rank may take
    // thousands of positions)
    float x[4][4], dt[2] = {0.f, 0.f};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = 32 * wp + 8 * jj + 2 * t + (e & 1) < nt;
        if constexpr (QPV)
          x[jj][e] = valid ? expf(__fsub_rn(sf[jj][e], m[e >> 1])) : 0.f;
        else
          x[jj][e] = valid ? ex2(fmaf(sf[jj][e], LOG2E, -ml2[e >> 1])) : 0.f;
        dt[e >> 1] += x[jj][e];
      }
    den[0] += dt[0];
    den[1] += dt[1];
    if constexpr (QPV) {
      // codes trunc(127 e + 0.5) (the product and the sum rounded one at a
      // time); A's k slots 4t .. 4t + 3 = n8 tiles 0 and 1, 16 + 4t .. = 2 and 3
      uint32_t c[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          c[jj][e] = static_cast<uint32_t>(__fadd_rn(__fmul_rn(x[jj][e], 127.f), 0.5f));
      const uint32_t pa[4] = {c[0][0] | c[0][1] << 8 | c[1][0] << 16 | c[1][1] << 24,
                              c[0][2] | c[0][3] << 8 | c[1][2] << 16 | c[1][3] << 24,
                              c[2][0] | c[2][1] << 8 | c[3][0] << 16 | c[3][1] << 24,
                              c[2][2] | c[2][3] << 8 | c[3][2] << 16 | c[3][3] << 24};
#pragma unroll
      for (int jd = 0; jd < NJD; ++jd) {
        const int d = 8 * jd + gq;  // the warp's 32 slots of V^T row d
        mma_s8(o[jd], pa, lds32(tV + swz<64>(d * 64 + 32 * wp) + 4 * t),
               lds32(tV + swz<64>(d * 64 + 32 * wp + 16) + 4 * t));
      }
    } else {
      uint32_t ph[2][4], pl[2][4];  // positions 32 wp + 16 kk .. + 15: n8 tiles 2kk, 2kk + 1
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // r: row gq (even r) or gq + 8, n8 tile 2kk + r / 2
          const float x0 = __fmul_rn(x[2 * kk + (r >> 1)][2 * (r & 1)], PSCALE);
          const float x1 = __fmul_rn(x[2 * kk + (r >> 1)][2 * (r & 1) + 1], PSCALE);
          const __half2 hi = __floats2half2_rn(x0, x1);
          const float2 back = __half22float2(hi);
          const __half2 lo = __floats2half2_rn(__fsub_rn(x0, back.x), __fsub_rn(x1, back.y));
          ph[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
          pl[kk][r] = *reinterpret_cast<const uint32_t*>(&lo);
        }
#pragma unroll
      for (int jp = 0; jp < NJD / 2; ++jp) {  // dims 16 jp ..: the tile's sums, then the running ones
        float ot[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {  // V rows (positions) 32 wp + 16 kk .. + 15
          uint32_t vb[4];
          const int pos = 32 * wp + 16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7);
          ldsm_x4_t(vb, tV + chunk16<2 * DH>(pos, 2 * jp + (lane >> 4)));
          mma_f16(ot[0], ph[kk], vb[0], vb[1]);
          mma_f16(ot[0], pl[kk], vb[0], vb[1]);
          mma_f16(ot[1], ph[kk], vb[2], vb[3]);
          mma_f16(ot[1], pl[kk], vb[2], vb[3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[2 * jp][e] += ot[0][e];
          o[2 * jp + 1][e] += ot[1][e];
        }
      }
    }
  }
  if (!tma) cp_async_wait<0>();  // the stream's last groups are empty
  __syncthreads();               // the ring and the turned tiles are free

  // ---- the block's sums: the quad's exp sums, then the two warps' of a row tile ----
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    den[h] += __shfl_xor_sync(0xffffffffu, den[h], 1);
    den[h] += __shfl_xor_sync(0xffffffffu, den[h], 2);
  }
  acc_t* sO = reinterpret_cast<acc_t*>(smem);  // [rp][OS]
  if (rows_warp && wp == 1) {
#pragma unroll
    for (int jd = 0; jd < NJD; ++jd)
#pragma unroll
      for (int e = 0; e < 4; ++e) sO[(e < 2 ? row0 : row1) * OS + 8 * jd + 2 * t + (e & 1)] = o[jd][e];
    if (t == 0) {
      sDenW[row0] = den[0];
      sDenW[row1] = den[1];
      if (online) {  // (no peer reads the maxima in this mode)
        sMaxW[1][row0] = m[0];
        sMaxW[1][row1] = m[1];
      }
    }
  }
  __syncthreads();
  if (rows_warp && wp == 0) {
    // online: both warps' sums rescaled to the larger of their running maxima
    float w0[2] = {1.f, 1.f}, w1[2] = {1.f, 1.f};
    if (online) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m1 = sMaxW[1][h ? row1 : row0], mm = fmaxf(m[h], m1);
        w0[h] = m[h] == NEG ? 0.f : ex2(__fsub_rn(ml2[h], __fmul_rn(mm, LOG2E)));
        w1[h] = m1 == NEG ? 0.f : ex2(__fsub_rn(__fmul_rn(m1, LOG2E), __fmul_rn(mm, LOG2E)));
        if (t == 0) sM[h ? row1 : row0] = mm;
      }
    }
#pragma unroll
    for (int jd = 0; jd < NJD; ++jd)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc_t* so = sO + (e < 2 ? row0 : row1) * OS + 8 * jd + 2 * t + (e & 1);
        if constexpr (QPV)
          *so += o[jd][e];
        else
          *so = online ? fmaf(*so, w1[e >> 1], o[jd][e] * w0[e >> 1]) : *so + o[jd][e];
      }
    if (t == 0) {
      sDen[row0] = online ? __fadd_rn(den[0] * w0[0], sDenW[row0] * w1[0]) : __fadd_rn(den[0], sDenW[row0]);
      sDen[row1] = online ? __fadd_rn(den[1] * w0[1], sDenW[row1] * w1[1]) : __fadd_rn(den[1], sDenW[row1]);
    }
  }
  cluster_sync();  // every rank's sums are written

  // ---- rank r: rows r, r + C, ..: every rank's sums in rank order ----
  const int mine = rep > static_cast<int>(rank) ? (rep - 1 - static_cast<int>(rank)) / ncl + 1 : 0;
  if (tid < mine) {  // the rows' exp sums, every rank's loads issued first
    const int row = rank + ncl * tid;
    uint32_t pd[MAX_CLUSTER], pm[MAX_CLUSTER];
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k) {
      pd[k] = k < static_cast<int>(ncl) ? ld_peer(peer_addr(&sDen[row], k)) : 0u;
      pm[k] = k < static_cast<int>(ncl) && online ? ld_peer(peer_addr(&sM[row], k))
                                                   : __float_as_uint(NEG);
    }
    float mm = online ? NEG : sM[row], dn = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k) mm = fmaxf(mm, __uint_as_float(pm[k]));
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k) {  // online: rank k's sums rescaled to the slot's max
      const float mk = __uint_as_float(pm[k]);
      const float w = !online ? 1.f : mk == NEG ? 0.f : ex2(__fsub_rn(__fmul_rn(mk, LOG2E), __fmul_rn(mm, LOG2E)));
      sWt[tid][k] = w;
      dn = online ? fmaf(w, __uint_as_float(pd[k]), dn) : __fadd_rn(dn, __uint_as_float(pd[k]));
    }
    sDenT[tid] = dn;
  }
  __syncthreads();
  const float vs127 = a.scales[2], vsp = __fmul_rn(a.scales[1], 1.f / PSCALE);
  float* og = a.out + bg * rep * DH;
  for (int i = tid; i < mine * DH; i += nthr) {
    const int j = i / DH, row = rank + ncl * j, d = i % DH;
    uint32_t ps[MAX_CLUSTER];
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k)
      ps[k] = k < static_cast<int>(ncl) ? ld_peer(peer_addr(sO + row * OS + d, k)) : 0u;
    acc_t s = 0;
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k) {  // online: rank k's sums rescaled to the slot's max
      if constexpr (QPV)
        s += from_bits<acc_t>(ps[k]);
      else
        s = fmaf(sWt[j][k], from_bits<float>(ps[k]), s);
    }
    og[row * DH + d] = QPV ? __fmul_rn(static_cast<float>(s), __fdiv_rn(vs127, sDenT[j]))
                           : __fdiv_rn(__fmul_rn(static_cast<float>(s), vsp), sDenT[j]);
  }
  cluster_sync();  // no block leaves while another reads its shared memory
}

// What a kernel's launches have set so far, per device: the dynamic shared
// memory limit, and whether it may run in clusters of 16.
struct Sized {
  int smem[64];
  bool wide[64];
};

// The launch: grid (C, Hkv, B) in clusters of C, max(256, 64 ceil(rep / 16)) threads.
template <class Kernel>
int launch(Kernel kernel, Sized& sized, const Args& a, int B, int cluster, int dh, bool qpv,
           cudaStream_t st) {
  const int rp = 16 * ((a.rep + 15) / 16), threads = max(MIN_THREADS, 4 * rp);
  const Layout lay(dh, rp, a.chmax, qpv, a.recompute);
  if (lay.total > SMEM_LIMIT || threads > MAX_THREADS) return cudaErrorInvalidValue;
  CUtensorMap tk = {}, tv = {};
  if (a.tma) {  // K^T as (B Hkv Dh rows, Smax bytes), V as (B Hkv Smax rows, Dh bytes)
    int rc = tensor_map(&tk, a.kt, a.Smax, static_cast<uint64_t>(B) * a.Hkv * dh, TP, dh,
                        CU_TENSOR_MAP_SWIZZLE_NONE);
    if (!rc)
      rc = tensor_map(&tv, a.v, dh, static_cast<uint64_t>(B) * a.Hkv * a.Smax, dh, TP,
                      CU_TENSOR_MAP_SWIZZLE_NONE);
    if (rc) return rc;
  }
  int dev = 0;
  cudaGetDevice(&dev);
  if (lay.total > 48 * 1024 && lay.total > sized.smem[dev & 63]) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized.smem[dev & 63] = lay.total;
  }
  if (cluster > 8 && !sized.wide[dev & 63]) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized.wide[dev & 63] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, a.Hkv, B);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = lay.total;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, tk, tv, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rows

// K3's and K7's split kernels, with and without ALiBi; QPV: quant_pv
template <int DH, bool QPV>
__global__ void __launch_bounds__(rows::MAX_THREADS)
rows_attn_cluster(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                  const rows::Args a) {
  rows::core<DH, QPV, false>(tm_k, tm_v, a);
}

template <int DH, bool QPV>
__global__ void __launch_bounds__(rows::MAX_THREADS)
rows_attn_alibi_cluster(const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, const rows::Args a) {
  rows::core<DH, QPV, true>(tm_k, tm_v, a);
}

template <int DH, bool QPV>
int launch_mode(const rows::Args& a, int B, int cluster, cudaStream_t st) {
  if (a.slopes) {
    static rows::Sized sized_alibi = {};
    return rows::launch(rows_attn_alibi_cluster<DH, QPV>, sized_alibi, a, B, cluster, DH, QPV, st);
  }
  static rows::Sized sized = {};  // what its launches have set, per device
  return rows::launch(rows_attn_cluster<DH, QPV>, sized, a, B, cluster, DH, QPV, st);
}

}  // namespace

extern "C" {

// q (B, H, Dh) int8; kt (B, Hkv, Dh, Smax) int8; v (B, Hkv, Smax, Dh) int8;
// lengths (B,) int32 valid positions per slot, each in [1, Smax]; scales f32
// [qk_scale, v_scale, v_scale / 127] on the device; slopes (H,) f32 ALiBi
// slopes on the device, or null; out (B, H, Dh) f32.  Any H / Hkv up to 128.
// The caller's plan (ops/attention.py rows_plan): cluster (2, 4, 8 or 16)
// blocks a (slot, kv head), and with quant_pv recompute (the scores: 0 kept
// in shared memory; recomputed in a second pass from K streamed again, 1, or
// from the rank's K tiles kept in shared memory in fp16, 2); without
// quant_pv recompute is 0 (one pass against a running max).
int int8_decode_attention_rows(const void* q, const void* kt, const void* v, const void* lengths,
                               const void* scales, const void* slopes, void* out, int B, int H,
                               int Hkv, int Dh, int Smax, int quant_pv, int cluster, int recompute,
                               void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv || H / Hkv > rows::MAX_REP || Smax <= 0 || Smax % 4 ||
      (cluster != 2 && cluster != 4 && cluster != 8 && cluster != 16) || (Dh != 64 && Dh != 128) ||
      recompute < 0 || recompute > 2 || (recompute && !quant_pv))
    return cudaErrorInvalidValue;
  rows::Args a{static_cast<const int8_t*>(q), static_cast<const int8_t*>(kt),
               static_cast<const int8_t*>(v), static_cast<const int*>(lengths),
               static_cast<const float*>(scales), static_cast<const float*>(slopes),
               static_cast<float*>(out), Hkv, H / Hkv, Smax,
               ((Smax + cluster - 1) / cluster + rows::TP - 1) / rows::TP * rows::TP,
               recompute, Smax % 16 == 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 64)
    return quant_pv ? launch_mode<64, true>(a, B, cluster, st)
                    : launch_mode<64, false>(a, B, cluster, st);
  return quant_pv ? launch_mode<128, true>(a, B, cluster, st)
                  : launch_mode<128, false>(a, B, cluster, st);
}

}  // extern "C"
