// Pieces shared by the probe kernels P2 and P3 (int8_gemv_engines.cu,
// s4_gemv.cu) and K10 (w4a8_span_gemm.cu): the s8 tensor-core step, the byte
// transpose that turns n-contiguous weight rows into the k-contiguous columns
// mma.sync reads, the sign extension of packed nibbles, and the skinny
// (M <= 16) GEMV bodies on the tensor cores and on the CUDA cores.
//
// Everything here has internal linkage: each source is its own shared
// library, and the dynamic linker would merge weak symbols across them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) { return *reinterpret_cast<const uint32_t*>(p); }

// 32-bit word q of a 16-byte vector (q known at compile time after unrolling)
__device__ __forceinline__ uint32_t u4_word(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// rows r0..r3 of 4 bytes (4 columns each) -> c[j] = the 4 rows' bytes of column j
__device__ __forceinline__ void transpose4x4(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3,
                                             uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t2 = __byte_perm(r0, r1, 0x7362), t3 = __byte_perm(r2, r3, 0x7362);
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

// the low / high nibbles of the 4 bytes of w, each sign-extended to an int8 lane
__device__ __forceinline__ uint32_t lo_s4(uint32_t w) {
  return __vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ uint32_t hi_s4(uint32_t w) {
  return __vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// ---- skinny GEMV: out (M, cols) int32 = x (M, K) int8 . W (K, cols), M <= 16 ----
//
// A block takes 64 columns of W and walks its share of K, [kb, ke), in chunks
// of 128 rows.  Each of its 128 threads loads one unit per chunk, 4 rows of
// 16 columns, and turns it into 16 column words of 4 k values
// (transpose4x4); the next chunk's unit is loaded into registers while the
// current one is consumed.  When K is split over blocks (gridDim.y > 1, so
// that enough loads are in flight to stream the weights), each block adds
// its int32 sums into the zeroed output with atomicAdd: integer sums, so
// the result is exact in any order.

enum WMode { W_S8 = 0, W_S4_PAIRS = 1, W_S4_HALVES = 2 };

constexpr int SK_BN = 64, SK_BK = 128, SK_THREADS = 128;
constexpr int SK_LDS = SK_BK + 16;  // shared row stride: 36 words, conflict-free fragments

// The unit of thread (kr, cg) of block `blk` at chunk k0, in one of three weight formats:
//   W_S8        W (K, ldw) int8; the unit is 16 bytes of each row at column 64 blk + 16 cg.
//   W_S4_PAIRS  bytes (K, ldw); W[k, 2j] = low nibble of byte j, W[k, 2j+1] = its high
//               nibble (XLA's int4 packing).  8 bytes of each row give 16 columns.
//   W_S4_HALVES bytes (K, ldw); each `bn` columns of W are [low nibbles | high nibbles] of
//               their bn/2 bytes (an in-kernel int8 -> int4 bitcast of a (K, bn/2) block
//               whose rows pair up, then reshape(K, bn)).  8 bytes of each row give 8
//               columns of the low half and the 8 columns bn/2 further on.
template <int MODE>
struct Unit {
  static constexpr int WORDS = MODE == W_S8 ? 4 : 2;  // 32-bit words per row
  uint32_t raw[4][WORDS];

  __device__ __forceinline__ void fetch(const uint8_t* __restrict__ w, size_t ldw, int k,
                                        int blk, int cg) {
    const uint8_t* p = w + (size_t)k * ldw + (MODE == W_S8 ? blk * 64 + cg * 16 : blk * 32 + cg * 8);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (MODE == W_S8) {
        const uint4 v = *reinterpret_cast<const uint4*>(p + i * ldw);
        raw[i][0] = v.x; raw[i][1] = v.y; raw[i][2] = v.z; raw[i][3] = v.w;
      } else {
        const uint2 v = *reinterpret_cast<const uint2*>(p + i * ldw);
        raw[i][0] = v.x; raw[i][1] = v.y;
      }
    }
  }

  // word q (4 columns) of row i, as int8 lanes
  __device__ __forceinline__ uint32_t word(int i, int q) const {
    if constexpr (MODE == W_S8) {
      return raw[i][q];
    } else if constexpr (MODE == W_S4_PAIRS) {
      const uint32_t u = raw[i][q >> 1];
      return __byte_perm(lo_s4(u), hi_s4(u), (q & 1) ? 0x7362 : 0x5140);
    } else {
      const uint32_t u = raw[i][q & 1];
      return (q < 2) ? lo_s4(u) : hi_s4(u);
    }
  }

  // the block's tile column (0..63) of word q's first column
  __device__ __forceinline__ static int tile_col(int cg, int q) {
    if constexpr (MODE == W_S4_HALVES) return (q < 2 ? 0 : 32) + cg * 8 + (q & 1) * 4;
    return cg * 16 + q * 4;
  }

  // the four column words (4 k values each) of word position q
  __device__ __forceinline__ void columns(int q, uint32_t (&c)[4]) const {
    transpose4x4(word(0, q), word(1, q), word(2, q), word(3, q), c);
  }
};

// output column of tile column c of block blk (W_S4_HALVES: `bn` columns per bitcast block)
template <int MODE>
__device__ __forceinline__ int out_col(int blk, int c, int bn) {
  if constexpr (MODE == W_S4_HALVES) {
    const int half = bn / 2, jb = blk * 32;
    const int base = (jb / half) * bn + jb % half;
    return c < 32 ? base + c : base + half + (c - 32);
  }
  return blk * SK_BN + c;
}

struct SkinnySmem {
  int8_t a[16 * SK_LDS];     // x chunk, rows past M zero
  int8_t b[SK_BN * SK_LDS];  // weight chunk [column][k]
};

// this block's rows [kb, ke) of K: split gridDim.y ways in whole chunks
__device__ __forceinline__ void k_range(int K, int& kb, int& ke) {
  const int chunks = K / SK_BK, z = blockIdx.y, nz = gridDim.y;
  kb = chunks * z / nz * SK_BK;
  ke = chunks * (z + 1) / nz * SK_BK;
}

__device__ __forceinline__ void put(int* p, int v) {
  if (gridDim.y > 1)
    atomicAdd(p, v);
  else
    *p = v;
}

// Tensor cores: mma.sync m16n8k32 with x as the A operand.  For M <= 8 the
// fragment registers of rows 8-15 are zero and those rows are never stored.
template <int MODE>
__device__ __forceinline__ void skinny_mma_block(const int8_t* __restrict__ x, int M, int K,
                                                 const uint8_t* __restrict__ w, size_t ldw,
                                                 int blk, int bn, int* __restrict__ out, int ldo,
                                                 SkinnySmem& sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kr = tid >> 2, cg = tid & 3;         // weight unit: rows 4 kr.., column group cg
  const int xr = tid >> 3, xc = (tid & 7) * 16;  // x chunk: 16 rows of 8 x 16 bytes
  const bool lower = M > 8;
  Unit<MODE> u;
  uint4 xa = make_uint4(0, 0, 0, 0);
  int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
  int kb, ke;
  k_range(K, kb, ke);

  u.fetch(w, ldw, kb + 4 * kr, blk, cg);
  if (xr < M) xa = *reinterpret_cast<const uint4*>(x + (size_t)xr * K + kb + xc);
  for (int k0 = kb; k0 < ke; k0 += SK_BK) {
    *reinterpret_cast<uint4*>(sm.a + xr * SK_LDS + xc) = xa;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t c[4];
      u.columns(q, c);
      const int c0 = Unit<MODE>::tile_col(cg, q);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(sm.b + (c0 + j) * SK_LDS + 4 * kr) = c[j];
    }
    __syncthreads();
    if (k0 + SK_BK < ke) {  // next chunk into registers while this one is consumed
      u.fetch(w, ldw, k0 + SK_BK + 4 * kr, blk, cg);
      if (xr < M) xa = *reinterpret_cast<const uint4*>(x + (size_t)xr * K + k0 + SK_BK + xc);
    }
#pragma unroll
    for (int kk = 0; kk < SK_BK; kk += 32) {
      const int8_t* pa = sm.a + g * SK_LDS + kk + t * 4;
      const uint32_t a[4] = {ld32(pa), lower ? ld32(pa + 8 * SK_LDS) : 0u, ld32(pa + 16),
                             lower ? ld32(pa + 8 * SK_LDS + 16) : 0u};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int8_t* pb = sm.b + (warp * 16 + j * 8 + g) * SK_LDS + kk + t * 4;
        const uint32_t b[2] = {ld32(pb), ld32(pb + 16)};
        mma_s8(acc[j], a, b);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + (e >> 1) * 8;
      if (row < M)
        put(out + (size_t)row * ldo + out_col<MODE>(blk, warp * 16 + j * 8 + t * 2 + (e & 1), bn),
            acc[j][e]);
    }
}

// CUDA cores: row 0 of x against int8 W with __dp4a, no shared weight tile:
// each thread keeps 16 column sums over its rows, reduced over the block.
__device__ __forceinline__ void skinny_dp4a_block(const int8_t* __restrict__ x, int K,
                                                  const uint8_t* __restrict__ w, size_t ldw,
                                                  int blk, int* __restrict__ out,
                                                  int (&red)[SK_THREADS / 32][SK_BN]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kr = tid >> 2, cg = tid & 3;
  Unit<W_S8> u;
  int acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0;
  int kb, ke;
  k_range(K, kb, ke);
  u.fetch(w, ldw, kb + 4 * kr, blk, cg);
  for (int k0 = kb; k0 < ke; k0 += SK_BK) {
    const int xw = static_cast<int>(ld32(x + k0 + 4 * kr));
    Unit<W_S8> cur = u;
    if (k0 + SK_BK < ke) u.fetch(w, ldw, k0 + SK_BK + 4 * kr, blk, cg);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t c[4];
      cur.columns(q, c);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[q * 4 + j] = __dp4a(static_cast<int>(c[j]), xw, acc[q * 4 + j]);
    }
  }
  // sum over kr: lanes 4 apart in the warp, then the block's 4 warps
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  }
  if (lane < 4) {
#pragma unroll
    for (int i = 0; i < 16; ++i) red[warp][cg * 16 + i] = acc[i];
  }
  __syncthreads();
  if (tid < SK_BN) {
    int s = 0;
#pragma unroll
    for (int wi = 0; wi < SK_THREADS / 32; ++wi) s += red[wi][tid];
    put(out + blk * SK_BN + tid, s);
  }
}

}  // namespace
