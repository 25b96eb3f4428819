// The main loop shared by the W4A8 GEMMs K1 (w4a8_rp_gemm.cu), K9 and K10
// (w4a8_span_gemm.cu) and by the probe P1 (s8_gemm.cu), for Hopper (sm_90a).
// The fused decode kernels K4-K6 and K12's norm and requant entries
// (fused_gemv_sm90.cuh) run its TMA ring, wgmma wrappers, rowpair loader (K12:
// the span unpack) and descriptor cache in a kernel of their own, with codes
// they make in shared memory as the B operand; the prefill
// attention K2 (int8_prefill_attention.cu) takes its TMA, mbarrier and wgmma
// helpers.
//
//   acc[m, n] = sum_k x[m, k] * w8[k, n]   (exact int32)
//
// x is int8 (M, K), row-major, so already K-major for wgmma.  w8 is the int8
// weight matrix that a Loader makes from its own storage, read from device
// memory as it is: K1's rowpair nibbles, K9's span nibbles, P1's plain int8.
// The epilogue writes __fmul_rn(float(acc), alpha[n]) (+ __fadd_rn beta[n])
// as f32 (OUT_F32) or as __float2int_rn clamped to int8 (OUT_S8), or P1's
// float(acc) (OUT_RAW); a K split writes int32 partials that splitk_combine
// sums exactly and finishes the same way.
//
// A Loader with FP set (K10's, fp32 group scales and zeros) keeps its int32
// sums per group instead: one accumulator set per half (the two halves of a
// stage are two groups), which each span's first product writes (scale-d 0),
// and after a span's last stage (gs / HB stages) a flush into one fp32 sum
// per output, half 0's group then half 1's:
//   facc += s_g * (float(d_g) - z_g * rowsum_g(x)),
// with __fmul_rn / __fsub_rn / __fadd_rn.  The groups' fp32 scale and zero
// rows come by TMA on the span's last stage; the row sums from the producer
// warpgroup's three idle warps (dp4a of each x row of both boxes against
// 0x01010101, exact integers in any order), handed over on a third mbarrier
// a stage, so that the consumers keep their issue slots for the unpack and
// the flush.  A K split holds whole spans and writes fp32 partials, which
// splitk_combine adds in split order before the epilogue.  The flush reads
// the plane sums, so it waits for every product in flight: ptxas serialises
// the wgmmas if any instruction reads an accumulator register while one is
// in flight (C7514), even one of a finished second set, so a span's flush
// cannot overlap its successor's products in the same warpgroup.
//
// What bounds it: at prefill the int8 tensor-core rate and the unpack beside
// it, at decode the weight bytes.  The design:
//   * one block = a producer warpgroup, in which one thread issues TMA, and two
//     consumer warpgroups (setmaxnreg 40 / 232); a block owns 128 weight
//     columns (one 64-row wgmma tile a consumer warpgroup) and BM token rows;
//   * a ring of STAGES stages in dynamic shared memory, each filled by TMA and
//     signalled by an mbarrier (full, with the byte count; empty, one arrival
//     per consumer warp).  A stage holds 2 HB logical k as two halves: two x
//     boxes [BM][HB], swizzled HB bytes (64 or 32), at the k the Loader names
//     (K9's span layout takes its two nibble planes from two places of x),
//     SRC_ROWS rows of the weight storage as a box [SRC_ROWS][128 bytes]
//     swizzled 128 bytes, and for a SCALED Loader the int8 scale and zero rows
//     of each half's group;
//   * wgmma.mma_async m64nBMk32 s8.s8 -> s32 with the weights as the A operand
//     in registers and the x box as the B operand in shared memory: int8 wgmma
//     takes both operands K-major, and the weights are n-contiguous, so they
//     are turned into K-major A fragments in registers and never written back.
//     A thread of consumer warp w holds the fragment rows g and g + 8 (g = lane
//     / 4) of its warpgroup's 64-row tile, and they are the 2 columns of one
//     2-byte column pair; its k are 4t .. 4t + 3 and 16 + 4t .. + 3 (t = lane
//     % 4) of each 32-k step.  So per stage it loads the rows its k need of
//     that pair (16-bit shared loads), turns each 4 rows into 2 column words
//     (byte permutes), and the Loader unpacks them straight into fragments.
//     Fragments are built for one 32-k step of both halves at a time, in two
//     register sets: the tensor cores run one set while the next is built, and
//     each warpgroup runs on its own (no shared tile, no barrier between the
//     warpgroups).  The unpack, not the tensor cores, bounds a stage, and it
//     is done once per block and weight tile, so the prefill tile is as tall
//     as wgmma allows: N = BM = 256 token rows, 128 accumulators a thread.  Decode (BM = 16) and prefill
//     are one code path: the weights are always the 64-row side;
//   * the tile and the K split come from the caller (the plan in
//     ops/quant_matmul.py); a split takes whole stages.
//
// Everything here has internal linkage: each source is its own shared
// library, and the dynamic linker would merge weak symbols across them.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

enum Out { OUT_F32 = 0, OUT_S8 = 1, OUT_RAW = 2 };

constexpr int CONSUMERS = 256;  // two consumer warpgroups
constexpr int THREADS = 384;    // and the producer warpgroup
constexpr int BN = 128;         // weight columns a block owns

struct GemmArgs {
  const void* scales;  // group g at row g * srep of (G * srep, N), int8 (f32: FP); unused by P1
  const void* zeros;
  int srep, gs;
  int M, N, K;
  int nst;  // stages over all of K
  int sps;  // stages per split (blockIdx.z)
  const float* alpha;
  const float* beta;  // or null
  void* out;
  void* part;  // (splits, M, N) int32 (f32: FP) when K is split, else null
};

// ---- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// the 3-d form, for a map whose rows are two halves (tensor_map's `half`)
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// generic-proxy shared memory accesses before this, ordered before the async
// proxy's after it (wgmma's reads, TMA's writes)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving registers that the async wgmma reads or
// writes (fragments, accumulators) across its issue and its wait
template <class T, int N>
__device__ __forceinline__ void fence_regs(T (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// K-major operand in shared memory (an x box), rows of HB bytes swizzled HB
// bytes (128, 64 or 32), 8-row groups 8 HB bytes apart; LBO is unused for
// swizzled K-major
__device__ __forceinline__ uint64_t gmma_desc(const void* p, int hb) {
  const uint64_t addr = smem_u32(p);
  const uint64_t sbo = (8 * hb) >> 4;
  const uint64_t layout = hb == 128 ? 1 : hb == 64 ? 2 : 3;  // B128, B64, B32
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (sbo << 32) | (layout << 62);
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(int (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<48> {
  static __device__ __forceinline__ void mma(int (&d)[24], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(int (&d)[128], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// ---- the fragment helpers the Loaders use -------------------------------------

// Fragments of one 32-k step of both halves: a[h][i] is register i of half h
// (i: rows g / g + 8 at k 4t.., then at k 16 + 4t..).
typedef uint32_t Frags[2][4];

// The 2 bytes of column pair cp (0..63) in row r of a stage's weight rows: a
// TMA box [SRC_ROWS][128 bytes] swizzled 128 bytes (the 16-byte chunk index
// XORed with r % 8, so that the 4 lanes t, which read 4 rows of one pair,
// mostly hit different banks)
__device__ __forceinline__ uint32_t ldw(const uint8_t* rows, int r, int cp) {
  return *reinterpret_cast<const uint16_t*>(rows + r * 128 + ((((cp >> 3) ^ (r & 7)) << 4) |
                                                              ((cp & 7) << 1)));
}

// Rows r0, r0 + d1, r0 + d2, r0 + d3 of column pair cp: c[j] holds column j's
// bytes of the four rows, in that order.
__device__ __forceinline__ void quad(const uint8_t* rows, int cp, int r0, int d1, int d2, int d3,
                                     uint32_t (&c)[2]) {
  const uint32_t t01 = __byte_perm(ldw(rows, r0, cp), ldw(rows, r0 + d1, cp), 0x5410);
  const uint32_t t23 = __byte_perm(ldw(rows, r0 + d2, cp), ldw(rows, r0 + d3, cp), 0x5410);
  c[0] = __byte_perm(t01, t23, 0x6420);
  c[1] = __byte_perm(t01, t23, 0x7531);
}

// Column j of the pair is row g + 8 j: fragment registers j (k 4t..) and 2 + j
// (k 16 + 4t..).
__device__ __forceinline__ void put_col(uint32_t (&a)[4], int j, uint32_t k0, uint32_t k16) {
  a[j] = k0;
  a[2 + j] = k16;
}

// int8 (c - z) * s of the four codes in the low 16 bits of the two 16-bit
// lanes of e (bytes 0, 2 of the result) and o (bytes 1, 3).  Each lane holds
// 0x8000 + (c - z) * s in [0, 0xFFFF] (|(c - z) * s| <= 143 * 128), so the
// lanes never carry and each low byte is the int8 wrap of (c - z) * s.
__device__ __forceinline__ uint32_t deq4(uint32_t e, uint32_t o, uint32_t s, uint32_t bias) {
  return __byte_perm(e * s + bias, o * s + bias, 0x6240);
}

// Per column j of column pair cp of a stage's scale rows [4][BN] (row 2h: the
// scales of half h's group, row 2h + 1 its zeros): the sign-extended scale
// and the bias (0x8000 - z * s) in both 16-bit lanes.
__device__ __forceinline__ void col_scales(const uint8_t* scl, int h, int cp, uint32_t (&s)[2],
                                           uint32_t (&bias)[2]) {
  const uint32_t sw = *reinterpret_cast<const uint16_t*>(scl + 2 * h * BN + 2 * cp);
  const uint32_t zw = *reinterpret_cast<const uint16_t*>(scl + (2 * h + 1) * BN + 2 * cp);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int sj = static_cast<int8_t>(sw >> (8 * j)), zj = static_cast<int8_t>(zw >> (8 * j));
    s[j] = static_cast<uint32_t>(sj);
    bias[j] = static_cast<uint32_t>(0x8000 - zj * sj) * 0x10001u;
  }
}

// ---- the rowpair loader (K1, K4, K5) -------------------------------------------

// Rowpair weights: stage st is packed rows 64 st .. 64 st + 63, logical k
// 128 st .. 128 st + 127 in order (row r: k 2r low nibble, 2r + 1 high
// nibble, each the shifted code (c - 8) & 0xF); half h is x's k 128 st + 64 h
// .. + 63.  The 32-k step kk of half h is packed rows 32 h + 16 kk .. + 15,
// and a thread's k 4t .. 4t + 3 and 16 + 4t .. + 3 of it are rows 2t, 2t + 1
// and 8 + 2t, 9 + 2t: one permute of 4 rows gives both fragment words of
// each column.  QS scale rows per half: 1 when each 64-k half lies in one
// group (K1: groupsize % 64 == 0), 2 when each 32-k step has its own (K4,
// K5: any groupsize % 32 == 0).  Scale row r of a stage is the stage's rows
// 2r (scales) and 2r + 1 (zeros) of [4 QS][BN] bytes; it serves half r (QS
// 1) or the 32-k step r = 2 h + kk (QS 2).
template <int QS>
struct RowpairLoader {
  static constexpr int HB = 64, SRC_ROWS = 64;
  static constexpr bool SCALED = true, FP = false;
  struct Scales {
    uint32_t s[2 * QS][2], b[2 * QS][2];  // per scale row, per column of the pair
  };

  static __device__ __forceinline__ int x_k(const GemmArgs&, int st, int h) { return 128 * st + 64 * h; }
  // past K (a last stage of 64 k) the group is past the scale rows: TMA fills zeros
  static __device__ __forceinline__ int group(const GemmArgs& a, int st, int h) {
    return (128 * st + 64 * h) / a.gs;
  }

  static __device__ __forceinline__ void scales(const uint8_t* scl, int cp, Scales& sc) {
#pragma unroll
    for (int r = 0; r < 2 * QS; ++r) col_scales(scl, r, cp, sc.s[r], sc.b[r]);
  }

  // the column words c of a 32-k step (rows 2t, 2t + 1, 8 + 2t, 9 + 2t) ->
  // the fragment registers of one half, with scale row r
  static __device__ __forceinline__ void unpack(const uint32_t (&c)[2], const Scales& sc, int r,
                                                uint32_t (&a)[4]) {
    constexpr uint32_t M4 = 0x000F000F;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint32_t w = c[j] ^ 0x88888888u;  // codes c4 + 8 in 0..15
      // low nibbles: k 4t, 4t + 2, 16 + 4t, 16 + 4t + 2; high nibbles one further
      const uint32_t lo = deq4(w & M4, (w >> 8) & M4, sc.s[r][j], sc.b[r][j]);
      const uint32_t hi = deq4((w >> 4) & M4, (w >> 12) & M4, sc.s[r][j], sc.b[r][j]);
      put_col(a, j, __byte_perm(lo, hi, 0x5140), __byte_perm(lo, hi, 0x7362));
    }
  }

  // the swizzled offsets of column pair cp in even and odd rows (off[0],
  // off[1]): the four rows a thread reads of a step are 2t, 2t + 1, 8 + 2t,
  // 9 + 2t past a multiple of 16, so their row % 8 is 2t or 2t + 1 (ldw's
  // swizzle), and all other address terms are constant
  static __device__ __forceinline__ void pair_offsets(int cp, int t, uint32_t (&off)[2]) {
#pragma unroll
    for (int p = 0; p < 2; ++p) off[p] = (((cp >> 3) ^ (2 * t + p)) << 4) | ((cp & 7) << 1);
  }

  // the fragments of 32-k step kk from a thread's row base rows + 2t * 128
  // and its pair_offsets (K4 and K5 keep the offsets across their loop)
  static __device__ __forceinline__ void frags_at(const uint8_t* rows_t, const uint32_t (&off)[2],
                                                  const Scales& sc, int kk, Frags& a) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint8_t* b = rows_t + (32 * h + 16 * kk) * 128;
      auto ld = [&](int d) { return *reinterpret_cast<const uint16_t*>(b + d * 128 + off[d & 1]); };
      const uint32_t t01 = __byte_perm(ld(0), ld(1), 0x5410);
      const uint32_t t23 = __byte_perm(ld(8), ld(9), 0x5410);
      const uint32_t c[2] = {__byte_perm(t01, t23, 0x6420), __byte_perm(t01, t23, 0x7531)};
      unpack(c, sc, QS == 1 ? h : 2 * h + kk, a[h]);
    }
  }

  // frags_at for the loop of gemm_sm90 (K1), which passes cp and t
  static __device__ __forceinline__ void frags(const uint8_t* rows, const Scales& sc, int cp, int t,
                                               int kk, Frags& a) {
    uint32_t off[2];
    pair_offsets(cp, t, off);
    frags_at(rows + 2 * t * 128, off, sc, kk, a);
  }
};

// ---- the span loader (K9; K12's norm and requant entries take its unpack) ----------

// The span unpack: the column words of one 32-row step of span bytes, rows 4t
// .. 4t + 3 (c0) and 16 + 4t .. + 3 (c16), -> the fragments of both planes:
// half 0 from the high nibbles with scale (s_hi, b_hi), half 1 from the low
// nibbles with (s_lo, b_lo), each per column of the pair.
__device__ __forceinline__ void span_unpack(const uint32_t (&c0)[2], const uint32_t (&c16)[2],
                                            const uint32_t (&s_hi)[2], const uint32_t (&b_hi)[2],
                                            const uint32_t (&s_lo)[2], const uint32_t (&b_lo)[2],
                                            Frags& a) {
  constexpr uint32_t M4 = 0x000F000F;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    put_col(a[0], j, deq4((c0[j] >> 4) & M4, (c0[j] >> 12) & M4, s_hi[j], b_hi[j]),
            deq4((c16[j] >> 4) & M4, (c16[j] >> 12) & M4, s_hi[j], b_hi[j]));
    put_col(a[1], j, deq4(c0[j] & M4, (c0[j] >> 8) & M4, s_lo[j], b_lo[j]),
            deq4(c16[j] & M4, (c16[j] >> 8) & M4, s_lo[j], b_lo[j]));
  }
}

// Span layout, span = 2 * gs: packed row p = t * gs + r (span t, row r of its
// gs packed rows) holds in its high nibble the code of logical row
// t * span + r (group 2t) and in its low nibble the code of logical row
// t * span + gs + r (group 2t + 1).  Codes are unsigned 0..15 and the zeros
// are not shifted (the rowpair layout of K1 stores c - 8).
//
// K9's stage st: packed rows PR st .. PR st + PR - 1, inside span t at row
// r0 (PR = 64 when groupsize % 64 == 0, else 32: a stage lies inside one
// span).  Half 0 is the high plane, x's k 2 t gs + r0 .. + PR - 1 (group
// 2t); half 1 the low plane, gs further (group 2t + 1).  The 32-k step kk of
// both halves is packed rows 32 kk .. + 31, and a thread's k 4t .. 4t + 3
// and 16 + 4t .. + 3 are rows 32 kk + 4t .. and 32 kk + 16 + 4t ..: two
// permutes of 4 rows give both planes' fragment words of each column.
template <int PR>
struct SpanLoader {
  static constexpr int HB = PR, SRC_ROWS = PR;
  static constexpr bool SCALED = true, FP = false;
  struct Scales {
    uint32_t s[2][2], b[2][2];  // per plane, per column of the pair
  };

  static __device__ __forceinline__ int x_k(const GemmArgs& a, int st, int h) {
    const int p0 = PR * st, t = p0 / a.gs;
    return 2 * t * a.gs + (p0 - t * a.gs) + h * a.gs;
  }
  static __device__ __forceinline__ int group(const GemmArgs& a, int st, int h) {
    return 2 * (PR * st / a.gs) + h;
  }

  static __device__ __forceinline__ void scales(const uint8_t* scl, int cp, Scales& sc) {
    col_scales(scl, 0, cp, sc.s[0], sc.b[0]);
    col_scales(scl, 1, cp, sc.s[1], sc.b[1]);
  }

  static __device__ __forceinline__ void frags(const uint8_t* rows, const Scales& sc, int cp, int t,
                                               int kk, Frags& a) {
    uint32_t c0[2], c16[2];
    quad(rows, cp, 32 * kk + 4 * t, 1, 2, 3, c0);
    quad(rows, cp, 32 * kk + 16 + 4 * t, 1, 2, 3, c16);
    span_unpack(c0, c16, sc.s[0], sc.b[0], sc.s[1], sc.b[1], a);
  }
};

// ---- shared memory ------------------------------------------------------------

constexpr int round1k(int b) { return (b + 1023) / 1024 * 1024; }

template <class L, int BM, int STAGES>
struct Smem {
  static constexpr int A_HALF = BM * L::HB;                  // one x box
  static constexpr int W_OFF = round1k(2 * A_HALF);          // the weight rows
  static constexpr int W_BYTES = L::SRC_ROWS * BN;
  // scale and zero rows: int8 [s 0 | z 0 | s 1 | z 1][BN] of the halves'
  // groups every stage, or (FP) f32 [s 0 | s 1 | z 0 | z 1][BN] on a span's
  // last stage
  static constexpr int SCL_OFF = W_OFF + W_BYTES;
  static constexpr int SCL_BYTES = L::SCALED ? 4 * BN : L::FP ? 16 * BN : 0;
  static constexpr int CS_OFF = SCL_OFF + SCL_BYTES;         // FP: row sums [2][BM] f32
  static constexpr int STAGE = round1k(CS_OFF + (L::FP ? 8 * BM : 0));
  static constexpr int BAR_OFF = STAGES * STAGE;
  static constexpr int BARS = L::FP ? 3 : 2;                 // full, empty (and FP's row sums)
  static constexpr int TOTAL = BAR_OFF + BARS * STAGES * 8 + 1024;  // + alignment slack
  // bytes TMA brings per stage (FP: + SCL_BYTES on a span's last stage)
  static constexpr uint32_t TX = 2 * A_HALF + W_BYTES + (L::SCALED ? SCL_BYTES : 0);
  static_assert(TOTAL <= 232448, "shared memory");
};

// ---- the kernel -----------------------------------------------------------------

__device__ __forceinline__ float finish_f32(float acc, const GemmArgs& a, int n) {
  const float y = __fmul_rn(acc, a.alpha[n]);
  return a.beta ? __fadd_rn(y, a.beta[n]) : y;
}

template <int OUT>
__device__ __forceinline__ float finish(int acc, const GemmArgs& a, int n) {
  if constexpr (OUT == OUT_RAW) return __int2float_rn(acc);
  return finish_f32(static_cast<float>(acc), a, n);
}

__device__ __forceinline__ int8_t sat8(float y) {
  return static_cast<int8_t>(min(127, max(-128, __float2int_rn(y))));
}

// columns n and n + 1 of row m
template <int OUT>
__device__ __forceinline__ void store2(const GemmArgs& a, int m, int n, int v0, int v1) {
  const size_t o = (size_t)m * a.N + n;
  if (a.part) {
    *reinterpret_cast<int2*>(static_cast<int*>(a.part) + (size_t)blockIdx.z * a.M * a.N + o) =
        make_int2(v0, v1);
  } else if constexpr (OUT == OUT_S8) {
    char2 c;
    c.x = sat8(finish<OUT>(v0, a, n));
    c.y = sat8(finish<OUT>(v1, a, n + 1));
    *reinterpret_cast<char2*>(static_cast<int8_t*>(a.out) + o) = c;
  } else {
    *reinterpret_cast<float2*>(static_cast<float*>(a.out) + o) =
        make_float2(finish<OUT>(v0, a, n), finish<OUT>(v1, a, n + 1));
  }
}

// FP: the flush of a span's group sums (hi: half 0's group, lo: half 1's)
// into facc, in the reference's order, from the span's last stage's scale
// rows scl and row sums cs.  Accumulator e is column 2 cp + ((e >> 1) & 1) and
// token 8 (e >> 2) + 2t + (e & 1).
template <int BM>
__device__ __forceinline__ void fp_flush(const uint8_t* scl, const uint8_t* cs_b,
                                         const int (&hi)[BM / 2], const int (&lo)[BM / 2], int cp,
                                         int t, float (&facc)[BM / 2]) {
  const float* sz = reinterpret_cast<const float*>(scl);
  const float* cs = reinterpret_cast<const float*>(cs_b);
  float2 sc[2], zc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sc[h] = *reinterpret_cast<const float2*>(sz + h * BN + 2 * cp);
    zc[h] = *reinterpret_cast<const float2*>(sz + (2 + h) * BN + 2 * cp);
  }
#pragma unroll
  for (int j = 0; j < BM / 8; ++j) {
    const float2 r_hi = *reinterpret_cast<const float2*>(cs + 8 * j + 2 * t);
    const float2 r_lo = *reinterpret_cast<const float2*>(cs + BM + 8 * j + 2 * t);
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int e0 = 0; e0 < 2; ++e0) {
        const int e = 4 * j + 2 * k + e0;
        const float s_hi = k ? sc[0].y : sc[0].x, z_hi = k ? zc[0].y : zc[0].x;
        const float s_lo = k ? sc[1].y : sc[1].x, z_lo = k ? zc[1].y : zc[1].x;
        const float x_hi = e0 ? r_hi.y : r_hi.x, x_lo = e0 ? r_lo.y : r_lo.x;
        const float a = __fadd_rn(facc[e], __fmul_rn(s_hi, __fsub_rn(static_cast<float>(hi[e]),
                                                                     __fmul_rn(z_hi, x_hi))));
        facc[e] = __fadd_rn(a, __fmul_rn(s_lo, __fsub_rn(static_cast<float>(lo[e]), __fmul_rn(z_lo, x_lo))));
      }
  }
}

constexpr int RS_THREADS = THREADS - CONSUMERS - 32;  // FP: the producer warpgroup's row-sum warps

template <class L, int BM, int STAGES, int OUT>
__global__ void __launch_bounds__(THREADS, 1)
gemm_sm90(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
          const __grid_constant__ CUtensorMap tm_s, const __grid_constant__ CUtensorMap tm_z,
          const __grid_constant__ GemmArgs args) {
  using S = Smem<L, BM, STAGES>;
  constexpr int HB = L::HB, KK = HB / 32;  // 32-k steps per half
  constexpr int NA = BM / 2;                // accumulators a thread (a set)
  static_assert(BM % 16 == 0 && BM <= 256, "tile");
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte aligned by an offset from smem_raw, so that the compiler keeps
  // every access in the shared window (LDS; a pointer made from an integer
  // takes generic loads and 64-bit address arithmetic)
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* csfull = empty + STAGES;  // FP: a stage's row sums are written

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int st0 = blockIdx.z * args.sps;
  const int n_it = min(args.nst - st0, args.sps);
  const int spst = L::FP ? args.gs / HB : 0;  // FP: stages a span

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32 + (L::FP ? RS_THREADS : 0));
      if constexpr (L::FP) mbar_init(&csfull[s], RS_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CONSUMERS) {
      // ---- producer ----
      for (int i = 0, j = 0; i < n_it; ++i) {  // j: FP's stage of the span
        const int s = i % STAGES, st = st0 + i;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) + 1) & 1);
        uint8_t* base = smem + s * S::STAGE;
        const bool span_end = L::FP && j == spst - 1;
        mbar_expect_tx(&full[s], S::TX + (span_end ? S::SCL_BYTES : 0));
        tma_load_2d(base, &tm_x, &full[s], L::x_k(args, st, 0), m0);
        tma_load_2d(base + S::A_HALF, &tm_x, &full[s], L::x_k(args, st, 1), m0);
        tma_load_2d(base + S::W_OFF, &tm_w, &full[s], n0, L::SRC_ROWS * st);
        if constexpr (L::SCALED) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = L::group(args, st, h) * args.srep;
            tma_load_2d(base + S::SCL_OFF + 2 * h * BN, &tm_s, &full[s], n0, row);
            tma_load_2d(base + S::SCL_OFF + (2 * h + 1) * BN, &tm_z, &full[s], n0, row);
          }
        }
        if constexpr (L::FP) {
          if (span_end) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = L::group(args, st, h) * args.srep;
              tma_load_2d(base + S::SCL_OFF + h * BN * 4, &tm_s, &full[s], n0, row);
              tma_load_2d(base + S::SCL_OFF + (2 + h) * BN * 4, &tm_z, &full[s], n0, row);
            }
          }
          j = span_end ? 0 : j + 1;
        }
      }
    } else if constexpr (L::FP) {
      if (threadIdx.x >= CONSUMERS + 32) {
        // ---- row sums: pair p is row p % BM of x box p / BM ----
        constexpr int NP = (2 * BM + RS_THREADS - 1) / RS_THREADS;
        const int rs = threadIdx.x - CONSUMERS - 32;
        int sum[NP];
#pragma unroll
        for (int k = 0; k < NP; ++k) sum[k] = 0;
        for (int i = 0, j = 0; i < n_it; ++i, j = j == spst - 1 ? 0 : j + 1) {
          const int s = i % STAGES;
          mbar_wait(&full[s], (i / STAGES) & 1);
          uint8_t* base = smem + s * S::STAGE;
#pragma unroll
          for (int k = 0; k < NP; ++k) {
            const int p = rs + RS_THREADS * k;
            if (p < 2 * BM) {  // a swizzle permutes the 16-byte chunks inside a row only
              const uint4* row = reinterpret_cast<const uint4*>(base + p * HB);
#pragma unroll
              for (int c = 0; c < HB / 16; ++c) {
                const uint4 w = row[c];
                sum[k] = __dp4a(static_cast<int>(w.x), 0x01010101, sum[k]);
                sum[k] = __dp4a(static_cast<int>(w.y), 0x01010101, sum[k]);
                sum[k] = __dp4a(static_cast<int>(w.z), 0x01010101, sum[k]);
                sum[k] = __dp4a(static_cast<int>(w.w), 0x01010101, sum[k]);
              }
            }
          }
          if (j == spst - 1) {  // the span's last stage
            float* cs = reinterpret_cast<float*>(base + S::CS_OFF);
#pragma unroll
            for (int k = 0; k < NP; ++k) {
              const int p = rs + RS_THREADS * k;
              if (p < 2 * BM) cs[p] = static_cast<float>(sum[k]);  // exact: |sum| <= gs * 128
              sum[k] = 0;
            }
          }
          mbar_arrive(&csfull[s]);
          mbar_arrive(&empty[s]);
        }
      }
    }
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ct = threadIdx.x, wg = ct >> 7, warp = (ct >> 5) & 3, lane = ct & 31;
    const int g = lane >> 2, t = lane & 3;
    const int cp = 32 * wg + 8 * warp + g;  // this thread's column pair of the block's 64
    // the accumulators: the first product of the block (FP: of each span)
    // writes them (scale-d 0), so no other instruction defines them; one that
    // did inside the pipeline would make ptxas serialise the wgmmas.  FP: acc
    // holds half 0's group, acc_lo half 1's, facc the fp32 sum
    int acc[NA];
    int acc_lo[L::FP ? NA : 1];
    float facc[L::FP ? NA : 1];
    if constexpr (L::FP) {
#pragma unroll
      for (int e = 0; e < NA; ++e) facc[e] = 0.0f;
    }
    // two fragment sets (one per 32-k step of a 64-k half): the tensor cores read
    // one while the next is built; a 32-k half has one step and one set
    Frags fa[KK];

    for (int i = 0, j = 0; i < n_it; ++i) {  // j: FP's stage of the span
      const int s = i % STAGES;
      mbar_wait(&full[s], (i / STAGES) & 1);
      const uint8_t* xa = smem + s * S::STAGE;
      const uint8_t* rows = xa + S::W_OFF;
      typename L::Scales sc;
      L::scales(xa + S::SCL_OFF, cp, sc);
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        Frags& f = fa[kk];
        L::frags(rows, sc, cp, t, kk, f);
#pragma unroll
        for (int h = 0; h < 2; ++h) fence_regs(f[h]);
        fence_regs(acc);
        if constexpr (L::FP) fence_regs(acc_lo);
        wgmma_fence();
        if constexpr (L::FP) {
          const int scale_d = j != 0 || kk != 0;
          Wgmma<BM>::mma(acc, f[0], gmma_desc(xa + 32 * kk, HB), scale_d);
          Wgmma<BM>::mma(acc_lo, f[1], gmma_desc(xa + S::A_HALF + 32 * kk, HB), scale_d);
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            Wgmma<BM>::mma(acc, f[h], gmma_desc(xa + h * S::A_HALF + 32 * kk, HB), (i | kk | h) != 0);
        }
        wgmma_commit();
        wgmma_wait<KK - 1>();  // the step before is done: its fragment set is free
        fence_regs(acc);
        if constexpr (L::FP) fence_regs(acc_lo);
        // the last step of stage i - 1 is done: release its slot
        if (kk == 0 && i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % STAGES]);
      }
      if constexpr (L::FP) {
        if (j == spst - 1) {  // the span's products, then its flush (this slot's rows)
          wgmma_wait<0>();
          fence_regs(acc);
          fence_regs(acc_lo);
          mbar_wait(&csfull[s], (i / STAGES) & 1);
          fp_flush<BM>(xa + S::SCL_OFF, xa + S::CS_OFF, acc, acc_lo, cp, t, facc);
          j = 0;
        } else {
          ++j;
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // ---- epilogue: accumulator e is row g + 8 ((e >> 1) & 1), i.e. column
    // 2 cp + ((e >> 1) & 1), and token 8 (e >> 2) + 2t + (e & 1) ----
    const int n = n0 + 2 * cp;
    if (n < args.N) {
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int e0 = 0; e0 < 2; ++e0) {
          const int m = m0 + 8 * j + 2 * t + e0;
          if (m >= args.M) continue;
          if constexpr (L::FP) {  // the split's fp32 sums, or y = facc * alpha (+ beta)
            const float v0 = facc[4 * j + e0], v1 = facc[4 * j + 2 + e0];
            const size_t o = (size_t)m * args.N + n;
            if (args.part)
              *reinterpret_cast<float2*>(static_cast<float*>(args.part) +
                                         (size_t)blockIdx.z * args.M * args.N + o) = make_float2(v0, v1);
            else
              *reinterpret_cast<float2*>(static_cast<float*>(args.out) + o) =
                  make_float2(finish_f32(v0, args, n), finish_f32(v1, args, n + 1));
          } else {
            store2<OUT>(args, m, n, acc[4 * j + e0], acc[4 * j + 2 + e0]);
          }
        }
    }
  }
}

// Sums the splits' partials in split order (int32, exact; FP: fp32 with
// __fadd_rn) and finishes as the kernel.
template <int OUT, class L>
__global__ void splitk_combine(const GemmArgs a, int splits) {
  const size_t total = (size_t)a.M * a.N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int n = static_cast<int>(i % a.N);
  if constexpr (L::FP) {
    const float* part = static_cast<const float*>(a.part);
    float s = part[i];
    for (int z = 1; z < splits; ++z) s = __fadd_rn(s, part[z * total + i]);
    static_cast<float*>(a.out)[i] = finish_f32(s, a, n);
  } else {
    const int* part = static_cast<const int*>(a.part);
    int s = 0;
    for (int z = 0; z < splits; ++z) s += part[z * total + i];
    if constexpr (OUT == OUT_S8)
      static_cast<int8_t*>(a.out)[i] = sat8(finish<OUT>(s, a, n));
    else
      static_cast<float*>(a.out)[i] = finish<OUT>(s, a, n);
  }
}

// ---- host side: TMA descriptors and the launch -------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Descriptors cached by (pointer, shape, box, swizzle): the weights' are built
// once, an activation's whenever the allocator hands out a new address.
struct MapEntry {
  const void* ptr;
  uint64_t d0, d1, half;
  uint32_t b0, b1;
  int swizzle;
  bool f32;
  CUtensorMap map;
};
constexpr int MAP_SLOTS = 256;
MapEntry g_maps[MAP_SLOTS];
int g_map_count = 0, g_map_next = 0;
std::mutex g_map_mu;
EncodeTiledFn g_encode = nullptr;

// A 2-D uint8 tensor map over (d1 rows, d0 bytes a row), box b0 x b1; with
// `half`, a 3-D one that sees each row as two halves of `half` bytes (d0 = 2
// half), box b0 x 2 x b1: one box brings b0 bytes at the same place of both
// halves, side by side.  With f32, the elements are float32 (K10's scale
// rows) and d0, b0 and half count them.
int tensor_map(CUtensorMap* out, const void* p, uint64_t d0, uint64_t d1, uint32_t b0,
               uint32_t b1, CUtensorMapSwizzle swizzle, uint64_t half = 0, bool f32 = false) {
  std::lock_guard<std::mutex> lock(g_map_mu);
  for (int i = 0; i < g_map_count; ++i) {
    const MapEntry& e = g_maps[i];
    if (e.ptr == p && e.d0 == d0 && e.d1 == d1 && e.half == half && e.b0 == b0 && e.b1 == b1 &&
        e.swizzle == swizzle && e.f32 == f32) {
      *out = e.map;
      return 0;
    }
  }
  if (!g_encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess || !fn)
      return static_cast<int>(cudaErrorInvalidDeviceFunction);
    g_encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  const cuuint32_t rank = half ? 3 : 2;
  const uint64_t es = f32 ? 4 : 1;  // bytes an element
  const cuuint64_t dims2[2] = {d0, d1}, strides2[1] = {d0 * es};
  const cuuint64_t dims3[3] = {half, 2, d1}, strides3[2] = {half * es, d0 * es};
  const cuuint32_t box2[2] = {b0, b1}, box3[3] = {b0, 2, b1}, elem[3] = {1, 1, 1};
  MapEntry e{p, d0, d1, half, b0, b1, static_cast<int>(swizzle), f32, {}};
  if (g_encode(&e.map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_UINT8, rank,
               const_cast<void*>(p),
               half ? dims3 : dims2, half ? strides3 : strides2, half ? box3 : box2, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slot = g_map_count < MAP_SLOTS ? g_map_count++ : g_map_next++ % MAP_SLOTS;
  g_maps[slot] = e;
  *out = e.map;
  return 0;
}

// x (M, K) int8 and the weight storage (w_rows, N) bytes; args.part set when
// `splits` > 1 (FP: whole spans a split).  Returns a cudaError_t.
template <class L, int BM, int STAGES, int OUT>
int launch_gemm(const void* x, const void* w, int w_rows, const GemmArgs& a, int splits,
                cudaStream_t st) {
  using S = Smem<L, BM, STAGES>;
  CUtensorMap tx, tw;
  int rc = tensor_map(&tx, x, a.K, a.M, L::HB, BM,
                      L::HB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B);
  if (!rc) rc = tensor_map(&tw, w, a.N, w_rows, BN, L::SRC_ROWS, CU_TENSOR_MAP_SWIZZLE_128B);
  CUtensorMap ts = tw, tz = tw;  // unused unless the Loader is SCALED or FP
  if ((L::SCALED || L::FP) && !rc) {
    const int rows = a.K / a.gs * a.srep;
    rc = tensor_map(&ts, a.scales, a.N, rows, BN, 1, CU_TENSOR_MAP_SWIZZLE_NONE, 0, L::FP);
    if (!rc) rc = tensor_map(&tz, a.zeros, a.N, rows, BN, 1, CU_TENSOR_MAP_SWIZZLE_NONE, 0, L::FP);
  }
  if (rc) return rc;
  auto kernel = gemm_sm90<L, BM, STAGES, OUT>;
  static uint64_t sized = 0;  // devices whose limit is raised, one set per instantiation
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(sized >> (dev & 63) & 1)) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::TOTAL);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized |= 1ull << (dev & 63);
  }
  const dim3 grid((a.M + BM - 1) / BM, (a.N + BN - 1) / BN, splits);
  kernel<<<grid, THREADS, S::TOTAL, st>>>(tx, tw, ts, tz, a);
  if (splits > 1) {
    const size_t total = (size_t)a.M * a.N;
    splitk_combine<OUT, L><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(a, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
