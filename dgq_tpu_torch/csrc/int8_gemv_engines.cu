// P2: the raw int8 GEMV engines at decode shapes, for Hopper (sm_90a).
//
// Replaces the TPU kernels of scripts/probe_gemv_engines.py, which set the
// TPU's matrix unit (MXU) against its vector unit (VPU) at M = 8:
//   mxu_gemv  (body _mxu_kernel): out (M, N) int32 = x (M, K) . w (K, N), here
//             on the tensor cores (wgmma m64n8k32, the M <= 8 rows as the B
//             operand);
//   vpu_gemv  (body _vpu_kernel): row 0 only, here on the CUDA cores (__dp4a);
//   mix_gemv  (body kern): one launch whose first nm / 128 blocks run the
//             tensor-core engine on columns [0, nm) for every row and whose
//             other blocks run the dp4a engine on [nm, N) for row 0: two
//             outputs, (M, nm) and (1, N - nm), as the TPU kernel's.
// Hopper's tensor cores and CUDA cores are the analogues of the MXU and the
// VPU: the engines the fused decode kernels K4-K6 and K12 choose between.
//
// What bounds them on this card: the K * N weight bytes (50.3 MB at K 4096,
// N 12288) over the 3.35 TB/s of device memory; the operations are 8 (or 1)
// rows' worth.  So they run the loop of K4-K6 and K12 (fused_gemv_sm90.cuh)
// with nothing else in it: no nibble unpack, no codes to make, no epilogue,
// which makes P2 the streaming ceiling those kernels are held to.  A block
// owns 128 columns; one producer thread keeps four stages of 128 rows x 128
// columns (16 KB, one TMA box) in flight on mbarriers, and brings x's rows
// over the block's K range by TMA as the codes; the tensor-core engine's
// two consumer warpgroups turn each stage into wgmma A fragments on the way
// from shared memory (FusedS8); the dp4a engine is a block of its own over
// the same ring (dp4a_block: eight warps read whole 128-byte rows and
// transpose each 4 x 4 bytes).  K is split over blockIdx.y by the plan
// (probe_gemv_engines.gemv_plan) so that every SM streams about the same
// bytes: the int32 partials go to a scratch that a second small kernel sums
// in split order (no block adds into another's sums: no atomics, no zeroed
// output; the sums are exact), launched as the engines' programmatic
// dependent so that its launch overlaps their tail.  The mix is one kernel
// whose branch on blockIdx.x is uniform over each block.  Measured on the
// card, every engine streams the weights about as fast as the library's
// int8 GEMM (torch._int_mm) reads the same bytes.

#include "raw_gemv.cuh"

namespace {

constexpr int G_BM = 8;  // the token-row tile: wgmma N = 8
constexpr int G_MXU = 0, G_VPU = 1, G_MIX = 2;

__device__ __forceinline__ uint32_t lds_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
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

// One block of the dp4a engine: row 0 of x against the weight columns [col0
// + 128 tile, + 128) over the stages [sps blockIdx.y, + sps) of K; the
// block's int32 sums go to a.out_s32[128 tile + c], or its split's row of
// a.part.  The shared memory is the fused body's (fused_smem): x's rows by
// TMA as its code boxes (code_offset), then a ring of FusedS8's stages (128
// rows x 128 columns, swizzled 128 bytes) that one producer thread keeps
// full on mbarriers.  Consumer warp w takes rows 16 w .. + 15 of each stage
// and lane l columns 4 (l % 4) .. + 3 of the 16-byte chunk l / 4: a warp's
// load is one whole 128-byte row (no bank conflict under the swizzle), and
// each 4 rows x 4 columns become 4 column words of 4 k for __dp4a.  A warp
// releases a stage's slot with an arrive whose address depends on its sums
// (plus `zero`, 0 at run time): ptxas may issue an arrive ahead of plain
// instructions, with the loads they consume in flight (the race the wgmma
// engine's release avoids), but not ahead of the values its address needs.
__device__ __forceinline__ void dp4a_block(const CUtensorMap& tm_w, const CUtensorMap& tm_x,
                                           const FusedArgs& a, int tile, int col0, int zero) {
  using L = FusedS8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* codes = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* ring = codes + static_cast<size_t>(G_BM) * 128 * a.sps;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + F_RING * L::STAGE);
  uint64_t* empty = full + F_RING;
  uint64_t* coded = empty + F_RING;
  const int n0 = BN * tile;
  const int st0 = blockIdx.y * a.sps, n_it = min(a.nst - st0, a.sps);
  const int klen = 128 * n_it;

  if (threadIdx.x == 0) {
    for (int s = 0; s < F_RING; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], F_CONSUMERS / 32);
    }
    mbar_init(coded, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= F_CONSUMERS) {
    // ---- producer: x's rows over the block's K range, then the stages ----
    if (threadIdx.x != F_CONSUMERS) return;
    mbar_expect_tx(coded, G_BM * klen);
    for (int h = 0; h < klen / 64; ++h)
      tma_load_2d(codes + h * G_BM * F_HB, &tm_x, coded, 128 * st0 + 64 * h, 0);
    for (int i = 0; i < n_it; ++i) {
      const int s = i % F_RING;
      if (i >= F_RING) mbar_wait(&empty[s], ((i / F_RING) + 1) & 1);
      mbar_expect_tx(&full[s], L::STAGE);
      tma_load_2d(ring + s * L::STAGE, &tm_w, &full[s], col0 + n0, 128 * (st0 + i));
    }
    return;
  }

  // ---- consumers ----
  const int ct = threadIdx.x, w = ct >> 5, lane = ct & 31;
  const uint32_t ring_s = smem_u32(ring), codes_s = smem_u32(codes);
  const uint32_t col = 4 * (lane & 3), chunk = lane >> 2;
  int acc[4] = {0, 0, 0, 0};
  mbar_wait(coded, 0);
  for (int i = 0; i < n_it; ++i) {
    const int s = i % F_RING;
    mbar_wait(&full[s], (i / F_RING) & 1);
    const uint32_t base = ring_s + s * L::STAGE;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = 16 * w + 4 * u;
      const int xw = static_cast<int>(lds_u32(codes_s + code_offset<G_BM>(0, 128 * i + r)));
      uint32_t v[4], c[4];
#pragma unroll
      for (int d = 0; d < 4; ++d)
        v[d] = lds_u32(base + (r + d) * 128 + (((chunk ^ ((r + d) & 7)) << 4) | col));
      transpose4x4(v[0], v[1], v[2], v[3], c);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = __dp4a(static_cast<int>(c[j]), xw, acc[j]);
    }
    if (lane == 0) {
      const uint32_t bar = smem_u32(&empty[s]) + ((acc[0] | acc[1] | acc[2] | acc[3]) & zero);
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
    }
  }
  consumers_sync();  // every consumer is past the ring, whose stages have all come
  int* red = reinterpret_cast<int*>(ring);  // [8 warps][128 columns]
  *reinterpret_cast<int4*>(red + w * BN + 4 * lane) = make_int4(acc[0], acc[1], acc[2], acc[3]);
  consumers_sync();
  const int n = n0 + ct;
  if (ct >= BN || n >= a.N) return;
  int sum = 0;
#pragma unroll
  for (int k = 0; k < F_CONSUMERS / 32; ++k) sum += red[k * BN + ct];
  if (a.part)
    a.part[static_cast<size_t>(blockIdx.y) * a.N + n] = sum;
  else
    a.out_s32[n] = sum;
}

// Each kernel takes the tensor-core engine's arguments `am` (columns [0,
// nm)) and the dp4a engine's `av` (columns [nm, N) of the weight map, row 0).
__global__ void __launch_bounds__(F_THREADS, 3)
mxu_gemv_sm90(const __grid_constant__ CUtensorMap tm_w, const __grid_constant__ CUtensorMap tm_x,
              const __grid_constant__ FusedArgs am, const __grid_constant__ FusedArgs, int, int,
              int) {
  fused_gemv_body<F_RAW, G_BM, FusedS8>(tm_w, tm_x, tm_x, tm_x, tm_x, am);
  let_dependents_start();
}

__global__ void __launch_bounds__(F_THREADS, 3)
vpu_gemv_sm90(const __grid_constant__ CUtensorMap tm_w, const __grid_constant__ CUtensorMap tm_x,
              const __grid_constant__ FusedArgs, const __grid_constant__ FusedArgs av, int, int,
              int zero) {
  dp4a_block(tm_w, tm_x, av, blockIdx.x, 0, zero);
  let_dependents_start();
}

__global__ void __launch_bounds__(F_THREADS, 3)
mix_gemv_sm90(const __grid_constant__ CUtensorMap tm_w, const __grid_constant__ CUtensorMap tm_x,
              const __grid_constant__ FusedArgs am, const __grid_constant__ FusedArgs av,
              int mtiles, int nm, int zero) {
  if (static_cast<int>(blockIdx.x) < mtiles)
    fused_gemv_body<F_RAW, G_BM, FusedS8>(tm_w, tm_x, tm_x, tm_x, tm_x, am);
  else
    dp4a_block(tm_w, tm_x, av, blockIdx.x - mtiles, nm, zero);
  let_dependents_start();
}

struct GemvCall {
  const void* x;
  const void* w;
  int* om;  // (M, nm) int32
  int* ov;  // (1, N - nm) int32
  int* pm;  // their (splits, ...) int32 partials when K is split, else null
  int* pv;
  int M, N, K, nm, splits, sps;
};

// The plan's arguments, checked: M 1..8 rows, N and nm on the 128-column
// tile, K on the 128-k stage, 1 to 8 splits of sps stages each that cover K
// exactly, a partials scratch for each engine that has columns exactly when
// K is split, and the shared memory a block may take.
bool gemv_args_ok(const GemvCall& g) {
  const bool split = g.splits > 1;
  return g.M >= 1 && g.M <= G_BM && g.N > 0 && g.N % BN == 0 && g.K > 0 && g.K % 128 == 0 &&
         g.nm >= 0 && g.nm <= g.N && g.nm % BN == 0 && g.splits >= 1 && g.splits <= 8 &&
         g.sps >= 1 && g.splits * g.sps == g.K / 128 &&
         (g.nm == 0 || split == (g.pm != nullptr)) &&
         (g.nm == g.N || split == (g.pv != nullptr)) &&
         fused_smem(G_BM, g.sps, FusedS8::STAGE) <= F_SMEM_LIMIT;
}

int launch(int engine, const GemvCall& g, void* stream) {
  if (!gemv_args_ok(g)) return F_BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using Fn = void (*)(CUtensorMap, CUtensorMap, FusedArgs, FusedArgs, int, int, int);
  const Fn kernels[3] = {mxu_gemv_sm90, vpu_gemv_sm90, mix_gemv_sm90};
  const Fn kernel = kernels[engine];
  CUtensorMap tw, tx;
  int rc = tensor_map(&tw, g.w, g.N, g.K, BN, 128, CU_TENSOR_MAP_SWIZZLE_128B);
  // the vpu engine reads row 0 only
  if (!rc)
    rc = tensor_map(&tx, g.x, g.K, engine == G_VPU ? 1 : g.M, F_HB, G_BM,
                    CU_TENSOR_MAP_SWIZZLE_64B);
  if (rc) return rc;
  FusedArgs am{}, av{};
  am.M = g.M;
  am.N = g.nm;
  am.K = g.K;
  am.nst = g.K / 128;
  am.sps = g.sps;
  am.out_s32 = g.om;
  am.part = g.pm;
  av = am;
  av.N = g.N - g.nm;
  av.out_s32 = g.ov;
  av.part = g.pv;
  // kernels whose limits are raised, per device (P2 runs on one)
  static uint64_t sized[3] = {0, 0, 0};
  // the last argument, 0, is the dp4a blocks' `zero`
  return launch_raw_gemv(kernel, sized[engine], dim3(g.N / BN, g.splits, 1),
                         fused_smem(G_BM, g.sps, FusedS8::STAGE), st, g.pm, g.om, g.M * g.nm,
                         g.pv, g.ov, g.N - g.nm, g.splits, tw, tx, am, av, g.nm / BN, g.nm, 0);
}

}  // namespace

extern "C" {

// x (M, K) int8 with M <= 8, w (K, N) int8 row-major, out (M, N) int32; the
// plan: `splits` (at most 8) K splits of `sps` stages of 128 k, part (splits,
// M, N) int32 scratch when splits > 1 (summed by a second launch), else
// null.  N % 128 == 0, K % 128 == 0.  Returns a cudaError_t, or -1 when it
// rejects its arguments.
int mxu_gemv(const void* x, const void* w, void* out, void* part, int M, int N, int K,
             int splits, int sps, void* stream) {
  const GemvCall g{x, w, static_cast<int*>(out), nullptr, static_cast<int*>(part), nullptr,
                   M, N, K, N, splits, sps};
  return launch(G_MXU, g, stream);
}

// row 0 of x (., K) int8, w (K, N) int8, out (1, N) int32; part (splits, 1,
// N) int32 when splits > 1.
int vpu_gemv(const void* x, const void* w, void* out, void* part, int N, int K, int splits,
             int sps, void* stream) {
  const GemvCall g{x, w, nullptr, static_cast<int*>(out), nullptr, static_cast<int*>(part),
                   1, N, K, 0, splits, sps};
  return launch(G_VPU, g, stream);
}

// om (M, nm) int32 from columns [0, nm) of w for every row, ov (1, N - nm)
// int32 from row 0 and the rest; pm (splits, M, nm) and pv (splits, 1, N -
// nm) int32 when splits > 1.  nm % 128 == 0.
int mix_gemv(const void* x, const void* w, void* om, void* ov, void* pm, void* pv, int M, int N,
             int K, int nm, int splits, int sps, void* stream) {
  const GemvCall g{x, w, static_cast<int*>(om), static_cast<int*>(ov), static_cast<int*>(pm),
                   static_cast<int*>(pv), M, N, K, nm, splits, sps};
  return launch(G_MIX, g, stream);
}

}  // extern "C"
