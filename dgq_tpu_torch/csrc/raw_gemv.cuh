// The raw GEMVs' launch and K splits, for Hopper (sm_90a): the probes P2
// (int8_gemv_engines.cu) and P3 (s4_gemv.cu) run fused_gemv_sm90.cuh's body
// in its raw mode F_RAW (x's int8 rows by TMA as the codes, int32 sums out)
// in clusters of one block, and sum the int32 partials of a K split with a
// second small kernel in split order (exact; no atomics, no zeroed output),
// launched as their programmatic dependent so that its launch overlaps
// their tail.
//
// Everything here has internal linkage (w4a8_gemm_sm90.cuh's rule).

#pragma once

#include "fused_gemv_sm90.cuh"

namespace {

// The sum of a K split's partials is launched as the raw GEMVs' dependent
// (programmatic stream serialisation): each block lets it start once its
// first thread is done, and it waits for the whole grid and its memory.
__device__ __forceinline__ void let_dependents_start() {
  if (threadIdx.x == 0) asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// The K splits: outputs 4 i .. 4 i + 3 of `total` (a multiple of 4)
// summed over the int32 partials (splits <= 8, total) of `part` in split
// order, every split's load issued before the first add.
__device__ __forceinline__ void sum_splits(const int* part, int* out, size_t total, int splits,
                                           size_t i) {
  int4 v[8];
#pragma unroll
  for (int z = 0; z < 8; ++z)
    v[z] = z < splits ? reinterpret_cast<const int4*>(part + z * total)[i] : make_int4(0, 0, 0, 0);
  int4 s = v[0];
#pragma unroll
  for (int z = 1; z < 8; ++z) {
    s.x += v[z].x;
    s.y += v[z].y;
    s.z += v[z].z;
    s.w += v[z].w;
  }
  reinterpret_cast<int4*>(out)[i] = s;
}

// the K splits of two outputs: tm sums (P2's tensor-core engine, P3), then
// tv (P2's dp4a engine; 0 for P3), each a multiple of 4, 4 a thread
__global__ void gemv_engines_combine(const int* pm, int* om, int tm, const int* pv, int* ov,
                                     int tv, int splits) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the engines' grid and its stores
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < static_cast<size_t>(tm / 4))
    sum_splits(pm, om, tm, splits, i);
  else if (i < static_cast<size_t>(tm / 4 + tv / 4))
    sum_splits(pv, ov, tv, splits, i - tm / 4);
}

// Launches a raw GEMV `kernel` (its arguments `args`) over `grid` blocks of
// F_THREADS with `smem` bytes of dynamic shared memory, in clusters of one
// block (the body's cluster barriers), then, when K is split (`splits` >
// 1), gemv_engines_combine over (pm, om, tm, pv, ov, tv) as its
// programmatic dependent.  `sized`: the devices whose limits are raised for
// `kernel`.  Returns a cudaError_t.
template <class Kernel, class... Args>
int launch_raw_gemv(Kernel kernel, uint64_t& sized, dim3 grid, size_t smem, cudaStream_t st,
                    const int* pm, int* om, int tm, const int* pv, int* ov, int tv, int splits,
                    Args... args) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(sized >> (dev & 63) & 1)) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(F_SMEM_LIMIT));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized |= 1ull << (dev & 63);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(F_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (splits > 1) {
    cudaLaunchConfig_t cc = {};
    cc.gridDim = dim3(static_cast<unsigned>((tm / 4 + tv / 4 + 255) / 256), 1, 1);
    cc.blockDim = dim3(256, 1, 1);
    cc.stream = st;
    cudaLaunchAttribute pdl[1];
    pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    pdl[0].val.programmaticStreamSerializationAllowed = 1;
    cc.attrs = pdl;
    cc.numAttrs = 1;
    const cudaError_t ec =
        cudaLaunchKernelEx(&cc, gemv_engines_combine, pm, om, tm, pv, ov, tv, splits);
    if (ec != cudaSuccess) return static_cast<int>(ec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
