// Helpers shared by the AED decode steps (aed_step.cuh) and the Qwen3
// steps (qwen_common.cuh): bf16 rounding, warp and block reductions, the
// row chunking of an attention, the halves of a chained launch and of a
// cluster barrier, and the launch itself.
#pragma once

#include <algorithm>
#include <utility>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace aed {

constexpr int kBlock = 128;      // quantization block
constexpr int kHd = 64;          // AED head width
constexpr int kLnThreads = 1024;

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum (or max) over the block; every thread gets the result. `red` holds
// one float per warp. Ends with a barrier, so `red` may be reused.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = lane < nwarps ? red[lane] : (kMax ? -INFINITY : 0.f);
  r = kMax ? warp_max(r) : warp_sum(r);
  __syncthreads();
  return r;
}

// Internal linkage: each library keeps its own copy of the launch, which
// calls the CUDA runtime that library links.
namespace {

__device__ __forceinline__ void grid_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }
__device__ __forceinline__ void grid_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
// The two halves of a cluster barrier: every block of the cluster has
// started once the wait returns (before any distributed shared memory access).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory"); }

// Row chunks of an attention over `rows` cached rows: at least min_rows a
// chunk, at most max_chunks (the chunk count depends on the row count alone).
__host__ __device__ __forceinline__ int attn_chunks(int rows, int min_rows, int max_chunks) {
  const int c = (rows + min_rows - 1) / min_rows;
  return c < 1 ? 1 : (c > max_chunks ? max_chunks : c);
}

// The rows a chunk of an attention takes: [r0, r1) of `rows`, in `splits`
// chunks of ceil(rows / splits).
__device__ __forceinline__ void chunk_rows(int rows, int splits, int c, int* r0, int* r1) {
  const int len = (rows + splits - 1) / splits;
  *r0 = min(rows, c * len);
  *r1 = min(rows, *r0 + len);
}

// cudaLaunchKernelEx with the chain attribute (pdl) and a cluster of
// `cluster` blocks along x (0: none).
template <typename... Exp, typename... Act>
cudaError_t launch(void (*kernel)(Exp...), dim3 grid, dim3 block, size_t smem, cudaStream_t st,
                   int pdl, int cluster, Act&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attrs[2];
  int n = 0;
  if (pdl) {
    attrs[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attrs[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  if (cluster > 0) {
    attrs[n].id = cudaLaunchAttributeClusterDimension;
    attrs[n].val.clusterDim.x = cluster;
    attrs[n].val.clusterDim.y = 1;
    attrs[n].val.clusterDim.z = 1;
    ++n;
  }
  cfg.attrs = attrs;
  cfg.numAttrs = n;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Act>(args)...);
}

}  // namespace

}  // namespace aed
