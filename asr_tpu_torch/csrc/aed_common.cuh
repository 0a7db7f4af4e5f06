// Device helpers shared by the AED decode-step kernels (fused_aed_step.cu,
// batch 1, and fused_aed_multi.cu, B slots) and the Qwen3 step
// (fused_decode.cu): bf16 rounding, warp and block reductions, the 128 x 128
// int8 tile load and dot of the q8 matvec, the 64-wide head-row dot products
// and loads of the attention kernels, the row chunking of an attention and
// the split-K sum of the tied head. Both AED kernels round and sum in the
// same order through these, so one slot of the multi-slot step computes what
// the batch-1 step computes for it.
#pragma once

#include <algorithm>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace aed {

constexpr int kBlock = 128;      // quantization block and matvec column slab
constexpr int kHd = 64;          // head width
constexpr int kMaxSplits = 8;    // row chunks per head in an attention
constexpr int kMvThreads = 128;  // matvec block: 4 warps, one 128 x 128 int8 tile
constexpr int kAttnThreads = 256;
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

// The q8 matvec's tile: a block of 4 warps owns one 128 x 128 int8 tile.
// Warp w takes rows [32 w, 32 w + 32); lane (rl, cl) = (lane / 8, lane % 8)
// holds the 16 columns [16 cl, 16 cl + 16) of rows 32 w + rl + 4 i, i < 8:
// 8 loads of 16 bytes, all issued before the first is used.
__device__ __forceinline__ void load_tile(const int8_t* w, int ldw, int row0, int slab, int q_rows,
                                          int4 (&q)[8]) {
  const int lane = threadIdx.x & 31;
  const int8_t* wp = w + (size_t)(row0 + q_rows) * ldw + slab + (lane & 7) * 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) q[i] = __ldg(reinterpret_cast<const int4*>(wp + (size_t)(4 * i) * ldw));
}

// acc[j] = sum over the warp's 32 rows r of xb[r] * q[r, 16 cl + j], summed
// over the four row phases (lanes 8 apart): every lane of a column group
// ends with the warp's sums for its 16 columns. xb holds the tile's 128
// inputs, already rounded to bf16.
__device__ __forceinline__ void tile_dot(const int4 (&q)[8], const float* xb, int r0,
                                         float (&acc)[16]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float xv = xb[r0 + 4 * i];
    const int words[4] = {q[i].x, q[i].y, q[i].z, q[i].w};
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        // byte u, sign-extended
        const float qv = (float)((int)((unsigned)words[t] << (24 - 8 * u)) >> 24);
        acc[4 * t + u] = fmaf(xv, qv, acc[4 * t + u]);
      }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 8);
    acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 16);
  }
}

// bf16(q_s) . bf16(row) over one 64-wide head row, loaded 16 bytes at a time.
__device__ __forceinline__ float row_dot(const float* row, const float* qs) {
  float a = 0.f;
#pragma unroll
  for (int c = 0; c < kHd / 4; ++c) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row) + c);
    a = fmaf(qs[4 * c], bf16r(v.x), a);
    a = fmaf(qs[4 * c + 1], bf16r(v.y), a);
    a = fmaf(qs[4 * c + 2], bf16r(v.z), a);
    a = fmaf(qs[4 * c + 3], bf16r(v.w), a);
  }
  return a;
}

__device__ __forceinline__ float row_dot(const __nv_bfloat16* row, const float* qs) {
  float a = 0.f;
#pragma unroll
  for (int c = 0; c < kHd / 8; ++c) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row) + c);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 v = __bfloat1622float2(p[t]);
      a = fmaf(qs[8 * c + 2 * t], v.x, a);
      a = fmaf(qs[8 * c + 2 * t + 1], v.y, a);
    }
  }
  return a;
}

// Four consecutive values of a row, rounded to bf16.
__device__ __forceinline__ float4 load4(const float* p) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(bf16r(v.x), bf16r(v.y), bf16r(v.z), bf16r(v.w));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

// Row chunks per head: at least 64 rows a chunk, at most kMaxSplits chunks.
__host__ __device__ __forceinline__ int splits_for(int rows) {
  const int s = (rows + 63) / 64;
  return s < 1 ? 1 : (s > kMaxSplits ? kMaxSplits : s);
}

// The rows a chunk of an attention takes: [r0, r1) of `rows`, in `splits`
// chunks of ceil(rows / splits).
__device__ __forceinline__ void chunk_rows(int rows, int splits, int c, int* r0, int* r1) {
  const int len = (rows + splits - 1) / splits;
  *r0 = min(rows, c * len);
  *r1 = min(rows, *r0 + len);
}

// logits = sum_b part[b, :]: the tied head's split-K partials summed.
__global__ void head_reduce(const float* __restrict__ part, int nb, float* __restrict__ logits,
                            int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float a = 0.f;
  for (int b = 0; b < nb; ++b) a += part[(size_t)b * n + i];
  logits[i] = a;
}

}  // namespace aed
