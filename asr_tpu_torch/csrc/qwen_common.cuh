// Device helpers shared by the Qwen3 decode-step kernels (fused_decode.cu,
// batch 1, and fused_decode_multi.cu, B slots): the matvec input staging,
// the q/k/v rebuild (sum of the q|k|v partials, per-head RMSNorm, RoPE), the
// two attention passes of one (kv head, row chunk) and the residual +
// RMSNorm of one row. Both kernels run every slot's arithmetic through
// these, in the same order, so a slot of the multi-slot step computes what
// the batch-1 step computes for it alone.
//
// Split-K partials are addressed as part[b * kb_stride + column]: the batch-1
// kernel keeps one row a K-block (kb_stride = the row width), the multi-slot
// kernel B rows a K-block (kb_stride = B x the row width, the slot's row
// picked by offsetting `part`).
#pragma once

#include "aed_common.cuh"

namespace qwen {

using namespace aed;

constexpr int kQHd = 128;  // Qwen3 head width

// The stacked weights of a step (wh, h_s, h_zs null without the head).
struct Weights {
  const float *in_s, *post_s, *qn_s, *kn_s, *fn_s;
  const int8_t *wq, *wo, *wgu, *wd, *wh;
  const float *qkv_s, *qkv_zs, *o_s, *o_zs, *gu_s, *gu_zs, *dn_s, *dn_zs, *h_s, *h_zs;
};

inline Weights make_weights(const void* in_s, const void* post_s, const void* qn_s,
                            const void* kn_s, const void* fn_s, const void* wq, const void* qkv_s,
                            const void* qkv_zs, const void* wo, const void* o_s, const void* o_zs,
                            const void* wgu, const void* gu_s, const void* gu_zs, const void* wd,
                            const void* dn_s, const void* dn_zs, const void* wh, const void* h_s,
                            const void* h_zs) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  return Weights{f(in_s),   f(post_s), f(qn_s),  f(kn_s),   f(fn_s),  i8(wq),   i8(wo),
                 i8(wgu),   i8(wd),    i8(wh),   f(qkv_s),  f(qkv_zs), f(o_s),  f(o_zs),
                 f(gu_s),   f(gu_zs),  f(dn_s),  f(dn_zs),  f(h_s),   f(h_zs)};
}

// Input k of a matvec whose 128-row block is being staged.
//   kIn 0: sum over nx vectors xs[t * ldx + k] (attention chunk contexts);
//   kIn 1: SiLU(g) * u with g, u summed over nx gate|up partial rows
//          xs[t * ldx + k] and xs[t * ldx + f + k].
template <int kIn>
__device__ __forceinline__ float mv_input(const float* xs, int nx, size_t ldx, int f, int k) {
  if (kIn == 0) {
    float v = 0.f;
    for (int t = 0; t < nx; ++t) v += __ldg(xs + (size_t)t * ldx + k);
    return v;
  }
  float g = 0.f, u = 0.f;
  for (int t = 0; t < nx; ++t) {
    g += __ldg(xs + (size_t)t * ldx + k);
    u += __ldg(xs + (size_t)t * ldx + f + k);
  }
  return g / (1.f + expf(-g)) * u;
}

// xres = xin (when given), else xres + sum_b part[b * kb_stride + :];
// y = xres * rsqrt(mean(xres^2) + eps) * w, over one row of d values. Every
// thread of the block calls it; xsm holds d floats of shared memory.
__device__ __forceinline__ void resid_rms_row(float* __restrict__ xres,
                                              const float* __restrict__ xin,
                                              const float* __restrict__ part, int nb,
                                              size_t kb_stride, const float* __restrict__ w,
                                              float* __restrict__ y, int d, float eps, float* xsm,
                                              float* red) {
  float sq = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    float v;
    if (xin != nullptr) {
      v = xin[i];
    } else {
      float a = 0.f;
      for (int b = 0; b < nb; ++b) a += part[(size_t)b * kb_stride + i];
      v = xres[i] + a;
    }
    xres[i] = v;
    xsm[i] = v;
    sq += v * v;
  }
  const float r = rsqrtf(block_reduce<false>(sq, red) / d + eps);
  for (int i = threadIdx.x; i < d; i += blockDim.x) y[i] = xsm[i] * r * w[i];
}

// The vectors of kv head h, rebuilt from the q|k|v partials (nb K-blocks):
// for each of its G q heads, qf = RoPE(RMSNorm(q)) * 128^-0.5 and qs =
// bf16(qf); with `fresh`, kf = RoPE(RMSNorm(k)) and vf = v. Every thread of
// the block calls it (it synchronises); threads < 128 own one column each.
template <int G>
__device__ void head_vectors(const float* part, int nb, size_t kb_stride, int qd, int kvw, int h,
                             const float* qn, const float* kn, const float* cosr,
                             const float* sinr, float eps, bool fresh, float (*qs)[kQHd],
                             float (*qf)[kQHd], float* kf, float* vf, float* red) {
  const int tid = threadIdx.x;
  const bool mine = tid < kQHd;
  float qv[G], kv = 0.f;
  if (mine) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float a = 0.f;
      for (int b = 0; b < nb; ++b) a += part[(size_t)b * kb_stride + (h * G + g) * kQHd + tid];
      qv[g] = a;
    }
    if (fresh) {
      float a = 0.f, c = 0.f;
      for (int b = 0; b < nb; ++b) {
        a += part[(size_t)b * kb_stride + qd + h * kQHd + tid];
        c += part[(size_t)b * kb_stride + qd + kvw + h * kQHd + tid];
      }
      kv = a;
      vf[tid] = c;
    }
  }
  // RMSNorm over each 128-wide head
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float ss = block_reduce<false>(mine ? qv[g] * qv[g] : 0.f, red);
    if (mine) qv[g] = qv[g] * rsqrtf(ss / kQHd + eps) * qn[tid];
  }
  if (fresh) {
    const float ss = block_reduce<false>(mine ? kv * kv : 0.f, red);
    if (mine) kv = kv * rsqrtf(ss / kQHd + eps) * kn[tid];
  }
  // RoPE (rotate_half: [-x[64:], x[:64]]) needs the other half's value.
  if (mine) {
#pragma unroll
    for (int g = 0; g < G; ++g) qf[g][tid] = qv[g];
    if (fresh) kf[tid] = kv;
  }
  __syncthreads();
  const float scale = 0.088388347648318440f;  // 128 ** -0.5
  float qr[G], kr = 0.f;
  if (mine) {
    const float c = cosr[tid], s = sinr[tid];
    const int other = tid < kQHd / 2 ? tid + kQHd / 2 : tid - kQHd / 2;
    const float sign = tid < kQHd / 2 ? -1.f : 1.f;
#pragma unroll
    for (int g = 0; g < G; ++g) qr[g] = (qv[g] * c + sign * qf[g][other] * s) * scale;
    if (fresh) kr = kv * c + sign * kf[other] * s;
  }
  __syncthreads();
  if (mine) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      qf[g][tid] = qr[g];
      qs[g][tid] = bf16r(qr[g]);
    }
    if (fresh) kf[tid] = kr;
  }
  __syncthreads();
}

// a[g] = qs[g] . row over one 128-wide head row (bf16 values, or floats
// rounded to bf16), loaded 16 bytes at a time.
template <int G>
__device__ __forceinline__ void row_dots(const float* row, float (*qs)[kQHd], float* a) {
#pragma unroll
  for (int g = 0; g < G; ++g) a[g] = 0.f;
#pragma unroll 8
  for (int c = 0; c < kQHd / 4; ++c) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row) + c);
    const float w[4] = {bf16r(v.x), bf16r(v.y), bf16r(v.z), bf16r(v.w)};
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[g] = fmaf(qs[g][4 * c + e], w[e], a[g]);
  }
}

template <int G>
__device__ __forceinline__ void row_dots(const __nv_bfloat16* row, float (*qs)[kQHd],
                                         float* a) {
#pragma unroll
  for (int g = 0; g < G; ++g) a[g] = 0.f;
#pragma unroll 4
  for (int c = 0; c < kQHd / 8; ++c) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row) + c);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 v = __bfloat1622float2(p[t]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        a[g] = fmaf(qs[g][8 * c + 2 * t], v.x, a[g]);
        a[g] = fmaf(qs[g][8 * c + 2 * t + 1], v.y, a[g]);
      }
    }
  }
}

// Pass 1 of chunk c of kv head h: scores the cached rows [r0, r1) of
// `rows` (kc and vc point at the first attended row, row stride kvw) for
// the G q heads into sc[qh * ld_sc + j], and leaves each q head's max and
// sum of exp(score - max) in stats[(qh * splits + c) * 2 + {0, 1}]. Chunk 0
// also scores the fresh row, in f32, as row `rows`, and (with `write`)
// writes it into the caches there. Every thread of the block calls it.
template <typename T, int G>
__device__ __forceinline__ void attn_scores_chunk(
    const float* __restrict__ part, int nb, size_t kb_stride, int qd, int kvw, int h,
    const float* __restrict__ qn, const float* __restrict__ kn, const float* __restrict__ cosr,
    const float* __restrict__ sinr, float eps, T* __restrict__ kc, T* __restrict__ vc, int rows,
    bool write, int splits, int c, float* __restrict__ sc, int ld_sc,
    float* __restrict__ stats) {
  __shared__ float qs[G][kQHd], qf[G][kQHd], kf[kQHd], vf[kQHd];
  __shared__ float red[32];
  const int tid = threadIdx.x;
  const bool fresh = c == 0;
  head_vectors<G>(part, nb, kb_stride, qd, kvw, h, qn, kn, cosr, sinr, eps, fresh, qs, qf, kf, vf,
                  red);
  if (fresh && write && tid < kQHd) {
    store(kc + (size_t)rows * kvw + h * kQHd + tid, kf[tid]);
    store(vc + (size_t)rows * kvw + h * kQHd + tid, vf[tid]);
  }
  int r0, r1;
  chunk_rows(rows, splits, c, &r0, &r1);
  float m[G];
#pragma unroll
  for (int g = 0; g < G; ++g) m[g] = -INFINITY;
  for (int j = r0 + tid; j < r1; j += blockDim.x) {
    float a[G];
    row_dots<G>(kc + (size_t)j * kvw + h * kQHd, qs, a);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sc[(size_t)(h * G + g) * ld_sc + j] = a[g];
      m[g] = fmaxf(m[g], a[g]);
    }
  }
  float snew[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    snew[g] = 0.f;
    if (fresh) {
      for (int i = 0; i < kQHd; ++i) snew[g] = fmaf(qf[g][i], kf[i], snew[g]);
      if (tid == 0) sc[(size_t)(h * G + g) * ld_sc + rows] = snew[g];
      m[g] = fmaxf(m[g], snew[g]);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float mg = block_reduce<true>(m[g], red);
    float l = 0.f;
    for (int j = r0 + tid; j < r1; j += blockDim.x) l += expf(sc[(size_t)(h * G + g) * ld_sc + j] - mg);
    if (fresh && tid == 0) l += expf(snew[g] - mg);
    l = block_reduce<false>(l, red);
    if (tid == 0) {
      stats[((h * G + g) * splits + c) * 2] = mg;
      stats[((h * G + g) * splits + c) * 2 + 1] = l;
    }
  }
}

// Pass 2 of chunk c of kv head h: with each q head's max M and sum S over
// every chunk, writes ctx[c * ld_ctx + qh * 128 + :] = sum over the chunk's
// rows of bf16(exp(s - M) / S) * bf16(v); chunk 0 adds the fresh row's p * v
// in f32 (v rebuilt from the partials). vc points at the first attended row.
template <typename T, int G>
__device__ __forceinline__ void attn_pv_chunk(const float* __restrict__ part, int nb,
                                              size_t kb_stride, int qd, int kvw, int h,
                                              const T* __restrict__ vc, int rows, int splits, int c,
                                              const float* __restrict__ sc, int ld_sc,
                                              const float* __restrict__ stats,
                                              float* __restrict__ ctx, int ld_ctx) {
  __shared__ float vf[kQHd];
  __shared__ float pv[kAttnThreads / 32][G][kQHd];
  const int tid = threadIdx.x;
  const bool fresh = c == 0;
  if (fresh && tid < kQHd) {
    float a = 0.f;
    for (int b = 0; b < nb; ++b) a += part[(size_t)b * kb_stride + qd + kvw + h * kQHd + tid];
    vf[tid] = a;
  }
  float big[G], sum[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float* st = stats + (size_t)(h * G + g) * splits * 2;
    big[g] = -INFINITY;
    for (int i = 0; i < splits; ++i) big[g] = fmaxf(big[g], st[2 * i]);
    sum[g] = 0.f;
    for (int i = 0; i < splits; ++i)
      if (st[2 * i + 1] > 0.f) sum[g] += st[2 * i + 1] * expf(st[2 * i] - big[g]);
  }
  int r0, r1;
  chunk_rows(rows, splits, c, &r0, &r1);
  // 8 groups of 32 threads; group gi takes rows r0 + gi, r0 + gi + 8, ...;
  // each thread owns 4 of the head's 128 columns.
  const int gi = tid >> 5, cc = (tid & 31) * 4;
  float4 acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = r0 + gi; j < r1; j += kAttnThreads / 32) {
    const float4 v = load4(vc + (size_t)j * kvw + h * kQHd + cc);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float p = bf16r(expf(sc[(size_t)(h * G + g) * ld_sc + j] - big[g]) / sum[g]);
      acc[g].x = fmaf(p, v.x, acc[g].x);
      acc[g].y = fmaf(p, v.y, acc[g].y);
      acc[g].z = fmaf(p, v.z, acc[g].z);
      acc[g].w = fmaf(p, v.w, acc[g].w);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    pv[gi][g][cc] = acc[g].x;
    pv[gi][g][cc + 1] = acc[g].y;
    pv[gi][g][cc + 2] = acc[g].z;
    pv[gi][g][cc + 3] = acc[g].w;
  }
  __syncthreads();
  if (tid < kQHd) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < kAttnThreads / 32; ++i) a += pv[i][g][tid];
      if (fresh) a += expf(sc[(size_t)(h * G + g) * ld_sc + rows] - big[g]) / sum[g] * vf[tid];
      ctx[(size_t)c * ld_ctx + (h * G + g) * kQHd + tid] = a;
    }
  }
}

}  // namespace qwen
