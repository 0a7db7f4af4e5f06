// One multi-slot AED decode step for Hopper (sm_90a): every continuous-
// batching slot of a pre-LN encoder-decoder decoder advances by one token
// through all layers, the final LayerNorm and the q8 tied head, behind one
// C entry point.
//
// Replaces the Pallas TPU megakernel asr_tpu/ops/fused_aed_multi.py:_kernel
// (fused_aed_step_multi). It follows that kernel's math, not its VMEM strip
// pools or paired-head lanes: for every slot b the result is what the
// batch-1 step (fused_aed_step.cu) computes for that slot alone, with the
// same rounding points -- each slot's matvec input row rounded to bf16 on
// its own, the block affine (x.q)*s - sum(x)*(z*s) with sum(x) per slot row,
// cached scores bf16(q*d_h^-0.5).bf16(k), the fresh row's score and p*v in
// f32, probabilities rounded to bf16 for P.V, LayerNorm, softmax, GELU and
// residuals in f32 -- and in the same summation order (the shared helpers
// of aed_common.cuh, the same row chunking).
//
// Per slot: pos[b] >= 0 is the cache row the token takes (written in place
// into that slot's self planes); pos[b] = -1 parks the slot: it writes no
// cache row, attends only to its own fresh row (cache reads stay in range,
// as max(pos, 0) keeps them in the TPU kernel) and gives finite logits that
// the caller discards. Cross attention of slot b masks rows at and past
// tc_valid[b]. pos and tc_valid are (B,) int32 device arrays, so a step
// needs no host synchronisation.
//
// Takes: B >= 2 slots (batch 1 is fused_aed_step.cu's job), at most
// kMaxSlots; head_dim 64; D and F multiples of 128; quantization block 128;
// self planes (NL, B, T, D) and cross planes (NL, B, Tc, D) row-major, of
// one type, float or bf16; every pointer 16-byte aligned. The wrapper
// (asr_tpu_torch/ops/fused_aed_multi.py) checks all of it.
//
// What bounds it on an H100 (3.35 TB/s HBM): the weights are read once for
// all slots, and that is the point of the kernel -- the weight bytes do not
// scale with B. Whisper-Large-v3-Turbo (D 1280, F 5120, 4 layers, V_pad
// 52224) reads 168.5 MB a step for every slot together (91.8 MB int8
// decoder weights, 5.7 MB of scales, the 66.8 MB int8 head, 4.2 MB of its
// scales); each slot adds its caches: 61.4 MB of f32 cross K/V (30.7 MB in
// bf16) and up to 18.4 MB of f32 self cache (9.2 MB in bf16) at pos 447.
// At B = 8, pos 447, that is 0.49 GB with bf16 caches and 0.81 GB with f32,
// a floor of about 146 and 241 us a step, 18-30 us a token (the batch-1
// step takes 433-455 us a token). A step does about 2 B FLOP per weight
// byte, far below the ~295 the tensor cores need to be the limit: memory
// bound.
//
// Design: the batch-1 step's fixed sequence of 59 kernels (14 per layer +
// 3), each given a slot axis, enqueued on the caller's stream:
//   q8_matvec_multi: one block of 4 warps per 128 x 128 int8 tile, which it
//     loads into registers once and applies to every slot's row in turn
//     (each row summed over its input chunks and rounded once into shared
//     memory); split-K partials [K-block][slot][N].
//   resid_ln / gelu_bias / head_reduce: the split-K epilogues, one row (or
//     row segment) per slot.
//   attn_scores / attn_pv: a grid of (head, chunk, slot); each block reads
//     its slot's pos and tc_valid from device memory and takes the batch-1
//     step's row chunking of that slot (at least 64 rows a chunk, at most
//     8); chunks past a slot's count exit (pass 2 leaves them a zero
//     context row).
// Left for later: wgmma / mma for the B-row product, TMA, a persistent
// launch or a CUDA graph.

#include "aed_common.cuh"

namespace {

using namespace aed;

constexpr int kMaxSlots = 32;

// part[(b * nslots + sl) * n + col] = s[b, col] * sum_{k in block b} x_sl[k] q[k, col]
//                                     - zs[b, col] * sum_{k in block b} x_sl[k]
// with x_sl[k] = bf16(sum_{t < nx} xs[sl * ld_slot + t * ldx + k]), for the
// columns [0, n) of a weight with row stride ldw. grid = (n / 128, K / 128);
// dynamic shared memory: nslots x 128 floats.
__global__ void __launch_bounds__(kMvThreads)
q8_matvec_multi(const float* __restrict__ xs, int nx, int ldx, int ld_slot, int nslots,
                const int8_t* __restrict__ w, int ldw, const float* __restrict__ s,
                const float* __restrict__ zs, int n, float* __restrict__ part) {
  extern __shared__ float xb[];  // [nslots][128]
  __shared__ float wsum[kMvThreads / 32][kBlock];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y;
  const int slab = blockIdx.x * kBlock;
  for (int sl = 0; sl < nslots; ++sl) {
    float v = 0.f;
    const float* xp = xs + (size_t)sl * ld_slot + b * kBlock + tid;
    for (int t = 0; t < nx; ++t) v += __ldg(xp + (size_t)t * ldx);
    xb[sl * kBlock + tid] = bf16r(v);
  }
  __syncthreads();
  const int cl = lane & 7, rl = lane >> 3;
  const int r0 = warp * 32 + rl;
  int4 q[8];
  load_tile(w, ldw, b * kBlock, slab, r0, q);
  const int col = slab + tid;
  const float sc = __ldg(s + (size_t)b * ldw + col), z = __ldg(zs + (size_t)b * ldw + col);
  for (int sl = 0; sl < nslots; ++sl) {
    const float* xr = xb + sl * kBlock;
    float acc[16];
    tile_dot(q, xr, r0, acc);
    if (rl == 0) {
#pragma unroll
      for (int j = 0; j < 16; ++j) wsum[warp][cl * 16 + j] = acc[j];
    }
    __syncthreads();
    const float px = warp_sum(xr[lane] + xr[lane + 32] + xr[lane + 64] + xr[lane + 96]);
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < kMvThreads / 32; ++i) a += wsum[i][tid];
    part[((size_t)b * nslots + sl) * n + col] = sc * a - z * px;
    __syncthreads();  // wsum is rewritten for the next slot
  }
}

// Slot sl = blockIdx.x: xres_sl = xin_sl (when given), else xres_sl +
// (sum_b part[b, sl, :] + bias); y_sl = LayerNorm(xres_sl) * s + b.
// Dynamic shared memory D floats.
__global__ void __launch_bounds__(kLnThreads)
resid_ln_multi(float* __restrict__ xres, const float* __restrict__ xin,
               const float* __restrict__ part, int nb, int nslots, const float* __restrict__ bias,
               const float* __restrict__ ls, const float* __restrict__ lb, float* __restrict__ y,
               int d, float eps) {
  extern __shared__ float xs[];
  __shared__ float red[32];
  const int sl = blockIdx.x;
  float* xr = xres + (size_t)sl * d;
  float sum = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    float v;
    if (xin != nullptr) {
      v = xin[(size_t)sl * d + i];
    } else {
      float a = 0.f;
      for (int b = 0; b < nb; ++b) a += part[((size_t)b * nslots + sl) * d + i];
      v = (xr[i] + a) + bias[i];
    }
    xr[i] = v;
    xs[i] = v;
    sum += v;
  }
  const float mean = block_reduce<false>(sum, red) / d;
  float sq = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float c = xs[i] - mean;
    sq += c * c;
  }
  const float rstd = rsqrtf(block_reduce<false>(sq, red) / d + eps);
  float* yr = y + (size_t)sl * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) yr[i] = (xs[i] - mean) * rstd * ls[i] + lb[i];
}

// h[sl, i] = gelu(sum_b part[b, sl, i] + bias[i]), exact (erf) GELU; grid.y = slot.
__global__ void gelu_bias_multi(const float* __restrict__ part, int nb, int nslots,
                                const float* __restrict__ bias, float* __restrict__ h, int f) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x, sl = blockIdx.y;
  if (i >= f) return;
  float a = 0.f;
  for (int b = 0; b < nb; ++b) a += part[((size_t)b * nslots + sl) * f + i];
  const float v = a + bias[i];
  h[(size_t)sl * f + i] = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// logits[sl, i] = sum_b part[b, sl, i]; grid.y = slot.
__global__ void head_reduce_multi(const float* __restrict__ part, int nb, int nslots,
                                  float* __restrict__ logits, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x, sl = blockIdx.y;
  if (i >= n) return;
  float a = 0.f;
  for (int b = 0; b < nb; ++b) a += part[((size_t)b * nslots + sl) * n + i];
  logits[(size_t)sl * n + i] = a;
}

// The rows slot sl attends to, and whether its self step writes a row.
// Self: the cached rows [0, pos) (none for a parked slot) and the fresh row
// at pos; cross: rows [0, tc_valid).
template <bool kSelf>
__device__ __forceinline__ int slot_rows(const int* pos, const int* tc_valid, int sl, int t_rows,
                                         bool* write) {
  if (kSelf) {
    const int p = pos[sl];
    *write = p >= 0 && p < t_rows;
    return *write ? p : 0;
  }
  *write = false;
  return min(max(tc_valid[sl], 1), t_rows);
}

// q (and for self k, v) of head h of slot sl: sum_b part[b, sl, seg + h*64 + :]
// + bias, where part_sl points at slot sl's row of K-block 0 and kb_stride
// steps one K-block. Threads [0, 64) fill qs = bf16(q * scale), qf = q,
// kf = k, vf = v.
template <bool kSelf>
__device__ __forceinline__ void head_qkv(const float* part_sl, int nb, size_t kb_stride,
                                         const float* bias, int d, int col, float scale,
                                         float* qs, float* qf, float* kf, float* vf) {
  const int tid = threadIdx.x;
  if (tid < kHd) {
    float q = 0.f, k = 0.f, v = 0.f;
    for (int b = 0; b < nb; ++b) {
      const float* pr = part_sl + b * kb_stride + col + tid;
      q += pr[0];
      if (kSelf) {
        k += pr[d];
        v += pr[2 * d];
      }
    }
    q += bias[col + tid];
    qf[tid] = q;
    qs[tid] = bf16r(q * scale);
    if (kSelf) {
      kf[tid] = k + bias[d + col + tid];
      vf[tid] = v + bias[2 * d + col + tid];
    }
  }
  __syncthreads();
}

// Pass 1, grid (heads, kMaxSplits, slots): chunk c of head h of slot sl
// scores its rows of the slot's cache plane (row stride d, plane stride
// plane) into sc[(sl * heads + h) * ld_sc + j] and leaves its max and sum of
// exp(score - max) in stats[((sl * heads + h) * kMaxSplits + c) * 2 + {0, 1}].
// In the self variant, chunk 0 also writes the fresh k/v row at pos (unless
// the slot is parked) and scores it, in f32, as row `rows`.
template <typename T, bool kSelf>
__global__ void __launch_bounds__(kAttnThreads)
attn_scores_multi(const float* __restrict__ part, int nb, int nslots, int ld_part,
                  const float* __restrict__ bias, T* __restrict__ kc, T* __restrict__ vc,
                  size_t plane, int t_rows, const int* __restrict__ pos,
                  const int* __restrict__ tc_valid, int d, int heads, float scale,
                  float* __restrict__ sc, int ld_sc, float* __restrict__ stats) {
  __shared__ float qs[kHd], qf[kHd], kf[kHd], vf[kHd];
  __shared__ float red[32];
  const int h = blockIdx.x, c = blockIdx.y, sl = blockIdx.z, tid = threadIdx.x;
  bool write;
  const int rows = slot_rows<kSelf>(pos, tc_valid, sl, t_rows, &write);
  const int splits = splits_for(rows);
  if (c >= splits) return;
  const int col = h * kHd;
  T* kp = kc + sl * plane;
  T* vp = vc + sl * plane;
  float* sch = sc + (size_t)(sl * heads + h) * ld_sc;
  head_qkv<kSelf>(part + (size_t)sl * ld_part, nb, (size_t)nslots * ld_part, bias, d, col, scale,
                  qs, qf, kf, vf);
  const bool fresh = kSelf && c == 0;
  if (fresh && write && tid < kHd) {
    store(kp + (size_t)rows * d + col + tid, kf[tid]);
    store(vp + (size_t)rows * d + col + tid, vf[tid]);
  }
  int r0, r1;
  chunk_rows(rows, splits, c, &r0, &r1);
  float m = -INFINITY;
  for (int j = r0 + tid; j < r1; j += blockDim.x) {
    const float a = row_dot(kp + (size_t)j * d + col, qs);
    sch[j] = a;
    m = fmaxf(m, a);
  }
  float snew = 0.f;
  if (fresh) {
    for (int i = 0; i < kHd; ++i) snew += qf[i] * kf[i] * scale;
    if (tid == 0) sch[rows] = snew;
    m = fmaxf(m, snew);
  }
  m = block_reduce<true>(m, red);
  float l = 0.f;
  for (int j = r0 + tid; j < r1; j += blockDim.x) l += expf(sch[j] - m);
  if (fresh && tid == 0) l += expf(snew - m);
  l = block_reduce<false>(l, red);
  if (tid == 0) {
    float* st = stats + ((size_t)(sl * heads + h) * kMaxSplits + c) * 2;
    st[0] = m;
    st[1] = l;
  }
}

// Pass 2, grid (heads, kMaxSplits, slots): with the max M and the sum S over
// every chunk of head h of slot sl, chunk c writes ctx[(sl * kMaxSplits + c)
// * d + h*64 + :] = sum over its rows of bf16(exp(s - M) / S) * bf16(v);
// chunk 0 of the self variant adds the fresh row's p * v in f32. Chunks past
// the slot's count write zeros. The o-proj matvec sums a slot's 8 vectors.
template <typename T, bool kSelf>
__global__ void __launch_bounds__(kAttnThreads)
attn_pv_multi(const float* __restrict__ part, int nb, int nslots, int ld_part,
              const float* __restrict__ bias, const T* __restrict__ vc, size_t plane, int t_rows,
              const int* __restrict__ pos, const int* __restrict__ tc_valid, int d, int heads,
              const float* __restrict__ sc, int ld_sc, const float* __restrict__ stats,
              float* __restrict__ ctx) {
  __shared__ float qs[kHd], qf[kHd], kf[kHd], vf[kHd];
  __shared__ float pv[16][kHd];
  const int h = blockIdx.x, c = blockIdx.y, sl = blockIdx.z, tid = threadIdx.x;
  const int col = h * kHd;
  bool write;
  const int rows = slot_rows<kSelf>(pos, tc_valid, sl, t_rows, &write);
  const int splits = splits_for(rows);
  float* out = ctx + ((size_t)sl * kMaxSplits + c) * d + col;
  if (c >= splits) {
    if (tid < kHd) out[tid] = 0.f;
    return;
  }
  const T* vp = vc + sl * plane;
  const float* sch = sc + (size_t)(sl * heads + h) * ld_sc;
  const float* st = stats + (size_t)(sl * heads + h) * kMaxSplits * 2;
  const bool fresh = kSelf && c == 0;
  if (fresh)
    head_qkv<kSelf>(part + (size_t)sl * ld_part, nb, (size_t)nslots * ld_part, bias, d, col, 0.f,
                    qs, qf, kf, vf);
  float big = -INFINITY;
  for (int i = 0; i < splits; ++i) big = fmaxf(big, st[2 * i]);
  float sum = 0.f;
  for (int i = 0; i < splits; ++i) {
    const float li = st[2 * i + 1];
    if (li > 0.f) sum += li * expf(st[2 * i] - big);
  }
  int r0, r1;
  chunk_rows(rows, splits, c, &r0, &r1);
  // 16 groups of 16 threads; group g takes rows r0 + g, r0 + g + 16, ...;
  // each thread owns 4 of the head's 64 columns.
  const int g = tid >> 4, cc = (tid & 15) * 4;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int j = r0 + g; j < r1; j += 16) {
    const float p = bf16r(expf(sch[j] - big) / sum);
    const float4 v = load4(vp + (size_t)j * d + col + cc);
    acc.x = fmaf(p, v.x, acc.x);
    acc.y = fmaf(p, v.y, acc.y);
    acc.z = fmaf(p, v.z, acc.z);
    acc.w = fmaf(p, v.w, acc.w);
  }
  pv[g][cc] = acc.x;
  pv[g][cc + 1] = acc.y;
  pv[g][cc + 2] = acc.z;
  pv[g][cc + 3] = acc.w;
  __syncthreads();
  if (tid < kHd) {
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) a += pv[i][tid];
    if (fresh) a += expf(sch[rows] - big) / sum * vf[tid];
    out[tid] = a;
  }
}

void matvec(const float* x, int nx, int ldx, int ld_slot, int nslots, const int8_t* w, int ldw,
            const float* s, const float* zs, int k, int n, float* part, cudaStream_t st) {
  q8_matvec_multi<<<dim3(n / kBlock, k / kBlock), kMvThreads, sizeof(float) * nslots * kBlock,
                    st>>>(x, nx, ldx, ld_slot, nslots, w, ldw, s, zs, n, part);
}

template <typename T, bool kSelf>
void attention(const float* part, int nb, int nslots, int ld_part, const float* bias, T* kc, T* vc,
               int t_rows, const int* pos, const int* tc_valid, int d, int heads, float scale,
               float* sc, int ld_sc, float* stats, float* ctx, cudaStream_t st) {
  const dim3 grid(heads, kMaxSplits, nslots);
  const size_t plane = (size_t)t_rows * d;
  attn_scores_multi<T, kSelf><<<grid, kAttnThreads, 0, st>>>(part, nb, nslots, ld_part, bias, kc,
                                                             vc, plane, t_rows, pos, tc_valid, d,
                                                             heads, scale, sc, ld_sc, stats);
  attn_pv_multi<T, kSelf><<<grid, kAttnThreads, 0, st>>>(part, nb, nslots, ld_part, bias, vc,
                                                         plane, t_rows, pos, tc_valid, d, heads,
                                                         sc, ld_sc, stats, ctx);
}

// Scratch layout, in floats, for B slots: xres, y (B x D each), h1 (B x F),
// ctx (B x kMaxSplits x D), scores (B x heads x ld_sc, ld_sc >= max(t_self,
// t_cross) + 1), stats (B x heads x kMaxSplits x 2), then the matvec
// partials (B x max(D/128 x max(3D, F, V_pad), F/128 x D)), 16-byte aligned.
struct ScratchPlan {
  size_t y, h1, ctx, sc, stats, part, floats;
  int ld_sc;
  ScratchPlan(int nslots, int d, int f, int heads, int t_self, int t_cross, int vp) {
    const size_t bs = nslots;
    ld_sc = (std::max(t_self, t_cross) + 1 + 3) / 4 * 4;
    const size_t kbd = d / kBlock, kbf = f / kBlock;
    const size_t widest = static_cast<size_t>(std::max(std::max(3 * d, f), vp));
    y = bs * d;
    h1 = y + bs * d;
    ctx = h1 + bs * f;
    sc = ctx + bs * kMaxSplits * d;
    stats = sc + bs * heads * ld_sc;
    part = (stats + bs * heads * kMaxSplits * 2 + 3) / 4 * 4;
    floats = part + bs * std::max(kbd * widest, kbf * static_cast<size_t>(d));
  }
};

template <typename T>
void run_layers(const float* x, const float* ln1_s, const float* ln1_b, const float* lnc_s,
                const float* lnc_b, const float* ln2_s, const float* ln2_b, const float* lnf_s,
                const float* lnf_b, const float* ba, const float* bb, const int8_t* wa,
                const float* a_s, const float* a_zs, const int8_t* wb, const float* b_s,
                const float* b_zs, const int8_t* wh, const float* h_s, const float* h_zs, T* kself,
                T* vself, T* ck, T* cv, const int* pos, const int* tc_valid, float* logits,
                float* scratch, int nl, int bs, int d, int heads, int f, int t_self, int t_cross,
                int vp, float eps, cudaStream_t st) {
  const ScratchPlan plan(bs, d, f, heads, t_self, t_cross, vp);
  float *xres = scratch, *y = scratch + plan.y, *h1 = scratch + plan.h1, *ctx = scratch + plan.ctx;
  float *sc = scratch + plan.sc, *stats = scratch + plan.stats, *part = scratch + plan.part;
  const int na = 6 * d + f;
  const int kbd = d / kBlock, kbf = f / kBlock;
  const float scale = 0.125f;  // kHd ** -0.5
  const size_t ln_smem = sizeof(float) * d;
  const int ctx_slot = kMaxSplits * d;

  resid_ln_multi<<<bs, kLnThreads, ln_smem, st>>>(xres, x, nullptr, 0, bs, nullptr, ln1_s, ln1_b,
                                                  y, d, eps);
  for (int l = 0; l < nl; ++l) {
    const int8_t* wal = wa + (size_t)l * d * na;
    const float* asl = a_s + (size_t)l * kbd * na;
    const float* azl = a_zs + (size_t)l * kbd * na;
    const float* bal = ba + (size_t)l * na;
    T* ksl = kself + (size_t)l * bs * t_self * d;
    T* vsl = vself + (size_t)l * bs * t_self * d;
    T* ckl = ck + (size_t)l * bs * t_cross * d;
    T* cvl = cv + (size_t)l * bs * t_cross * d;

    // self attention over each slot's cache rows [0, pos) and its fresh row
    matvec(y, 1, d, d, bs, wal, na, asl, azl, d, 3 * d, part, st);
    attention<T, true>(part, kbd, bs, 3 * d, bal, ksl, vsl, t_self, pos, tc_valid, d, heads, scale,
                       sc, plan.ld_sc, stats, ctx, st);
    matvec(ctx, kMaxSplits, d, ctx_slot, bs, wal + 3 * d, na, asl + 3 * d, azl + 3 * d, d, d, part,
           st);
    resid_ln_multi<<<bs, kLnThreads, ln_smem, st>>>(xres, nullptr, part, kbd, bs, bal + 3 * d,
                                                    lnc_s + (size_t)l * d, lnc_b + (size_t)l * d,
                                                    y, d, eps);
    // cross attention over each slot's rows [0, tc_valid)
    matvec(y, 1, d, d, bs, wal + 4 * d, na, asl + 4 * d, azl + 4 * d, d, d, part, st);
    attention<T, false>(part, kbd, bs, d, bal + 4 * d, ckl, cvl, t_cross, pos, tc_valid, d, heads,
                        scale, sc, plan.ld_sc, stats, ctx, st);
    matvec(ctx, kMaxSplits, d, ctx_slot, bs, wal + 5 * d, na, asl + 5 * d, azl + 5 * d, d, d, part,
           st);
    resid_ln_multi<<<bs, kLnThreads, ln_smem, st>>>(xres, nullptr, part, kbd, bs, bal + 5 * d,
                                                    ln2_s + (size_t)l * d, ln2_b + (size_t)l * d,
                                                    y, d, eps);
    // MLP
    matvec(y, 1, d, d, bs, wal + 6 * d, na, asl + 6 * d, azl + 6 * d, d, f, part, st);
    gelu_bias_multi<<<dim3((f + 255) / 256, bs), 256, 0, st>>>(part, kbd, bs, bal + 6 * d, h1, f);
    matvec(h1, 1, f, f, bs, wb + (size_t)l * f * d, d, b_s + (size_t)l * kbf * d,
           b_zs + (size_t)l * kbf * d, f, d, part, st);
    const bool last = l + 1 == nl;
    resid_ln_multi<<<bs, kLnThreads, ln_smem, st>>>(
        xres, nullptr, part, kbf, bs, bb + (size_t)l * d,
        last ? lnf_s : ln1_s + (size_t)(l + 1) * d, last ? lnf_b : ln1_b + (size_t)(l + 1) * d,
        y, d, eps);
  }
  // tied head
  matvec(y, 1, d, d, bs, wh, vp, h_s, h_zs, d, vp, part, st);
  head_reduce_multi<<<dim3((vp + 255) / 256, bs), 256, 0, st>>>(part, kbd, bs, logits, vp);
}

}  // namespace

// Largest slot count fused_aed_step_multi takes.
extern "C" int fused_aed_multi_max_slots() { return kMaxSlots; }

// Floats of scratch memory fused_aed_step_multi needs.
extern "C" long long fused_aed_multi_scratch_floats(int nslots, int d, int f, int heads,
                                                    int t_self, int t_cross, int vp) {
  return static_cast<long long>(ScratchPlan(nslots, d, f, heads, t_self, t_cross, vp).floats);
}

// Enqueues the step on `stream` and returns cudaGetLastError() (0 on
// success). x is (B, D); self planes (NL, B, t_self, D) and cross planes
// (NL, B, t_cross, D) of float (cache_bf16 = 0) or bf16; pos and tc_valid
// (B,) int32 on the device; logits (B, V_pad); scratch holds
// fused_aed_multi_scratch_floats(...) floats. The caller checks shapes,
// types, alignment and 2 <= B <= kMaxSlots.
extern "C" int fused_aed_step_multi(
    const void* x, const void* ln1_s, const void* ln1_b, const void* lnc_s, const void* lnc_b,
    const void* ln2_s, const void* ln2_b, const void* lnf_s, const void* lnf_b, const void* ba,
    const void* bb, const void* wa, const void* a_s, const void* a_zs, const void* wb,
    const void* b_s, const void* b_zs, const void* wh, const void* h_s, const void* h_zs,
    void* kself, void* vself, void* ck, void* cv, const void* pos, const void* tc_valid,
    void* logits, void* scratch, int nl, int nslots, int d, int heads, int f, int t_self,
    int t_cross, int vp, int cache_bf16, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FAM_F(p) static_cast<const float*>(p)
#define FAM_I8(p) static_cast<const int8_t*>(p)
#define FAM_ARGS(T)                                                                              \
  FAM_F(x), FAM_F(ln1_s), FAM_F(ln1_b), FAM_F(lnc_s), FAM_F(lnc_b), FAM_F(ln2_s), FAM_F(ln2_b),  \
      FAM_F(lnf_s), FAM_F(lnf_b), FAM_F(ba), FAM_F(bb), FAM_I8(wa), FAM_F(a_s), FAM_F(a_zs),     \
      FAM_I8(wb), FAM_F(b_s), FAM_F(b_zs), FAM_I8(wh), FAM_F(h_s), FAM_F(h_zs),                  \
      static_cast<T*>(kself), static_cast<T*>(vself), static_cast<T*>(ck), static_cast<T*>(cv), \
      static_cast<const int*>(pos), static_cast<const int*>(tc_valid),                          \
      static_cast<float*>(logits), static_cast<float*>(scratch), nl, nslots, d, heads, f, t_self, \
      t_cross, vp, eps, st
  if (cache_bf16) {
    run_layers<__nv_bfloat16>(FAM_ARGS(__nv_bfloat16));
  } else {
    run_layers<float>(FAM_ARGS(float));
  }
#undef FAM_ARGS
#undef FAM_F
#undef FAM_I8
  return static_cast<int>(cudaGetLastError());
}
