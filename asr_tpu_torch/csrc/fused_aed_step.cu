// One batch-1 AED decode step for Hopper (sm_90a): every decoder layer of
// the pre-LN encoder-decoder block, then the final LayerNorm and the q8
// tied head, behind one C entry point.
//
// Replaces the Pallas TPU megakernel asr_tpu/ops/fused_aed_step.py:_kernel
// (with _strip8; fused_aed_step). Per layer it computes
//   LN1 -> self q|k|v -> self-attention over cache[:pos] + the fresh row,
//   which is written into the caches at pos in place -> o-proj + residual
//   -> LN -> cross-q -> cross-attention over rows < tc_valid -> cross-o +
//   residual -> LN2 -> fc1 -> exact GELU -> fc2 + residual,
// and rounds where the TPU kernel rounds: matvec inputs to bf16 (int8
// weights are exact), f32 accumulation with the block affine applied per
// 128 rows as (x.q)*s - sum(x)*(z*s); scores bf16(q*d_h^-0.5).bf16(k) for
// cached rows, the fresh row's score and p*v in f32 from the unrounded
// q, k, v; probabilities rounded to bf16 for P.V; LayerNorm (eps), softmax,
// biases, GELU (erff) and residuals in f32.
//
// Takes: head_dim 64; D and F multiples of 128; quantization block 128;
// self and cross caches of one type, float or bf16, (NL, rows, D)
// row-major; every pointer 16-byte aligned. The wrapper
// (asr_tpu_torch/ops/fused_aed_step.py) checks all of it.
//
// What bounds it on an H100 (3.35 TB/s HBM): a step is a chain of matvecs
// and two attentions at batch 1, a few FLOP per byte, so it is memory
// bound. Whisper-Large-v3-Turbo (D 1280, F 5120, 4 layers, V_pad 52224)
// reads 91.8 MB of int8 decoder weights and 5.7 MB of scales, the 66.8 MB
// int8 head and 4.2 MB of its scales, 61.4 MB of f32 cross K/V (30.7 MB in
// bf16) and up to 18.4 MB of f32 self cache: 0.21-0.25 GB, a floor of about
// 62-74 us per step.
//
// Design: a fixed sequence of 59 kernels (14 per layer + 3) enqueued on the
// caller's stream, none of which synchronises with the host.
//   q8_matvec_partial: one block of 4 warps per 128 x 128 int8 tile, so
//     even the 1.6 MB D x D weights spread over 100 SMs; each lane issues
//     its 8 loads of 16 bytes (16 columns of every 4th row) at once, and the
//     block's inputs are summed and rounded once into shared memory. It
//     writes one partial row per 128-row block (split-K), already scaled by
//     the block affine.
//   resid_ln / gelu_bias / head_reduce: sum those partials, add the bias
//     (and the residual, then LayerNorm, or GELU) -- the split-K epilogue.
//   attn_scores / attn_pv: each head's rows in up to 8 chunks, one block a
//     chunk (160 blocks for 1500 cross rows). Pass 1 scores a chunk (one row
//     per thread, 16-byte loads) and keeps its max and sum of exponentials;
//     pass 2 combines those into the head's softmax, rounds the
//     probabilities to bf16 and leaves the chunk's P.V, which the o-proj
//     matvec sums as it reads its input. The self variant also writes the
//     fresh k/v row and adds its score and p*v in f32.
// The device helpers (tile dot, head-row dots, reductions) live in
// aed_common.cuh, shared with the multi-slot step (fused_aed_multi.cu).
// Left for later: a persistent single launch or a CUDA graph (launch gaps:
// about 70 us of a step), TMA / cp.async pipelining, and a multi-block
// LayerNorm epilogue.

#include "aed_common.cuh"

namespace {

using namespace aed;

// part[b, n] = s[b, n] * sum_{k in block b} bf16(x[k]) q[k, n]
//              - zs[b, n] * sum_{k in block b} bf16(x[k])
// for the columns [0, N) of a weight with row stride ldw (int8) and scale
// row stride ldw (float), where x[k] = sum_{i < nx} xs[i * ldx + k] (the
// attention kernels leave one context vector per row chunk). One block of
// 4 warps per (128-row block, 128-column slab): grid = (N / 128, K / 128).
__global__ void __launch_bounds__(kMvThreads)
q8_matvec_partial(const float* __restrict__ xs, int nx, int ldx, const int8_t* __restrict__ w,
                  int ldw, const float* __restrict__ s, const float* __restrict__ zs, int n,
                  float* __restrict__ part) {
  __shared__ float xb[kBlock];
  __shared__ float wsum[kMvThreads / 32][kBlock];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y;
  const int slab = blockIdx.x * kBlock;
  // This block's 128 inputs, summed over the nx vectors and rounded once.
  {
    float v = 0.f;
    for (int t = 0; t < nx; ++t) v += __ldg(xs + (size_t)t * ldx + b * kBlock + tid);
    xb[tid] = bf16r(v);
  }
  __syncthreads();
  const int cl = lane & 7, rl = lane >> 3;
  const int r0 = warp * 32 + rl;
  int4 q[8];
  load_tile(w, ldw, b * kBlock, slab, r0, q);
  float acc[16];
  tile_dot(q, xb, r0, acc);
  if (rl == 0) {
#pragma unroll
    for (int j = 0; j < 16; ++j) wsum[warp][cl * 16 + j] = acc[j];
  }
  __syncthreads();
  const float px = warp_sum(xb[lane] + xb[lane + 32] + xb[lane + 64] + xb[lane + 96]);
  float a = 0.f;
#pragma unroll
  for (int i = 0; i < kMvThreads / 32; ++i) a += wsum[i][tid];
  const int col = slab + tid;
  part[(size_t)b * n + col] = __ldg(s + (size_t)b * ldw + col) * a - __ldg(zs + (size_t)b * ldw + col) * px;
}

// xres = xin (when given), else xres + (sum_b part[b, :] + bias);
// y = LayerNorm(xres) * s + b. One block; dynamic shared memory D floats.
__global__ void __launch_bounds__(kLnThreads)
resid_ln(float* __restrict__ xres, const float* __restrict__ xin, const float* __restrict__ part,
         int nb, const float* __restrict__ bias, const float* __restrict__ ls,
         const float* __restrict__ lb, float* __restrict__ y, int d, float eps) {
  extern __shared__ float xs[];
  __shared__ float red[32];
  float sum = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    float v;
    if (xin != nullptr) {
      v = xin[i];
    } else {
      float a = 0.f;
      for (int b = 0; b < nb; ++b) a += part[(size_t)b * d + i];
      v = (xres[i] + a) + bias[i];
    }
    xres[i] = v;
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
  for (int i = threadIdx.x; i < d; i += blockDim.x) y[i] = (xs[i] - mean) * rstd * ls[i] + lb[i];
}

// h = gelu(sum_b part[b, :] + bias), exact (erf) GELU.
__global__ void gelu_bias(const float* __restrict__ part, int nb, const float* __restrict__ bias,
                          float* __restrict__ h, int f) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= f) return;
  float a = 0.f;
  for (int b = 0; b < nb; ++b) a += part[(size_t)b * f + i];
  const float v = a + bias[i];
  h[i] = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// q (and for self k, v) of head h: sum_b part[b, seg + h*64 + :] + bias.
// Threads [0, 64) fill qs = bf16(q * scale), qf = q, kf = k, vf = v.
template <bool kSelf>
__device__ __forceinline__ void head_qkv(const float* part, int nb, int ld_part,
                                         const float* bias, int d, int col, float scale,
                                         float* qs, float* qf, float* kf, float* vf) {
  const int tid = threadIdx.x;
  if (tid < kHd) {
    float q = 0.f, k = 0.f, v = 0.f;
    for (int b = 0; b < nb; ++b) {
      const float* pr = part + (size_t)b * ld_part + col + tid;
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

// Pass 1, grid (heads, splits): chunk c of head h scores its rows of the
// cache, kc (row stride d), into sc[h * ld_sc + j], and leaves its max and
// its sum of exp(score - max) in stats[(h * splits + c) * 2 + {0, 1}]. In
// the self variant, chunk 0 also writes the fresh k/v row into the caches
// at `pos` (= rows) and scores it, in f32, as row `rows`.
template <typename T, bool kSelf>
__global__ void __launch_bounds__(kAttnThreads)
attn_scores(const float* __restrict__ part, int nb, int ld_part, const float* __restrict__ bias,
            T* __restrict__ kc, T* __restrict__ vc, int rows, int d, float scale, int splits,
            float* __restrict__ sc, int ld_sc, float* __restrict__ stats) {
  __shared__ float qs[kHd], qf[kHd], kf[kHd], vf[kHd];
  __shared__ float red[32];
  const int h = blockIdx.x, c = blockIdx.y, tid = threadIdx.x;
  const int col = h * kHd;
  float* sch = sc + (size_t)h * ld_sc;
  head_qkv<kSelf>(part, nb, ld_part, bias, d, col, scale, qs, qf, kf, vf);
  const bool fresh = kSelf && c == 0;
  if (fresh && tid < kHd) {
    store(kc + (size_t)rows * d + col + tid, kf[tid]);
    store(vc + (size_t)rows * d + col + tid, vf[tid]);
  }
  int r0, r1;
  chunk_rows(rows, splits, c, &r0, &r1);
  float m = -INFINITY;
  for (int j = r0 + tid; j < r1; j += blockDim.x) {
    const float a = row_dot(kc + (size_t)j * d + col, qs);
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
    stats[(h * splits + c) * 2] = m;
    stats[(h * splits + c) * 2 + 1] = l;
  }
}

// Pass 2, grid (heads, splits): with the max M and the sum S over every
// chunk of head h, chunk c writes ctx[c * d + h*64 + :] = sum over its rows
// of bf16(exp(s - M) / S) * bf16(v); chunk 0 of the self variant adds the
// fresh row's p * v in f32. The o-proj matvec sums the chunks' vectors.
template <typename T, bool kSelf>
__global__ void __launch_bounds__(kAttnThreads)
attn_pv(const float* __restrict__ part, int nb, int ld_part, const float* __restrict__ bias,
        const T* __restrict__ vc, int rows, int d, int splits, const float* __restrict__ sc,
        int ld_sc, const float* __restrict__ stats, float* __restrict__ ctx) {
  __shared__ float qs[kHd], qf[kHd], kf[kHd], vf[kHd];
  __shared__ float pv[16][kHd];
  const int h = blockIdx.x, c = blockIdx.y, tid = threadIdx.x;
  const int col = h * kHd;
  const float* sch = sc + (size_t)h * ld_sc;
  const bool fresh = kSelf && c == 0;
  if (fresh) head_qkv<kSelf>(part, nb, ld_part, bias, d, col, 0.f, qs, qf, kf, vf);
  float big = -INFINITY;
  for (int i = 0; i < splits; ++i) big = fmaxf(big, stats[(h * splits + i) * 2]);
  float sum = 0.f;
  for (int i = 0; i < splits; ++i) {
    const float li = stats[(h * splits + i) * 2 + 1];
    if (li > 0.f) sum += li * expf(stats[(h * splits + i) * 2] - big);
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
    const float4 v = load4(vc + (size_t)j * d + col + cc);
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
    ctx[(size_t)c * d + col + tid] = a;
  }
}

void matvec(const float* x, int nx, const int8_t* w, int ldw, const float* s, const float* zs,
            int k, int n, float* part, cudaStream_t st) {
  q8_matvec_partial<<<dim3(n / kBlock, k / kBlock), kMvThreads, 0, st>>>(x, nx, k, w, ldw, s, zs, n,
                                                                         part);
}

template <typename T, bool kSelf>
void attention(const float* part, int nb, int ld_part, const float* bias, T* kc, T* vc, int rows,
               int d, int heads, float scale, float* sc, int ld_sc, float* stats, float* ctx,
               cudaStream_t st) {
  const int splits = splits_for(rows);
  const dim3 grid(heads, splits);
  attn_scores<T, kSelf><<<grid, kAttnThreads, 0, st>>>(part, nb, ld_part, bias, kc, vc, rows, d,
                                                        scale, splits, sc, ld_sc, stats);
  attn_pv<T, kSelf><<<grid, kAttnThreads, 0, st>>>(part, nb, ld_part, bias, vc, rows, d, splits, sc,
                                                    ld_sc, stats, ctx);
}

// Scratch layout, in floats: xres, y (D each), h1 (F), ctx (kMaxSplits D),
// scores (heads x ld_sc, ld_sc >= max(t_self, t_cross) + 1), stats (heads x
// kMaxSplits x 2), then the matvec partials (max(D/128 x max(3D, F, V_pad),
// F/128 x D)), 16-byte aligned.
struct ScratchPlan {
  size_t y, h1, ctx, sc, stats, part, floats;
  int ld_sc;
  ScratchPlan(int d, int f, int heads, int t_self, int t_cross, int vp) {
    ld_sc = (std::max(t_self, t_cross) + 1 + 3) / 4 * 4;
    const size_t kbd = d / kBlock, kbf = f / kBlock;
    const size_t widest = static_cast<size_t>(std::max(std::max(3 * d, f), vp));
    y = d;
    h1 = y + d;
    ctx = h1 + f;
    sc = ctx + static_cast<size_t>(kMaxSplits) * d;
    stats = sc + static_cast<size_t>(heads) * ld_sc;
    part = (stats + static_cast<size_t>(heads) * kMaxSplits * 2 + 3) / 4 * 4;
    floats = part + std::max(kbd * widest, kbf * static_cast<size_t>(d));
  }
};

template <typename T>
void run_layers(const float* x, const float* ln1_s, const float* ln1_b, const float* lnc_s,
                const float* lnc_b, const float* ln2_s, const float* ln2_b, const float* lnf_s,
                const float* lnf_b, const float* ba, const float* bb, const int8_t* wa,
                const float* a_s, const float* a_zs, const int8_t* wb, const float* b_s,
                const float* b_zs, T* kself, T* vself, T* ck, T* cv, const int8_t* wh,
                const float* h_s, const float* h_zs, float* logits, float* scratch, int nl, int d,
                int heads, int f, int t_self, int t_cross, int vp, int pos, int tc_valid,
                float eps, cudaStream_t st) {
  const ScratchPlan plan(d, f, heads, t_self, t_cross, vp);
  float *xres = scratch, *y = scratch + plan.y, *h1 = scratch + plan.h1, *ctx = scratch + plan.ctx;
  float *sc = scratch + plan.sc, *stats = scratch + plan.stats, *part = scratch + plan.part;
  const int na = 6 * d + f;
  const int kbd = d / kBlock, kbf = f / kBlock;
  const float scale = 0.125f;  // kHd ** -0.5
  const size_t ln_smem = sizeof(float) * d;
  const int self_splits = splits_for(pos), cross_splits = splits_for(tc_valid);

  resid_ln<<<1, kLnThreads, ln_smem, st>>>(xres, x, nullptr, 0, nullptr, ln1_s, ln1_b, y, d, eps);
  for (int l = 0; l < nl; ++l) {
    const int8_t* wal = wa + (size_t)l * d * na;
    const float* asl = a_s + (size_t)l * kbd * na;
    const float* azl = a_zs + (size_t)l * kbd * na;
    const float* bal = ba + (size_t)l * na;
    T* ksl = kself + (size_t)l * t_self * d;
    T* vsl = vself + (size_t)l * t_self * d;
    T* ckl = ck + (size_t)l * t_cross * d;
    T* cvl = cv + (size_t)l * t_cross * d;

    // self attention over cache rows [0, pos) and the fresh row
    matvec(y, 1, wal, na, asl, azl, d, 3 * d, part, st);
    attention<T, true>(part, kbd, 3 * d, bal, ksl, vsl, pos, d, heads, scale, sc, plan.ld_sc,
                       stats, ctx, st);
    matvec(ctx, self_splits, wal + 3 * d, na, asl + 3 * d, azl + 3 * d, d, d, part, st);
    resid_ln<<<1, kLnThreads, ln_smem, st>>>(xres, nullptr, part, kbd, bal + 3 * d,
                                             lnc_s + (size_t)l * d, lnc_b + (size_t)l * d, y, d,
                                             eps);
    // cross attention over rows [0, tc_valid)
    matvec(y, 1, wal + 4 * d, na, asl + 4 * d, azl + 4 * d, d, d, part, st);
    attention<T, false>(part, kbd, d, bal + 4 * d, ckl, cvl, tc_valid, d, heads, scale, sc,
                        plan.ld_sc, stats, ctx, st);
    matvec(ctx, cross_splits, wal + 5 * d, na, asl + 5 * d, azl + 5 * d, d, d, part, st);
    resid_ln<<<1, kLnThreads, ln_smem, st>>>(xres, nullptr, part, kbd, bal + 5 * d,
                                             ln2_s + (size_t)l * d, ln2_b + (size_t)l * d, y, d,
                                             eps);
    // MLP
    matvec(y, 1, wal + 6 * d, na, asl + 6 * d, azl + 6 * d, d, f, part, st);
    gelu_bias<<<(f + 255) / 256, 256, 0, st>>>(part, kbd, bal + 6 * d, h1, f);
    matvec(h1, 1, wb + (size_t)l * f * d, d, b_s + (size_t)l * kbf * d,
           b_zs + (size_t)l * kbf * d, f, d, part, st);
    const bool last = l + 1 == nl;
    resid_ln<<<1, kLnThreads, ln_smem, st>>>(
        xres, nullptr, part, kbf, bb + (size_t)l * d,
        last ? lnf_s : ln1_s + (size_t)(l + 1) * d, last ? lnf_b : ln1_b + (size_t)(l + 1) * d,
        y, d, eps);
  }
  // tied head
  matvec(y, 1, wh, vp, h_s, h_zs, d, vp, part, st);
  head_reduce<<<(vp + 255) / 256, 256, 0, st>>>(part, kbd, logits, vp);
}

}  // namespace

// Floats of scratch memory fused_aed_step needs.
extern "C" long long fused_aed_step_scratch_floats(int d, int f, int heads, int t_self,
                                                   int t_cross, int vp) {
  return static_cast<long long>(ScratchPlan(d, f, heads, t_self, t_cross, vp).floats);
}

// Enqueues the step on `stream` and returns cudaGetLastError() (0 on
// success). Caches are (NL, rows, D) of float (cache_bf16 = 0) or bf16;
// scratch holds fused_aed_step_scratch_floats(...) floats. The caller checks
// shapes, types, alignment and that pos < t_self, 1 <= tc_valid <= t_cross.
extern "C" int fused_aed_step(
    const void* x, const void* ln1_s, const void* ln1_b, const void* lnc_s, const void* lnc_b,
    const void* ln2_s, const void* ln2_b, const void* lnf_s, const void* lnf_b, const void* ba,
    const void* bb, const void* wa, const void* a_s, const void* a_zs, const void* wb,
    const void* b_s, const void* b_zs, const void* wh, const void* h_s, const void* h_zs,
    void* kself, void* vself, void* ck, void* cv, void* logits, void* scratch, int nl, int d,
    int heads, int f, int t_self, int t_cross, int vp, int pos, int tc_valid, int cache_bf16,
    float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FAS_F(p) static_cast<const float*>(p)
#define FAS_I8(p) static_cast<const int8_t*>(p)
  if (cache_bf16) {
    using T = __nv_bfloat16;
    run_layers<T>(FAS_F(x), FAS_F(ln1_s), FAS_F(ln1_b), FAS_F(lnc_s), FAS_F(lnc_b), FAS_F(ln2_s),
                  FAS_F(ln2_b), FAS_F(lnf_s), FAS_F(lnf_b), FAS_F(ba), FAS_F(bb), FAS_I8(wa),
                  FAS_F(a_s), FAS_F(a_zs), FAS_I8(wb), FAS_F(b_s), FAS_F(b_zs),
                  static_cast<T*>(kself), static_cast<T*>(vself), static_cast<T*>(ck),
                  static_cast<T*>(cv), FAS_I8(wh), FAS_F(h_s), FAS_F(h_zs),
                  static_cast<float*>(logits), static_cast<float*>(scratch), nl, d, heads, f,
                  t_self, t_cross, vp, pos, tc_valid, eps, st);
  } else {
    using T = float;
    run_layers<T>(FAS_F(x), FAS_F(ln1_s), FAS_F(ln1_b), FAS_F(lnc_s), FAS_F(lnc_b), FAS_F(ln2_s),
                  FAS_F(ln2_b), FAS_F(lnf_s), FAS_F(lnf_b), FAS_F(ba), FAS_F(bb), FAS_I8(wa),
                  FAS_F(a_s), FAS_F(a_zs), FAS_I8(wb), FAS_F(b_s), FAS_F(b_zs),
                  static_cast<T*>(kself), static_cast<T*>(vself), static_cast<T*>(ck),
                  static_cast<T*>(cv), FAS_I8(wh), FAS_F(h_s), FAS_F(h_zs),
                  static_cast<float*>(logits), static_cast<float*>(scratch), nl, d, heads, f,
                  t_self, t_cross, vp, pos, tc_valid, eps, st);
  }
#undef FAS_F
#undef FAS_I8
  return static_cast<int>(cudaGetLastError());
}
