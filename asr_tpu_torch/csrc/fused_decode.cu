// One batch-1 Qwen3 decode step for Hopper (sm_90a): every layer of the
// RMSNorm + GQA (per-head q/k RMSNorm, NeoX RoPE) + gated-SiLU decoder, then
// the final RMSNorm and the optional packed-int4 tied head, behind one C
// entry point.
//
// Replaces the Pallas TPU megakernel asr_tpu/ops/fused_decode.py:_kernel,
// _kernel_with_head and _kernel_impl (fused_decode_step). Per layer it
// computes
//   RMSNorm -> q|k|v (packed int4) -> per-head q/k RMSNorm + RoPE, the fresh
//   k/v row written into the caches at pos in place -> GQA attention over the
//   cached rows [shift, pos) and the fresh row -> o-proj + residual ->
//   RMSNorm -> gate|up -> SiLU(gate) * up -> down + residual,
// and rounds where the TPU kernel rounds: matvec inputs to bf16 (the nibbles
// are exact), f32 accumulation with the block affine applied per 128 rows as
// (x.u)*s - sum(x)*(z*s); cached-row scores bf16(q*128^-0.5).bf16(k), the
// fresh row's score and p*v in f32 from the unrounded q, k, v; probabilities
// rounded to bf16 for P.V; RMSNorms, softmax, SiLU and residuals in f32.
//
// Weights are packed int4: a (K/2, N) int8 array whose low nibble holds rows
// [0, K/2) and high nibble rows [K/2, K); scales and zero*scale are (K/128,
// N) f32, rows [0, K/256) for the low plane. Takes: head width 128; 2 q
// heads a kv head (G, a template parameter); H and F multiples of 256; caches (NL, T, nkv*128) of
// float or bf16; every pointer 16-byte aligned. The wrapper
// (asr_tpu_torch/ops/fused_decode.py) checks all of it.
//
// What bounds it on an H100 (3.35 TB/s HBM): a step is a chain of matvecs at
// batch 1 and one attention a layer, about 2 FLOP per weight byte, so it is
// memory bound. Qwen3-ASR-0.6B (H 1024, 28 layers, 16/8 heads, F 3072,
// V_pad 153600) reads 220 MB of packed int4 decoder weights and 27.5 MB of
// scales, the 78.6 MB packed head and 9.8 MB of its scales, and 2 x 28 x pos
// x 2 KB of bf16 cache (50 MB at pos 440): about 0.39 GB, a floor of about
// 0.115 ms a step.
//
// Design: a fixed sequence of 8 kernels a layer (+ 1, + 2 for the head)
// enqueued on the caller's stream, none of which synchronises with the host
// (pos and shift come from the host loop, which knows them):
//   p4_matvec_partial: one block of 4 warps per 128 x 128 tile of packed
//     bytes; each lane issues 8 loads of 16 bytes at once and splits every
//     byte into its two nibbles, so each weight byte is read once for both
//     K-halves. It writes one partial row per 128-row quantization block
//     (split-K), already scaled by the block affine. The down projection
//     computes SiLU(gate) * up from the gate|up partials as it reads its
//     inputs, and the o-projection sums the attention's per-chunk contexts.
//   resid_rms: sums a matvec's partials into the residual and applies the
//     next RMSNorm (one block).
//   attn_scores / attn_pv: one block per (kv head, row chunk), up to 8
//     chunks; each k and v row is read once for the kv head's q heads. Every
//     block rebuilds its q heads (and chunk 0 the fresh k and v) from the
//     q|k|v partials: sum, RMSNorm, RoPE; chunk 0 writes the cache row. Pass
//     1 scores and keeps each chunk's max and sum of exponentials, pass 2
//     combines them into one softmax, rounds the probabilities and leaves
//     each chunk's P.V for the o-projection.
// The device helpers (tile load, reductions, chunking, bf16 loads) are the
// AED kernels' (aed_common.cuh); the input staging, the q/k/v rebuild, the
// two attention passes and the residual + RMSNorm are shared with the
// multi-slot step (qwen_common.cuh), which runs them for every slot.
// Left for later: a persistent single launch or a CUDA graph (launch gaps),
// TMA / cp.async pipelining, tensor cores for the nibble products.

#include "qwen_common.cuh"

namespace {

using namespace qwen;

// The nibble tile dot: as aed::tile_dot, for both nibbles of each byte. lo
// takes the low-half inputs xlo, hi the high-half inputs xhi.
__device__ __forceinline__ void nibble_dot(const int4 (&q)[8], const float* xlo, const float* xhi,
                                           int r0, float (&lo)[16], float (&hi)[16]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) lo[j] = hi[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float xl = xlo[r0 + 4 * i], xh = xhi[r0 + 4 * i];
    const unsigned words[4] = {(unsigned)q[i].x, (unsigned)q[i].y, (unsigned)q[i].z,
                               (unsigned)q[i].w};
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const unsigned b = (words[t] >> (8 * u)) & 0xFFu;  // the byte, unsigned
        lo[4 * t + u] = fmaf(xl, (float)(b & 0xFu), lo[4 * t + u]);
        hi[4 * t + u] = fmaf(xh, (float)(b >> 4), hi[4 * t + u]);
      }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    lo[j] += __shfl_xor_sync(0xffffffffu, lo[j], 8);
    lo[j] += __shfl_xor_sync(0xffffffffu, lo[j], 16);
    hi[j] += __shfl_xor_sync(0xffffffffu, hi[j], 8);
    hi[j] += __shfl_xor_sync(0xffffffffu, hi[j], 16);
  }
}

// part[b, n] = s[b, n] * sum_{k in block b} bf16(x[k]) u[k, n]
//              - zs[b, n] * sum_{k in block b} bf16(x[k])
// over the N columns of a packed (K/2, N) weight; grid = (N / 128, K / 256):
// block (i, j) takes packed rows [128 j, 128 j + 128), which carry the
// quantization blocks j (low nibble) and K/256 + j (high nibble).
template <int kIn>
__global__ void __launch_bounds__(kMvThreads)
p4_matvec_partial(const float* __restrict__ xs, int nx, int ldx, int f,
                  const int8_t* __restrict__ w, const float* __restrict__ s,
                  const float* __restrict__ zs, int n, int k2, float* __restrict__ part) {
  __shared__ float xb[2][kBlock];
  __shared__ float wsum[2][kMvThreads / 32][kBlock];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j = blockIdx.y;
  const int slab = blockIdx.x * kBlock;
  xb[0][tid] = bf16r(mv_input<kIn>(xs, nx, ldx, f, j * kBlock + tid));
  xb[1][tid] = bf16r(mv_input<kIn>(xs, nx, ldx, f, k2 + j * kBlock + tid));
  __syncthreads();
  const int cl = lane & 7, rl = lane >> 3;
  const int r0 = warp * 32 + rl;
  int4 q[8];
  load_tile(w, n, j * kBlock, slab, r0, q);
  float lo[16], hi[16];
  nibble_dot(q, xb[0], xb[1], r0, lo, hi);
  if (rl == 0) {
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      wsum[0][warp][cl * 16 + jj] = lo[jj];
      wsum[1][warp][cl * 16 + jj] = hi[jj];
    }
  }
  __syncthreads();
  const int col = slab + tid;
  const int nbh = k2 / kBlock;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const float px = warp_sum(xb[p][lane] + xb[p][lane + 32] + xb[p][lane + 64] + xb[p][lane + 96]);
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < kMvThreads / 32; ++i) a += wsum[p][i][tid];
    const size_t b = (size_t)(p * nbh + j) * n + col;
    part[b] = __ldg(s + b) * a - __ldg(zs + b) * px;
  }
}

// xres = xin (when given), else xres + sum_b part[b, :];
// y = xres * rsqrt(mean(xres^2) + eps) * w. One block; dynamic shared memory
// d floats.
__global__ void __launch_bounds__(kLnThreads)
resid_rms(float* __restrict__ xres, const float* __restrict__ xin, const float* __restrict__ part,
          int nb, const float* __restrict__ w, float* __restrict__ y, int d, float eps) {
  extern __shared__ float xsm[];
  __shared__ float red[32];
  resid_rms_row(xres, xin, part, nb, d, w, y, d, eps, xsm, red);
}

// Pass 1, grid (kv heads, splits): chunk c of kv head h scores its cached
// rows [shift + r0, shift + r1) for the G q heads into sc[qh * ld_sc + j]
// (j counted from shift), and leaves each q head's max and sum of
// exp(score - max) in stats[(qh * splits + c) * 2 + {0, 1}]. Chunk 0 also
// writes the fresh k/v row into the caches at pos and scores it, in f32, as
// row pos - shift.
template <typename T, int G>
__global__ void __launch_bounds__(kAttnThreads)
attn_scores(const float* __restrict__ part, int nb, int ld, int qd, int kvw,
            const float* __restrict__ qn, const float* __restrict__ kn,
            const float* __restrict__ cosr, const float* __restrict__ sinr, float eps,
            T* __restrict__ kc, T* __restrict__ vc, int shift, int pos, int splits,
            float* __restrict__ sc, int ld_sc, float* __restrict__ stats) {
  attn_scores_chunk<T, G>(part, nb, ld, qd, kvw, blockIdx.x, qn, kn, cosr, sinr, eps,
                          kc + (size_t)shift * kvw, vc + (size_t)shift * kvw, pos - shift, true,
                          splits, blockIdx.y, sc, ld_sc, stats);
}

// Pass 2, grid (kv heads, splits): with each q head's max M and sum S over
// every chunk, chunk c writes ctx[c * ld_ctx + qh * 128 + :] = sum over its
// rows of bf16(exp(s - M) / S) * bf16(v); chunk 0 adds the fresh row's p * v
// in f32 (v rebuilt from the partials). The o-projection sums the chunks.
template <typename T, int G>
__global__ void __launch_bounds__(kAttnThreads)
attn_pv(const float* __restrict__ part, int nb, int ld, int qd, int kvw, const T* __restrict__ vc,
        int shift, int pos, int splits, const float* __restrict__ sc, int ld_sc,
        const float* __restrict__ stats, float* __restrict__ ctx, int ld_ctx) {
  attn_pv_chunk<T, G>(part, nb, ld, qd, kvw, blockIdx.x, vc + (size_t)shift * kvw, pos - shift,
                      splits, blockIdx.y, sc, ld_sc, stats, ctx, ld_ctx);
}

template <int kIn>
void matvec(const float* x, int nx, int ldx, int f, const int8_t* w, const float* s,
            const float* zs, int k2, int n, float* part, cudaStream_t st) {
  p4_matvec_partial<kIn><<<dim3(n / kBlock, k2 / kBlock), kMvThreads, 0, st>>>(x, nx, ldx, f, w, s,
                                                                             zs, n, k2, part);
}

// Scratch layout, in floats, each part 16-byte aligned: xres, y (H each), ctx
// (kMaxSplits x nh*128), scores (nh x ld_sc, ld_sc >= T + 1), stats (nh x
// kMaxSplits x 2), partials A (H/128 x max(q|k|v width, 2F, V_pad)) and B
// (max(nh*128, F)/128 x H).
struct ScratchPlan {
  size_t y, ctx, sc, stats, part_a, part_b, floats;
  int ld_sc;
  static size_t up4(size_t v) { return (v + 3) / 4 * 4; }
  ScratchPlan(int h, int nh, int nkv, int f, int t, int vp) {
    ld_sc = static_cast<int>(up4(t + 1));
    const size_t qd = static_cast<size_t>(nh) * kQHd;
    const size_t qn = static_cast<size_t>(nh + 2 * nkv) * kQHd;
    y = up4(h);
    ctx = y + up4(h);
    sc = ctx + kMaxSplits * qd;
    stats = sc + static_cast<size_t>(nh) * ld_sc;
    part_a = up4(stats + static_cast<size_t>(nh) * kMaxSplits * 2);
    part_b = part_a + static_cast<size_t>(h / kBlock) *
                          std::max(std::max(qn, static_cast<size_t>(2 * f)), static_cast<size_t>(vp));
    floats = part_b + std::max(qd, static_cast<size_t>(f)) / kBlock * h;
  }
};

template <typename T, int G>
void run_layers(const Weights& W, const float* x, const float* cosr, const float* sinr, T* kc,
                T* vc, float* hidden, float* logits, float* scratch, int nl, int h, int nh, int nkv,
                int f, int t, int vp, int pos, int shift, float eps, cudaStream_t st) {
  const ScratchPlan plan(h, nh, nkv, f, t, vp);
  float *xres = scratch, *y = scratch + plan.y, *ctx = scratch + plan.ctx, *sc = scratch + plan.sc;
  float *stats = scratch + plan.stats, *pa = scratch + plan.part_a, *pb = scratch + plan.part_b;
  const int qd = nh * kQHd, kvw = nkv * kQHd, qn = qd + 2 * kvw;
  const int nbh = h / kBlock;
  const int splits = splits_for(pos - shift);
  const size_t smem = sizeof(float) * h;
  const size_t kbh = static_cast<size_t>(h / 2 / kBlock), kbo = qd / 2 / kBlock, kbf = f / 2 / kBlock;

  resid_rms<<<1, kLnThreads, smem, st>>>(xres, x, nullptr, 0, W.in_s, y, h, eps);
  for (int l = 0; l < nl; ++l) {
    T* kcl = kc + (size_t)l * t * kvw;
    T* vcl = vc + (size_t)l * t * kvw;
    // q|k|v, then attention over [shift, pos) and the fresh row
    matvec<0>(y, 1, h, 0, W.wq + (size_t)l * (h / 2) * qn, W.qkv_s + (size_t)l * 2 * kbh * qn,
              W.qkv_zs + (size_t)l * 2 * kbh * qn, h / 2, qn, pa, st);
    const dim3 grid(nkv, splits);
    attn_scores<T, G><<<grid, kAttnThreads, 0, st>>>(
        pa, nbh, qn, qd, kvw, W.qn_s + (size_t)l * kQHd, W.kn_s + (size_t)l * kQHd, cosr, sinr,
        eps, kcl, vcl, shift, pos, splits, sc, plan.ld_sc, stats);
    attn_pv<T, G><<<grid, kAttnThreads, 0, st>>>(pa, nbh, qn, qd, kvw, vcl, shift, pos, splits, sc,
                                                  plan.ld_sc, stats, ctx, qd);
    // o-proj + residual, RMSNorm
    matvec<0>(ctx, splits, qd, 0, W.wo + (size_t)l * (qd / 2) * h, W.o_s + (size_t)l * 2 * kbo * h,
              W.o_zs + (size_t)l * 2 * kbo * h, qd / 2, h, pb, st);
    resid_rms<<<1, kLnThreads, smem, st>>>(xres, nullptr, pb, qd / kBlock, W.post_s + (size_t)l * h,
                                           y, h, eps);
    // gate|up, SiLU(gate) * up -> down + residual, the next RMSNorm
    matvec<0>(y, 1, h, 0, W.wgu + (size_t)l * (h / 2) * 2 * f,
              W.gu_s + (size_t)l * 2 * kbh * 2 * f, W.gu_zs + (size_t)l * 2 * kbh * 2 * f, h / 2,
              2 * f, pa, st);
    matvec<1>(pa, nbh, 2 * f, f, W.wd + (size_t)l * (f / 2) * h, W.dn_s + (size_t)l * 2 * kbf * h,
              W.dn_zs + (size_t)l * 2 * kbf * h, f / 2, h, pb, st);
    const bool last = l + 1 == nl;
    resid_rms<<<1, kLnThreads, smem, st>>>(xres, nullptr, pb, f / kBlock,
                                           last ? W.fn_s : W.in_s + (size_t)(l + 1) * h,
                                           last ? hidden : y, h, eps);
  }
  if (W.wh != nullptr) {
    matvec<0>(hidden, 1, h, 0, W.wh, W.h_s, W.h_zs, h / 2, vp, pa, st);
    head_reduce<<<(vp + 255) / 256, 256, 0, st>>>(pa, nbh, logits, vp);
  }
}

constexpr int kGroups = 2;  // q heads per kv head

}  // namespace

// Floats of scratch memory fused_decode needs (vp = 0 without the head).
extern "C" long long fused_decode_scratch_floats(int h, int nh, int nkv, int f, int t, int vp) {
  return static_cast<long long>(ScratchPlan(h, nh, nkv, f, t, vp).floats);
}

// Enqueues the step on `stream` and returns cudaGetLastError() (0 on
// success). Caches are (NL, T, nkv*128) of float (cache_bf16 = 0) or bf16;
// wh, h_s, h_zs and logits are null without the head (vp = 0); scratch holds
// fused_decode_scratch_floats(...) floats. The caller checks shapes, types,
// alignment, that nh = 2 nkv, and 0 <= shift <= pos < T.
extern "C" int fused_decode(
    const void* x, const void* cosr, const void* sinr, const void* in_s, const void* post_s,
    const void* qn_s, const void* kn_s, const void* fn_s, const void* wq, const void* qkv_s,
    const void* qkv_zs, const void* wo, const void* o_s, const void* o_zs, const void* wgu,
    const void* gu_s, const void* gu_zs, const void* wd, const void* dn_s, const void* dn_zs,
    const void* wh, const void* h_s, const void* h_zs, void* kc, void* vc, void* hidden,
    void* logits, void* scratch, int nl, int h, int nh, int nkv, int f, int t, int vp, int pos,
    int shift, int cache_bf16, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FD_F(p) static_cast<const float*>(p)
  const Weights W = make_weights(in_s, post_s, qn_s, kn_s, fn_s, wq, qkv_s, qkv_zs, wo, o_s, o_zs,
                                 wgu, gu_s, gu_zs, wd, dn_s, dn_zs, wh, h_s, h_zs);
  float* hid = static_cast<float*>(hidden);
  float* lg = static_cast<float*>(logits);
  float* scr = static_cast<float*>(scratch);
  if (cache_bf16) {
    using T = __nv_bfloat16;
    run_layers<T, kGroups>(W, FD_F(x), FD_F(cosr), FD_F(sinr), static_cast<T*>(kc),
                           static_cast<T*>(vc), hid, lg, scr, nl, h, nh, nkv, f, t, vp, pos, shift,
                           eps, st);
  } else {
    run_layers<float, kGroups>(W, FD_F(x), FD_F(cosr), FD_F(sinr), static_cast<float*>(kc),
                               static_cast<float*>(vc), hid, lg, scr, nl, h, nh, nkv, f, t, vp, pos,
                               shift, eps, st);
  }
#undef FD_F
  return static_cast<int>(cudaGetLastError());
}
