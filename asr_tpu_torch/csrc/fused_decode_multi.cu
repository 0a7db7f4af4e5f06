// One multi-slot Qwen3 decode step for Hopper (sm_90a): every continuous-
// batching slot advances by one token through every layer of the RMSNorm +
// GQA (per-head q/k RMSNorm, NeoX RoPE) + gated-SiLU decoder, the final
// RMSNorm and the optional packed-int4 tied head, behind one C entry point.
//
// Replaces the Pallas TPU megakernel asr_tpu/ops/fused_decode_multi.py:
// _kernel_multi, _kernel_multi_with_head and _kernel_multi_impl
// (fused_decode_step_multi). It follows that kernel's math, not its VMEM
// strip pools, 8-row cache patches or DMA semaphores: for every slot b the
// result is what the batch-1 step (fused_decode.cu) computes for that slot
// alone at shift 0, with the same rounding points -- each slot's matvec
// input row rounded to bf16 on its own, exact nibbles, the block affine
// (x.u)*s - sum(x)*(z*s) with sum(x) per slot row, cached scores
// bf16(q*128^-0.5).bf16(k) over the compact rows [0, pos), the fresh row's
// score and p*v in f32, probabilities rounded to bf16 for P.V, RMSNorms,
// softmax, SiLU and residuals in f32 -- and in the same summation order (the
// shared device code of qwen_common.cuh and the batch-1 matvec's reduction
// tree).
//
// Per slot: pos[b] >= 0 is the cache row the token takes (written in place
// into that slot's planes; the compact layout, so it is also the RoPE
// position whose cos/sin rows the caller passes); pos[b] = -1 parks the
// slot: it writes no cache row, attends only to its own fresh row and gives
// finite output that the caller discards. pos is a (B,) int32 device array,
// so a step needs no host synchronisation.
//
// Takes: B >= 2 slots (batch 1 is fused_decode.cu's job), at most
// kMaxSlots; head width 128; 2 q heads a kv head; H and F multiples of 256;
// packed int4 weights of block 128; caches (NL, B, T, nkv*128) of float or
// bf16; every pointer 16-byte aligned. The wrapper
// (asr_tpu_torch/ops/fused_decode_multi.py) checks all of it.
//
// What bounds it on an H100 (3.35 TB/s HBM): the weights are read once for
// all slots. Qwen3-ASR-0.6B (H 1024, 28 layers, 16/8 heads, F 3072, V_pad
// 153600) reads 220 MB of packed decoder weights, 27.5 MB of their scales
// and 88 MB of packed head and scales a step, for every slot together; each
// slot adds 2 x 28 x pos rows of cache, 2 KB a row in bf16 (4 KB in f32). At
// B = 8, pos 440, that is 0.74 GB with bf16 caches and 1.14 GB with f32, a
// floor of about 0.22 and 0.34 ms a step. A step does 2 B FLOP per weight
// nibble: memory bound.
//
// Design: the batch-1 step's sequence of 227 kernels (8 a layer + 3), each
// given a slot axis, enqueued on the caller's stream:
//   p4_matvec_multi: 16 warps on one 128 x 128 tile of packed bytes. Each
//     lane loads its 8 words of 4 bytes once and splits every byte into its
//     two nibbles once, keeping the 64 values in registers, then applies
//     them to every slot's staged input row in turn (the rows in shared
//     memory, laid out so a lane reads its 8 inputs with two 16-byte loads).
//     A column's partial sums run over the same rows in the same order as in
//     the batch-1 tile (lane = row phase x column group; the 4 row phases
//     summed across lanes 8 and 16 apart, the 4 row groups in order).
//     Split-K partials [K-block][slot][N], already scaled by the block
//     affine.
//   resid_rms_multi / head_reduce_multi: the split-K epilogues, one block or
//     row segment per slot.
//   attn_scores_multi / attn_pv_multi: a grid of (kv head, chunk, slot);
//     each block reads its slot's pos from device memory and takes the
//     batch-1 step's row chunking of that slot (at least 64 rows a chunk, at
//     most 8); chunks past a slot's count exit. The o-projection sums each
//     slot's chunk contexts over that slot's count.
// Left for later: tensor cores (mma / wgmma) for the B-row nibble product,
// TMA / cp.async pipelining, a persistent launch or a CUDA graph.

#include "qwen_common.cuh"

namespace {

using namespace qwen;

constexpr int kMaxSlots = 32;
constexpr int kMmThreads = 512;  // 16 warps: 4 row groups x 4 column quarters of a tile
constexpr int kGroups = 2;       // q heads per kv head

// Where row k of a staged 128-row input block lives: the lane of row phase
// rl in row group wo reads rows wo * 32 + rl + 4 i, i < 8, as 8 consecutive
// floats.
__device__ __forceinline__ int staged(int k) { return (k & ~31) + (k & 3) * 8 + ((k >> 2) & 7); }

// The rows slot sl attends to, and whether it writes its fresh row: the
// cached rows [0, pos) and row pos; none, and no write, for a parked slot.
__device__ __forceinline__ int slot_rows(const int* pos, int sl, int t_rows, bool* write) {
  const int p = pos[sl];
  *write = p >= 0 && p < t_rows;
  return *write ? p : 0;
}

// part[((b * nslots) + sl) * n + col] for the K-block b of packed rows
// [128 j, 128 j + 128) (b = j for the low nibble, K/256 + j for the high):
//   s[b, col] * sum_{k in block b} x_sl[k] u[k, col] - zs[b, col] * sum_{k in block b} x_sl[k]
// with x_sl[k] = bf16(mv_input<kIn>(xs + sl * ld_slot, nx_sl, ldx, f, k)),
// nx_sl = nx, or with `pos` the chunk count of slot sl's attention.
// grid = (N / 128, K / 256); dynamic shared memory nslots x 258 floats.
template <int kIn>
__global__ void __launch_bounds__(kMmThreads, 1)
p4_matvec_multi(const float* __restrict__ xs, int nx, size_t ldx, size_t ld_slot, int f,
                const int* __restrict__ pos, int t_rows, int nslots, const int8_t* __restrict__ w,
                const float* __restrict__ s, const float* __restrict__ zs, int n, int k2,
                float* __restrict__ part) {
  extern __shared__ float xsm[];  // [nslots][2][128] staged inputs, then [nslots][2] their sums
  __shared__ float wsum[2][2][4][kBlock];  // [slot of the pair][nibble plane][row group][column]
  float* pxs = xsm + (size_t)nslots * 2 * kBlock;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wo = warp >> 2, rl = lane >> 3;
  const int c0 = (warp & 3) * 32 + (lane & 7) * 4;  // this thread's 4 columns of the slab
  const int r0 = wo * 32 + rl;                       // and its rows r0 + 4 i of the block
  const int j = blockIdx.y, slab = blockIdx.x * kBlock;
  // The weight words first, so that their loads overlap the staging.
  unsigned q[8];
  const int8_t* wp = w + (size_t)(j * kBlock + r0) * n + slab + c0;
#pragma unroll
  for (int i = 0; i < 8; ++i) q[i] = __ldg(reinterpret_cast<const unsigned*>(wp + (size_t)(4 * i) * n));
  for (int e = tid; e < nslots * 2 * kBlock; e += kMmThreads) {
    const int sl = e >> 8, p = (e >> 7) & 1, k = e & (kBlock - 1);
    int nxs = nx;
    if (pos != nullptr) {
      bool write;
      nxs = splits_for(slot_rows(pos, sl, t_rows, &write));
    }
    xsm[(sl * 2 + p) * kBlock + staged(k)] =
        bf16r(mv_input<kIn>(xs + sl * ld_slot, nxs, ldx, f, p * k2 + j * kBlock + k));
  }
  __syncthreads();
  // sum(x) of each staged row, as the batch-1 matvec sums it
  for (int e = warp; e < nslots * 2; e += kMmThreads / 32) {
    const float* xr = xsm + e * kBlock;
    const float px = warp_sum(xr[staged(lane)] + xr[staged(lane + 32)] + xr[staged(lane + 64)] +
                              xr[staged(lane + 96)]);
    if (lane == 0) pxs[e] = px;
  }
  // the two nibbles of every byte, once for all slots
  float lov[8][4], hiv[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned b = (q[i] >> (8 * u)) & 0xFFu;
      lov[i][u] = (float)(b & 0xFu);
      hiv[i][u] = (float)(b >> 4);
    }
  __syncthreads();
  const int nbh = k2 / kBlock;
  for (int sl0 = 0; sl0 < nslots; sl0 += 2) {
    for (int g = 0; g < 2 && sl0 + g < nslots; ++g) {
      const float4* xr = reinterpret_cast<const float4*>(xsm + (sl0 + g) * 2 * kBlock + wo * 32 +
                                                         rl * 8);
      const float4 l0 = xr[0], l1 = xr[1], h0 = xr[kBlock / 4], h1 = xr[kBlock / 4 + 1];
      const float xl[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
      const float xh[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
      float lo[4], hi[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) lo[u] = hi[u] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          lo[u] = fmaf(xl[i], lov[i][u], lo[u]);
          hi[u] = fmaf(xh[i], hiv[i][u], hi[u]);
        }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        lo[u] += __shfl_xor_sync(0xffffffffu, lo[u], 8);
        lo[u] += __shfl_xor_sync(0xffffffffu, lo[u], 16);
        hi[u] += __shfl_xor_sync(0xffffffffu, hi[u], 8);
        hi[u] += __shfl_xor_sync(0xffffffffu, hi[u], 16);
      }
      if (rl == 0) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          wsum[g][0][wo][c0 + u] = lo[u];
          wsum[g][1][wo][c0 + u] = hi[u];
        }
      }
    }
    __syncthreads();
    const int g = tid >> 8, p = (tid >> 7) & 1, col = tid & (kBlock - 1);
    const int sl = sl0 + g;
    if (sl < nslots) {
      const float px = pxs[sl * 2 + p];
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) a += wsum[g][p][i][col];
      const size_t b = (size_t)(p * nbh + j) * n + slab + col;
      part[((size_t)(p * nbh + j) * nslots + sl) * n + slab + col] =
          __ldg(s + b) * a - __ldg(zs + b) * px;
    }
    __syncthreads();  // wsum is rewritten for the next pair
  }
}

// Slot sl = blockIdx.x: xres_sl = xin_sl (when given), else xres_sl +
// sum_b part[b, sl, :]; y_sl = RMSNorm(xres_sl) * w. Dynamic shared memory
// d floats.
__global__ void __launch_bounds__(kLnThreads)
resid_rms_multi(float* __restrict__ xres, const float* __restrict__ xin,
                const float* __restrict__ part, int nb, int nslots, const float* __restrict__ w,
                float* __restrict__ y, int d, float eps) {
  extern __shared__ float xsm[];
  __shared__ float red[32];
  const size_t off = (size_t)blockIdx.x * d;
  resid_rms_row(xres + off, xin != nullptr ? xin + off : nullptr,
                part != nullptr ? part + off : nullptr, nb, (size_t)nslots * d, w, y + off, d, eps,
                xsm, red);
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

// Pass 1, grid (kv heads, kMaxSplits, slots): chunk c of kv head h of slot
// sl, as the batch-1 step's pass 1 over that slot's rows [0, pos); the
// slot's scores at sc + sl * nh * ld_sc, its chunk statistics at stats + sl
// * nh * kMaxSplits * 2.
template <typename T, int G>
__global__ void __launch_bounds__(kAttnThreads)
attn_scores_multi(const float* __restrict__ part, int nb, int nslots, int ld, int qd, int kvw,
                  const float* __restrict__ qn, const float* __restrict__ kn,
                  const float* __restrict__ cosr, const float* __restrict__ sinr, float eps,
                  T* __restrict__ kc, T* __restrict__ vc, int t_rows, const int* __restrict__ pos,
                  float* __restrict__ sc, int ld_sc, float* __restrict__ stats) {
  const int h = blockIdx.x, c = blockIdx.y, sl = blockIdx.z;
  bool write;
  const int rows = slot_rows(pos, sl, t_rows, &write);
  const int splits = splits_for(rows);
  if (c >= splits) return;
  const int nh = G * gridDim.x;
  const size_t plane = (size_t)t_rows * kvw;
  attn_scores_chunk<T, G>(part + (size_t)sl * ld, nb, (size_t)nslots * ld, qd, kvw, h, qn, kn,
                          cosr + sl * kQHd, sinr + sl * kQHd, eps, kc + sl * plane,
                          vc + sl * plane, rows, write, splits, c, sc + (size_t)sl * nh * ld_sc,
                          ld_sc, stats + (size_t)sl * nh * kMaxSplits * 2);
}

// Pass 2, grid (kv heads, kMaxSplits, slots): chunk c of kv head h of slot
// sl writes its context row at ctx + (sl * kMaxSplits + c) * qd.
template <typename T, int G>
__global__ void __launch_bounds__(kAttnThreads)
attn_pv_multi(const float* __restrict__ part, int nb, int nslots, int ld, int qd, int kvw,
              const T* __restrict__ vc, int t_rows, const int* __restrict__ pos,
              const float* __restrict__ sc, int ld_sc, const float* __restrict__ stats,
              float* __restrict__ ctx) {
  const int h = blockIdx.x, c = blockIdx.y, sl = blockIdx.z;
  bool write;
  const int rows = slot_rows(pos, sl, t_rows, &write);
  const int splits = splits_for(rows);
  if (c >= splits) return;
  const int nh = G * gridDim.x;
  attn_pv_chunk<T, G>(part + (size_t)sl * ld, nb, (size_t)nslots * ld, qd, kvw, h,
                      vc + sl * (size_t)t_rows * kvw, rows, splits, c,
                      sc + (size_t)sl * nh * ld_sc, ld_sc,
                      stats + (size_t)sl * nh * kMaxSplits * 2,
                      ctx + (size_t)sl * kMaxSplits * qd, qd);
}

template <int kIn>
void matvec(const float* x, int nx, size_t ldx, size_t ld_slot, int f, const int* pos, int t_rows,
            int nslots, const int8_t* w, const float* s, const float* zs, int k2, int n,
            float* part, cudaStream_t st) {
  const size_t smem = sizeof(float) * nslots * (2 * kBlock + 2);
  p4_matvec_multi<kIn><<<dim3(n / kBlock, k2 / kBlock), kMmThreads, smem, st>>>(
      x, nx, ldx, ld_slot, f, pos, t_rows, nslots, w, s, zs, n, k2, part);
}

// Scratch layout, in floats, for B slots, each part 16-byte aligned: xres, y
// (B x H each), ctx (B x kMaxSplits x nh*128), scores (B x nh x ld_sc, ld_sc
// >= T + 1), stats (B x nh x kMaxSplits x 2), partials A (H/128 x B x max(q|k|v
// width, 2F, V_pad)) and B (max(nh*128, F)/128 x B x H).
struct ScratchPlan {
  size_t y, ctx, sc, stats, part_a, part_b, floats;
  int ld_sc;
  static size_t up4(size_t v) { return (v + 3) / 4 * 4; }
  ScratchPlan(int nslots, int h, int nh, int nkv, int f, int t, int vp) {
    const size_t bs = nslots;
    ld_sc = static_cast<int>(up4(t + 1));
    const size_t qd = static_cast<size_t>(nh) * kQHd;
    const size_t qn = static_cast<size_t>(nh + 2 * nkv) * kQHd;
    y = up4(bs * h);
    ctx = y + up4(bs * h);
    sc = ctx + bs * kMaxSplits * qd;
    stats = sc + bs * nh * ld_sc;
    part_a = up4(stats + bs * nh * kMaxSplits * 2);
    part_b = part_a + bs * static_cast<size_t>(h / kBlock) *
                          std::max(std::max(qn, static_cast<size_t>(2 * f)), static_cast<size_t>(vp));
    floats = part_b + bs * std::max(qd, static_cast<size_t>(f)) / kBlock * h;
  }
};

template <typename T, int G>
void run_layers(const Weights& W, const float* x, const float* cosr, const float* sinr, T* kc,
                T* vc, const int* pos, float* hidden, float* logits, float* scratch, int nl, int bs,
                int h, int nh, int nkv, int f, int t, int vp, float eps, cudaStream_t st) {
  const ScratchPlan plan(bs, h, nh, nkv, f, t, vp);
  float *xres = scratch, *y = scratch + plan.y, *ctx = scratch + plan.ctx, *sc = scratch + plan.sc;
  float *stats = scratch + plan.stats, *pa = scratch + plan.part_a, *pb = scratch + plan.part_b;
  const int qd = nh * kQHd, kvw = nkv * kQHd, qn = qd + 2 * kvw;
  const int nbh = h / kBlock;
  const size_t smem = sizeof(float) * h;
  const size_t kbh = static_cast<size_t>(h / 2 / kBlock), kbo = qd / 2 / kBlock, kbf = f / 2 / kBlock;
  const dim3 grid(nkv, kMaxSplits, bs);

  resid_rms_multi<<<bs, kLnThreads, smem, st>>>(xres, x, nullptr, 0, bs, W.in_s, y, h, eps);
  for (int l = 0; l < nl; ++l) {
    T* kcl = kc + (size_t)l * bs * t * kvw;
    T* vcl = vc + (size_t)l * bs * t * kvw;
    // q|k|v, then attention over each slot's rows [0, pos) and its fresh row
    matvec<0>(y, 1, 0, h, 0, nullptr, t, bs, W.wq + (size_t)l * (h / 2) * qn,
              W.qkv_s + (size_t)l * 2 * kbh * qn, W.qkv_zs + (size_t)l * 2 * kbh * qn, h / 2, qn,
              pa, st);
    attn_scores_multi<T, G><<<grid, kAttnThreads, 0, st>>>(
        pa, nbh, bs, qn, qd, kvw, W.qn_s + (size_t)l * kQHd, W.kn_s + (size_t)l * kQHd, cosr, sinr,
        eps, kcl, vcl, t, pos, sc, plan.ld_sc, stats);
    attn_pv_multi<T, G><<<grid, kAttnThreads, 0, st>>>(pa, nbh, bs, qn, qd, kvw, vcl, t, pos, sc,
                                                       plan.ld_sc, stats, ctx);
    // o-proj over each slot's chunk contexts + residual, RMSNorm
    matvec<0>(ctx, 0, qd, (size_t)kMaxSplits * qd, 0, pos, t, bs, W.wo + (size_t)l * (qd / 2) * h,
              W.o_s + (size_t)l * 2 * kbo * h, W.o_zs + (size_t)l * 2 * kbo * h, qd / 2, h, pb, st);
    resid_rms_multi<<<bs, kLnThreads, smem, st>>>(xres, nullptr, pb, qd / kBlock, bs,
                                                  W.post_s + (size_t)l * h, y, h, eps);
    // gate|up, SiLU(gate) * up -> down + residual, the next RMSNorm
    matvec<0>(y, 1, 0, h, 0, nullptr, t, bs, W.wgu + (size_t)l * (h / 2) * 2 * f,
              W.gu_s + (size_t)l * 2 * kbh * 2 * f, W.gu_zs + (size_t)l * 2 * kbh * 2 * f, h / 2,
              2 * f, pa, st);
    matvec<1>(pa, nbh, (size_t)bs * 2 * f, 2 * f, f, nullptr, t, bs,
              W.wd + (size_t)l * (f / 2) * h, W.dn_s + (size_t)l * 2 * kbf * h,
              W.dn_zs + (size_t)l * 2 * kbf * h, f / 2, h, pb, st);
    const bool last = l + 1 == nl;
    resid_rms_multi<<<bs, kLnThreads, smem, st>>>(xres, nullptr, pb, f / kBlock, bs,
                                                  last ? W.fn_s : W.in_s + (size_t)(l + 1) * h,
                                                  last ? hidden : y, h, eps);
  }
  if (W.wh != nullptr) {
    matvec<0>(hidden, 1, 0, h, 0, nullptr, t, bs, W.wh, W.h_s, W.h_zs, h / 2, vp, pa, st);
    head_reduce_multi<<<dim3((vp + 255) / 256, bs), 256, 0, st>>>(pa, nbh, bs, logits, vp);
  }
}

}  // namespace

// Largest slot count fused_decode_multi takes.
extern "C" int fused_decode_multi_max_slots() { return kMaxSlots; }

// Floats of scratch memory fused_decode_multi needs (vp = 0 without the head).
extern "C" long long fused_decode_multi_scratch_floats(int nslots, int h, int nh, int nkv, int f,
                                                       int t, int vp) {
  return static_cast<long long>(ScratchPlan(nslots, h, nh, nkv, f, t, vp).floats);
}

// Enqueues the step on `stream` and returns cudaGetLastError() (0 on
// success). x, hidden (B, H); cos, sin (B, 128); caches (NL, B, T, nkv*128)
// of float (cache_bf16 = 0) or bf16; pos (B,) int32 on the device; wh, h_s,
// h_zs and logits (B, V_pad) are null without the head (vp = 0); scratch
// holds fused_decode_multi_scratch_floats(...) floats. The caller checks
// shapes, types, alignment, that nh = 2 nkv and 2 <= B <= kMaxSlots.
extern "C" int fused_decode_multi(
    const void* x, const void* cosr, const void* sinr, const void* in_s, const void* post_s,
    const void* qn_s, const void* kn_s, const void* fn_s, const void* wq, const void* qkv_s,
    const void* qkv_zs, const void* wo, const void* o_s, const void* o_zs, const void* wgu,
    const void* gu_s, const void* gu_zs, const void* wd, const void* dn_s, const void* dn_zs,
    const void* wh, const void* h_s, const void* h_zs, void* kc, void* vc, const void* pos,
    void* hidden, void* logits, void* scratch, int nl, int nslots, int h, int nh, int nkv, int f,
    int t, int vp, int cache_bf16, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Weights W = make_weights(in_s, post_s, qn_s, kn_s, fn_s, wq, qkv_s, qkv_zs, wo, o_s, o_zs,
                                 wgu, gu_s, gu_zs, wd, dn_s, dn_zs, wh, h_s, h_zs);
  const float *xf = static_cast<const float*>(x), *cf = static_cast<const float*>(cosr),
              *sf = static_cast<const float*>(sinr);
  const int* p = static_cast<const int*>(pos);
  float* hid = static_cast<float*>(hidden);
  float* lg = static_cast<float*>(logits);
  float* scr = static_cast<float*>(scratch);
  if (cache_bf16) {
    using T = __nv_bfloat16;
    run_layers<T, kGroups>(W, xf, cf, sf, static_cast<T*>(kc), static_cast<T*>(vc), p, hid, lg, scr,
                           nl, nslots, h, nh, nkv, f, t, vp, eps, st);
  } else {
    run_layers<float, kGroups>(W, xf, cf, sf, static_cast<float*>(kc), static_cast<float*>(vc), p,
                               hid, lg, scr, nl, nslots, h, nh, nkv, f, t, vp, eps, st);
  }
  return static_cast<int>(cudaGetLastError());
}
