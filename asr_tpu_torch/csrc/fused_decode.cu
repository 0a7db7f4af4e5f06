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
// heads a kv head; H and F multiples of 256; caches (NL, T, nkv*128) of
// float or bf16; every pointer 16-byte aligned. The wrapper
// (asr_tpu_torch/ops/fused_decode.py) checks all of it and passes the plan
// (decode_plan: each matvec's column tile and split, the attention's chunk
// rule).
//
// What bounds it on an H100 (3.35 TB/s HBM): a step is a chain of matvecs at
// batch 1 and one attention a layer, about 2 FLOP per weight byte, so it is
// memory bound. Qwen3-ASR-0.6B (H 1024, 28 layers, 16/8 heads, F 3072,
// V_pad 153600) reads 220 MB of packed int4 decoder weights and 27.5 MB of
// scales, the 78.6 MB packed head and 9.8 MB of its scales, and 2 x 28 x pos
// x 2 KB of bf16 cache (50 MB at pos 440): about 0.39 GB, a floor of about
// 0.115 ms a step. A layer's matvecs are 7.86 MB, 2.3 us of HBM time: each
// is bound by latency, so the design keeps every SM fed and the launches
// chained.
//
// Design: the step of qwen_common.cuh (shared with the multi-slot step,
// fused_decode_multi.cu) at one slot: 7 chained kernels a layer, the
// tensor-core nibble matvec with its split-K sum inside a cluster, attention
// in one launch, inputs staged once by their producers. This file adds the
// batch-1 entry (pos and shift from the host loop, which knows them) and the
// matvec alone (qwen_matvec) for tests and timing.

#include "qwen_common.cuh"

// Floats of scratch memory fused_decode needs.
extern "C" long long fused_decode_scratch_floats(int h, int nh, int nkv, int f) {
  return static_cast<long long>(qwen::Scratch(1, h, nh, nkv, f).floats);
}

// Enqueues the step on `stream` and returns the first launch's error (0 on
// success). Caches are (NL, T, nkv*128) of float (cache_bf16 = 0) or bf16;
// wh, h_s, h_zs and logits are null without the head (vp = 0); scratch holds
// fused_decode_scratch_floats(...) floats; plan holds qwen::kPlanInts ints.
// The caller checks shapes, types, alignment, that nh = 2 nkv, and 0 <=
// shift <= pos < T.
extern "C" int fused_decode(
    const void* x, const void* cosr, const void* sinr, const void* in_s, const void* post_s,
    const void* qn_s, const void* kn_s, const void* fn_s, const void* wq, const void* qkv_s,
    const void* qkv_zs, const void* wo, const void* o_s, const void* o_zs, const void* wgu,
    const void* gu_s, const void* gu_zs, const void* wd, const void* dn_s, const void* dn_zs,
    const void* wh, const void* h_s, const void* h_zs, void* kc, void* vc, void* hidden,
    void* logits, void* scratch, int nl, int h, int nh, int nkv, int f, int t, int vp, int pos,
    int shift, int cache_bf16, float eps, const int* plan, void* stream) {
  using namespace qwen;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Weights W = make_weights(in_s, post_s, qn_s, kn_s, fn_s, wq, qkv_s, qkv_zs, wo, o_s, o_zs,
                                 wgu, gu_s, gu_zs, wd, dn_s, dn_zs, wh, h_s, h_zs);
  const Plan P(plan);
  const float *xf = static_cast<const float*>(x), *cf = static_cast<const float*>(cosr),
              *sf = static_cast<const float*>(sinr);
  float* hid = static_cast<float*>(hidden);
  float* lg = static_cast<float*>(logits);
  float* scr = static_cast<float*>(scratch);
  cudaError_t err;
  if (cache_bf16) {
    using T = __nv_bfloat16;
    err = run_step<T>(W, P, xf, cf, sf, static_cast<T*>(kc), static_cast<T*>(vc), nullptr, pos,
                      shift, hid, lg, scr, nl, 1, h, nh, nkv, f, t, vp, eps, st);
  } else {
    err = run_step<float>(W, P, xf, cf, sf, static_cast<float*>(kc), static_cast<float*>(vc),
                          nullptr, pos, shift, hid, lg, scr, nl, 1, h, nh, nkv, f, t, vp, eps, st);
  }
  return static_cast<int>(err);
}

// Floats of scratch memory qwen_matvec needs for `rows` rows of depth k.
extern "C" long long qwen_matvec_scratch_floats(int rows, int k) {
  return static_cast<long long>(qwen::Staged::floats(rows > 16 ? 32 : 16, k));
}

// The step's matvec alone: out (rows, n) = x (rows, k) through a packed
// (k/2, n) weight with (2, k/256, n) scales and zero*scales, x staged first
// (a second kernel, chained to the matvec), with the tile (bn, parts) of a
// plan. rows <= 32; k a multiple of 256.
extern "C" int qwen_matvec(const void* x, const void* w, const void* s, const void* zs, void* out,
                           void* scratch, int rows, int k, int n, int bn, int parts, void* stream) {
  using namespace qwen;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 1 || rows > 32 || k % 256) return static_cast<int>(cudaErrorInvalidValue);
  float* scr = static_cast<float*>(scratch);
  const int mpad = rows > 16 ? 32 : 16;
  cudaError_t err = launch(stage_rows, dim3(k / 256, rows), dim3(256), 0, st, 1, 0,
                           static_cast<const float*>(x), k, scr, mpad);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Mv a{scr, static_cast<const int8_t*>(w), static_cast<const float*>(s),
             static_cast<const float*>(zs), k, n, rows, parts, 0, static_cast<float*>(out), n,
             nullptr};
  return static_cast<int>(launch_matvec(a, bn, 1, st));
}

// What the plan (ops/fused_decode.py) must know of this file, which the
// wrapper checks against its own copies when it loads the library: the
// parts of a matvec tile at most, the 128-row blocks a part holds, the
// packed rows of a stage and their padding, the shared memory a block may
// take, the attention's chunks at most (its cluster) and the plan's ints.
extern "C" void qwen_plan_limits(int* out) {
  using namespace qwen;
  const int v[] = {kMaxParts, kMaxBlocksPerPart, kStage, packed::BPAD, kMaxSmem, kMaxChunks, kPlanInts};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
}

// Shared memory of a matvec block of column tile bn (32 or 64) split into
// `parts` over depth k, for `rows` slots; -1 for a tile this file has no
// kernel for.
extern "C" long long qwen_matvec_smem(int bn, int parts, int k, int rows) {
  using namespace qwen;
  if (parts < 1 || k % 256 || rows < 1 || rows > 32 || (bn != 32 && bn != 64)) return -1;
  const bool two = rows > 16;
  const size_t b = bn == 32 ? (two ? mv_smem<2, 1>(k, rows, parts) : mv_smem<1, 1>(k, rows, parts))
                            : (two ? mv_smem<2, 2>(k, rows, parts) : mv_smem<1, 2>(k, rows, parts));
  return static_cast<long long>(b);
}
