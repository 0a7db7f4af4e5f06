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
// (asr_tpu_torch/ops/fused_aed_step.py) checks all of it and passes the
// plan (aed_plan: each matvec's column tile and split of K, the
// attentions' chunk rule and staging).
//
// What bounds it on an H100 (3.35 TB/s HBM): a step is a chain of matvecs
// and two attentions at batch 1, a few FLOP per byte, so it is memory
// bound. Whisper-Large-v3-Turbo (D 1280, F 5120, 4 layers, V_pad 52224)
// reads 91.8 MB of int8 decoder weights and 5.7 MB of scales, the 66.8 MB
// int8 head and 4.2 MB of its scales, 61.4 MB of f32 cross K/V (30.7 MB in
// bf16) and up to 18.4 MB of f32 self cache: 0.21-0.25 GB, a floor of about
// 62-74 us per step. A layer's matvecs are 23 MB, 7 us of HBM time, in six
// launches: each is bound by latency as much as by bytes, so the design
// keeps every SM fed and the launches chained.
//
// Design: the step of aed_step.cuh (shared with the multi-slot step,
// fused_aed_multi.cu) at one slot: 11 chained kernels a layer, the
// tensor-core int8 matvec with its split-K sum inside a cluster, each
// attention in one launch, inputs staged once by their producers. This
// file adds the batch-1 entries: fused_aed_step takes pos and tc_valid from
// the host loop, which knows them; fused_aed_step_dev reads them from device
// ints, so a CUDA graph of one token (ops/fused_aed_step.py:
// FusedAedDecoder) replays it at every position, the position advanced on
// the device. Both run the same kernels with the same plan, so their outputs
// are bitwise equal. Then the matvec alone (aed_matvec) for tests and
// timing, and what the plan checks of the kernels.

#include "aed_step.cuh"

// Floats of scratch memory fused_aed_step needs.
extern "C" long long fused_aed_step_scratch_floats(int d, int f) {
  return static_cast<long long>(aedstep::Scratch(1, d, f).floats);
}

// Enqueues the step on `stream` and returns the first launch's error (0 on
// success). Caches are (NL, rows, D) of float (cache_bf16 = 0) or bf16;
// scratch holds fused_aed_step_scratch_floats(...) floats; plan holds
// aedstep::kPlanInts ints. The caller checks shapes, types, alignment and
// that pos < t_self, 1 <= tc_valid <= t_cross.
extern "C" int fused_aed_step(
    const void* x, const void* ln1_s, const void* ln1_b, const void* lnc_s, const void* lnc_b,
    const void* ln2_s, const void* ln2_b, const void* lnf_s, const void* lnf_b, const void* ba,
    const void* bb, const void* wa, const void* a_s, const void* a_zs, const void* wb,
    const void* b_s, const void* b_zs, const void* wh, const void* h_s, const void* h_zs,
    void* kself, void* vself, void* ck, void* cv, void* logits, void* scratch, int nl, int d,
    int heads, int f, int t_self, int t_cross, int vp, int pos, int tc_valid, int cache_bf16,
    float eps, const int* plan, void* stream) {
  using namespace aedstep;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Weights W = make_weights(ln1_s, ln1_b, lnc_s, lnc_b, ln2_s, ln2_b, lnf_s, lnf_b, ba, bb, wa, a_s,
                                 a_zs, wb, b_s, b_zs, wh, h_s, h_zs);
  const Plan P(plan);
  const float* xf = static_cast<const float*>(x);
  float* lg = static_cast<float*>(logits);
  float* scr = static_cast<float*>(scratch);
  cudaError_t err;
  if (cache_bf16) {
    using T = __nv_bfloat16;
    err = run_step<T>(W, P, xf, static_cast<T*>(kself), static_cast<T*>(vself), static_cast<T*>(ck),
                      static_cast<T*>(cv), nullptr, nullptr, pos, tc_valid, lg, scr, nl, 1, d, heads, f,
                      t_self, t_cross, vp, eps, st);
  } else {
    using T = float;
    err = run_step<T>(W, P, xf, static_cast<T*>(kself), static_cast<T*>(vself), static_cast<T*>(ck),
                      static_cast<T*>(cv), nullptr, nullptr, pos, tc_valid, lg, scr, nl, 1, d, heads, f,
                      t_self, t_cross, vp, eps, st);
  }
  return static_cast<int>(err);
}

// fused_aed_step with pos and tc_valid read on the device from one int32
// each (the multi-slot step's path at one slot), so the launches can be
// captured once and replayed at every position. The caller checks what
// fused_aed_step's caller checks, and 0 <= *pos < t_self once for the whole
// loop.
extern "C" int fused_aed_step_dev(
    const void* x, const void* ln1_s, const void* ln1_b, const void* lnc_s, const void* lnc_b,
    const void* ln2_s, const void* ln2_b, const void* lnf_s, const void* lnf_b, const void* ba,
    const void* bb, const void* wa, const void* a_s, const void* a_zs, const void* wb,
    const void* b_s, const void* b_zs, const void* wh, const void* h_s, const void* h_zs,
    void* kself, void* vself, void* ck, void* cv, const void* pos, const void* tc_valid,
    void* logits, void* scratch, int nl, int d, int heads, int f, int t_self, int t_cross, int vp,
    int cache_bf16, float eps, const int* plan, void* stream) {
  using namespace aedstep;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Weights W = make_weights(ln1_s, ln1_b, lnc_s, lnc_b, ln2_s, ln2_b, lnf_s, lnf_b, ba, bb, wa, a_s,
                                 a_zs, wb, b_s, b_zs, wh, h_s, h_zs);
  const Plan P(plan);
  const float* xf = static_cast<const float*>(x);
  const int* p = static_cast<const int*>(pos);
  const int* tv = static_cast<const int*>(tc_valid);
  float* lg = static_cast<float*>(logits);
  float* scr = static_cast<float*>(scratch);
  cudaError_t err;
  if (cache_bf16) {
    using T = __nv_bfloat16;
    err = run_step<T>(W, P, xf, static_cast<T*>(kself), static_cast<T*>(vself), static_cast<T*>(ck),
                      static_cast<T*>(cv), p, tv, 0, 0, lg, scr, nl, 1, d, heads, f, t_self, t_cross, vp,
                      eps, st);
  } else {
    using T = float;
    err = run_step<T>(W, P, xf, static_cast<T*>(kself), static_cast<T*>(vself), static_cast<T*>(ck),
                      static_cast<T*>(cv), p, tv, 0, 0, lg, scr, nl, 1, d, heads, f, t_self, t_cross, vp,
                      eps, st);
  }
  return static_cast<int>(err);
}

// Floats of scratch memory aed_matvec needs for `rows` rows of depth k.
extern "C" long long aed_matvec_scratch_floats(int rows, int k) {
  return static_cast<long long>(aedstep::Staged::floats(rows > 16 ? 32 : 16, k));
}

// The step's matvec alone: out (rows, n) = x (rows, k) through an int8 (k, n)
// weight with (k/128, n) scales and zero*scales, x staged first (a second
// kernel, chained to the matvec), with the tile (bn, parts) of a plan.
// rows <= 32; k a multiple of 128.
extern "C" int aed_matvec(const void* x, const void* w, const void* s, const void* zs, void* out,
                          void* scratch, int rows, int k, int n, int bn, int parts, void* stream) {
  using namespace aedstep;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 1 || rows > 32 || k % kBlock) return static_cast<int>(cudaErrorInvalidValue);
  float* scr = static_cast<float*>(scratch);
  const int mpad = rows > 16 ? 32 : 16;
  cudaError_t err = launch(stage_rows, dim3(k / kBlock, rows), dim3(kBlock), 0, st, 1, 0,
                           static_cast<const float*>(x), k, scr, mpad);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Mv a{scr, static_cast<const int8_t*>(w), static_cast<const float*>(s),
             static_cast<const float*>(zs), nullptr, k, n, n, rows, parts, kOut,
             static_cast<float*>(out), n, nullptr};
  return static_cast<int>(launch_matvec(a, bn, 1, st));
}

// What the plan (ops/fused_aed_step.py) must know of this file, which the
// wrapper checks against its own copies when it loads the library: the
// parts of a matvec tile at most, the padding of a staged weight row, the
// shared memory a block may take, the attention's chunks at most (its
// cluster), its threads a block and the plan's ints.
extern "C" void aed_plan_limits(int* out) {
  using namespace aedstep;
  const int v[] = {kMaxParts, kWPad, kMaxSmem, kMaxChunks, kRowThreads, kPlanInts};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
}

// Shared memory of a matvec block of column tile bn (32, 64 or 128) split
// into `parts` over depth k, for `rows` slots; -1 for a tile this file has
// no kernel for.
extern "C" long long aed_matvec_smem(int bn, int parts, int k, int rows) {
  if (parts < 1 || k % aed::kBlock || rows < 1 || rows > 32) return -1;
  const size_t b = aedstep::matvec_smem(bn, parts, k, rows);
  return b == 0 ? -1 : static_cast<long long>(b);
}

// Shared memory of an attention block holding `cap` score rows and staging
// `srows` k and v rows of `itemsize` bytes a value.
extern "C" long long aed_attn_smem(int cap, int srows, int itemsize) {
  return static_cast<long long>(aedstep::attn_smem(cap, srows, itemsize));
}
