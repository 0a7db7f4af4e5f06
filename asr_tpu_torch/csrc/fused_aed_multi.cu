// One multi-slot AED decode step for Hopper (sm_90a): every continuous-
// batching slot of a pre-LN encoder-decoder decoder advances by one token
// through all layers, the final LayerNorm and the q8 tied head, behind one
// C entry point.
//
// Replaces the Pallas TPU megakernel asr_tpu/ops/fused_aed_multi.py:_kernel
// (fused_aed_step_multi). It follows that kernel's math, not its VMEM strip
// pools or paired-head lanes: for every slot b the result is what the
// batch-1 step (fused_aed_step.cu) computes for that slot alone, bitwise.
// Both run the step of aed_step.cuh, whose every order (the matvec's k16
// steps, block terms and parts, the attention's chunks and their
// combination, the staging sums) depends on the shapes alone and never on
// the slot count: slots are the rows of the matvec's m16 tiles, and
// mma.sync's result for a row does not depend on the other rows.
//
// Per slot: pos[b] >= 0 is the cache row the token takes (written in place
// into that slot's self planes); pos[b] = -1 parks the slot: it writes no
// cache row, attends only to its own fresh row and gives finite logits that
// the caller discards. Cross attention of slot b masks rows at and past
// tc_valid[b]. pos and tc_valid are (B,) int32 device arrays, so a step
// needs no host synchronisation.
//
// Takes: B >= 2 slots (batch 1 is fused_aed_step.cu's job), at most
// kMaxSlots; head_dim 64; D and F multiples of 128; quantization block 128;
// self planes (NL, B, T, D) and cross planes (NL, B, Tc, D) row-major, of
// one type, float or bf16; every pointer 16-byte aligned. The wrapper
// (asr_tpu_torch/ops/fused_aed_multi.py) checks all of it and passes the
// batch-1 step's plan.
//
// What bounds it on an H100 (3.35 TB/s HBM): the weights are read once for
// all slots. Whisper-Large-v3-Turbo (D 1280, F 5120, 4 layers, V_pad
// 52224) reads 168.5 MB a step for every slot together (91.8 MB int8
// decoder weights, 5.7 MB of scales, the 66.8 MB int8 head, 4.2 MB of its
// scales); each slot adds its caches: 61.4 MB of f32 cross K/V (30.7 MB in
// bf16) and up to 18.4 MB of f32 self cache (9.2 MB in bf16) at pos 447.
// At B = 8, pos 447, that is 0.49 GB with bf16 caches and 0.81 GB with f32,
// a floor of about 146 and 241 us a step; attention carries ~79 % of the
// f32 bytes, so its chunks stage their k and v rows with every copy in
// flight at once. The matvec's tensor cores take the B rows of a tile at
// no extra weight traffic.

#include "aed_step.cuh"

namespace {
constexpr int kMaxSlots = 32;  // two m16 tiles of the matvec
}  // namespace

// Largest slot count fused_aed_step_multi takes.
extern "C" int fused_aed_multi_max_slots() { return kMaxSlots; }

// Floats of scratch memory fused_aed_step_multi needs.
extern "C" long long fused_aed_multi_scratch_floats(int nslots, int d, int f) {
  return static_cast<long long>(aedstep::Scratch(nslots, d, f).floats);
}

// Enqueues the step on `stream` and returns the first launch's error (0 on
// success). x is (B, D); self planes (NL, B, t_self, D) and cross planes
// (NL, B, t_cross, D) of float (cache_bf16 = 0) or bf16; pos and tc_valid
// (B,) int32 on the device; logits (B, V_pad); scratch holds
// fused_aed_multi_scratch_floats(...) floats; plan holds aedstep::kPlanInts
// ints. The caller checks shapes, types, alignment and 2 <= B <= kMaxSlots.
extern "C" int fused_aed_step_multi(
    const void* x, const void* ln1_s, const void* ln1_b, const void* lnc_s, const void* lnc_b,
    const void* ln2_s, const void* ln2_b, const void* lnf_s, const void* lnf_b, const void* ba,
    const void* bb, const void* wa, const void* a_s, const void* a_zs, const void* wb,
    const void* b_s, const void* b_zs, const void* wh, const void* h_s, const void* h_zs,
    void* kself, void* vself, void* ck, void* cv, const void* pos, const void* tc_valid,
    void* logits, void* scratch, int nl, int nslots, int d, int heads, int f, int t_self,
    int t_cross, int vp, int cache_bf16, float eps, const int* plan, void* stream) {
  using namespace aedstep;
  if (nslots < 2 || nslots > kMaxSlots) return static_cast<int>(cudaErrorInvalidValue);
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
                      static_cast<T*>(cv), p, tv, 0, 0, lg, scr, nl, nslots, d, heads, f, t_self, t_cross,
                      vp, eps, st);
  } else {
    using T = float;
    err = run_step<T>(W, P, xf, static_cast<T*>(kself), static_cast<T*>(vself), static_cast<T*>(ck),
                      static_cast<T*>(cv), p, tv, 0, 0, lg, scr, nl, nslots, d, heads, f, t_self, t_cross,
                      vp, eps, st);
  }
  return static_cast<int>(err);
}
