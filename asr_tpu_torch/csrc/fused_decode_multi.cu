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
// alone at shift 0, bitwise. Both run the step of qwen_common.cuh, whose
// every order (the matvec's split and block sum, the attention's chunks and
// their combination, the staging sums) depends on the shapes alone and never
// on the slot count: slots are the rows of the matvec's m16 tiles, and
// mma.sync's result for a row does not depend on the other rows.
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
// (asr_tpu_torch/ops/fused_decode_multi.py) checks all of it and passes the
// batch-1 step's plan.
//
// What bounds it on an H100 (3.35 TB/s HBM): the weights are read once for
// all slots. Qwen3-ASR-0.6B (H 1024, 28 layers, 16/8 heads, F 3072, V_pad
// 153600) reads 220 MB of packed decoder weights, 27.5 MB of their scales
// and 88 MB of packed head and scales a step, for every slot together; each
// slot adds 2 x 28 x pos rows of cache, 2 KB a row in bf16 (4 KB in f32). At
// B = 8, pos 440, that is 0.74 GB with bf16 caches and 1.14 GB with f32, a
// floor of about 0.22 and 0.34 ms a step. The matvec's tensor cores take
// the B rows of a tile at no extra weight traffic.

#include "qwen_common.cuh"

namespace {
constexpr int kMaxSlots = 32;  // two m16 tiles of the matvec
}  // namespace

// Largest slot count fused_decode_multi takes.
extern "C" int fused_decode_multi_max_slots() { return kMaxSlots; }

// Floats of scratch memory fused_decode_multi needs.
extern "C" long long fused_decode_multi_scratch_floats(int nslots, int h, int nh, int nkv, int f) {
  return static_cast<long long>(qwen::Scratch(nslots, h, nh, nkv, f).floats);
}

// Enqueues the step on `stream` and returns the first launch's error (0 on
// success). x, hidden (B, H); cos, sin (B, 128); caches (NL, B, T, nkv*128)
// of float (cache_bf16 = 0) or bf16; pos (B,) int32 on the device; wh, h_s,
// h_zs and logits (B, V_pad) are null without the head (vp = 0); scratch
// holds fused_decode_multi_scratch_floats(...) floats; plan holds
// qwen::kPlanInts ints. The caller checks shapes, types, alignment, that nh
// = 2 nkv and 2 <= B <= kMaxSlots.
extern "C" int fused_decode_multi(
    const void* x, const void* cosr, const void* sinr, const void* in_s, const void* post_s,
    const void* qn_s, const void* kn_s, const void* fn_s, const void* wq, const void* qkv_s,
    const void* qkv_zs, const void* wo, const void* o_s, const void* o_zs, const void* wgu,
    const void* gu_s, const void* gu_zs, const void* wd, const void* dn_s, const void* dn_zs,
    const void* wh, const void* h_s, const void* h_zs, void* kc, void* vc, const void* pos,
    void* hidden, void* logits, void* scratch, int nl, int nslots, int h, int nh, int nkv, int f,
    int t, int vp, int cache_bf16, float eps, const int* plan, void* stream) {
  using namespace qwen;
  if (nslots < 2 || nslots > kMaxSlots) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Weights W = make_weights(in_s, post_s, qn_s, kn_s, fn_s, wq, qkv_s, qkv_zs, wo, o_s, o_zs,
                                 wgu, gu_s, gu_zs, wd, dn_s, dn_zs, wh, h_s, h_zs);
  const Plan P(plan);
  const float *xf = static_cast<const float*>(x), *cf = static_cast<const float*>(cosr),
              *sf = static_cast<const float*>(sinr);
  const int* p = static_cast<const int*>(pos);
  float* hid = static_cast<float*>(hidden);
  float* lg = static_cast<float*>(logits);
  float* scr = static_cast<float*>(scratch);
  cudaError_t err;
  if (cache_bf16) {
    using T = __nv_bfloat16;
    err = run_step<T>(W, P, xf, cf, sf, static_cast<T*>(kc), static_cast<T*>(vc), p, 0, 0, hid, lg,
                      scr, nl, nslots, h, nh, nkv, f, t, vp, eps, st);
  } else {
    err = run_step<float>(W, P, xf, cf, sf, static_cast<float*>(kc), static_cast<float*>(vc), p, 0,
                          0, hid, lg, scr, nl, nslots, h, nh, nkv, f, t, vp, eps, st);
  }
  return static_cast<int>(err);
}
