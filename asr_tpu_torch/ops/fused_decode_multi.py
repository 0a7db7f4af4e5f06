"""One multi-slot Qwen3 decode step: every continuous-batching slot advances
by one token through all layers, the final RMSNorm and the optional
packed-int4 tied head.

Counterpart of ``asr_tpu/ops/fused_decode_multi.py``. The continuous LLM
engine (``parallel/llm_batcher.py``) gives each request its own compact
cache planes and position, so requests join and leave a running batch
mid-flight. For every slot the step computes what the batch-1 step
(``ops/fused_decode.py``) computes for that slot alone at shift 0, with the
same rounding points; the weights are read once for all slots.

:func:`fused_decode_step_multi` runs it on a CUDA tensor through the
hand-written Hopper kernel ``asr_tpu_torch/csrc/fused_decode_multi.cu``
(nvcc, ``sm_90a``, bound with ``ctypes``) or raises; on a CPU tensor it runs
the plain PyTorch version :func:`fused_decode_step_multi_reference`, which
runs each slot through the batch-1 plain version's layer, so a slot's
results equal that version's bitwise. Both kernels run one step design and
one plan (``fd.decode_plan``), so on the card too a slot equals the batch-1
kernel's result for it alone, bitwise.

``pos`` is a ``(B,)`` int32 tensor on the caches' device, so a step needs no
host synchronisation. ``pos[b] = -1`` parks slot b: it writes no cache row,
attends only to its own fresh row and returns finite output the caller
discards. The TPU kernel's VMEM planning (``fused_fits_multi``), its 8-row
aligned cache patches and DMA semaphores have no counterpart; the kernel
takes B >= 2 slots (batch 1 is the batch-1 step's job), at most
``MAX_SLOTS``.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from asr_tpu_torch.ops import fused_decode as fd
from asr_tpu_torch.ops import nvcc_build

# Kernel launches since import (or since a caller reset it to 0): one per step.
LAUNCHES = 0

SOURCE = nvcc_build.CSRC / "fused_decode_multi.cu"
NVCC_FLAGS = nvcc_build.NVCC_FLAGS
MAX_SLOTS = fd.MAX_ROWS  # kMaxSlots in the kernel source: two m16 tiles of the matvec

_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def kernel_takes(cfg, n_slots: int) -> bool:
    """Whether the kernel takes this geometry and slot count."""
    return (cfg.head_dim == fd.HEAD_DIM and cfg.num_heads == fd.GROUPS * cfg.num_kv_heads
            and cfg.hidden % 256 == 0 and cfg.ffn_dim % 256 == 0
            and 2 <= n_slots <= MAX_SLOTS)


# ── plain PyTorch version ───────────────────────────────────────────────


def fused_decode_step_multi_reference(stacked: dict, cfg, x: torch.Tensor,
                                      k_cache: torch.Tensor, v_cache: torch.Tensor,
                                      pos: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Plain PyTorch version of the kernel, same arguments and results as
    :func:`fused_decode_step_multi`: each slot through the batch-1 plain
    version's layers at shift 0 (its planes take row ``pos[b]`` in place),
    each layer's nibbles unpacked once for all slots."""
    st, t = stacked, k_cache.shape[2]
    hd = fd.HEAD_DIM
    slots = []
    for b, p in enumerate(pos.tolist()):
        if 0 <= p < t:  # views: row p is written in place
            slots.append((k_cache[:, b], v_cache[:, b], p))
        else:  # parked: only the fresh row, written into a throwaway row
            slots.append((k_cache[:, b, :1].clone(), v_cache[:, b, :1].clone(), 0))
    xs = [x[b : b + 1].to(torch.float32) for b in range(len(slots))]
    cs = [(cos[b : b + 1].reshape(1, hd).to(torch.float32),
           sin[b : b + 1].reshape(1, hd).to(torch.float32)) for b in range(len(slots))]
    for l in range(k_cache.shape[0]):
        mats = fd._layer_weights(st, l)
        for b, (kc, vc, p) in enumerate(slots):
            xs[b] = fd._layer(st, l, mats, cfg, xs[b], kc[l], vc[l], p, 0, *cs[b])
    hidden = [fd._rms(xb, st["fn_s"], cfg.rms_eps) for xb in xs]
    logits = None
    if "wh" in st:
        vals = fd._nibbles(st["wh"])
        logits = torch.cat([fd._dot(hb, vals, st["h_s"][0], st["h_zs"][0]) for hb in hidden])
    return torch.cat(hidden), logits, k_cache, v_cache


# ── the CUDA kernel ─────────────────────────────────────────────────────


def build() -> tuple[Path, str]:
    """Compile the kernel (once per source and flags); return (library, nvcc log)."""
    return nvcc_build.build(SOURCE, NVCC_FLAGS)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            # x, cos, sin, 17 stacked arrays, wh, h_s, h_zs, k, v, pos, hidden, logits, scratch;
            # 9 ints, eps, plan, stream
            lib.fused_decode_multi.argtypes = ([ctypes.c_void_p] * 29 + [ctypes.c_int] * 9
                                               + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
            lib.fused_decode_multi.restype = ctypes.c_int
            lib.fused_decode_multi_scratch_floats.argtypes = [ctypes.c_int] * 5
            lib.fused_decode_multi_scratch_floats.restype = ctypes.c_longlong
            lib.fused_decode_multi_max_slots.restype = ctypes.c_int
            if lib.fused_decode_multi_max_slots() != MAX_SLOTS:
                raise RuntimeError("fused_decode_multi.cu and MAX_SLOTS disagree")
            _lib = lib
    return _lib


def fused_decode_step_multi_cuda(stacked: dict, cfg, x: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor, pos: torch.Tensor, cos: torch.Tensor,
                                 sin: torch.Tensor, plan: fd.DecodePlan | None = None):
    """Launch the CUDA kernel; checks every argument and raises on what the
    kernel does not take (2..MAX_SLOTS slots, head width 128, 2 q heads a kv
    head, H and F multiples of 256, block-128 packed weights, f32 or bf16
    caches of one dtype, int32 ``pos`` on the card). ``plan`` defaults to
    ``fd.decode_plan``'s, the batch-1 step's: it never depends on B."""
    global LAUNCHES
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"fused_decode_step_multi_cuda needs CUDA tensors, got {dev}")
    h, nh, nkv, f = cfg.hidden, cfg.num_heads, cfg.num_kv_heads, cfg.ffn_dim
    if cfg.head_dim != fd.HEAD_DIM or nh != fd.GROUPS * nkv or h % 256 or f % 256:
        raise ValueError(f"the kernel takes head_dim {fd.HEAD_DIM}, {fd.GROUPS} q heads a kv head "
                         f"and H, F multiples of 256; got {cfg}")
    nl, bs, t = k_cache.shape[0], k_cache.shape[1], k_cache.shape[2]
    if not 2 <= bs <= MAX_SLOTS:
        raise ValueError(f"the multi-slot kernel takes 2..{MAX_SLOTS} slots, got {bs} "
                         "(batch 1 is fused_decode_step's)")
    for key, shape in fd._stacked_shapes(nl, h, nh, nkv, f).items():
        dtypes = (torch.int8,) if key.startswith("w") else (torch.float32,)
        fd._check(key, stacked[key], shape, dtypes, dev)
    head = "wh" in stacked
    vp = stacked["wh"].shape[1] if head else 0
    if head:
        if vp % fd.BLOCK:
            raise ValueError(f"wh must be (H/2, V_pad) with V_pad a multiple of {fd.BLOCK}, got {vp}")
        fd._check("wh", stacked["wh"], (h // 2, vp), (torch.int8,), dev)
        for key in ("h_s", "h_zs"):
            fd._check(key, stacked[key], (1, 2, h // 256, vp), (torch.float32,), dev)
    fd._check("x", x, (bs, h), (torch.float32,), dev)
    for name, a in (("cos", cos), ("sin", sin)):
        fd._check(name, a, (bs, fd.HEAD_DIM), (torch.float32,), dev)
    cdt = k_cache.dtype
    if cdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"caches must be float32 or bfloat16, got {cdt}")
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        fd._check(name, c, (nl, bs, t, nkv * fd.HEAD_DIM), (cdt,), dev)
    fd._check("pos", pos, (bs,), (torch.int32,), dev)
    plan = plan or fd.decode_plan(cfg, t, vp)
    lib = _load()
    scratch = torch.empty((lib.fused_decode_multi_scratch_floats(bs, h, nh, nkv, f),),
                          device=dev, dtype=torch.float32)
    hidden = torch.empty((bs, h), device=dev, dtype=torch.float32)
    logits = torch.empty((bs, vp), device=dev, dtype=torch.float32) if head else None
    null = ctypes.c_void_p(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_decode_multi(
            x.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            *(stacked[k].data_ptr() for k in fd._ORDER),
            *((stacked[k].data_ptr() for k in ("wh", "h_s", "h_zs")) if head else (null,) * 3),
            k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(), hidden.data_ptr(),
            logits.data_ptr() if head else null, scratch.data_ptr(),
            nl, bs, h, nh, nkv, f, t, vp, int(cdt == torch.bfloat16), cfg.rms_eps,
            plan.c_array(), stream)
    if err != 0:
        raise RuntimeError(f"fused_decode_multi launch failed: CUDA error {err}")
    with _count_lock:
        LAUNCHES += 1
    return hidden, logits, k_cache, v_cache


def fused_decode_step_multi(stacked: dict, cfg, x: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, pos: torch.Tensor, cos: torch.Tensor,
                            sin: torch.Tensor):
    """One multi-slot Qwen3 decode step.

    Args:
      stacked: from ``ops.fused_decode.stack_decode_params`` (the same
        stacked weights the batch-1 step takes).
      x: (B, H) f32 input embedding rows (B >= 2 slots).
      k_cache/v_cache: (NL, B, T, n_kv * 128) per-slot planes, f32 or bf16;
        row ``pos[b]`` of slot b's planes is written in place, every other
        row is left as it was.
      pos: (B,) int32 compact cache positions (tokens so far in the slot);
        -1 parks a slot.
      cos/sin: (B, 128) f32 RoPE rows at each slot's position.

    Returns ``(hidden, logits, k_cache, v_cache)``: ``hidden`` (B, H) f32 is
    final-normalized; ``logits`` (B, V_pad) f32 when the stacked weights
    carry the head (pad columns exactly 0), else None. On a CPU tensor this
    is the plain version; on a CUDA tensor the kernel.
    """
    if x.shape[0] < 2:
        raise ValueError("the multi-slot step needs >= 2 slots (fused_decode_step takes batch 1)")
    if x.device.type == "cpu":
        return fused_decode_step_multi_reference(stacked, cfg, x, k_cache, v_cache, pos, cos, sin)
    return fused_decode_step_multi_cuda(stacked, cfg, x, k_cache, v_cache, pos, cos, sin)
