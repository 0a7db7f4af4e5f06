"""One multi-slot AED decode step: every continuous-batching slot advances by
one token through all decoder layers and the q8 tied head.

Counterpart of ``asr_tpu/ops/fused_aed_multi.py``. The continuous AED engine
(``parallel/aed_batcher.py``) gives each request its own self-KV plane and
its own cross-KV plane (its encoder output), with per-slot positions, so
requests join and leave a running batch mid-flight. For every slot the step
computes what the batch-1 step (``ops/fused_aed_step.py``) computes for that
slot alone, with the same rounding points; the weights are read once for all
slots.

:func:`fused_aed_step_multi` runs it on a CUDA tensor through the
hand-written Hopper kernel ``asr_tpu_torch/csrc/fused_aed_multi.cu`` (nvcc,
``sm_90a``, bound with ``ctypes``) or raises; on a CPU tensor it runs the
plain PyTorch version :func:`fused_aed_step_multi_reference`, which is the
batch-1 plain version run slot by slot.

``pos`` and ``tc_valid`` are ``(B,)`` int32 tensors on the caches' device,
so a step needs no host synchronisation. ``pos[b] = -1`` parks slot b: it
writes no cache row, attends only to its own fresh row and returns finite
logits the caller discards. The TPU kernel's VMEM planning
(``aed_fused_fits_multi``) has no counterpart; the kernel takes B >= 2
slots (batch 1 is the batch-1 step's job), at most the kernel's
``max_slots``, and the batch-1 step's plan (``ops/fused_aed_step.aed_plan``),
which has no slot count in it: that is what keeps each slot bitwise the
batch-1 step.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from asr_tpu_torch.ops import nvcc_build
from asr_tpu_torch.ops.fused_aed_step import (
    BLOCK,
    EPS,
    HEAD_DIM,
    AedGeom,
    AedPlan,
    _check,
    _stacked_shapes,
    aed_plan,
    fused_aed_step_reference,
)

# Kernel launches since import (or since a caller reset it to 0): one per step.
LAUNCHES = 0

SOURCE = nvcc_build.CSRC / "fused_aed_multi.cu"
NVCC_FLAGS = nvcc_build.NVCC_FLAGS
MAX_SLOTS = 32  # kMaxSlots in the kernel source

_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def kernel_takes(geom: AedGeom, n_slots: int) -> bool:
    """Whether the kernel takes this geometry and slot count."""
    d, f, h = geom.d_model, geom.ffn_dim, geom.num_heads
    return (h * HEAD_DIM == d and d % BLOCK == 0 and f % BLOCK == 0
            and 2 <= n_slots <= MAX_SLOTS)


# ── plain PyTorch version ───────────────────────────────────────────────


def fused_aed_step_multi_reference(stacked: dict, geom: AedGeom, x: torch.Tensor,
                                   k_self: torch.Tensor, v_self: torch.Tensor,
                                   cross_k: torch.Tensor, cross_v: torch.Tensor,
                                   pos: torch.Tensor, tc_valid: torch.Tensor):
    """Plain PyTorch version of the kernel, same arguments and results as
    :func:`fused_aed_step_multi`: each slot through the batch-1 plain version
    (its self planes take row ``pos[b]`` in place)."""
    t_self, t_cross = k_self.shape[2], cross_k.shape[2]
    rows = []
    for b, (p, tc) in enumerate(zip(pos.tolist(), tc_valid.tolist())):
        tc = min(max(int(tc), 1), t_cross)
        if 0 <= p < t_self:
            ks, vs = k_self[:, b], v_self[:, b]  # views: row p is written in place
        else:  # parked: only the fresh row, written into a throwaway row
            p = 0
            ks, vs = k_self[:, b, :1].clone(), v_self[:, b, :1].clone()
        lg, _, _ = fused_aed_step_reference(stacked, geom, x[b : b + 1], ks, vs,
                                            cross_k[:, b], cross_v[:, b], p, tc)
        rows.append(lg)
    return torch.cat(rows), k_self, v_self


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
            # x, 19 stacked arrays, 4 caches, pos, tc_valid, logits, scratch; 9 ints, eps, plan,
            # stream
            lib.fused_aed_step_multi.argtypes = ([ctypes.c_void_p] * 28 + [ctypes.c_int] * 9
                                                 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
            lib.fused_aed_step_multi.restype = ctypes.c_int
            lib.fused_aed_multi_scratch_floats.argtypes = [ctypes.c_int] * 3
            lib.fused_aed_multi_scratch_floats.restype = ctypes.c_longlong
            lib.fused_aed_multi_max_slots.restype = ctypes.c_int
            if lib.fused_aed_multi_max_slots() != MAX_SLOTS:
                raise RuntimeError("fused_aed_multi.cu and MAX_SLOTS disagree")
            _lib = lib
    return _lib


def fused_aed_step_multi_cuda(stacked: dict, geom: AedGeom, x: torch.Tensor,
                              k_self: torch.Tensor, v_self: torch.Tensor,
                              cross_k: torch.Tensor, cross_v: torch.Tensor,
                              pos: torch.Tensor, tc_valid: torch.Tensor,
                              plan: AedPlan | None = None):
    """Launch the CUDA kernel; checks every argument and raises on what the
    kernel does not take (B >= 2 slots, head_dim 64, D and F multiples of
    128, block-128 q8 weights, f32 or bf16 caches of one dtype, int32
    ``pos`` / ``tc_valid`` on the card). ``plan`` defaults to
    ``aed_plan``'s, the batch-1 step's."""
    global LAUNCHES
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"fused_aed_step_multi_cuda needs CUDA tensors, got {dev}")
    d, f, h = geom.d_model, geom.ffn_dim, geom.num_heads
    if h * HEAD_DIM != d or d % BLOCK or f % BLOCK:
        raise ValueError(f"the kernel takes head_dim {HEAD_DIM} and D, F multiples of {BLOCK}; "
                         f"got D={d}, heads={h}, F={f}")
    nl, bs, t_self = k_self.shape[0], k_self.shape[1], k_self.shape[2]
    if not 2 <= bs <= MAX_SLOTS:
        raise ValueError(f"the multi-slot kernel takes 2..{MAX_SLOTS} slots, got {bs} "
                         "(batch 1 is fused_aed_step's)")
    t_cross = cross_k.shape[2]
    vp = stacked["wh"].shape[-1]
    if vp % BLOCK:
        raise ValueError(f"wh must be (D, V_pad) with V_pad a multiple of {BLOCK}, got {vp}")
    shapes = _stacked_shapes(nl, d, f, vp)
    for key, shape in shapes.items():
        dtypes = (torch.int8,) if key in ("wa_all", "wb_all", "wh") else (torch.float32,)
        _check(key, stacked[key], shape, dtypes, dev)
    _check("x", x, (bs, d), (torch.float32,), dev)
    cdt = k_self.dtype
    if cdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"caches must be float32 or bfloat16, got {cdt}")
    for name, t, rows in (("k_self", k_self, t_self), ("v_self", v_self, t_self),
                          ("cross_k", cross_k, t_cross), ("cross_v", cross_v, t_cross)):
        _check(name, t, (nl, bs, rows, d), (cdt,), dev)
    _check("pos", pos, (bs,), (torch.int32,), dev)
    _check("tc_valid", tc_valid, (bs,), (torch.int32,), dev)
    plan = plan or aed_plan(d, f, vp, t_self, t_cross)
    lib = _load()
    scratch = torch.empty((lib.fused_aed_multi_scratch_floats(bs, d, f),), device=dev,
                          dtype=torch.float32)
    logits = torch.empty((bs, vp), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_aed_step_multi(
            x.data_ptr(), *(stacked[k].data_ptr() for k in shapes),
            k_self.data_ptr(), v_self.data_ptr(), cross_k.data_ptr(), cross_v.data_ptr(),
            pos.data_ptr(), tc_valid.data_ptr(), logits.data_ptr(), scratch.data_ptr(),
            nl, bs, d, h, f, t_self, t_cross, vp, int(cdt == torch.bfloat16), EPS,
            plan.c_array(), stream)
    if err != 0:
        raise RuntimeError(f"fused_aed_step_multi launch failed: CUDA error {err}")
    with _count_lock:
        LAUNCHES += 1
    return logits, k_self, v_self


def fused_aed_step_multi(stacked: dict, geom: AedGeom, x: torch.Tensor,
                         k_self: torch.Tensor, v_self: torch.Tensor,
                         cross_k: torch.Tensor, cross_v: torch.Tensor,
                         pos: torch.Tensor, tc_valid: torch.Tensor):
    """One multi-slot AED decode step.

    Args:
      stacked: from ``ops.fused_aed_step.stack_aed_step_params`` (the same
        stacked weights the batch-1 step takes).
      x: (B, D) f32 input rows (family embed math applied; B >= 2 slots).
      k_self/v_self: (NL, B, T, D) per-slot self planes (f32 or bf16); row
        ``pos[b]`` of slot b's planes is written in place, every other row
        is left as it was.
      cross_k/cross_v: (NL, B, Tc, D) per-slot cross planes in the caches'
        dtype; rows at and past ``tc_valid[b]`` are masked.
      pos: (B,) int32 cache positions; -1 parks a slot.
      tc_valid: (B,) int32 real cross rows per slot.

    Returns ``(logits (B, V_pad) f32, k_self, v_self)``; pad logits are 0.
    On a CPU tensor this is the plain version; on a CUDA tensor the kernel.
    """
    if x.shape[0] < 2:
        raise ValueError("the multi-slot step needs >= 2 slots (fused_aed_step takes batch 1)")
    if x.device.type == "cpu":
        return fused_aed_step_multi_reference(stacked, geom, x, k_self, v_self, cross_k, cross_v,
                                              pos, tc_valid)
    return fused_aed_step_multi_cuda(stacked, geom, x, k_self, v_self, cross_k, cross_v, pos,
                                     tc_valid)
