"""Shared torch/numpy -> port-tensor mapping helpers for the checkpoint loaders.

Counterpart of ``asr_tpu/loaders/_common.py``. One definition of the
linear/layernorm/conv conversions so every loader agrees on dtype coercion
(fp16/bf16 checkpoints load as f32) and layout (torch Linear ``(out, in)``
-> ours ``(in, out)``; Conv2d OIHW -> HWIO; depthwise Conv1d ``(C, 1, K)``
-> ``(K, C)``). The loaders return trees of CPU tensors in the layout
``runtime/artifact.params_from_flat`` gives.

:func:`asarray` is the port's stand-in for the JAX package's
``jnp.asarray``: it keeps each dtype the JAX package keeps and narrows the
64-bit ones as JAX does with 64-bit types off (f64 -> f32, int64 -> int32,
uint64 -> uint32), so both packages' trees hold the same bytes. A bf16
array (as ``runtime/artifact.read_safetensors`` gives a BF16 tensor) stays
bf16, as ``jnp.asarray`` keeps an ml_dtypes bfloat16 array.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32}


def asarray(a) -> torch.Tensor:
    """Array-like (numpy array, torch tensor, Python scalar) -> a CPU tensor
    of its own memory, 64-bit types narrowed to 32 bits, bf16 kept."""
    from asr_tpu_torch.runtime.artifact import tensor_from_numpy, tensor_to_numpy

    if isinstance(a, torch.Tensor):
        a = tensor_to_numpy(a)
    arr = np.asarray(a)
    arr = arr.astype(_NARROW.get(arr.dtype, arr.dtype), copy=False)
    return tensor_from_numpy(arr)


def tree_asarray(tree):
    """:func:`asarray` over every leaf of a dict / list tree; dict keys come
    out sorted, as a JAX tree map returns them."""
    if isinstance(tree, dict):
        return {k: tree_asarray(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_asarray(v) for v in tree)
    return asarray(tree)


def to_np(t) -> np.ndarray:
    """torch tensor / array-like -> float32-preserving numpy (fp16/bf16
    checkpoints upcast so downstream math is f32)."""
    if hasattr(t, "detach"):
        t = t.detach().cpu()
        if t.dtype in (torch.float16, torch.bfloat16, torch.float64):
            t = t.float()
        return t.numpy()
    arr = np.asarray(t)
    if arr.dtype in (np.float16, np.float64):
        return arr.astype(np.float32)
    return arr


def lin(sd: Mapping[str, Any], key: str) -> dict:
    """torch Linear -> {"w": (in, out)[, "b"]} (bias included when present)."""
    p = {"w": asarray(to_np(sd[f"{key}.weight"]).T)}
    if f"{key}.bias" in sd:
        p["b"] = asarray(to_np(sd[f"{key}.bias"]))
    return p


def ln(sd: Mapping[str, Any], key: str) -> dict:
    """torch LayerNorm -> {"scale", "bias"}."""
    return {
        "scale": asarray(to_np(sd[f"{key}.weight"])),
        "bias": asarray(to_np(sd[f"{key}.bias"])),
    }


def conv2d_hwio(sd: Mapping[str, Any], key: str) -> dict:
    """torch Conv2d OIHW -> {"w": HWIO, "b"}."""
    p = {"w": asarray(to_np(sd[f"{key}.weight"]).transpose(2, 3, 1, 0))}
    if f"{key}.bias" in sd:
        p["b"] = asarray(to_np(sd[f"{key}.bias"]))
    return p


def dw1d(sd: Mapping[str, Any], key: str) -> dict:
    """torch depthwise Conv1d (C, 1, K) -> {"w": (K, C)[, "b"]}."""
    w = to_np(sd[f"{key}.weight"])
    p = {"w": asarray(w[:, 0, :].T)}
    if f"{key}.bias" in sd:
        p["b"] = asarray(to_np(sd[f"{key}.bias"]))
    return p
