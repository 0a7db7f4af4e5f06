"""Quantization-friendly channel reordering (exact math).

Counterpart of ``asr_tpu/quant/reorder.py``: the same statistics (numpy
f64 on the host, so both packages pick the same permutation), the same
four FFN shapes and the same LayerNorm rule; the permutation is applied to
the tensors where they lie (on the card when the tree is there).

The reference permutes FFN hidden channels and per-head V/o_proj rows by
magnitude statistics before weight-only quantization so each quant block
holds channels of similar scale (``Whisper/Export_Whisper.py:549-609``,
flags :47-49; also Qwen ``Export_Qwen_ASR.py:83-85``, Dolphin
``Export_Dolphin.py:29-31``). The permutation is exact: the hidden axis of
an FFN is contraction-internal, so sorting it changes nothing numerically
(up to float summation order) while lowering block-RTN error.

Recognized FFN shapes (all with elementwise activations between, so the
hidden axis is freely permutable):

- ``{"w1","b1","w2","b2"}`` — SANM/Paraformer ffn dicts (raw arrays)
- ``{"w1": {"w","b"}, "w2": {...}}`` — nested-linear ffn dicts (Conformer /
  FastConformer / FireRed / Fun-ASR-Nano encoder). A sibling ``"norm"`` over
  the hidden axis (Paraformer decoder FFN, w2(LN(relu(w1 x)))) has its
  scale/bias permuted too — LayerNorm's mean/var reduce over all channels so
  the permutation stays exact; an input-side norm (FireRed, hidden=4d) is
  left alone. The ambiguous case hidden == in_dim is skipped entirely.
- ``{"fc1": {...}, "fc2": {...}}`` — transformer mlp dicts
- ``{"gate","up","down"}`` — gated-SiLU (Qwen3) mlp dicts
"""

from __future__ import annotations

import numpy as np
import torch

STATS = ("absmean", "rms", "l4", "std")


def channel_stat(w: torch.Tensor, kind: str = "absmean") -> np.ndarray:
    """Per-output-channel statistic of a (in, hidden) weight."""
    w = w.detach().to("cpu", torch.float64).numpy()
    if kind == "absmean":
        return np.mean(np.abs(w), axis=0)
    if kind == "rms":
        return np.sqrt(np.mean(w * w, axis=0))
    if kind == "l4":
        return np.mean(w ** 4, axis=0) ** 0.25
    if kind == "std":
        return np.std(w, axis=0)
    raise ValueError(f"stat {kind!r} not in {STATS}")


def _perm(stat: np.ndarray) -> np.ndarray:
    return np.argsort(stat, kind="stable")


def _take(x: torch.Tensor, p: np.ndarray, axis: int) -> torch.Tensor:
    """``x`` with its ``axis`` permuted by ``p``, on ``x``'s device."""
    return x.index_select(axis, torch.from_numpy(p).to(x.device))


def _apply(node: dict, stat_kind: str) -> bool:
    """Reorder one recognized FFN dict in place; True if it matched."""
    if {"w1", "w2"} <= node.keys() and getattr(node["w1"], "ndim", 0) == 2 \
            and node["w1"].shape[1] == node["w2"].shape[0]:
        p = _perm(channel_stat(node["w1"], stat_kind))
        node["w1"] = _take(node["w1"], p, 1)
        node["w2"] = _take(node["w2"], p, 0)
        if "b1" in node:
            node["b1"] = _take(node["b1"], p, 0)
        return True
    def _lin(v):
        return isinstance(v, dict) and "w" in v and getattr(v["w"], "ndim", 0) == 2

    if {"w1", "w2"} <= node.keys() and _lin(node["w1"]) and _lin(node["w2"]) \
            and node["w1"]["w"].shape[1] == node["w2"]["w"].shape[0]:
        in_dim, hidden = node["w1"]["w"].shape
        norm = node.get("norm")
        norm_scale = norm.get("scale") if isinstance(norm, dict) else None
        norm_on_hidden = norm_scale is not None and norm_scale.shape == (hidden,)
        if norm_on_hidden and hidden == in_dim:
            return False  # cannot tell hidden-norm from input-norm — skip
        p = _perm(channel_stat(node["w1"]["w"], stat_kind))
        node["w1"]["w"] = _take(node["w1"]["w"], p, 1)
        if "b" in node["w1"]:
            node["w1"]["b"] = _take(node["w1"]["b"], p, 0)
        node["w2"]["w"] = _take(node["w2"]["w"], p, 0)
        if norm_on_hidden:
            norm["scale"] = _take(norm["scale"], p, 0)
            if "bias" in norm:
                norm["bias"] = _take(norm["bias"], p, 0)
        return True
    if {"fc1", "fc2"} <= node.keys() and isinstance(node["fc1"], dict) \
            and "w" in node["fc1"] and getattr(node["fc1"]["w"], "ndim", 0) == 2 \
            and node["fc1"]["w"].shape[1] == node["fc2"]["w"].shape[0]:
        p = _perm(channel_stat(node["fc1"]["w"], stat_kind))
        node["fc1"]["w"] = _take(node["fc1"]["w"], p, 1)
        if "b" in node["fc1"]:
            node["fc1"]["b"] = _take(node["fc1"]["b"], p, 0)
        node["fc2"]["w"] = _take(node["fc2"]["w"], p, 0)
        return True
    if {"gate", "up", "down"} <= node.keys() and isinstance(node["gate"], dict) \
            and "w" in node["gate"] and getattr(node["gate"]["w"], "ndim", 0) == 2:
        # silu(gate) * up is elementwise in the hidden channel: one shared perm.
        s = channel_stat(node["gate"]["w"], stat_kind) + channel_stat(node["up"]["w"], stat_kind)
        p = _perm(s)
        for half in ("gate", "up"):
            node[half]["w"] = _take(node[half]["w"], p, 1)
            if "b" in node[half]:
                node[half]["b"] = _take(node[half]["b"], p, 0)
        node["down"]["w"] = _take(node["down"]["w"], p, 0)
        return True
    return False


def channel_reorder_pytree(params, stat: str = "absmean") -> tuple:
    """Return (reordered params, number of FFN pairs permuted). Apply
    BEFORE quantize_pytree/apply_plans; outputs are numerically identical
    (modulo float summation order)."""
    if stat not in STATS:
        raise ValueError(f"stat {stat!r} not in {STATS}")
    count = 0

    def walk(node):
        nonlocal count
        if isinstance(node, dict):
            copy = {k: walk(v) for k, v in node.items()}
            if _apply(copy, stat):
                count += 1
            return copy
        if isinstance(node, (list, tuple)):
            walked = [walk(v) for v in node]
            return type(node)(walked) if isinstance(node, tuple) else walked
        return node

    return walk(params), count
