"""Batched multi-head attention, ``(B, T, H, D)`` layout, softmax in f32.

Counterpart of ``asr_tpu/layers/attention.py``: plain matmuls and softmax
with an additive f32 bias (0 keep, ``NEG_INF`` drop) built from valid
lengths, so padded batches reproduce variable-length runs.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def length_mask(valid: torch.Tensor, t: int) -> torch.Tensor:
    """Boolean key-validity mask ``(B, t)`` from per-sample valid lengths."""
    return torch.arange(t, device=valid.device)[None, :] < valid[:, None]


def attention_bias_from_lengths(valid: torch.Tensor, t: int) -> torch.Tensor:
    """Additive bias ``(B, 1, 1, t)`` masking padded key positions."""
    keep = length_mask(valid, t)
    zero = torch.zeros((), dtype=torch.float32, device=valid.device)
    return torch.where(keep, zero, NEG_INF)[:, None, None, :]


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        bias: torch.Tensor | None = None, scale: float | None = None) -> torch.Tensor:
    """q ``(B, Tq, H, D)``, k/v ``(B, Tk, H, D)`` -> ``(B, Tq, H, D)`` in q's dtype.

    k/v in another dtype (a bf16 cache under f32 compute) are promoted to
    q's, as JAX's einsum promotes them."""
    k, v = k.to(q.dtype), v.to(q.dtype)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
