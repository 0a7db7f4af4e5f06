"""Rotary position embeddings (GPT-NeoX half-rotation convention).

Counterpart of ``asr_tpu/layers/rope.py``: the cos/sin tables are computed
in float64 with numpy, as the JAX package computes them, then cast to f32,
so both packages rotate by bit-identical tables."""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def rope_tables(max_len: int, head_dim: int, theta: float) -> np.ndarray:
    """(2, max_len, head_dim) stacked cos/sin with duplicated frequencies
    ([f0..f_{d/2-1}, f0..f_{d/2-1}] layout)."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    t = np.arange(max_len, dtype=np.float64)
    freqs = t[:, None] * inv_freq[None, :]
    emb = np.concatenate([freqs, freqs], axis=-1)
    return np.stack([np.cos(emb), np.sin(emb)]).astype(np.float32)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, D); cos/sin (T, D) broadcast over batch and heads, or
    (B, T, D) for per-row position tables (left-padded batch decode)."""
    if cos.ndim == 3:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    else:
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    return x * c.to(x.dtype) + rotate_half(x) * s.to(x.dtype)
