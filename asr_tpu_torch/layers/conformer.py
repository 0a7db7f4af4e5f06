"""Relative-position attention pieces shared by the conformer-style encoders.

Counterpart of the parts of ``asr_tpu/layers/conformer.py`` that FireRed's
conformer and Dolphin's E-Branchformer use: the interleaved sin/cos table
over relative positions (numpy, f64 then f32, as the JAX package computes
it, so both packages hold bit-identical tables), the Transformer-XL skew,
relative-position multi-head attention, and an NHWC conv2d over HWIO
weights (the artifact's layout, transposed where it is used) with the
length rule of the two-conv k3/s2 stems. The
FastConformer block, its conv module and the depthwise-separable 8x
subsampling (Parakeet, Nemotron) are not ported yet.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from asr_tpu_torch.layers.transformer import dense


@functools.lru_cache(maxsize=32)
def relative_position_embedding(seq_len: int, d_model: int) -> np.ndarray:
    """Interleaved sin/cos table over relative positions S-1 .. -(S-1),
    shape (2S-1, D). Cached: callers must not write into it."""
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, d_model, 2, dtype=np.float64) / d_model))
    positions = np.arange(seq_len - 1, -seq_len, -1, dtype=np.float64)
    freqs = positions[:, None] * inv_freq[None, :]
    emb = np.stack([np.sin(freqs), np.cos(freqs)], axis=-1).reshape(len(positions), d_model)
    return emb.astype(np.float32)


@functools.lru_cache(maxsize=16)
def absolute_positions(t_max: int, d_model: int, device: torch.device) -> torch.Tensor:
    """Sinusoid rows for absolute positions 0 .. t_max-1 on ``device``: rows
    [0, t_max) of the relative table hold positions t_max-1 .. 0, reversed
    (the FireRed / Dolphin decoders' input positions). Cached: read only."""
    table = relative_position_embedding(t_max, d_model)[:t_max][::-1]
    return torch.from_numpy(np.ascontiguousarray(table)).to(device)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """Transformer-XL skew: (B, H, S, 2S-1) -> (B, H, S, 2S-1) such that
    out[..., i, j] = x[..., i, j + S - 1 - i] (then the caller slices [..., :S])."""
    b, h, s, w = x.shape
    x = F.pad(x, (1, 0))
    x = x.reshape(b, h, w + 1, s)[:, :, 1:]
    return x.reshape(b, h, s, w)


def rel_pos_attention(x: torch.Tensor, p: dict, num_heads: int, pos_embed: torch.Tensor,
                      attn_bias: torch.Tensor | None) -> torch.Tensor:
    """Relative-position MHA. x (B, S, D); pos_embed (2S-1, D); ``p`` holds
    q, k, v, o, the ``rel_k`` projection and ``bias_u`` / ``bias_v``."""
    b, s, d = x.shape
    hd = d // num_heads
    q = dense(x, p["q"]).reshape(b, s, num_heads, hd).transpose(1, 2)
    k = dense(x, p["k"]).reshape(b, s, num_heads, hd).transpose(1, 2)
    v = dense(x, p["v"]).reshape(b, s, num_heads, hd).transpose(1, 2)
    rel_k = dense(pos_embed, p["rel_k"]).reshape(-1, num_heads, hd)  # (2S-1, H, hd)
    qu = q + p["bias_u"][None, :, None, :]
    qv = q + p["bias_v"][None, :, None, :]
    ac = torch.einsum("bhsd,bhtd->bhst", qu, k)
    bd = rel_shift(torch.einsum("bhsd,phd->bhsp", qv, rel_k))[..., :s]
    scores = (ac + bd).to(torch.float32) * (hd ** -0.5)
    if attn_bias is not None:
        scores = scores + attn_bias
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhst,bhtd->bshd", probs, v).reshape(b, s, d)
    return dense(ctx, p["o"])


def subsampled_length(valid_frames: torch.Tensor) -> torch.Tensor:
    """Frames left after two unpadded k3/s2 convs (the FireRed and Dolphin stems)."""
    return ((valid_frames - 3) // 2 + 1 - 3) // 2 + 1


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           stride=(1, 1), padding=(0, 0), groups: int = 1) -> torch.Tensor:
    """NHWC conv2d with an HWIO weight (``F.conv2d`` inside)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=tuple(stride),
                 padding=tuple(padding), groups=groups).permute(0, 2, 3, 1)
    if b is not None:
        y = y + b
    return y
