"""Conformer pieces: relative-position attention and the FastConformer block.

Counterpart of ``asr_tpu/layers/conformer.py``. The relative-position
parts serve FireRed's conformer, Dolphin's E-Branchformer and the
FastConformer alike: the interleaved sin/cos table over relative positions
(numpy, f64 then f32, as the JAX package computes it, so both packages
hold bit-identical tables), the Transformer-XL skew, relative-position
multi-head attention, and an NHWC conv2d over HWIO weights (the artifact's
layout, transposed where it is used; an asymmetric ``padding`` is applied
with ``F.pad`` first) with the length rule of the two-conv k3/s2 stems.

The FastConformer half (Parakeet; Nemotron reuses ``_ff``) is the block

    x + 0.5*ffn1 -> + rel-pos MHSA -> + conv module (pointwise, GLU,
    depthwise, BatchNorm folded to ``bn.scale`` / ``bn.shift``, SiLU,
    pointwise) -> + 0.5*ffn2 -> LayerNorm

and the depthwise-separable 8x subsampling in front of it. Every conv
input is zero-masked past the valid frames and attention carries a
key-validity bias, so a padded batch equals variable-length runs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from asr_tpu_torch.layers.norms import layer_norm
from asr_tpu_torch.layers.sanm import depthwise_conv1d_time
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
    """NHWC conv2d with an HWIO weight (``F.conv2d`` inside). ``padding`` is
    (H, W) symmetric pads or ((top, bottom), (left, right))."""
    x = x.permute(0, 3, 1, 2)
    if isinstance(padding[0], (tuple, list)):
        (top, bottom), (left, right) = padding
        x = F.pad(x, (left, right, top, bottom))
        padding = (0, 0)
    y = F.conv2d(x, w.permute(3, 2, 0, 1), stride=tuple(stride), padding=tuple(padding),
                 groups=groups).permute(0, 2, 3, 1)
    if b is not None:
        y = y + b
    return y


def _ff(x: torch.Tensor, p: dict) -> torch.Tensor:
    return dense(F.silu(dense(x, p["w1"])), p["w2"])


def zero_past(y: torch.Tensor, key_mask: torch.Tensor | None) -> torch.Tensor:
    """Zero the rows of ``y`` (B, T, ...) where ``key_mask`` (B, T) is False."""
    if key_mask is None:
        return y
    return torch.where(key_mask[..., None], y, torch.zeros((), dtype=y.dtype, device=y.device))


def conv_module(x: torch.Tensor, p: dict, key_mask: torch.Tensor | None) -> torch.Tensor:
    """Conformer conv module. x (B, S, D); BatchNorm folded to an affine
    (``bn.scale``, ``bn.shift``); padded rows zeroed before the depthwise conv."""
    a, g = torch.chunk(dense(x, p["pw1"]), 2, dim=-1)
    y = zero_past(a * torch.sigmoid(g), key_mask)  # GLU
    pad = (p["dw"]["w"].shape[0] - 1) // 2
    y = depthwise_conv1d_time(y, p["dw"]["w"], pad, pad) + p["dw"]["b"]
    y = F.silu(y * p["bn"]["scale"] + p["bn"]["shift"])
    return dense(y, p["pw2"])


def conformer_block(x: torch.Tensor, p: dict, num_heads: int, pos_embed: torch.Tensor,
                    attn_bias: torch.Tensor | None, key_mask: torch.Tensor | None) -> torch.Tensor:
    """One FastConformer block over x (B, S, D)."""
    def ln(y, name):
        return layer_norm(y, p[name]["scale"], p[name]["bias"])

    x = x + 0.5 * _ff(ln(x, "norm_ff1"), p["ff1"])
    x = x + rel_pos_attention(ln(x, "norm_att"), p["attn"], num_heads, pos_embed, attn_bias)
    x = x + conv_module(ln(x, "norm_conv"), p["conv"], key_mask)
    x = x + 0.5 * _ff(ln(x, "norm_ff2"), p["ff2"])
    return ln(x, "norm_out")


def _conv_out_len(n, k: int, stride: int, pad: int):
    return (n + 2 * pad - k) // stride + 1


def mask_time(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Zero the rows of an NHWC map (H = time) at and past ``valid``."""
    keep = torch.arange(x.shape[1], device=x.device)[None, :] < valid[:, None]
    return torch.where(keep[:, :, None, None], x, torch.zeros((), dtype=x.dtype, device=x.device))


def subsample_conv2d(feats: torch.Tensor, p: dict, valid: torch.Tensor, kernel: int = 3,
                     stride: int = 2) -> tuple[torch.Tensor, torch.Tensor]:
    """FastConformer depthwise-separable 8x subsampling: (B, T, n_mels) ->
    ((B, T', d_model), subsampled valid counts). The padded frames are
    zeroed before every strided conv, the valid counts recomputed after it,
    and the (time, mel, channel) map flattened channel-major (torch's
    ``flatten(2)`` of NCHW) into the output linear."""
    pad = (kernel - 1) // 2
    x = feats[..., None]  # NHWC with H = time, W = mel
    ch = p["conv0"]["w"].shape[-1]
    x = mask_time(x, valid)
    x = torch.relu(conv2d(x, p["conv0"]["w"], p["conv0"]["b"], (stride, stride), (pad, pad)))
    valid = _conv_out_len(valid, kernel, stride, pad)
    for i in (1, 2):
        x = mask_time(x, valid)
        x = conv2d(x, p[f"dw{i}"]["w"], p[f"dw{i}"]["b"], (stride, stride), (pad, pad), groups=ch)
        valid = _conv_out_len(valid, kernel, stride, pad)
        x = torch.relu(conv2d(x, p[f"pw{i}"]["w"], p[f"pw{i}"]["b"]))
    b, t = x.shape[0], x.shape[1]
    x = x.transpose(2, 3).reshape(b, t, -1)  # channel-major, like torch's flatten(2)
    return dense(x, p["out"]), valid
