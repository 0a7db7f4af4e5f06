"""SANM encoder block (FunASR): self-attention + FSMN memory + FFN.

Counterpart of ``asr_tpu/layers/sanm.py``, the unfolded SANM math:

    y   = norm1(x)
    q,k,v = split(W_qkv y + b_qkv)
    ctx = softmax(q k^T / sqrt(d)) v
    mem = depthwise_conv(v, k_taps, symmetric zero pad) + v     # FSMN
    branch = W_out ctx + b_out + mem
    a   = branch + x            (only when in_size == out_size)
    out = a + W2 relu(W1 norm2(a) + b1) + b2

The depthwise FSMN conv is K shifted adds over ``v``, zero-masked past the
valid length so padded batches see the zero padding a variable-length run
would.

On a tensor-parallel rank (``parallel/mesh.py``) q, k and v are the rank's
heads and ``fsmn_w`` its share of v's channels; the memory ``mem`` is then
gathered before it joins the row-parallel ``out`` (whose sum is whole).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from asr_tpu_torch.layers.attention import mha
from asr_tpu_torch.layers.norms import layer_norm
from asr_tpu_torch.layers.transformer import dense
from asr_tpu_torch.parallel import mesh


def depthwise_conv1d_time(x: torch.Tensor, weight: torch.Tensor, left_pad: int, right_pad: int) -> torch.Tensor:
    """Depthwise conv over time as shifted adds. x ``(B, T, C)``, weight
    ``(K, C)`` (tap 0 leftmost) -> ``(B, T + left_pad + right_pad - K + 1, C)``."""
    k = weight.shape[0]
    xp = F.pad(x, (0, 0, left_pad, right_pad))
    t_out = xp.shape[1] - k + 1
    out = xp[:, 0:t_out, :] * weight[0]
    for i in range(1, k):
        out = out + xp[:, i : i + t_out, :] * weight[i]
    return out


def sanm_block(x: torch.Tensor, p: dict, num_heads: int, head_dim: int,
               attn_bias: torch.Tensor | None, key_mask: torch.Tensor | None,
               residual: bool) -> torch.Tensor:
    """One SANM block. ``x`` (B, T, in_size) -> (B, T, hidden).

    ``p`` keys: norm1{scale,bias}, qkv{w,b}, fsmn_w (K, hidden), out{w,b},
    norm2{scale,bias}, ffn{w1,b1,w2,b2}. ``key_mask`` (B, T) bool validity."""
    b, t = x.shape[0], x.shape[1]
    y = layer_norm(x, p["norm1"]["scale"], p["norm1"]["bias"])
    q, k, v = torch.chunk(dense(y, p["qkv"]), 3, dim=-1)
    hidden = v.shape[-1]  # a rank's own heads under tensor parallelism
    num_heads = hidden // head_dim
    if key_mask is not None:
        v = torch.where(key_mask[..., None], v, torch.zeros((), dtype=v.dtype, device=v.device))
    ctx = mha(
        q.reshape(b, t, num_heads, head_dim),
        k.reshape(b, t, num_heads, head_dim),
        v.reshape(b, t, num_heads, head_dim),
        bias=attn_bias,
    ).reshape(b, t, hidden)
    pad = (p["fsmn_w"].shape[0] - 1) // 2
    mem = depthwise_conv1d_time(v, p["fsmn_w"], pad, pad) + v
    if getattr(p["fsmn_w"], "tp_role", None) == "gather":
        mem = mesh.all_gather(mem)
    branch = dense(ctx, p["out"]) + mem
    a = branch + x if residual else branch
    y2 = layer_norm(a, p["norm2"]["scale"], p["norm2"]["bias"])
    h = torch.relu(dense(y2, {"w": p["ffn"]["w1"], "b": p["ffn"]["b1"]}))
    return a + dense(h, {"w": p["ffn"]["w2"], "b": p["ffn"]["b2"]})
