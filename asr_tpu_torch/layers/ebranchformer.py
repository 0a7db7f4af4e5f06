"""E-Branchformer encoder block (espnet): attention branch + cgMLP branch.

Counterpart of ``asr_tpu/layers/ebranchformer.py`` (Dolphin's encoder), the
unfolded checkpoint math:

    x  = x + 0.5 * ffn_macaron(norm_ff_macaron(x))
    a  = rel_pos_attention(norm_mha(x))                        # branch 1
    g0 = gelu(channel_proj1(norm_mlp(x)))                      # branch 2
    r, g = split(g0);  g = depthwise_conv(LayerNorm(g))        # CSGU
    m  = channel_proj2(r * g)
    c  = concat(a, m); c = depthwise_conv_fusion(c) + c        # merge conv
    x  = x + merge_proj(c)
    x  = x + 0.5 * ffn(norm_ff(x))
    x  = norm_final(x)

Depthwise convs see zeros at padded frames (``key_mask``), so a padded
batch matches each utterance run alone in its valid region.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from asr_tpu_torch.layers.conformer import rel_pos_attention
from asr_tpu_torch.layers.norms import layer_norm
from asr_tpu_torch.layers.sanm import depthwise_conv1d_time
from asr_tpu_torch.layers.transformer import dense


def _ffn(x: torch.Tensor, p: dict) -> torch.Tensor:
    y = layer_norm(x, p["norm"]["scale"], p["norm"]["bias"])
    return dense(F.silu(dense(y, p["w1"])), p["w2"])


def _masked(x: torch.Tensor, key_mask: torch.Tensor | None) -> torch.Tensor:
    if key_mask is None:
        return x
    return torch.where(key_mask[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))


def _depthwise(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Same-length depthwise conv over time with the ``(K, C)`` taps ``p["w"]``
    and the optional bias ``p["b"]``."""
    pad = (p["w"].shape[0] - 1) // 2
    y = depthwise_conv1d_time(x, p["w"], pad, pad)
    return y + p["b"] if "b" in p else y


def csgu(x: torch.Tensor, p: dict, key_mask: torch.Tensor | None) -> torch.Tensor:
    """Convolutional Spatial Gating Unit: split -> LN -> depthwise conv ->
    gate. x (B, T, 2*Dg) -> (B, T, Dg)."""
    r, g = torch.chunk(x, 2, dim=-1)
    g = _masked(layer_norm(g, p["norm"]["scale"], p["norm"]["bias"]), key_mask)
    return r * _depthwise(g, p["conv"])


def ebranchformer_block(x: torch.Tensor, p: dict, num_heads: int, pos_embed: torch.Tensor,
                        attn_bias: torch.Tensor | None,
                        key_mask: torch.Tensor | None) -> torch.Tensor:
    x = x + 0.5 * _ffn(x, p["ffn_macaron"])
    y_att = layer_norm(x, p["norm_mha"]["scale"], p["norm_mha"]["bias"])
    x1 = rel_pos_attention(y_att, p["attn"], num_heads, pos_embed, attn_bias)
    y_mlp = layer_norm(x, p["norm_mlp"]["scale"], p["norm_mlp"]["bias"])
    g0 = F.gelu(dense(y_mlp, p["cgmlp"]["proj1"]), approximate="none")
    x2 = dense(csgu(g0, p["cgmlp"]["csgu"], key_mask), p["cgmlp"]["proj2"])
    c = _masked(torch.cat([x1, x2], dim=-1), key_mask)
    c = c + _depthwise(c, p["fusion"])
    x = x + dense(c, p["merge_proj"])
    x = x + 0.5 * _ffn(x, p["ffn"])
    return layer_norm(x, p["norm_final"]["scale"], p["norm_final"]["bias"])


def init_block_params(generator: torch.Generator, d: int, heads: int, ffn_dim: int,
                      cgmlp_dim: int, csgu_kernel: int, fusion_kernel: int, device=None,
                      dtype: torch.dtype = torch.float32) -> dict:
    """Random-init block parameters with the checkpoint's layout and the JAX
    package's scales, drawn from ``generator`` on its own device and placed
    on ``device``."""
    device = torch.device(device) if device is not None else generator.device

    def normal(*shape, std):
        t = torch.randn(shape, generator=generator, device=generator.device) * std
        return t.to(device=device, dtype=dtype)

    def zeros(n):
        return torch.zeros((n,), device=device, dtype=dtype)

    def lin(i, o, bias=True):
        p = {"w": normal(i, o, std=i ** -0.5)}
        if bias:
            p["b"] = zeros(o)
        return p

    def norm(dd=d):
        return {"scale": torch.ones((dd,), device=device, dtype=dtype), "bias": zeros(dd)}

    half = cgmlp_dim // 2
    return {
        "ffn_macaron": {"norm": norm(), "w1": lin(d, ffn_dim), "w2": lin(ffn_dim, d)},
        "norm_mha": norm(),
        "attn": {
            "q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "o": lin(d, d),
            "rel_k": {"w": normal(d, d, std=d ** -0.5)},
            "bias_u": torch.zeros((heads, d // heads), device=device, dtype=dtype),
            "bias_v": torch.zeros((heads, d // heads), device=device, dtype=dtype),
        },
        "norm_mlp": norm(),
        "cgmlp": {
            "proj1": lin(d, cgmlp_dim),
            "csgu": {"norm": norm(half),
                     "conv": {"w": normal(csgu_kernel, half, std=0.1), "b": zeros(half)}},
            "proj2": lin(half, d),
        },
        "fusion": {"w": normal(fusion_kernel, 2 * d, std=0.1), "b": zeros(2 * d)},
        "merge_proj": lin(2 * d, d),
        "ffn": {"norm": norm(), "w1": lin(d, ffn_dim), "w2": lin(ffn_dim, d)},
        "norm_final": norm(),
    }
