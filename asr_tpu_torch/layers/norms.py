"""Normalization layers. Statistics always in float32."""

from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Affine LayerNorm over the last axis in f32, biased variance
    (counterpart of ``asr_tpu/layers/norms.py:layer_norm``)."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
    y = (xf - mean) / torch.sqrt(var + eps)
    y = y * scale.to(torch.float32) + bias.to(torch.float32)
    return y.to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis in f32 (counterpart of
    ``asr_tpu/layers/norms.py:rms_norm``)."""
    xf = x.to(torch.float32)
    var = torch.square(xf).mean(dim=-1, keepdim=True)
    y = xf / torch.sqrt(var + eps) * scale.to(torch.float32)
    return y.to(x.dtype)
