"""Block-wise affine weight quantization, worked out by the reference itself.

A ``(K, N)`` weight is cut into blocks of ``block`` rows along K (one block
of K rows where K is not a multiple); each (block, column) pair has an f32
scale and an integer zero point, ``w ~ (q - zero) * scale``. The fit is the
range fit followed by ``refine`` least-squares passes on the scale and the
zero point, the published q8 serving recipe (blocks of 128, two passes).
An embedding table is quantized per row along D with the range fit alone.

The functions return the dequantized f32 weight: the reference computes
with it in float32.
"""

from __future__ import annotations

import torch


def fake_quant(w: torch.Tensor, bits: int, block: int = 128, refine: int = 2) -> torch.Tensor:
    """(K, N) f32 weight -> its dequantized ``bits``-bit block fit, f32."""
    k, n = w.shape
    if k % block:
        block = k
    qmax = (1 << bits) - 1
    blocks = w.reshape(k // block, block, n).to(torch.float32)
    wmin = blocks.amin(dim=1, keepdim=True)
    wmax = blocks.amax(dim=1, keepdim=True)
    scale = (wmax - wmin) * torch.tensor(1.0 / qmax, dtype=torch.float32, device=w.device)
    scale = torch.where(scale <= 1e-12, torch.ones_like(scale), scale)
    zero = torch.round(-wmin / scale)

    def quant(scale, zero):
        return torch.clamp(torch.round(blocks / scale + zero), 0, qmax)

    for _ in range(refine):
        centered = quant(scale, zero) - zero
        num = (centered * blocks).sum(dim=1, keepdim=True)
        den = (centered * centered).sum(dim=1, keepdim=True)
        scale = torch.where(den > 1e-12, num / torch.clamp(den, min=1e-12), scale)
        scale = torch.where(scale.abs() <= 1e-12, torch.ones_like(scale), scale)
        zero_f = (quant(scale, zero) - blocks / scale).mean(dim=1, keepdim=True)
        zero = torch.clamp(torch.round(zero_f), 0, qmax)
    q = quant(scale, zero)
    return ((q - zero) * scale).reshape(k, n)


def fake_quant_rows(table: torch.Tensor, bits: int, block: int = 128) -> torch.Tensor:
    """(V, D) table quantized per row in ``block``-wide groups along D
    (range fit, no refinement) -> its dequantized f32 copy."""
    return fake_quant(table.t().contiguous(), bits, block, refine=0).t().contiguous()
