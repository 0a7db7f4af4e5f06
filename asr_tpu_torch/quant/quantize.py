"""Weight-only int8 quantization (block-wise affine) for serving.

Counterpart of ``asr_tpu/quant/quantize.py``: round-to-nearest range fit
plus the optional least-squares refinement of scale and zero point, and the
same storage. A ``(K, N)`` weight is cut into blocks of ``block`` rows along
K; each (block, column) pair has one f32 scale and zero point, and
``w ~ (q - zero) * scale``. Storage is CENTERED: ``q - 128`` as int8 and
``zero - 128`` as f32, exactly as the JAX package writes it, so artifact
folders move between the two packages unchanged. When ``K % block != 0``
the block becomes K (one block per column).

Packed int4/int2 storage, the kquant and hqq objectives, dynamic int8 and
``QuantizedEmbedding`` are not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch


def _fit_rtn(blocks: torch.Tensor, qmax: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Range fit per block. blocks (NB, B, N) -> scale, zero (NB, 1, N)."""
    wmin = blocks.amin(dim=1, keepdim=True)
    wmax = blocks.amax(dim=1, keepdim=True)
    # XLA folds the division by the constant qmax into a multiply by its f32
    # reciprocal; doing the same keeps q bit-identical to the JAX package.
    scale = (wmax - wmin) * torch.tensor(1.0 / qmax, dtype=torch.float32, device=blocks.device)
    scale = torch.where(scale <= 1e-12, torch.ones_like(scale), scale)
    return scale, torch.round(-wmin / scale)


def quantize_weight(w: torch.Tensor, bits: int = 8, block: int = 128, refine_iters: int = 0):
    """Quantize a (K, N) weight block-wise along K.

    Returns (q int8 (K, N) centered, scale (NB, N), zero (NB, N) centered)."""
    k, n = w.shape
    if k % block:
        raise ValueError(f"K={k} is not a multiple of block={block}")
    qmax = (1 << bits) - 1
    blocks = w.reshape(k // block, block, n).to(torch.float32)
    scale, zero = _fit_rtn(blocks, qmax)

    def quant(scale, zero):
        return torch.clamp(torch.round(blocks / scale + zero), 0, qmax)

    for _ in range(refine_iters):
        # Least-squares re-fit of the scale on (q - zero) vs w, then of the zero.
        centered = quant(scale, zero) - zero
        num = (centered * blocks).sum(dim=1, keepdim=True)
        den = (centered * centered).sum(dim=1, keepdim=True)
        scale = torch.where(den > 1e-12, num / torch.clamp(den, min=1e-12), scale)
        scale = torch.where(scale.abs() <= 1e-12, torch.ones_like(scale), scale)
        zero_f = (quant(scale, zero) - blocks / scale).mean(dim=1, keepdim=True)
        zero = torch.clamp(torch.round(zero_f), 0, qmax)
    q = (quant(scale, zero) - 128.0).to(torch.int8).reshape(k, n)
    return q, scale[:, 0, :], zero[:, 0, :] - 128.0


class QuantizedLinear:
    """Block-quantized linear weight with the JAX package's fields.

    Dict-style access (``leaf["q"]``) mirrors the JAX class; ``packed`` and
    ``dynamic`` are kept so artifact leaves round-trip, but the port only
    computes with unpacked static int8 leaves."""

    FIELDS = ("q", "scale", "zero", "bits", "block", "packed", "dynamic")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                 bits: int, block: int, packed: bool = False, dynamic: bool = False):
        self.q = q
        self.scale = scale
        self.zero = zero
        self.bits = int(bits)
        self.block = int(block)
        self.packed = bool(packed)
        self.dynamic = bool(dynamic)

    def __getitem__(self, key):
        return getattr(self, key)

    def __contains__(self, key):
        return key in self.FIELDS


def dequantize_weight(qleaf) -> torch.Tensor:
    """Unpacked quantized leaf (or equivalent dict) -> dense f32 (K, N) weight."""
    q = qleaf["q"].to(torch.float32)
    k, n = q.shape
    block = int(qleaf["block"])
    blocks = q.reshape(k // block, block, n)
    w = (blocks - qleaf["zero"][:, None, :]) * qleaf["scale"][:, None, :]
    return w.reshape(k, n)


def quantize_linear(w: torch.Tensor, bits: int = 8, block: int = 128,
                    refine_iters: int = 0) -> QuantizedLinear:
    """(K, N) weight -> QuantizedLinear; the block becomes K when it does not divide K."""
    if w.shape[0] % block:
        block = w.shape[0]
    q, scale, zero = quantize_weight(w, bits, block, refine_iters)
    return QuantizedLinear(q, scale, zero, bits, block)


def quantize_pytree(
    params,
    bits: int = 8,
    block: int = 128,
    refine_iters: int = 2,
    min_size: int = 1 << 16,
    predicate: Callable[[str, torch.Tensor], bool] | None = None,
):
    """Quantize every 2-D ``w``/``w1``/``w2`` linear weight of at least
    ``min_size`` elements, with the JAX package's defaults and walk."""
    # 2-D kernels under these parents are consumed elementwise, not by dense().
    non_matmul_parents = ("dw", "dw1", "dw2", "conv", "fusion")

    def walk(node, path):
        parent = path.rsplit("/", 1)[-1]
        if isinstance(node, dict):
            out = {}
            for key, value in node.items():
                p = f"{path}/{key}"
                if (
                    key in ("w", "w1", "w2")
                    and parent not in non_matmul_parents
                    and isinstance(value, torch.Tensor)
                    and value.ndim == 2
                    and value.numel() >= min_size
                    and (predicate is None or predicate(p, value))
                ):
                    out[key] = quantize_linear(value, bits, block, refine_iters)
                else:
                    out[key] = walk(value, p)
            return out
        if isinstance(node, (list, tuple)):
            walked = [walk(v, f"{path}/{i}") for i, v in enumerate(node)]
            return type(node)(walked) if isinstance(node, tuple) else walked
        return node

    return walk(params, "")


def dequantize_pytree(params):
    """Every QuantizedLinear leaf -> its dense f32 weight (the plain-matmul twin)."""
    if isinstance(params, QuantizedLinear):
        return dequantize_weight(params)
    if isinstance(params, dict):
        return {k: dequantize_pytree(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(dequantize_pytree(v) for v in params)
    return params
