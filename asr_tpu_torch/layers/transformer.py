"""Dense projection shared by the port's blocks.

Counterpart of ``dense`` in ``asr_tpu/layers/transformer.py``. The encoder
and decoder blocks of that module come with the Whisper slice.
"""

from __future__ import annotations

import torch

from asr_tpu_torch.ops.quant_matmul import quant_dense
from asr_tpu_torch.quant.quantize import QuantizedLinear


def dense(x: torch.Tensor, p: dict) -> torch.Tensor:
    """``x @ w (+ b)``; a QuantizedLinear ``w`` goes through :func:`quant_dense`
    (the int8 kernel on CUDA). Weights are ``(in, out)``."""
    w = p["w"]
    y = quant_dense(x, w) if isinstance(w, QuantizedLinear) else x @ w
    if p.get("b") is not None:
        y = y + p["b"]
    return y
