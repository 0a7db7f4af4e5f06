"""RNN-T greedy decode, batched, fixed shape.

Counterpart of ``asr_tpu/decode/rnnt.py``: at each encoder frame the joint
may emit up to ``max_symbols_per_frame`` non-blank tokens (the predictor
state advances on each emission only); a blank, or reaching the cap, moves
the row to its next frame with the state kept. The step cap is
``(max_symbols_per_frame + 1) * T``. The carry is fixed-shape tensors on
the device and the host reads ``all(done)`` once every
``tdt.SYNC_EVERY`` steps, as in ``decode/tdt.py``.
"""

from __future__ import annotations

from typing import Callable

import torch

from asr_tpu_torch.decode import tdt


def rnnt_greedy(
    joint_step: Callable,
    enc: torch.Tensor,
    enc_valid: torch.Tensor,
    h0: torch.Tensor,
    c0: torch.Tensor,
    start_token: int,
    blank_id: int,
    max_tokens: int,
    max_symbols_per_frame: int = 10,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched RNN-T greedy loop. The interface of ``tdt_greedy`` without
    durations; ``joint_step`` returns ``(logits (B, V + 1), h', c')``."""
    b, t, _ = enc.shape
    dev = enc.device
    rows = torch.arange(b, device=dev)
    valid = enc_valid.to(device=dev, dtype=torch.int64)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    st = {
        "frame": torch.zeros(b, dtype=torch.int64, device=dev),
        "nsym": torch.zeros(b, dtype=torch.int64, device=dev),  # emitted on the current frame
        "token": torch.full((b,), start_token, dtype=torch.int64, device=dev),
        "h": h0, "c": c0,
        "buf": torch.zeros((b, max_tokens + 1), dtype=torch.int32, device=dev),  # + the dump slot
        "count": torch.zeros(b, dtype=torch.int64, device=dev),
        "done": torch.zeros(b, dtype=torch.bool, device=dev),
    }

    def step() -> torch.Tensor:
        frame, nsym, token, h, c, count, done = (
            st[k] for k in ("frame", "nsym", "token", "h", "c", "count", "done"))
        logits, h2, c2 = joint_step(token, h, c, enc[rows, frame.clamp(0, t - 1)])
        tok = torch.argmax(logits, dim=-1)
        is_blank = tok == blank_id
        capped = nsym >= max_symbols_per_frame
        emit = ~is_blank & ~done & ~capped
        st["buf"][rows, torch.where(emit, count, max_tokens)] = tok.to(torch.int32)
        count = count + emit.to(torch.int64)
        st["token"] = torch.where(emit, tok, token)
        st["h"] = torch.where(emit[None, :, None], h2, h)
        st["c"] = torch.where(emit[None, :, None], c2, c)
        advance = (is_blank | capped) & ~done
        frame = frame + advance.to(torch.int64)
        st["nsym"] = torch.where(advance, zero, nsym + emit.to(torch.int64))
        st["frame"], st["count"] = frame, count
        st["done"] = done | (frame >= valid) | (count >= max_tokens)
        return st["done"]

    tdt.run_chunked(step, (max_symbols_per_frame + 1) * t, tdt.SYNC_EVERY)
    return st["buf"][:, :max_tokens], st["count"].to(torch.int32)
