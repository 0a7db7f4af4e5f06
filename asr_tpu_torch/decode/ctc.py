"""CTC greedy decode: argmax + repeat/blank collapse, fixed shape on device.

Counterpart of ``asr_tpu/decode/ctc.py``: the compacted ids are scattered
into a padded ``(B, T)`` buffer with a valid count per sample.
"""

from __future__ import annotations

import torch


def ctc_greedy_collapse(ids: torch.Tensor, valid_len: torch.Tensor, blank_id: int,
                        pad_id: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Framewise ids ``(B, T)`` -> (left-compacted tokens ``(B, T)`` int32, counts ``(B,)`` int32)."""
    b, t = ids.shape
    pos = torch.arange(t, device=ids.device)[None, :]
    valid = pos < valid_len[:, None]
    prev = torch.cat([torch.full((b, 1), -1, dtype=ids.dtype, device=ids.device), ids[:, :-1]], dim=1)
    keep = valid & (ids != blank_id) & (ids != prev)
    # Destination slot = exclusive cumsum of keep; dropped ids land in slot t.
    dest = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    dest = torch.where(keep, dest, torch.full_like(dest, t))
    out = torch.full((b, t + 1), pad_id, dtype=torch.int32, device=ids.device)
    out.scatter_(1, dest, ids.to(torch.int32))
    counts = keep.sum(dim=1).to(torch.int32)
    return out[:, :t], counts
