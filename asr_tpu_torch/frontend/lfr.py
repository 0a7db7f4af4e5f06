"""Low-Frame-Rate (LFR) stacking and CMVN.

Counterpart of ``asr_tpu/frontend/lfr.py``: stack ``m`` consecutive frames
every ``n`` frames, with indices clamped to ``[0, valid_frames - 1]`` so a
padded batch equals variable-length runs in its valid region.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def lfr_out_len(frames: int, lfr_n: int) -> int:
    return (frames + lfr_n - 1) // lfr_n


@functools.lru_cache(maxsize=16)
def _lfr_index_table(t_lfr: int, lfr_m: int, lfr_n: int) -> np.ndarray:
    base = np.arange(0, t_lfr * lfr_n, lfr_n, dtype=np.int64)[:, None]
    offs = np.arange(lfr_m, dtype=np.int64)[None, :] - (lfr_m - 1) // 2
    return np.maximum(base + offs, 0)


def lfr_stack(feats: torch.Tensor, lfr_m: int, lfr_n: int,
              valid_frames: torch.Tensor | int | None = None) -> torch.Tensor:
    """``(B, T, n_mels)`` -> ``(B, ceil(T / lfr_n), n_mels * lfr_m)``.

    ``valid_frames``: None, an int, or a ``(B,)`` tensor of valid input
    frames; indices are clamped to ``valid_frames - 1`` (an index of -1,
    from zero valid frames, counts from the end as in the JAX package)."""
    b, t, d = feats.shape
    t_lfr = lfr_out_len(t, lfr_n)
    table = torch.from_numpy(_lfr_index_table(t_lfr, lfr_m, lfr_n)).to(feats.device)
    if valid_frames is None:
        valid = torch.full((b,), t, dtype=torch.int64, device=feats.device)
    else:
        valid = torch.as_tensor(valid_frames, dtype=torch.int64, device=feats.device)
        valid = valid.expand(b) if valid.ndim == 0 else valid
    idx = torch.minimum(table[None], valid[:, None, None] - 1).reshape(b, -1)
    idx = torch.where(idx < 0, idx + t, idx)
    stacked = torch.gather(feats, 1, idx[..., None].expand(b, idx.shape[1], d))
    return stacked.reshape(b, t_lfr, d * lfr_m)


def apply_cmvn_addmul(feats: torch.Tensor, means: torch.Tensor, istd: torch.Tensor) -> torch.Tensor:
    """FunASR CMVN: ``(x + means) * istd`` (means stored negated, istd inverse std)."""
    return (feats + means) * istd
