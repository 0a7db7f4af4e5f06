"""Signal framing as shifted reshapes.

Counterpart of ``asr_tpu/frontend/framing.py``. With ``K = ceil(win / hop)``
blocks of ``hop`` samples, frame ``m`` is ``blocks[m : m + K]`` flattened:
the first ``win`` samples are the frame and the tail is scratch that a
basis with zero rows there ignores.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def num_frames_snip(num_samples: int, win: int, hop: int) -> int:
    """Kaldi ``snip_edges=True`` frame count: frames fully inside the signal."""
    if num_samples < win:
        return 0
    return (num_samples - win) // hop + 1


def frame_signal(x: torch.Tensor, win: int, hop: int, n_frames: int) -> torch.Tensor:
    """``(..., num_samples)`` -> ``(..., n_frames, K * hop)``; columns
    ``[0, win)`` hold the frame, the rest are the samples that follow it."""
    k = math.ceil(win / hop)
    need = (n_frames - 1 + k) * hop  # block m+k-1 must exist for the last frame
    pad = need - x.shape[-1]
    if pad > 0:
        x = F.pad(x, (0, pad))
    elif pad < 0:
        x = x[..., :need]
    blocks = x.reshape(*x.shape[:-1], n_frames - 1 + k, hop)
    return torch.cat([blocks[..., i : i + n_frames, :] for i in range(k)], dim=-1)
