"""CIF (Continuous Integrate-and-Fire) predictor decode, fixed shape.

Counterpart of ``asr_tpu/decode/cif.py``: per-frame weights ``alpha``
accumulate; a token fires whenever the running sum crosses an integer,
and each fired token's acoustic embedding is the alpha-weighted sum of the
encoder frames of its segment (the boundary frame's weight split between
two segments). A ``tail_threshold`` alpha appended after the last valid
frame lets a trailing partial sum fire.

Numerics: FunASR accumulates the alphas in float64 because an f32 cumsum
can miss an integer boundary and change the transcript. The JAX package
keeps f32 and runs the prefix sums as a compensated (Neumaier two-sum)
sequential scan; so does the port, step for step, so the two agree
bitwise on the prefix and hence on every fire position. The scan is T + 1
sequential steps over both prefix sums at once (the alphas and the
weighted frames share one carry), host-launched on a card.

Output is fixed-shape: ``(B, max_tokens, D)`` embeddings and counts; the
fired rows are scattered into a buffer with one dump slot (fires past
``max_tokens`` are clamped into it and dropped).
"""

from __future__ import annotations

import torch


def compensated_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Cumulative sum along ``dim`` with Neumaier compensation, in f32: one
    sequential step per element along ``dim`` (error ~2^-48)."""
    x = torch.movedim(x.to(torch.float32), dim, 0)
    s = torch.zeros_like(x[0])
    c = torch.zeros_like(x[0])
    out = torch.empty_like(x)
    for i in range(x.shape[0]):
        xi = x[i]
        t = s + xi
        e = torch.where(s.abs() >= xi.abs(), (s - t) + xi, (xi - t) + s)  # two-sum error term
        c = c + e
        s = t
        out[i] = t + c
    return torch.movedim(out, 0, dim)


def cif_fire(alphas: torch.Tensor, hidden: torch.Tensor, valid_len: torch.Tensor, max_tokens: int,
             tail_threshold: float = 0.45) -> tuple[torch.Tensor, torch.Tensor]:
    """Integrate-and-fire.

    Args:
      alphas: ``(B, T)`` sigmoid weights (>= 0).
      hidden: ``(B, T, D)`` encoder outputs.
      valid_len: ``(B,)`` valid frame counts (padded frames are ignored).
      max_tokens: static output capacity.
      tail_threshold: virtual alpha appended after the last valid frame.

    Returns ``(B, max_tokens, D)`` fired embeddings (zero past each count)
    and ``(B,)`` int32 fire counts.
    """
    b, t = alphas.shape
    d = hidden.shape[-1]
    dev = alphas.device
    pos = torch.arange(t + 1, device=dev)[None, :]
    valid = valid_len.to(device=dev, dtype=torch.int64)[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    # the tail threshold at the first padded slot, zero past it
    a_ext = torch.where(pos < valid, torch.cat([alphas.float(), alphas.new_zeros((b, 1)).float()], 1), zero)
    a_ext = torch.where(pos == valid, torch.full((), tail_threshold, device=dev), a_ext)
    h_ext = torch.cat([hidden.float(), hidden.new_zeros((b, 1, d)).float()], 1)
    h_ext = torch.where(pos[..., None] < valid[..., None], h_ext, zero)

    # One scan over [alpha | alpha * hidden]: (B, T + 1, 1 + D).
    both = compensated_cumsum(torch.cat([a_ext[..., None], a_ext[..., None] * h_ext], -1), dim=1)
    prefix, weighted = both[..., 0], both[..., 1:]
    floor = torch.floor(prefix)
    prev_floor = torch.cat([torch.zeros_like(floor[:, :1]), floor[:, :-1]], 1)
    fire = floor > prev_floor
    completed = weighted - (prefix - floor)[..., None] * h_ext

    # Fired rows in order into a (max_tokens + 1)-row buffer, then differences.
    dest = torch.where(fire, torch.cumsum(fire.to(torch.int64), 1) - 1, max_tokens).clamp(max=max_tokens)
    buf = torch.zeros((b, max_tokens + 1, d), dtype=torch.float32, device=dev)
    buf[torch.arange(b, device=dev)[:, None], dest] = completed  # the dump slot takes the rest
    prev = torch.cat([torch.zeros_like(buf[:, :1]), buf[:, : max_tokens - 1]], 1)
    counts = torch.clamp(floor[:, -1].to(torch.int32), max=max_tokens)
    embeds = buf[:, :max_tokens] - prev
    tok_pos = torch.arange(max_tokens, device=dev)[None, :]
    return torch.where((tok_pos < counts[:, None])[..., None], embeds, zero), counts
