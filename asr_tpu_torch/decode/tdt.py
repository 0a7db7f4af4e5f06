"""Token-and-Duration Transducer (TDT) greedy decode, batched, fixed shape.

Counterpart of ``asr_tpu/decode/tdt.py``: each joint step at a row's
current encoder frame emits (token, duration); a blank keeps the predictor
state and token, the duration advances the frame pointer (a blank with
duration 0 advances by 1), a non-blank updates the state and may predict
duration 0 (several tokens on one frame). The JAX package runs the loop as
one ``lax.while_loop`` on the device; here the carry is fixed-shape
tensors on the device and the host reads ``all(done)`` once every
:data:`SYNC_EVERY` steps (:func:`run_chunked`). A step after every row is
done changes no output, so the extra steps of a chunk are harmless, and
the loop never runs more than JAX's ``max_symbols_per_step * T`` steps.
"""

from __future__ import annotations

from typing import Callable

import torch

SYNC_EVERY = 8  # greedy steps between two host reads of all(done)
SYNCS = 0  # host reads of all(done) by the transducer loops, for measurement


def run_chunked(step: Callable[[], torch.Tensor], max_steps: int, sync_every: int) -> None:
    """Run ``step`` (one greedy step; returns the (B,) ``done`` flags) until
    ``max_steps`` steps have run or, read once every ``sync_every`` steps,
    every row is done."""
    global SYNCS
    steps = 0
    while steps < max_steps:
        for _ in range(min(sync_every, max_steps - steps)):
            done = step()
            steps += 1
        SYNCS += 1
        if bool(done.all()):
            break


def tdt_greedy(
    joint_step: Callable,
    enc: torch.Tensor,
    enc_valid: torch.Tensor,
    h0: torch.Tensor,
    c0: torch.Tensor,
    start_token: int,
    blank_id: int,
    durations: tuple[int, ...],
    max_tokens: int,
    max_symbols_per_step: int = 10,
    eos_id: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched TDT greedy loop.

    Args:
      joint_step: ``(token (B,), h, c, enc_frame (B, D)) ->
        (token_logits (B, V), dur_logits (B, ND), h', c')``.
      enc: ``(B, T, D)`` projected encoder frames.
      enc_valid: ``(B,)`` valid frame counts.
      h0 / c0: initial predictor state ``(L, B, H)``.
      start_token: the SOS convention (Parakeet starts from blank_id).

    Returns (tokens ``(B, max_tokens)`` int32, counts ``(B,)`` int32).
    """
    b, t, _ = enc.shape
    dev = enc.device
    dur_table = torch.tensor(durations, dtype=torch.int64, device=dev)
    rows = torch.arange(b, device=dev)
    valid = enc_valid.to(device=dev, dtype=torch.int64)
    zero, one = torch.zeros((), dtype=torch.int64, device=dev), torch.ones((), dtype=torch.int64, device=dev)
    st = {
        "frame": torch.zeros(b, dtype=torch.int64, device=dev),
        "token": torch.full((b,), start_token, dtype=torch.int64, device=dev),
        "h": h0, "c": c0,
        "buf": torch.zeros((b, max_tokens + 1), dtype=torch.int32, device=dev),  # + the dump slot
        "count": torch.zeros(b, dtype=torch.int64, device=dev),
        "done": torch.zeros(b, dtype=torch.bool, device=dev),
    }

    def step() -> torch.Tensor:
        frame, token, h, c, count, done = (st[k] for k in ("frame", "token", "h", "c", "count", "done"))
        enc_frame = enc[rows, frame.clamp(0, t - 1)]
        tok_logits, dur_logits, h2, c2 = joint_step(token, h, c, enc_frame)
        tok = torch.argmax(tok_logits, dim=-1)
        dur = dur_table[torch.argmax(dur_logits, dim=-1)]
        is_blank = tok == blank_id
        hit_eos = tok == eos_id if eos_id is not None else torch.zeros_like(done)
        emit = ~is_blank & ~hit_eos & ~done
        st["buf"][rows, torch.where(emit, count, max_tokens)] = tok.to(torch.int32)
        count = count + emit.to(torch.int64)
        keep_state = is_blank | done
        st["token"] = torch.where(keep_state | hit_eos, token, tok)
        st["h"] = torch.where(keep_state[None, :, None], h, h2)
        st["c"] = torch.where(keep_state[None, :, None], c, c2)
        dur = torch.where(is_blank & (dur == 0), one, dur)
        frame = frame + torch.where(done, zero, dur)
        st["frame"], st["count"] = frame, count
        st["done"] = done | (frame >= valid) | (count >= max_tokens) | hit_eos
        return st["done"]

    run_chunked(step, max_symbols_per_step * t, SYNC_EVERY)
    return st["buf"][:, :max_tokens], st["count"].to(torch.int32)
