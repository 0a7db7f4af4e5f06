"""Generic autoregressive decode loop over static-shape buffers.

Counterpart of ``asr_tpu/decode/ar.py``. JAX runs the loop as one
``lax.while_loop`` on the device; here it is a Python loop whose step
writes into fixed-size buffers (the token buffer, the model's KV caches),
with JAX's stop rule: run while ``i < max_new_tokens`` and not every row
has finished. Finished rows write ``eot_id``; buffer slots past the stop
stay 0, so the whole buffer matches JAX's. The stop test reads
``finished.all()`` back from the device: one host sync per step, the last
thing in the step's ``asr.decode.token`` span. The batch-1 greedy decode
of the fused AED step (``ops/fused_aed_step.FusedAedDecoder``) does not go
through this loop: it keeps the loop's state on the device and replays one
CUDA graph a token, with the same stop rule and the same one sync a step.

Works for any ``step(state, tokens (B, 1), pos) -> (logits (B, V), state)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from asr_tpu_torch.decode.strategies import (
    apply_repetition_penalty,
    suppress_tokens,
    top_k_top_p_sample,
)
from asr_tpu_torch.runtime.profiling import annotate


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    max_new_tokens: int
    eot_id: int
    suppress_ids: tuple[int, ...] = ()
    strategy: str = "greedy"  # greedy | penalty | sampling
    penalty: float = 1.0
    penalty_range: int = 64
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0


# noise(shape, device) -> uniform f32 draw in [1e-20, 1) for one sampling call.
Noise = Callable[[tuple, torch.device], torch.Tensor]


def select_token(
    logits: torch.Tensor,
    history_buf: torch.Tensor,
    history_len,
    cfg: DecodeConfig,
    generator: torch.Generator | None = None,
    history_start=0,
    noise: Noise | None = None,
) -> torch.Tensor:
    """Pick the next token ``(B,)`` from already-suppressed logits ``(B, V)``
    with the configured strategy (shared by the prefill's first token and
    the loop's steps). ``history_buf`` / ``history_len`` feed the penalty;
    ``history_start`` (the prompt length) excludes the prompt slots.
    Sampling takes its noise from ``noise`` when given, else ``generator``."""
    if cfg.strategy in ("penalty", "sampling") and cfg.penalty != 1.0:
        logits = apply_repetition_penalty(logits, history_buf, history_len, cfg.penalty,
                                          cfg.penalty_range, hist_start=history_start)
    if cfg.strategy == "sampling":
        uniform = noise(tuple(logits.shape), logits.device) if noise is not None else None
        return top_k_top_p_sample(logits, uniform, cfg.temperature, cfg.top_k, cfg.top_p,
                                  generator=generator)
    return torch.argmax(logits, dim=-1)


def ar_decode(
    step: Callable[[Any, torch.Tensor, int], tuple[torch.Tensor, Any]],
    state: Any,
    prompt_len: int,
    first_token: torch.Tensor,
    token_buffer: torch.Tensor,
    cfg: DecodeConfig,
    generator: torch.Generator | None = None,
    noise: Noise | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the AR loop.

    Args:
      step: feeds ONE token per row at position ``pos`` (the caches in
        ``state`` already hold the prompt).
      prompt_len: prompt length (the same for the batch).
      first_token: ``(B,)`` first generated token (from the prefill logits).
      token_buffer: ``(B, T_total)`` holding the prompt; generated ids are
        written from ``prompt_len`` on. It is not modified.

    Returns (tokens ``(B, T_total)`` int64, counts ``(B,)`` int32); a count
    includes the EOT token when one was produced.
    """
    b = token_buffer.shape[0]
    buf = token_buffer.to(torch.int64).clone()
    buf[:, prompt_len] = first_token
    finished = first_token == cfg.eot_id
    counts = torch.ones((b,), dtype=torch.int32, device=buf.device)
    i = 0

    def going_on() -> bool:  # the host sync, skipped once the budget is spent
        return i < cfg.max_new_tokens and not bool(finished.all())

    more = going_on()
    while more:
        with annotate("asr.decode.token"):  # a token's launches and the sync that reads it back
            pos = prompt_len + i
            logits, state = step(state, buf[:, pos : pos + 1], pos)
            logits = suppress_tokens(logits.to(torch.float32), cfg.suppress_ids)
            nxt = select_token(logits, buf, pos + 1, cfg, generator, history_start=prompt_len,
                               noise=noise)
            nxt = torch.where(finished, cfg.eot_id, nxt)
            buf[:, pos + 1] = nxt
            counts += (~finished).to(torch.int32)
            finished = finished | (nxt == cfg.eot_id)
            i += 1
            more = going_on()
    return buf, counts
