"""Logit-processing decode strategies, fixed shape.

Counterpart of ``asr_tpu/decode/strategies.py``: token suppression,
sliding-window repetition penalty, and temperature -> top-k -> top-p ->
Gumbel-argmax sampling. JAX draws the sampler's uniform noise from a
threefry key; here the noise is an argument, or is drawn from a
``torch.Generator`` when none is given, so a test can feed both packages
the same draw.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def suppress_tokens(logits: torch.Tensor, ids) -> torch.Tensor:
    """Hard-mask token ids (Whisper suppress list); returns a new tensor."""
    if ids is None or len(ids) == 0:
        return logits
    out = logits.clone()
    out[..., torch.as_tensor(list(ids), device=logits.device)] = NEG_INF
    return out


def apply_repetition_penalty(
    logits: torch.Tensor,
    history: torch.Tensor,
    hist_len,
    penalty: float,
    penalty_range: int,
    hist_start=0,
) -> torch.Tensor:
    """Penalize ids seen in the last ``penalty_range`` generated tokens:
    ``logit * penalty`` where negative, ``logit / penalty`` otherwise.
    Slots before ``hist_start`` (the prompt) are never penalized."""
    b, v = logits.shape
    h = history.shape[1]
    dev = logits.device
    idx = torch.arange(h, device=dev)[None, :]
    hist_len = torch.as_tensor(hist_len, device=dev).broadcast_to((b,))[:, None]
    start = torch.as_tensor(hist_start, device=dev).broadcast_to((b,))[:, None]
    in_window = (idx < hist_len) & (idx >= hist_len - penalty_range) & (idx >= start)
    safe_ids = torch.where(in_window, history.to(torch.int64), v)  # out of window -> dropped slot
    marks = torch.zeros((b, v + 1), dtype=torch.bool, device=dev)
    marks.scatter_(1, safe_ids, True)
    penalized = torch.where(logits < 0, logits * penalty, logits / penalty)
    return torch.where(marks[:, :v], penalized, logits)


def uniform_noise(shape, device, generator: torch.Generator | None = None) -> torch.Tensor:
    """Uniform f32 draw in [1e-20, 1), the range JAX's sampler draws from."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return torch.clamp(u, min=1e-20)


def top_k_top_p_sample(
    logits: torch.Tensor,
    uniform: torch.Tensor | None = None,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Temperature -> top-k -> top-p (nucleus) -> Gumbel-argmax sampling.
    ``top_k <= 0`` disables top-k; ``top_p >= 1`` disables nucleus.
    ``uniform`` is the (B, V) noise in [1e-20, 1); drawn from ``generator``
    when None. Returns (B,) int64 ids."""
    x = logits.to(torch.float32)
    if temperature != 1.0:
        x = x / temperature
    if top_k and top_k > 0:
        kth = torch.topk(x, top_k, dim=-1).values[..., -1:]
        x = torch.where(x < kth, NEG_INF, x)
    if top_p < 1.0:
        sorted_x = torch.sort(x, dim=-1, descending=True).values
        probs = torch.softmax(sorted_x, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = (cum - probs) < top_p  # exclusive cumulative prob < top_p
        cutoff = torch.where(keep_sorted, sorted_x, torch.inf).amin(dim=-1, keepdim=True)
        x = torch.where(x < cutoff, NEG_INF, x)
    if uniform is None:
        uniform = uniform_noise(x.shape, x.device, generator)
    gumbel = -torch.log(-torch.log(uniform))
    return torch.argmax(x + gumbel, dim=-1)
