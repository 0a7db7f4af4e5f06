"""RNN-T (transducer) and TDT losses as a diagonal-wavefront scan.

Counterpart of ``asr_tpu/parallel/rnnt_loss.py``. The forward-variable
recursion

    alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
                            alpha[t, u-1] + label[t, u-1])

is evaluated along anti-diagonals (t + u = const): every cell on a diagonal
depends only on the previous one, so a loop of T+U-1 steps updates whole
(B, T, U+1) slabs with elementwise ops, in the JAX package's form (the same
``NEG_INF`` masks, pads and ``where`` on the diagonal), so the numbers agree.

The loop runs on the host and launches about ten small kernels a step (more
for TDT, and again when the backward pass recomputes): it is host-paced, as
the CIF scan is. Each step runs under non-reentrant
``torch.utils.checkpoint`` where autograd records, the counterpart of the
JAX step's ``jax.checkpoint``: the backward pass keeps each step's input
slab and recomputes the step, so the saved residuals stay O(T+U) slabs.

Loss = -log P(labels | enc) = -(alpha[T-1, U] + blank[T-1, U]) gathered at
each sample's (T_valid, U_valid).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


def _lattice(log_probs: torch.Tensor, labels: torch.Tensor, t_valid: torch.Tensor,
             u_valid: torch.Tensor, blank_id):
    """The blank (B, T, U+1) and label (B, T, U) emission slabs, masked with
    ``NEG_INF`` outside each sample's valid lattice, and the diagonal index
    t + u of every cell."""
    b, t_max, u1, _ = log_probs.shape
    u_max = u1 - 1
    dev = log_probs.device
    t_valid = torch.as_tensor(t_valid, device=dev)
    u_valid = torch.as_tensor(u_valid, device=dev)
    labels = torch.as_tensor(labels, device=dev).to(torch.int64)
    blank_lp = log_probs[..., blank_id]
    # label_lp[b, t, u] = log_prob of emitting labels[b, u] at (t, u)
    index = labels[:, None, :, None].expand(b, t_max, u_max, 1)
    label_lp = torch.gather(log_probs[:, :, :u_max, :], 3, index)[..., 0]
    t_ids = torch.arange(t_max, device=dev)[None, :, None]
    u_ids = torch.arange(u1, device=dev)[None, None, :]
    in_t = t_ids < t_valid[:, None, None]
    neg = torch.full((), NEG_INF, dtype=log_probs.dtype, device=dev)
    blank_lp = torch.where(in_t & (u_ids <= u_valid[:, None, None]), blank_lp, neg)
    label_lp = torch.where(in_t & (u_ids[:, :, :u_max] < u_valid[:, None, None]), label_lp, neg)
    return blank_lp, label_lp, t_ids + u_ids, t_valid, u_valid


def _scan(step, alpha: torch.Tensor, n_diagonals: int) -> torch.Tensor:
    """``alpha = step(alpha, d)`` for d = 1 .. n_diagonals - 1, each step
    checkpointed where autograd records."""
    for d in range(1, n_diagonals):
        if torch.is_grad_enabled():
            alpha = checkpoint(step, alpha, d, use_reentrant=False)
        else:
            alpha = step(alpha, d)
    return alpha


def _alpha0(blank_lp: torch.Tensor) -> torch.Tensor:
    alpha = torch.full(blank_lp.shape, NEG_INF, dtype=blank_lp.dtype, device=blank_lp.device)
    alpha[:, 0, 0] = 0.0
    return alpha


def _final_cells(t_valid: torch.Tensor, u_valid: torch.Tensor, t_max: int, u_max: int):
    """(batch index, T_valid - 1, U_valid), clamped into the lattice as JAX clamps."""
    tv = torch.clamp(t_valid - 1, 0, t_max - 1)
    uv = torch.clamp(u_valid, 0, u_max)
    return torch.arange(tv.shape[0], device=tv.device), tv, uv


def rnnt_loss(
    log_probs: torch.Tensor,   # (B, T, U+1, V) joint log-softmax
    labels: torch.Tensor,      # (B, U) integer
    t_valid: torch.Tensor,     # (B,) frames per sample
    u_valid: torch.Tensor,     # (B,) label counts per sample
    blank_id: int = 0,
) -> torch.Tensor:
    """Per-sample negative log-likelihood (B,)."""
    _, t_max, u1, _ = log_probs.shape
    blank_lp, label_lp, diag, t_valid, u_valid = _lattice(log_probs, labels, t_valid, u_valid, blank_id)

    def step(alpha, d):
        # from above: arrived by emitting blank at (t-1, u)
        from_t = F.pad(alpha[:, :-1, :] + blank_lp[:, :-1, :], (0, 0, 1, 0), value=NEG_INF)
        # from left: arrived by emitting label u-1 at (t, u-1)
        from_u = F.pad(alpha[:, :, :-1] + label_lp, (1, 0), value=NEG_INF)
        return torch.where(diag == d, torch.logaddexp(from_t, from_u), alpha)

    alpha = _scan(step, _alpha0(blank_lp), t_max + u1)
    # Total log-prob: final blank emitted from (T_valid-1, U_valid).
    cell = _final_cells(t_valid, u_valid, t_max, u1 - 1)
    return -(alpha[cell] + blank_lp[cell])


def rnnt_loss_from_logits(logits, labels, t_valid, u_valid, blank_id=0):
    """Convenience: joint LOGITS (B, T, U+1, V) -> mean loss (scalar)."""
    lp = torch.log_softmax(logits, dim=-1)
    return torch.mean(rnnt_loss(lp, labels, t_valid, u_valid, blank_id))


def tdt_loss(
    token_log_probs: torch.Tensor,   # (B, T, U+1, V) token log-softmax
    dur_log_probs: torch.Tensor,     # (B, T, U+1, D) duration log-softmax
    labels: torch.Tensor,            # (B, U)
    t_valid: torch.Tensor,
    u_valid: torch.Tensor,
    durations: tuple = (0, 1, 2, 3, 4),
    blank_id: int = 0,
) -> torch.Tensor:
    """Token-and-Duration Transducer NLL (Parakeet-TDT's training law;
    greedy counterpart in ``decode/tdt.py``).

    Transitions from (t, u): emit ``labels[u]`` with duration d (advance to
    (t+d, u+1)), or emit blank with duration d >= 1 (advance to (t+d, u)).
    Every transition strictly increases t+u, so the same anti-diagonal
    wavefront as :func:`rnnt_loss` applies: T+U-1 steps, each combining
    |durations| shifted slabs.
    """
    _, t_max, u1, _ = token_log_probs.shape
    u_max = u1 - 1
    blank_lp, label_lp, diag, t_valid, u_valid = _lattice(token_log_probs, labels, t_valid, u_valid,
                                                          blank_id)

    def shift_t(m, d):
        """m[:, t-d, :] with NEG_INF fill (source row t-d)."""
        if d == 0:
            return m
        return F.pad(m[:, :-d, :], (0, 0, d, 0), value=NEG_INF)

    def step(alpha, diagonal):
        total = torch.full(alpha.shape, NEG_INF, dtype=alpha.dtype, device=alpha.device)
        for di, d in enumerate(durations):
            dlp = dur_log_probs[..., di]
            if d >= 1:
                # blank, duration d: (t-d, u) -> (t, u)
                total = torch.logaddexp(total, shift_t(alpha + blank_lp + dlp, d))
            # label, duration d: (t-d, u-1) -> (t, u)
            lbl = F.pad(alpha[:, :, :-1] + label_lp + dlp[:, :, :u_max], (1, 0), value=NEG_INF)
            total = torch.logaddexp(total, shift_t(lbl, d))
        return torch.where(diag == diagonal, total, alpha)

    alpha = _scan(step, _alpha0(blank_lp), t_max + u1)
    # Finish: blank from (T_valid-1, U_valid) with any duration that leaves
    # the valid frames (the reference decoder stops once t >= T).
    cell = _final_cells(t_valid, u_valid, t_max, u_max)
    final_dur = torch.logsumexp(
        torch.stack([dur_log_probs[cell + (di,)] for di, d in enumerate(durations) if d >= 1]), dim=0)
    return -(alpha[cell] + blank_lp[cell] + final_dur)
