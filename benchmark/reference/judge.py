"""The numbers that decide ``correct``: how far below the reference's best
logit the served tokens lie.

- An autoregressive decoder (Whisper): at each position of the prompt plus
  the served tokens, the gap ``max(logits) - logits[served]``; the reading
  is the widest. A request that stopped early served EOT at its end, which
  is judged the same way.
- A CTC model (SenseVoice): the program returns the collapsed ids only, so
  the reading is the smallest, over every frame path whose per-window CTC
  collapse gives those ids, of the path's widest gap. The per-window
  collapse starts afresh at each window, as the session's does.
"""

from __future__ import annotations

import torch

INF = float("inf")


def ar_widest_gap(logits: torch.Tensor, first: int, served: list[int]) -> float:
    """``logits`` (S, V) of a teacher-forced pass; row ``first + j`` scores
    ``served[j]``."""
    if not served:
        return 0.0
    rows = logits[first : first + len(served)].to(torch.float32)
    idx = torch.tensor(served, device=rows.device)[:, None]
    gaps = rows.max(dim=-1).values - rows.gather(1, idx)[:, 0]
    return float(gaps.max())


def ctc_widest_gap(window_logits: list[torch.Tensor], ids: list[int], blank: int) -> float:
    """The least widest gap of a frame path that collapses, window by
    window, to ``ids``. ``window_logits``: each window's (T_i, V) logits
    over its valid rows. Returns inf where no path gives ``ids``."""
    dev = window_logits[0].device
    lab = torch.tensor(ids, dtype=torch.int64, device=dev)
    n = len(ids)
    s = 2 * n + 1
    ext = torch.full((s,), blank, dtype=torch.int64, device=dev)
    ext[1::2] = lab
    is_label = torch.zeros((s,), dtype=torch.bool, device=dev)
    is_label[1::2] = True
    # a skip over the blank between two labels needs them to differ
    skip_ok = torch.zeros((s,), dtype=torch.bool, device=dev)
    if n > 1:
        skip_ok[3::2] = lab[1:] != lab[:-1]
    inf = torch.full((1,), INF, device=dev)
    cost = None  # cost[j]: least widest gap of a path so far ending in state j
    for lg in window_logits:
        lg = lg.to(torch.float32)
        gaps = lg.max(dim=-1, keepdim=True).values - lg  # (T, V)
        g = gaps[:, ext]                                  # (T, S)
        for t in range(g.shape[0]):
            if cost is None:  # the first frame: the leading blank or the first label
                best = torch.full((s,), INF, device=dev)
                best[: min(s, 2)] = 0.0
            elif t == 0:
                # a window boundary: the collapse restarts, so a label state
                # cannot carry on into the next window (that frame would emit
                # again), while a label may follow a label directly
                stay = torch.where(is_label, inf.expand(s), cost)
                step1 = torch.cat([inf, cost[:-1]])
                step2 = torch.cat([inf, inf, cost[:-2]])
                step2 = torch.where(is_label, step2, inf.expand(s))
                best = torch.minimum(torch.minimum(stay, step1), step2)
            else:
                step1 = torch.cat([inf, cost[:-1]])
                step2 = torch.cat([inf, inf, cost[:-2]])
                step2 = torch.where(skip_ok, step2, inf.expand(s))
                best = torch.minimum(torch.minimum(cost, step1), step2)
            cost = torch.maximum(best, g[t])
    if cost is None:
        return INF if n else 0.0
    return float(torch.minimum(cost[-1], cost[-2]) if s > 1 else cost[-1])
