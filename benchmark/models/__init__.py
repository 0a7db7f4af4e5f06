"""Builders, one module per ``family`` a configuration names. Each has
``build(config, mix, seed, device, spans) -> Target``; a target has
``sample_rate`` and ``scale`` (the traffic's audio), ``warmup(traffic)``,
``submit(request, notify=None) -> handle`` (``wait``, ``ok``, ``t_done``,
``out``; ``notify(handle)`` once it has returned),
``counters()``, ``work_flops(out)``, ``close()`` and
``judge(requests, outs, bits_control=None) -> readings``."""

from __future__ import annotations

import threading
import time

import torch


class Done:
    """The handle of a call that returned: already complete."""

    def __init__(self, out=None, error: BaseException | None = None):
        self.t_done = time.perf_counter()
        self.out = out
        self.error = error

    @property
    def ok(self) -> bool:
        return self.error is None

    def wait(self, timeout=None) -> bool:
        return True


class StampedEvent(threading.Event):
    """An event that keeps the time it was set, and tells ``notify`` (from
    the setting thread) that it was."""

    t_set = None
    notify = None

    def set(self) -> None:
        first = self.t_set is None
        if first:
            self.t_set = time.perf_counter()
        super().set()
        if first and self.notify is not None:
            self.notify(self)


def done(handle, notify):
    """A finished call's handle, ``notify`` told of it."""
    if notify is not None:
        notify(handle)
    return handle


def seeded_normal(seed: int, device, shapes: dict[str, tuple]) -> dict[str, torch.Tensor]:
    """Standard normal tensors of the given shapes from one draw of a
    generator on ``device`` seeded with ``seed``: the same seed gives the
    same tensors."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    total = sum(int(torch.Size(s).numel()) for s in shapes.values())
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = int(torch.Size(shape).numel())
        out[name] = flat[at : at + n].view(shape)
        at += n
    return out


def own(tree):
    """The tree with every tensor that is a view copied into storage of
    its own, so that the one draw behind the views can be freed."""
    if isinstance(tree, dict):
        return {k: own(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(own(v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree._base is not None:
        return tree.clone()
    return tree


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
