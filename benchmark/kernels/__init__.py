"""Work counts of the port's kernels, one module a kernel, frozen here.

Each gives the bytes and operations of one call from its shapes (each input
byte read once, each output byte written once, the cache rows the inputs
use rather than the cache's capacity) and the regular expression of its
device kernels' names in a trace. ``share(bound_s, device_s)`` is the
roofline share in percent."""

from __future__ import annotations


def share(bound_s: float, device_s: float) -> float | None:
    return 100.0 * bound_s / device_s if device_s > 0 and bound_s > 0 else None
