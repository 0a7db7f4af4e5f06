"""``csrc/quant_matmul_int8.cu``: x (M, K) f32 @ dequant(q (K, N) int8) ->
(M, N) f32, with an f32 scale and zero point per (block of K rows, column).

Bytes: x read (4 M K), the int8 weight (K N), its scales and zero points
(8 (K / block) N), the output written (4 M N). Operations: 2 M K N. The
bound of a call is the larger of bytes / 3.35 TB/s and operations /
989 TFLOP/s (the kernel's mma.sync runs in bf16 mode).
"""

from __future__ import annotations

from benchmark.core import bound_seconds
from benchmark.kernels import share

# its device kernels: the staging kernel and the tensor-core product (bf16
# mode) or the CUDA-core one (f32 mode), all in the file's ``i8`` namespace
NAMES = r"\bi8::"


def cost(m: int, k: int, n: int, block: int) -> tuple[int, float]:
    """(bytes, operations) of one call."""
    if k % block:
        block = k
    return 4 * m * k + k * n + 8 * (k // block) * n + 4 * m * n, 2.0 * m * k * n


def bound(calls) -> tuple[float, int]:
    """Σ bound seconds and the call count of ``calls`` = [(m, k, n, block, count)]."""
    total, count = 0.0, 0
    for m, k, n, block, c in calls:
        total += c * bound_seconds(*cost(m, k, n, block))
        count += c
    return total, count


def roofline(run, span: str) -> float | None:
    """Σ bound ÷ Σ device time over the traced spans named ``span`` whose
    int8 launches (the program's counter) equal the calls their shapes
    give; None if any traced span disagrees or none was traced."""
    if run.trace is None:
        return None
    pairs = run.trace.matched(run.spans.of(span))
    if not pairs:
        return None
    bound_s, device_us = 0.0, 0.0
    for rec, iv in pairs:
        b, c = bound(rec["int8_calls"])
        if c != rec.get("int8_launches"):
            return None
        bound_s += b
        device_us += run.trace.union((x, y) for x, y, _ in run.trace.kernels(NAMES, [iv]))
    return share(bound_s, device_us * 1e-6)
