"""The whole step's share (%) of the card's bf16 peak: model operations of
the work completed in the window (real windows, not padded ones; the
tokens decoded) over the window's length."""

from benchmark.metrics._common import mfu_throughput as read  # noqa: F401
