"""The card's idle share (%) of the traced sub-window: no kernel, copy or
memset running (the union of the trace's device events)."""

from benchmark.metrics._common import idle_share as read  # noqa: F401
