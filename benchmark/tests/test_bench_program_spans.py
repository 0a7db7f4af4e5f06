"""The readers of the program's stage spans (``metrics/_program.py``,
``encoder_idle.longform``, ``token_idle_us.single_b1``,
``session_idle_ms.request``) on a synthetic Chrome trace."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import core
from benchmark.metrics import _program
from benchmark.tracing import Trace


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def span(name, ts, dur):
    return ev(name, "user_annotation", ts, dur)


REQUEST = [
    span("bench.request#0", 0, 1000),
    span("asr.session.transcribe", 0, 1000),
    span("asr.session.pack", 0, 100),                  # no device event: 100 idle
    span("asr.session.upload", 100, 100),              # a copy of 60: 40 idle
    ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 120, 60),
    span("asr.sv.encode", 200, 500),
    span("asr.sv.block", 200, 250),
    ev("void i8::int8_mma_kernel<64, 128>(i8::Args)", "kernel", 210, 90),
    ev("at::native::elementwise_kernel", "kernel", 250, 100),   # overlaps: [210, 350)
    ev("aten::add", "cpu_op", 360, 5),
    ev("at::native::vectorized_elementwise_kernel", "kernel", 400, 200),
    ev("at::native::reduce_kernel", "kernel", 650, 100),        # across encode's end
    ev("asr.sv.encode", "gpu_user_annotation", 210, 540),       # the device-side copy: not a span
    span("asr.session.download", 700, 200),            # 50 of the kernel + a copy of 10: 140 idle
    ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 880, 10),
    span("asr.session.collect", 900, 100),             # 100 idle
]
TOKENS = [
    span("asr.decode.token", 1000, 100),
    span("asr.decode.token", 1100, 100),
    ev("void aedstep::q8_matvec<1, 4>(Mv)", "kernel", 1050, 100),  # 50 in each
    ev("cudaStreamSynchronize", "cuda_runtime", 1150, 50),
]


def run_of(events):
    return SimpleNamespace(trace=Trace(events))


def test_idle_inside_spans_is_clipped_at_their_edges():
    run = run_of(REQUEST + TOKENS)
    assert _program.spans(run, "asr.sv.encode") == [(200, 700)]
    # encode [200, 700): busy [210, 350) + [400, 600) + [650, 700) = 390
    assert _program.idle_us(run, [(200, 700)]) == pytest.approx(110)
    assert _program.idle_us(run, [(700, 900)]) == pytest.approx(140)  # [700, 750) + [880, 890)
    assert _program.idle_us(run, [(0, 100), (1000, 1100)]) == pytest.approx(100 + 50)
    assert _program.idle_us(run, []) == 0


@pytest.mark.parametrize("metric,want", [
    ("encoder_idle.longform", 100.0 * 110 / 500),
    ("session_idle_ms.request", 1e-3 * (100 + 40 + 140 + 100)),
    ("token_idle_us.single_b1", 50.0),
])
def test_readers(metric, want):
    assert core.metric_reader(metric)(run_of(REQUEST + TOKENS)) == pytest.approx(want)


def test_session_idle_counts_every_stage_over_the_requests():
    second = [dict(e, ts=e["ts"] + 2000) for e in REQUEST]
    run = run_of(REQUEST + second)
    assert core.metric_reader("session_idle_ms.request")(run) == pytest.approx(1e-3 * 380)


@pytest.mark.parametrize("metric", ["encoder_idle.longform", "session_idle_ms.request",
                                    "token_idle_us.single_b1"])
def test_none_without_the_programs_spans(metric):
    """The parent's trace holds the benchmark's spans and device events but
    no ``asr.*`` span; an untraced run has no trace."""
    plain = [e for e in REQUEST + TOKENS if not e["name"].startswith("asr.")]
    assert core.metric_reader(metric)(run_of(plain)) is None
    assert core.metric_reader(metric)(SimpleNamespace(trace=None)) is None
