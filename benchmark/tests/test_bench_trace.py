"""The trace arithmetic on a synthetic Chrome trace."""

from __future__ import annotations

import pytest

from benchmark.tracing import Spans, Trace, short_name


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    ev("bench.request#0", "user_annotation", 0, 100),
    ev("aten::mm", "cpu_op", 5, 10),
    ev("void i8::(anonymous namespace)::int8_mma_kernel<64, 128>(i8::Args)", "kernel", 10, 20),
    ev("void i8::(anonymous namespace)::stage_x_kernel(float const*)", "kernel", 25, 10),  # overlaps
    ev("Memcpy DtoH", "gpu_memcpy", 60, 5),
    ev("cudaStreamSynchronize", "cuda_runtime", 40, 30),
    ev("void aedstep::(anonymous namespace)::q8_matvec<1, 4>(Mv)", "kernel", 120, 10),
    ev("bench.prefill#1", "user_annotation", 110, 40),
]


def test_busy_union_and_window():
    t = Trace(EVENTS)
    assert t.window_us == 150
    assert t.busy_us() == pytest.approx(25 + 5 + 10)  # [10, 35) + [60, 65) + [120, 130)


def test_kernels_inside_spans():
    t = Trace(EVENTS)
    spans = Spans(enabled=False)
    spans.records = [{"name": "request", "seq": 0, "t0": 0, "t1": 1},
                     {"name": "prefill", "seq": 1, "t0": 2, "t1": 3}]
    (rec, iv), = t.matched(spans.of("request"))
    assert iv == (0, 100)
    inside = t.kernels(r"\bi8::", [iv])
    assert len(inside) == 2
    assert t.union((a, b) for a, b, _ in inside) == 25
    assert t.kernels(r"\baedstep::", [iv]) == []
    assert len(t.kernels(r"\baedstep::", [t.spans[1]])) == 1


def test_breakdown():
    t = Trace(EVENTS)
    ops = dict(t.device_ops())
    assert ops["i8::int8_mma_kernel"] == pytest.approx(20e-6)
    gaps = dict(t.idle_gaps())
    # [35, 60) under the synchronise, [65, 120) under the request span
    assert gaps["cudaStreamSynchronize"] == pytest.approx(25e-6)
    assert gaps["bench.request#0"] == pytest.approx(55e-6)


def test_short_name():
    assert short_name("void aedstep::(anonymous namespace)::attn_aed<float>(Attn)") == "aedstep::attn_aed"
