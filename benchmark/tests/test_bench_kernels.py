"""The frozen work counts against shapes worked out by hand."""

from __future__ import annotations

import pytest

from benchmark import core
from benchmark.kernels import aed_step, int8_mm
from benchmark.models import sensevoice, whisper

SV = core.read_json("configs", "sensevoice_small_q8")
WH = core.read_json("configs", "whisper_large_v3_turbo_q8")


def test_int8_cost_by_hand():
    # M=137, K=512, N=2048, blocks of 128: x 137*512*4, w 512*2048, scales and
    # zeros 4 blocks * 2048 * 8, out 137*2048*4
    nbytes, flops = int8_mm.cost(137, 512, 2048, 128)
    assert nbytes == 280576 + 1048576 + 65536 + 1122304
    assert flops == 2 * 137 * 512 * 2048
    # K not a multiple of the block: one block of K rows
    assert int8_mm.cost(10, 560, 1536, 128)[0] == 4 * 10 * 560 + 560 * 1536 + 8 * 1536 + 4 * 10 * 1536


def test_bound_takes_the_larger_side():
    nb, fl = int8_mm.cost(17500, 512, 2048, 128)
    assert core.bound_seconds(nb, fl) == pytest.approx(max(nb / 3.35e12, fl / 989e12))


def test_sensevoice_calls_and_rows():
    assert sensevoice.rows_per_window(SV) == 137  # 798 frames -> 133 LFR rows + 4 prompt rows
    calls = sensevoice.linears(SV)
    assert len(calls) == 281 and calls[0] == (560, 1536) and calls[-1] == (512, 25055)
    params = sum(k * n for k, n in calls)
    assert 2 * 137 * params == pytest.approx(63.9e9, rel=0.01)


def test_whisper_prefill_calls():
    calls = whisper.prefill_int8_calls(WH, 128)
    assert sum(c[-1] for c in calls) == 274  # 32 x 6 encoder, 2 x 8 cross k/v, 2 x 33 probe + prompt
    assert sum(c[-1] for c in calls if c[0] == 1500) == 208


def test_aed_step_counts_the_rows_used():
    g = whisper.geometry(WH)
    b1, f1 = aed_step.cost(slots=[(5, 1500)], **g)
    b2, f2 = aed_step.cost(slots=[(445, 1500)], **g)
    d, nl = 1280, 4
    assert b2 - b1 == 2 * nl * 440 * d * 4  # 440 more self rows of k and v, f32
    assert f2 - f1 == 4.0 * nl * 440 * d
    # a second slot reads no second copy of the weights
    b3, f3 = aed_step.cost(slots=[(5, 1500), (5, 1500)], **g)
    w = aed_step.weight_elems(d, 5120, nl, 51866)
    assert b3 - b1 < w and f3 == 2 * f1
    assert aed_step.cost(slots=[(5, 1500)], cache_bytes=2, **g)[0] < b1


def test_whisper_request_flops_grow_with_tokens():
    assert whisper.request_flops(WH, 10) - whisper.request_flops(WH, 9) == pytest.approx(
        whisper.token_flops(WH, 4 + 10))
    assert 2.0e12 < whisper.window_flops(WH) < 2.6e12
