"""A whole run at tiny widths on the CPU, the chip check skipped: sound, it
comes out correct; with the timed path broken underneath, as each fault a
cell can have, ``correct`` comes out false. And the control (the reference
one width lower in the program's place), held to the same comparison,
comes out not correct."""

from __future__ import annotations

import pytest
import torch

from benchmark import control, core
from benchmark import run as runner
from benchmark.tests.tiny import SERVED, SERVED_METRICS, tiny_cell

LIMIT = 0.1  # tiny widths: sound runs read about 0.01, the int4 control 0.3 and more
LONGFORM = "sensevoice_small_q8.longform"
SINGLE = "whisper_large_v3_turbo_q8.single_b1"


@pytest.fixture(autouse=True)
def tiny_limit(monkeypatch):
    monkeypatch.setattr(core, "limits", lambda workload: {"widest_gap": {"limit": LIMIT}})


def run(workload, seconds=3.0):
    spec, cell = tiny_cell(workload)
    return runner.run_cell(workload, 2**31 + 99, seconds, False, device="cpu", spec=spec,
                           cell=cell, log=lambda *a, **k: None)


@pytest.mark.parametrize("workload", [LONGFORM, SERVED, SINGLE])
def test_sound_run_is_correct(workload):
    res = run(workload)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


def test_served_readers_read_a_traced_run():
    """The served path's per-layer readers, listed for the served cell as a
    later PR would list them, read its spans and the server's own times (no
    trace on the CPU: the roofline finds nothing to read and stays out)."""
    spec, cell = tiny_cell(SERVED)
    res = runner.run_cell(SERVED, 2**31 + 99, 3.0, True, device="cpu", spec=spec, cell=cell,
                          log=lambda *a, **k: None)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert set(got) == set(SERVED_METRICS) - {"aed_multi.roofline"}
    assert got["prefill_ms.closed"]["value"] > 0 and got["queue_wait_ms.closed"]["value"] >= 0


def test_longform_token_altered(monkeypatch):
    from asr_tpu_torch.runtime.session import SenseVoiceSession

    real = SenseVoiceSession._forward

    def forward(self, *a, **k):
        toks, counts = real(self, *a, **k)
        toks = toks.clone()
        toks[0, 5] = (toks[0, 5] + 1) % 300
        return toks, counts

    monkeypatch.setattr(SenseVoiceSession, "_forward", forward)
    assert not run(LONGFORM)["correct"]


def test_longform_half_the_batch_left_out(monkeypatch):
    from asr_tpu_torch.runtime.session import SenseVoiceSession

    real = SenseVoiceSession._forward

    def forward(self, params, audio, valid, language="auto"):
        half = audio.shape[0] // 2
        toks, counts = real(self, params, audio[:max(half, 1)], valid[:max(half, 1)], language)
        pad = audio.shape[0] - toks.shape[0]
        return (torch.cat([toks, toks.new_zeros((pad, toks.shape[1]))]),
                torch.cat([counts, counts.new_zeros(pad)]))

    monkeypatch.setattr(SenseVoiceSession, "_forward", forward)
    assert not run(LONGFORM)["correct"]


def test_served_token_altered(monkeypatch):
    from asr_tpu_torch.parallel.aed_batcher import ContinuousAedBatcher

    real = ContinuousAedBatcher._logits

    def logits(self):
        out = real(self).clone()
        out[self.count == 3, 7] = 1e4  # each request's third token is 7, whatever the model says
        return out

    monkeypatch.setattr(ContinuousAedBatcher, "_logits", logits)
    assert not run(SERVED)["correct"]


def test_served_step_leaves_its_state(monkeypatch):
    from asr_tpu_torch.parallel.aed_batcher import ContinuousAedBatcher

    real = ContinuousAedBatcher._logits

    def logits(self):
        keep = [{k: t.clone() for k, t in layer.items()} for layer in self.state["layers"]]
        out = real(self)
        for layer, old in zip(self.state["layers"], keep):
            for k, t in old.items():
                layer[k].copy_(t)  # the caches as they were before the step
        return out

    monkeypatch.setattr(ContinuousAedBatcher, "_logits", logits)
    assert not run(SERVED)["correct"]


def test_served_half_the_slots_left_out(monkeypatch):
    from asr_tpu_torch.parallel.aed_batcher import ContinuousAedBatcher

    real = ContinuousAedBatcher._logits

    def logits(self):
        out = real(self).clone()
        half = out.shape[0] // 2
        out[half:] = out[:half]  # the second half of the slots gets the first half's rows
        out[:half] = out[half:].roll(1, dims=-1)
        return out

    monkeypatch.setattr(ContinuousAedBatcher, "_logits", logits)
    assert not run(SERVED)["correct"]


def test_single_token_altered(monkeypatch):
    from asr_tpu_torch.models import whisper as wh

    real = wh.step

    def step(params, cfg, state, token, pos):
        logits, state = real(params, cfg, state, token, pos)
        logits = logits.clone()
        logits[:, 7] = 1e4
        return logits, state

    monkeypatch.setattr(wh, "step", step)
    assert not run(SINGLE)["correct"]


@pytest.mark.parametrize("workload", [LONGFORM, SERVED, SINGLE])
def test_control_reads_above_the_limit(workload):
    spec, cell = tiny_cell(workload)
    lines = control.control(workload, [5], 1.5, device="cpu", cell=cell, log=lambda *a, **k: None)
    assert lines[0]["program"] < LIMIT < lines[0]["control"]
    assert lines[0]["correct"] and not lines[0]["control_correct"]


@pytest.mark.gpu
def test_control_on_the_card(monkeypatch):
    """The control at the cell's own size on the card (one short seed),
    held to the cell's own limit."""
    monkeypatch.undo()
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    lines = control.control(LONGFORM, [7], 6.0, log=lambda *a, **k: None)
    assert lines[0]["correct"] and not lines[0]["control_correct"]
