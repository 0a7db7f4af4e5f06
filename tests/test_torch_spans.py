"""The stage spans of the port's two benchmarked sessions
(``runtime/profiling.annotate``): under a ``torch.profiler`` profile a tiny
``SenseVoiceSession`` and a tiny ``WhisperSession`` (the fused batch-1
route, its plain version on the CPU) write every ``asr.*`` span, each
stage inside its ``asr.session.transcribe``; ``asr.sv.block`` once a block
and ``asr.decode.token`` once a loop iteration; with no profile recording
no ``record_function`` is entered; a profile of every thread gets the
spans too; the tokens are the same with the profiler on and off;
``transcribe --profile`` writes the spans.
"""

import dataclasses
import json
import wave

import numpy as np
import pytest
import torch

from asr_tpu_torch.decode.ar import DecodeConfig, ar_decode
from asr_tpu_torch.models import sensevoice as sv
from asr_tpu_torch.models import whisper as wh
from asr_tpu_torch.ops import fused_aed_step as fas
from asr_tpu_torch.ops import quant_matmul as qm
from asr_tpu_torch.quant.quantize import quantize_pytree
from asr_tpu_torch.runtime import profiling
from asr_tpu_torch.runtime.session import SenseVoiceSession
from asr_tpu_torch.runtime.whisper_session import WhisperSession, WhisperSessionConfig

SV_CFG = sv.SenseVoiceConfig(vocab_size=64, hidden=32, num_heads=4, head_dim=8, ffn_dim=48,
                             num_encoders0=1, num_encoders=2, num_tp_encoders=1, fsmn_kernel=5)
WH_CFG = wh.WhisperConfig(vocab_size=64, d_model=256, encoder_layers=1, decoder_layers=2,
                          num_heads=4, ffn_dim=1024, n_mels=16, max_source_positions=24,
                          max_target_positions=16, sot_id=1, eot_id=0, no_speech_id=2,
                          first_language_id=8, num_languages=4, no_timestamps_id=7,
                          transcribe_id=6, translate_id=5)
WH_WINDOW_S = 48 * 160 / 16000  # 48 mel frames -> 24 encoder rows

SESSION_STAGES = ("asr.session.pack", "asr.session.upload", "asr.session.download",
                  "asr.session.collect")
SPANS = {
    "sensevoice": SESSION_STAGES + ("asr.sv.frontend", "asr.sv.encode", "asr.sv.block", "asr.sv.ctc"),
    "whisper": SESSION_STAGES + ("asr.whisper.mel", "asr.whisper.encode", "asr.whisper.probe",
                                 "asr.whisper.prompt", "asr.whisper.stack", "asr.decode.token"),
}


@pytest.fixture(autouse=True)
def _torch_mode():
    prev, mm = torch.get_num_threads(), qm._CONFIG["mm"]
    torch.set_num_threads(2)
    qm.set_quant_config(mm="f32")
    yield
    qm._CONFIG["mm"] = mm
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def sessions():
    sv_sess = SenseVoiceSession(sv.init_params(SV_CFG, torch.Generator().manual_seed(0), "cpu"),
                                SV_CFG, window_seconds=0.5)
    wp = quantize_pytree(wh.init_params(WH_CFG, torch.Generator().manual_seed(1), "cpu"), bits=8,
                         block=128, refine_iters=0, min_size=0, quantize_embeddings=True)
    wh_sess = WhisperSession(wp, WH_CFG, window_seconds=WH_WINDOW_S,
                             session_cfg=WhisperSessionConfig(max_new_tokens=8, no_speech_threshold=None))
    wh_sess.stacked = fas.stack_whisper_step_params(wp, WH_CFG)  # the fused route, plain on the CPU
    rng = np.random.default_rng(0)
    audio = {"sensevoice": (rng.standard_normal(20000) * 2000).astype(np.float32),
             "whisper": (rng.standard_normal(6000) * 0.1).astype(np.float32)}
    return {"sensevoice": sv_sess, "whisper": wh_sess}, audio


def _annotations(path) -> list[dict]:
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _traced(tmp_path, fn):
    with profiling.trace(tmp_path / "prof", cuda=False) as tr:
        out = fn()
    return out, _annotations(tr.path)


def _inside(inner: dict, outer: dict) -> bool:
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def _check_nesting(spans: list[dict], family: str, requests: int) -> dict[str, int]:
    roots = [e for e in spans if e["name"] == "asr.session.transcribe"]
    assert len(roots) == requests
    counts: dict[str, int] = {}
    for e in spans:
        if e["name"].startswith("asr.") and e["name"] != "asr.session.transcribe":
            assert any(_inside(e, r) for r in roots), e["name"]
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    assert set(counts) == set(SPANS[family])
    return counts


def test_sensevoice_session_writes_every_stage_span(sessions, tmp_path):
    sess, audio = sessions[0]["sensevoice"], sessions[1]["sensevoice"]
    _, spans = _traced(tmp_path, lambda: [sess.transcribe(audio) for _ in range(2)])
    counts = _check_nesting(spans, "sensevoice", requests=2)
    assert counts["asr.sv.block"] == 2 * SV_CFG.num_blocks
    for name in ("asr.session.pack", "asr.session.upload", "asr.session.download",
                 "asr.session.collect", "asr.sv.frontend", "asr.sv.encode", "asr.sv.ctc"):
        assert counts[name] == 2, name


def test_whisper_session_writes_every_stage_span(sessions, tmp_path, monkeypatch):
    sess, audio = sessions[0]["whisper"], sessions[1]["whisper"]
    steps = []  # the fused route's steps: the plain step on CPU tensors, whichever loop runs it
    real = fas.fused_aed_step_reference
    monkeypatch.setattr(fas, "fused_aed_step_reference", lambda *a, **k: steps.append(1) or real(*a, **k))
    res, spans = _traced(tmp_path, lambda: sess.transcribe(audio))
    counts = _check_nesting(spans, "whisper", requests=1)
    assert steps and counts["asr.decode.token"] == len(steps)
    assert counts["asr.session.upload"] == 2  # the audio before the mel, the prompt after it
    for name in ("asr.session.pack", "asr.session.download", "asr.session.collect",
                 "asr.whisper.mel", "asr.whisper.encode", "asr.whisper.probe",
                 "asr.whisper.prompt", "asr.whisper.stack"):
        assert counts[name] == 1, name
    assert res.token_ids


@pytest.mark.parametrize("eot_at,max_new", [(3, 8), (None, 5)])
def test_decode_token_span_per_loop_iteration(tmp_path, eot_at, max_new):
    """One span per step call, which at batch 1 is the count less the
    prefill's token, whether EOT or the budget ends the loop."""
    eot, vocab = 0, 8
    calls = []

    def step(state, token, pos):
        calls.append(pos)
        nxt = eot if eot_at is not None and len(calls) == eot_at else 1 + len(calls) % (vocab - 1)
        return torch.nn.functional.one_hot(torch.tensor([nxt]), vocab).float(), state

    cfg = DecodeConfig(max_new_tokens=max_new, eot_id=eot)
    buf = torch.zeros((1, 2 + max_new + 1), dtype=torch.int64)
    (_, counts), spans = _traced(tmp_path, lambda: ar_decode(step, None, 2, torch.tensor([5]), buf, cfg))
    tokens = [e for e in spans if e["name"] == "asr.decode.token"]
    assert len(tokens) == len(calls) == int(counts[0]) - 1 == (eot_at or max_new)


def test_no_record_function_is_entered_without_a_profiler(sessions, monkeypatch, tmp_path):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    for family, sess in sessions[0].items():
        sess.transcribe(sessions[1][family])
    assert entered == []
    assert profiling.annotate("a") is profiling.annotate("b")  # one shared no-op context
    with profiling.trace(tmp_path / "prof", cuda=False):
        with profiling.annotate("asr.test"):
            pass
    assert entered == ["asr.test"]


def test_spans_are_written_under_a_profile_of_every_thread(sessions, tmp_path):
    """A profile that records every thread (as the benchmark's traced window
    runs) leaves ``torch.autograd._profiler_enabled()`` False; the spans are
    written all the same."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    sess, audio = sessions[0]["sensevoice"], sessions[1]["sensevoice"]
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        sess.transcribe(audio)
    path = tmp_path / "all_threads.json"
    prof.export_chrome_trace(str(path))
    _check_nesting(_annotations(path), "sensevoice", requests=1)


@pytest.mark.parametrize("family", ["sensevoice", "whisper"])
def test_tokens_are_the_same_with_the_profiler_on_and_off(sessions, tmp_path, family):
    sess, audio = sessions[0][family], sessions[1][family]
    off = sess.transcribe(audio).token_ids
    on, _ = _traced(tmp_path, lambda: sess.transcribe(audio).token_ids)
    assert on == off and off


def test_transcribe_profile_writes_the_session_spans(tmp_path, capsys):
    from asr_tpu_torch import cli
    from asr_tpu_torch.runtime.artifact import save_model
    from asr_tpu_torch.runtime.metadata import ModelMetadata

    save_model(tmp_path / "art", sv.init_params(SV_CFG, torch.Generator().manual_seed(0), "cpu"),
               ModelMetadata(family="sensevoice", extra={"config": dataclasses.asdict(SV_CFG)}))
    wav = tmp_path / "a.wav"
    with wave.open(str(wav), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.random.default_rng(0).standard_normal(12000) * 2000).astype(np.int16).tobytes())
    assert cli.main(["--platform", "cpu", "transcribe", "--model-dir", str(tmp_path / "art"),
                     "--profile", str(tmp_path / "logs"), str(wav)]) == 0
    capsys.readouterr()
    (trace,) = (tmp_path / "logs").glob("*.pt.trace.json")
    names = {e["name"] for e in _annotations(trace)}
    assert {"asr.session.transcribe", "asr.sv.encode", "asr.sv.block"} <= names
