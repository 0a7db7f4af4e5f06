"""``asr_tpu_torch/runtime/profiling.py``: ``trace`` on the CPU writes a
Chrome trace that holds an ``annotate`` span; a trace asked to record CUDA that holds no CUDA
event raises; ``device_summary`` counts launches, the busy union and the
idle share of a written trace; ``transcribe --profile`` on the CPU writes a
trace and prints its path.
"""

import dataclasses
import json
import warnings
import wave

import numpy as np
import pytest
import torch

from asr_tpu_torch.runtime import profiling
from asr_tpu_torch.runtime.profiling import annotate, device_summary, trace


def test_trace_on_the_cpu_holds_the_annotated_span(tmp_path):
    with trace(tmp_path / "prof", cuda=False) as tr:
        with annotate("probe_matmul"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    assert tr.path.parent == tmp_path / "prof" and tr.path.name.endswith(".pt.trace.json")
    events = json.loads(tr.path.read_text())["traceEvents"]
    assert any(e.get("name") == "probe_matmul" for e in events)
    assert profiling.device_events(tr.path) == []
    assert any(e.key == "probe_matmul" for e in tr.profile.key_averages())


def test_trace_that_should_hold_cuda_events_but_does_not_raises(tmp_path, monkeypatch):
    """On the card a trace without a CUDA event is an error (CUPTI missing),
    never a quiet CPU-only file."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    with pytest.raises(RuntimeError, match="holds no CUDA event"), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a CPU-only torch warns that it cannot trace CUDA
        with trace(tmp_path / "prof", cuda=True):
            torch.ones(8) + 1


def test_device_summary_counts_the_union_of_device_intervals(tmp_path):
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::int8_kernel<1>", "ts": 10.0,
         "dur": 20.0},
        {"ph": "X", "cat": "kernel", "name": "other_kernel", "ts": 25.0, "dur": 10.0},  # overlaps: 5 more
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 50.0, "dur": 5.0},
        {"ph": "X", "cat": "kernel", "name": "int8_kernel<2>", "ts": 60.0, "dur": 20.0},
        {"ph": "i", "cat": "kernel", "name": "int8 instant", "ts": 70.0},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = device_summary(path, "int8_kernel")
    assert got == {"kernels": 3, "launches": 2, "busy_us": 50.0, "window_us": 100.0, "idle_share": 0.5}
    assert device_summary(path)["launches"] == 3


def test_transcribe_profile_writes_a_trace_and_prints_its_path(tmp_path, capsys):
    from asr_tpu_torch import cli
    from asr_tpu_torch.models import sensevoice as sv
    from asr_tpu_torch.runtime.artifact import save_model
    from asr_tpu_torch.runtime.metadata import ModelMetadata

    cfg = sv.SenseVoiceConfig(vocab_size=64, hidden=32, num_heads=4, head_dim=8, ffn_dim=48,
                              num_encoders0=1, num_encoders=1, num_tp_encoders=1, fsmn_kernel=5)
    save_model(tmp_path / "art", sv.init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
               ModelMetadata(family="sensevoice", extra={"config": dataclasses.asdict(cfg)}))
    wav = tmp_path / "a.wav"
    with wave.open(str(wav), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.random.default_rng(0).standard_normal(12000) * 2000).astype(np.int16).tobytes())
    assert cli.main(["--platform", "cpu", "transcribe", "--model-dir", str(tmp_path / "art"),
                     "--profile", str(tmp_path / "logs"), str(wav)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"{wav}\t(0.75s, RTF ")
    traces = list((tmp_path / "logs").glob("*.pt.trace.json"))
    assert len(traces) == 1 and out[-1] == (f"trace written to {traces[0]} (open it in "
                                            "https://ui.perfetto.dev or chrome://tracing)")
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert "aten::matmul" in names or "aten::mm" in names
