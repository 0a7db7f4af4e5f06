"""Tiny cells for the CPU tests: each real cell's configuration and mix cut
to widths and lengths a CPU runs in seconds, and a served cell of the
tests' own (the Whisper configuration's ``continuous`` entry under a closed
loop of several clients, which no cell of ``BENCHMARK.json`` drives yet).
Every size is a test's own; the cells under ``benchmark/`` are never
changed."""

from __future__ import annotations

import copy
import json

from benchmark import core


SERVED = "whisper_large_v3_turbo_q8.served"
SERVED_MIX = {  # the continuous server under closed clients (tiny_cell cuts it further)
    "loop": "closed", "entry": "continuous", "server": {"n_slots": 8, "kv_dtype": "f32"},
    "clients": 32, "audio_seconds": {"dist": "loguniform", "low": 2, "high": 12},
    "max_new_tokens": 48, "cycle": 64, "warm_seconds": 2, "trace_seconds": 1.5,
    "judge_requests": 8,
}
SERVED_METRICS = {"queue_wait_ms.closed": ("ms", "lower"), "prefill_ms.closed": ("ms", "lower"),
                  "aed_multi.roofline": ("%", "higher")}


def served_spec() -> dict:
    """``BENCHMARK.json`` with the served cell added as a later PR would add
    it: the workload, and the served path's per-layer readers listed for it."""
    spec = copy.deepcopy(core.load_spec())
    single = next(w for w in spec["workloads"] if w["config"] == "whisper_large_v3_turbo_q8")
    spec["workloads"].append({**single, "name": SERVED, "traffic": "served"})
    for m in spec["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(SERVED)
    for name, (unit, better) in SERVED_METRICS.items():
        spec["per_layer"].append({"name": name, "unit": unit, "better": better,
                                  "source": "program_span", "layer": "server",
                                  "moves": "audio_s_per_s", "workloads": [SERVED]})
    return spec


def tiny_cell(workload: str):
    """The cell of ``BENCHMARK.json`` (or the served cell), cut to a tiny size."""
    if workload == SERVED:
        spec = served_spec()
        entry = next(w for w in spec["workloads"] if w["name"] == SERVED)
        conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
        cfg, mix = json.loads((core.ROOT / conf["file"]).read_text()), SERVED_MIX
    else:
        spec = core.load_spec()
        entry, cfg, mix = core.cell(spec, workload)
    cfg, mix = copy.deepcopy(cfg), copy.deepcopy(mix)
    if cfg["family"] == "sensevoice":
        cfg.update(vocab_size=300, hidden=256, num_heads=2, head_dim=128, ffn_dim=512,
                   num_encoders0=1, num_encoders=2, num_tp_encoders=1)
        mix["audio_seconds"] = {"dist": "loguniform", "low": 9, "high": 40}
    else:
        cfg.update(d_model=256, encoder_layers=1, decoder_layers=2, num_heads=4, ffn_dim=512)
        mix["max_new_tokens"] = 8
        mix["clients"] = min(mix["clients"], 4)
    mix["warm_seconds"] = min(mix["warm_seconds"], 0.5)
    mix["judge_requests"] = min(mix["judge_requests"], 3)
    return spec, (entry, cfg, mix)
