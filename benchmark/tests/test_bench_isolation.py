"""Nothing the harness loads is JAX or the JAX package, and the reference
loads nothing of the program: each checked in a fresh interpreter, by
whole top-level module names."""

from __future__ import annotations

import json
import subprocess
import sys

from benchmark import core

HARNESS = ["benchmark.run", "benchmark.control", "benchmark.traffic", "benchmark.tracing",
           "benchmark.loops.closed", "benchmark.models.sensevoice",
           "benchmark.models.whisper", "benchmark.kernels.int8_mm", "benchmark.kernels.aed_step",
           "benchmark.kernels.aed_multi", "asr_tpu_torch.runtime.session",
           "asr_tpu_torch.runtime.whisper_session", "asr_tpu_torch.parallel.llm_server"]
REFERENCE = ["benchmark.reference.sensevoice", "benchmark.reference.whisper",
             "benchmark.reference.judge", "benchmark.reference.quant",
             "benchmark.reference.frontend"]


def loaded_after(modules: list[str]) -> list[str]:
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "from benchmark import core\n"
            "if 'benchmark.run' in sys.modules:\n"
            "    for m in core.load_spec()['per_layer']: core.metric_reader(m['name'])\n"
            "    for m in core.load_spec()['end_to_end']:\n"
            "        if m['name'] != 'setup_s': core.metric_reader(m['name'], 'end_to_end')\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=core.ROOT, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_and_readers_load_no_jax():
    tops = loaded_after(HARNESS)
    assert "benchmark" in tops and "asr_tpu_torch" in tops
    assert not set(tops) & set(core.FORBIDDEN_MODULES)


def test_reference_loads_nothing_of_the_program():
    tops = loaded_after(REFERENCE)
    assert "asr_tpu_torch" not in tops
    assert not set(tops) & set(core.FORBIDDEN_MODULES)
