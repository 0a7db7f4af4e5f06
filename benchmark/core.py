"""What every cell shares: the spec and its files found by name, the card's
peaks, quartiles, the guard against JAX, and the result line.

Each configuration, traffic mix, loop, per-layer metric and limit lives in a
file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json`` (its ``family`` names ``models/<family>.py``),
- ``traffic/<mix>.json`` (its ``loop`` names ``loops/<loop>.py``),
- ``end_to_end/<metric>.py`` and ``metrics/<metric>.py`` (a ``read(run)``
  that returns a number or None), for the end-to-end and per-layer metrics,
- ``limits/<workload>.json`` (the limits ``correct`` is held to; a cell
  without one does not run).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# NVIDIA H100 SXM, dense rates (data sheet), at its 700 W limit.
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

# Top-level module names that may not be loaded: JAX and the JAX package.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "asr_tpu")


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def read_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def cell(spec: dict, workload: str) -> tuple[dict, dict, dict]:
    """The workload entry of ``BENCHMARK.json``, its configuration (the
    file's contents) and its traffic mix."""
    for w in spec["workloads"]:
        if w["name"] == workload:
            conf = next(c for c in spec["configs"] if c["name"] == w["config"])
            config = json.loads((ROOT / conf["file"]).read_text())
            return w, config, read_json("traffic", w["traffic"])
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def family_module(config: dict):
    return importlib.import_module(f"benchmark.models.{config['family']}")


def loop_module(traffic: dict):
    return importlib.import_module(f"benchmark.loops.{traffic['loop']}")


def metric_reader(name: str, kind: str = "metrics"):
    """``<kind>/<name>.py``'s ``read`` (``kind``: ``metrics`` for a
    per-layer metric, ``end_to_end`` for an end-to-end one); names hold
    dots, so by path."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(spec: dict, workload: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
    return [m for m in spec[kind] if workload in m.get("workloads", [workload])]


def limits(workload: str) -> dict:
    """``limits/<workload>.json``; a cell without it, or without the limit
    of its widest gap, is refused (KeyError): it could not fail."""
    path = HERE / "limits" / f"{workload}.json"
    if not path.exists():
        raise KeyError(f"{workload!r} has no limits file ({path.relative_to(ROOT)})")
    lim = json.loads(path.read_text())
    if not isinstance(lim.get("widest_gap", {}).get("limit"), (int, float)):
        raise KeyError(f"{path.relative_to(ROOT)} gives no widest_gap limit")
    return lim


def bound_seconds(nbytes: float, flops: float) -> float:
    """The least time the card could take: bytes at the HBM rate against
    operations at the bf16 tensor-core peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile (0..100), nearest rank; inf counts as the largest."""
    if not values:
        return float("inf")
    s = sorted(values)
    k = max(0, min(len(s) - 1, int(-(-q * len(s) // 100)) - 1))
    return s[k]


def forbidden_loaded() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES)


def set_environment() -> None:
    """The run's environment, set before torch loads: every build and
    kernel cache inside the checkout at fixed paths (the port's nvcc
    libraries already live in ``asr_tpu_torch/_build``), one OpenMP thread,
    no JAX behind a library's back."""
    cache = ROOT / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    # one process, few threads: no idle OpenMP pool spinning beside the
    # host-paced launch loops (the timed paths run no parallel CPU op)
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    os.environ.setdefault("USE_TF", "0")
