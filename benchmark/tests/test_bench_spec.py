"""BENCHMARK.json against the contract, and every cell found by name."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import core

SPEC = core.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_bounds():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_by_name(workload):
    entry, config, mix = core.cell(SPEC, workload)
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    assert core.family_module(config).build
    assert core.loop_module(mix).drive
    e2e = core.cell_metrics(SPEC, workload, "end_to_end")
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    layers = core.cell_metrics(SPEC, workload, "per_layer")
    assert layers
    e2e_names = {m["name"] for m in e2e}
    for m in layers:
        assert m["moves"] in e2e_names
        assert callable(core.metric_reader(m["name"]))
    for m in e2e:
        if m["name"] != "setup_s":
            assert callable(core.metric_reader(m["name"], "end_to_end"))


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_has_a_limit(workload):
    lim = core.limits(workload)["widest_gap"]
    assert 0 < lim["lower"] < lim["limit"] < lim["upper"]
    assert lim["upper"] >= 3 * lim["lower"]  # the control's reading separates
    assert lim["limit"] / lim["lower"] > lim["upper"] / lim["limit"]  # more room above the lower


def test_a_cell_without_limits_is_refused(monkeypatch, capsys):
    from benchmark import run as runner

    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({**spec["workloads"][0], "name": "sensevoice_small_q8.no_limits"})
    monkeypatch.setattr(core, "load_spec", lambda: spec)
    with pytest.raises(KeyError):
        core.limits("sensevoice_small_q8.no_limits")
    rc = runner.main(["--workload", "sensevoice_small_q8.no_limits", "--seed", "1",
                      "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "no limits file" in out.err


def test_an_unlisted_cell_is_refused():
    with pytest.raises(KeyError):
        core.cell(SPEC, "sensevoice_small_q8.closed_short")


def test_configs_are_files_of_their_own():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/")
        data = json.loads((core.ROOT / c["file"]).read_text())
        assert data["source"] == c["source"] and data["reduced"] == c["reduced"] == []
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
