"""``python -m asr_tpu_torch parity`` against ``asr_tpu parity``.

Both command lines run on a synthetic ``--examples`` folder (the two
registry files ``en/test_sample.wav`` and ``zh/zh-Shanghai.wav``, seeded
int16 noise) and tiny artifacts built by the JAX package's ``build``
(FireRed as in ``tests/test_cli.py``, and SenseVoice):

- a golden captured by either package's ``parity`` passes the other's
  ``parity --golden`` with rc 0 (stage probes within ``compare_probes``'
  defaults, token ids equal);
- the bare v1 fixture dict is read; a planted drift gives rc 1 and names the
  first drifting stage; ``--save-golden`` wins over ``--golden`` on the same
  file; a transcript-only golden still compares;
- the quantized kernels' matmul mode is ``f32`` during the run and comes
  back after it, and after an exception;
- a missing fixture root raises ``SystemExit``, as in the JAX package.
"""

import json
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from asr_tpu import cli as jcli
from asr_tpu_torch import cli as tcli
from asr_tpu_torch.ops import quant_matmul as tqm
from tests.test_torch_cli_build import _restore_modes, _sensevoice_src  # noqa: F401 (a fixture)

FIXTURES = ("en/test_sample.wav", "zh/zh-Shanghai.wav")


def write_examples(root: Path, seconds: float = 1.5) -> Path:
    """The two registry fixtures as 16 kHz mono int16 noise from a seed."""
    for i, rel in enumerate(FIXTURES):
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        pcm = (np.random.default_rng(40 + i).standard_normal(int(16000 * seconds)) * 3000).astype(np.int16)
        with wave.open(str(path), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(pcm.tobytes())
    return root


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """(examples root, {family: artifact folder}) built once by the JAX CLI."""
    from tests.test_firered import TINY, _firered_sd

    tmp = tmp_path_factory.mktemp("parity")
    examples = write_examples(tmp / "examples")
    src = tmp / "firered_ckpt"
    src.mkdir()
    torch.save({"args": {}, "model_state_dict": _firered_sd(TINY, np.random.default_rng(2))},
               src / "model.pth.tar")
    (src / "dict.txt").write_text("\n".join(f"t{i} {i}" for i in range(TINY.vocab_size)))
    arts = {"firered": tmp / "firered", "sensevoice": tmp / "sensevoice"}
    assert jcli.main(["--platform", "cpu", "--compile-cache", "", "build", "--family", "firered",
                      "--checkpoint", str(src), "--out", str(arts["firered"])]) == 0
    sv_src = _sensevoice_src(tmp / "sv_ckpt")
    assert jcli.main(["--platform", "cpu", "--compile-cache", "", "build", "--family", "sensevoice",
                      "--checkpoint", str(sv_src), "--out", str(arts["sensevoice"])]) == 0
    return examples, arts


def port(art: Path, examples: Path, *flags) -> int:
    return tcli.main(["--platform", "cpu", "parity", "--model-dir", str(art), "--examples", str(examples),
                      *flags])


def jax(art: Path, examples: Path, *flags) -> int:
    return jcli.main(["--platform", "cpu", "--compile-cache", "", "parity", "--model-dir", str(art),
                      "--examples", str(examples), *flags])


@pytest.mark.parametrize("family", ["firered", "sensevoice"])
def test_goldens_move_between_the_packages(folders, tmp_path, capsys, family):
    examples, arts = folders
    art = arts[family]
    jgold, tgold = tmp_path / "jax.json", tmp_path / "port.json"
    assert jax(art, examples, "--save-golden", str(jgold)) == 0
    assert port(art, examples, "--save-golden", str(tgold)) == 0
    out = capsys.readouterr().out
    assert f"goldens captured -> {tgold}" in out and "zh-Shanghai.wav\t[zh]\tRTF" in out
    want, got = json.loads(jgold.read_text()), json.loads(tgold.read_text())
    assert got["golden_schema"] == want["golden_schema"] == 2
    names = {"firered": ["zh-Shanghai.wav"], "sensevoice": ["test_sample.wav", "zh-Shanghai.wav"]}[family]
    assert sorted(got["fixtures"]) == sorted(want["fixtures"]) == names
    for name, w in want["fixtures"].items():
        g = got["fixtures"][name]
        assert (g["language"], g["token_ids"], g["text"]) == (w["language"], w["token_ids"], w["text"])
        assert sorted(g["probe"]) == sorted(w["probe"])
    assert port(art, examples, "--golden", str(jgold)) == 0
    assert f"PARITY OK: {len(names)} fixtures token-for-token" in capsys.readouterr().out
    assert jax(art, examples, "--golden", str(tgold)) == 0
    assert f"PARITY OK: {len(names)} fixtures" in capsys.readouterr().out


def test_golden_formats_drift_and_capture_precedence(folders, tmp_path, capsys):
    examples, arts = folders
    art = arts["sensevoice"]
    golden = tmp_path / "golden.json"
    assert port(art, examples, "--save-golden", str(golden)) == 0
    data = json.loads(golden.read_text())["fixtures"]
    assert set(data["zh-Shanghai.wav"]["probe"]) == {"frontend", "logits"}  # CTC in one graph

    v1 = tmp_path / "v1.json"  # the bare fixture dict, before the schema field
    v1.write_text(json.dumps(data))
    assert port(art, examples, "--golden", str(v1)) == 0

    # a drift planted in the front end's snapshot names it, not the logits after it
    bad = json.loads(json.dumps(data))
    bad["zh-Shanghai.wav"]["probe"]["frontend"]["head"][0] += 1.0
    v1.write_text(json.dumps({"golden_schema": 2, "fixtures": bad}))
    capsys.readouterr()
    assert port(art, examples, "--golden", str(v1)) == 1
    out = capsys.readouterr().out
    assert "PARITY FAIL" in out and "zh-Shanghai.wav: first drift at stage 'frontend'" in out
    bad["zh-Shanghai.wav"]["probe"]["frontend"]["head"][0] -= 1.0
    bad["test_sample.wav"]["token_ids"] = [1, 2, 3]
    v1.write_text(json.dumps(bad))
    assert port(art, examples, "--golden", str(v1)) == 1
    assert "test_sample.wav: token ids drifted" in capsys.readouterr().out

    # a transcript-only golden (no probes; empty ids fall back to the text)
    for v in bad.values():
        v.pop("probe")
        v["token_ids"] = []
    bad["test_sample.wav"]["text"] = data["test_sample.wav"]["text"]
    v1.write_text(json.dumps(bad))
    assert port(art, examples, "--golden", str(v1)) == 0

    # --save-golden wins on the same, not yet existing file: --golden is never read
    fresh = tmp_path / "fresh.json"
    assert port(art, examples, "--golden", str(fresh), "--save-golden", str(fresh)) == 0
    assert sorted(json.loads(fresh.read_text())["fixtures"]) == sorted(data)


@pytest.mark.parametrize("prior", [None, "bf16", "f32"])
def test_matmul_mode_is_f32_during_the_run_and_restored(folders, tmp_path, monkeypatch, prior):
    examples, arts = folders
    seen = []
    real = tcli._build_session

    def spy(*a, **kw):
        seen.append(tqm._resolve_mm(None))
        return real(*a, **kw)

    monkeypatch.setattr(tcli, "_build_session", spy)
    tqm._CONFIG["mm"] = prior
    assert port(arts["firered"], examples) == 0
    assert seen == ["f32"] and tqm._CONFIG["mm"] == prior
    with pytest.raises(FileNotFoundError):
        port(arts["firered"], examples, "--golden", str(tmp_path / "missing.json"))
    assert seen == ["f32", "f32"] and tqm._CONFIG["mm"] == prior


def test_missing_fixture_root_exits(folders, tmp_path):
    _, arts = folders
    with pytest.raises(SystemExit, match="no registered fixtures for family 'firered'"):
        port(arts["firered"], tmp_path / "nowhere")
    with pytest.raises(SystemExit, match="no registered fixtures for family 'firered'"):
        jax(arts["firered"], tmp_path / "nowhere")
