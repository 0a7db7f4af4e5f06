"""``python -m asr_tpu_torch build | quantize | optimize`` against the JAX
package's command line on the same folders: ``build`` of every family whose
geometry the checkpoint gives writes the same artifact; ``quantize`` with
each ``--algorithm`` and with ``--reorder``, and ``optimize --plan``, write
the same weights and metadata; the chain build -> quantize -> transcribe
gives the same text. ``build`` is host code and runs where no card is
visible; ``quantize`` and ``optimize`` refuse to run there unless given
``--platform cpu``.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from asr_tpu import cli as jcli
from asr_tpu_torch import cli as tcli
from tests.test_torch_cli import _text_lines
from tests.test_torch_export import SOURCES, assert_same_artifact
from tests.test_torch_loaders import write_mvn
from tests.test_torch_quant_objectives import xla_order  # noqa: F401 (a fixture)

REPO = Path(__file__).resolve().parent.parent
SV_SMALL = dict(vocab_size=64, hidden=512, num_heads=4, head_dim=128, ffn_dim=512,
                num_encoders0=1, num_encoders=1, num_tp_encoders=1, fsmn_kernel=5)


@pytest.fixture(autouse=True)
def _restore_modes():
    """Both command lines set their package's process-wide matmul mode;
    two torch threads a test (the suite runs several workers at once)."""
    from asr_tpu.ops import quant_matmul as jqm
    from asr_tpu_torch.ops import quant_matmul as tqm

    prev, jprev, threads = tqm._CONFIG["mm"], dict(jqm._CONFIG), torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    tqm._CONFIG["mm"] = prev
    jqm._CONFIG.update(jprev)
    torch.set_num_threads(threads)


def _run(tmp_path, capsys, argv: list[str], jax_argv: list[str] | None = None):
    """Both command lines on ``argv``; ``--out`` goes to ``tmp_path/t`` and
    ``tmp_path/j``. Returns the two output folders and stdout texts."""
    jax_argv = argv if jax_argv is None else jax_argv
    assert tcli.main(["--platform", "cpu", "--quant-mm", "f32", *argv, "--out", str(tmp_path / "t")]) == 0
    got = capsys.readouterr().out
    assert jcli.main(["--compile-cache", "", "--quant-mm", "f32", *jax_argv, "--out", str(tmp_path / "j")]) == 0
    return tmp_path / "t", tmp_path / "j", got, capsys.readouterr().out


def _sensevoice_src(folder: Path) -> Path:
    """A FunASR SenseVoice folder whose geometry the builder derives whole
    (heads of 128 as in SenseVoiceSmall), with a vocab the port can read."""
    from asr_tpu.models.sensevoice import SenseVoiceConfig
    from tests.test_loaders import _sensevoice_sd

    folder.mkdir(parents=True)
    cfg = SenseVoiceConfig(**SV_SMALL)
    sd = _sensevoice_sd(cfg, np.random.default_rng(0))
    sd = {k: v * 0.05 if v.ndim == 2 else v for k, v in sd.items()}
    torch.save(sd, folder / "model.pt")
    write_mvn(folder / "am.mvn", cfg.feature_size)
    return folder


BUILD = {  # family -> (SOURCES case, extra flags); the geometry comes from the checkpoint
    "sensevoice": ("sensevoice", []), "whisper": ("whisper", []),
    "paraformer": ("paraformer", ["--decode-mode", "en"]),
    "paraformer_streaming": ("paraformer", ["--decode-mode", "en"]),
    "nemotron": ("nemotron", []), "nemotron_streaming": ("nemotron", []),
    "firered": ("firered", []), "qwen_asr": ("qwen_asr", []), "qwen_aligner": ("qwen_aligner", []),
    "fun_asr_nano": ("fun_asr_nano", []), "fun_asr_nano_llm": ("fun_asr_nano_llm", []),
}


@pytest.mark.parametrize("family", sorted(BUILD))
def test_build_matches_jax(tmp_path, capsys, family):
    case, flags = BUILD[family]
    (tmp_path / "src").mkdir()
    _, src, _, _ = SOURCES[case](tmp_path / "src")
    argv = ["build", "--family", family, "--checkpoint", str(src), *flags]
    tdir, jdir, got, want = _run(tmp_path, capsys, argv)
    assert got == want.replace(str(jdir), str(tdir))
    assert_same_artifact(jdir, tdir)


@pytest.mark.parametrize("algorithm,flags", [
    ("rtn", []), ("kquant", []), ("hqq", ["--bits", "4", "--pack"]), ("dynamic", ["--bits", "4"]),
    ("kquant", ["--reorder", "absmean"]), ("rtn", ["--reorder", "l4", "--bits", "2", "--block", "64"]),
])
def test_quantize_matches_jax(tmp_path, capsys, xla_order, algorithm, flags):
    src = _sensevoice_src(tmp_path / "src")
    assert tcli.main(["build", "--family", "sensevoice", "--checkpoint", str(src),
                      "--out", str(tmp_path / "art")]) == 0
    capsys.readouterr()
    argv = ["quantize", "--model-dir", str(tmp_path / "art"), "--algorithm", algorithm, *flags]
    tdir, jdir, got, want = _run(tmp_path, capsys, argv)
    assert got.replace(str(tdir), "OUT") == want.replace(str(jdir), "OUT")
    assert_same_artifact(jdir, tdir)
    meta = json.loads((tdir / "metadata.json").read_text())["extra"]["quantization"]
    if algorithm == "dynamic":
        assert meta == {"bits": 8, "block": "per_column", "algorithm": "dynamic"}
        assert "--bits/--pack ignored" in got
    if "--reorder" in flags:
        assert "reordered 3 FFN pairs" in got


def test_optimize_matches_jax(tmp_path, capsys, xla_order):
    src = _sensevoice_src(tmp_path / "src")
    assert tcli.main(["build", "--family", "sensevoice", "--checkpoint", str(src),
                      "--out", str(tmp_path / "art")]) == 0
    plan = {"plans": {"enc": {"method": "q8", "algorithm": "kquant"},
                      "rest": {"method": "q4", "algorithm": "hqq", "pack": True, "block": 64}},
            "assign": [["encoders/*", "enc"], ["*", "rest"]]}
    (tmp_path / "plan.json").write_text(json.dumps(plan))
    argv = ["optimize", "--model-dir", str(tmp_path / "art"), "--plan", str(tmp_path / "plan.json")]
    tdir, jdir, _, _ = _run(tmp_path, capsys, argv)
    assert_same_artifact(jdir, tdir)
    assert json.loads((tdir / "metadata.json").read_text())["extra"]["optimizer_plan"] == plan


def test_build_quantize_transcribe_chain_matches_jax(tmp_path, capsys):
    """build -> quantize --algorithm kquant -> transcribe through both
    command lines: the same text lines (the exact f32 product both sides)."""
    import wave

    src = _sensevoice_src(tmp_path / "src")
    (src / "tokens.bpe.model").write_bytes(b"")  # the builder copies the first *.bpe.model
    build = ["build", "--family", "sensevoice", "--checkpoint", str(src)]
    (tmp_path / "b").mkdir()
    tdir, jdir, _, _ = _run(tmp_path / "b", capsys, build)
    for d in (tdir, jdir):  # a vocabulary the port reads on the card too
        meta = json.loads((d / "metadata.json").read_text())
        meta["tokenizer"] = {"kind": "vocab_txt", "file": "vocab.txt"}
        (d / "metadata.json").write_text(json.dumps(meta))
        (d / "vocab.txt").write_text("".join(f"t{i}\n" for i in range(64)))
    (tmp_path / "q").mkdir()
    _run(tmp_path / "q", capsys, ["quantize", "--model-dir", str(tdir), "--algorithm", "kquant", "--min-size", "0"],
         ["quantize", "--model-dir", str(jdir), "--algorithm", "kquant", "--min-size", "0"])
    wav = tmp_path / "a.wav"
    with wave.open(str(wav), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.random.default_rng(1).standard_normal(20000) * 3000).astype(np.int16).tobytes())
    for folder in (tmp_path / "q" / "t", tmp_path / "q" / "j"):
        argv = ["transcribe", "--model-dir", str(folder), str(wav)]
        assert tcli.main(["--platform", "cpu", "--quant-mm", "f32", *argv]) == 0
        got = capsys.readouterr().out
        assert jcli.main(["--compile-cache", "", "--quant-mm", "f32", *argv]) == 0
        want = capsys.readouterr().out
        assert _text_lines(got) == _text_lines(want) and _text_lines(got)[0][2]


def test_build_needs_no_card_and_quantize_asks_for_one(tmp_path):
    """In a fresh process with no card visible: ``build`` runs (host code);
    ``quantize`` without ``--platform cpu`` stops before touching the
    artifact."""
    src = _sensevoice_src(tmp_path / "src")
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"}
    run = lambda *a: subprocess.run([sys.executable, "-m", "asr_tpu_torch", *a], cwd=REPO, env=env,
                                    capture_output=True, text=True, timeout=300)
    proc = run("build", "--family", "sensevoice", "--checkpoint", str(src), "--out", str(tmp_path / "art"))
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "art" / "weights.safetensors").exists()
    proc = run("quantize", "--model-dir", str(tmp_path / "art"), "--out", str(tmp_path / "q"))
    assert proc.returncode != 0 and "no CUDA card is visible" in proc.stderr
    assert not (tmp_path / "q").exists()
