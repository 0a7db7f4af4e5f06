"""The port's artifact builders (``asr_tpu_torch/export.py``) against the JAX
package's: each of the eleven ``build_*_artifact`` functions (twelve cases
with the streaming variants, fifteen in all) runs in both packages on the
same synthetic checkpoint folder, and the two artifact folders hold the
same weights, leaf for leaf and bitwise (weight aliases expanded), the same
``metadata.json`` as JSON, and the same asset files. Each port artifact
loads in the JAX package's ``load_model`` and each JAX artifact in the
port's, and ``dolphin_language_catalog`` agrees.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from asr_tpu import export as jex
from asr_tpu.runtime import artifact as jart
from asr_tpu_torch import export as tex
from asr_tpu_torch.runtime import artifact as tart
from tests.test_torch_loaders import (assert_same_tree, dolphin_configs, hf_tokenizer, parakeet_state_dict,
                                      write_firered_folder, write_mvn, write_whisper_folder)

transformers = pytest.importorskip("transformers")


@pytest.fixture(autouse=True)
def _torch_threads():
    """Two torch threads a test: the suite runs several workers at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def port_config(cfg, module: str):
    """The port's config of the same name and fields as a JAX config."""
    import importlib

    cls = getattr(importlib.import_module(f"asr_tpu_torch.{module}"), type(cfg).__name__)
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = {}
    for k, v in cfg.__dict__.items():
        if k not in fields:
            continue
        if dataclasses.is_dataclass(v):
            sub = type(v).__module__.replace("asr_tpu.", "", 1)
            v = port_config(v, sub)
        kw[k] = v
    return cls(**kw)


QWEN_WORDS = ["<|im_start|>", "<|im_end|>", "<|endoftext|>", "<|audio_start|>", "<|audio_end|>",
              "<|audio_pad|>", "<timestamp>", "<asr_text>", "system", "user", "assistant", "language",
              "English", "Chinese"]


# ── source folders, one per builder case: (builder name, src, jax kwargs, port kwargs) ──
def src_sensevoice(tmp):
    from tests.test_loaders import SV_CFG, _sensevoice_sd

    src = tmp / "SenseVoiceSmall"
    src.mkdir()
    torch.save(_sensevoice_sd(SV_CFG, np.random.default_rng(0)), src / "model.pt")
    write_mvn(src / "am.mvn", SV_CFG.feature_size)
    (src / "chn_jpn_yue_eng_ko_spectok.bpe.model").write_bytes(b"spm")
    return "build_sensevoice_artifact", src, {"cfg": SV_CFG}, {"cfg": port_config(SV_CFG, "models.sensevoice")}


def src_whisper(tmp):
    return "build_whisper_artifact", write_whisper_folder(tmp / "whisper"), {}, {}


def _paraformer(tmp, **kw):
    from tests.test_loaders import PF_CFG, _paraformer_sd

    src = tmp / "paraformer"
    src.mkdir()
    torch.save(_paraformer_sd(PF_CFG, np.random.default_rng(1)), src / "model.pt")
    write_mvn(src / "am.mvn", PF_CFG.feature_size)
    (src / "tokens.txt").write_text("\n".join(f"tok{i}" for i in range(PF_CFG.vocab_size)))
    kw = dict(kw, decode_mode="en")
    return ("build_paraformer_artifact", src, dict(kw, cfg=PF_CFG),
            dict(kw, cfg=port_config(PF_CFG, "models.paraformer")))


def src_paraformer(tmp):
    return _paraformer(tmp)


def src_paraformer_streaming(tmp):
    return _paraformer(tmp, streaming=True)


def _dolphin(tmp, streaming: bool):
    from tests.test_loaders import _dolphin_sd

    jcfg, tcfg = dolphin_configs()
    src = tmp / "dolphin"
    src.mkdir()
    torch.save({"model": _dolphin_sd(jcfg, np.random.default_rng(7))}, src / "dolphin.pt")
    tokens = [f"t{i}" for i in range(jcfg.vocab_size)]
    tokens[40:48] = ["<asr>", "<zh>", "<ja>", "<en>", "<CN>", "<JP>", "<xx>", "<notimestamp>"]
    (src / "units.txt").write_text("\n".join(tokens), encoding="utf-8")
    kw = dict(vocab_path=src / "units.txt", streaming=streaming)
    return "build_dolphin_artifact", src / "dolphin.pt", dict(kw, cfg=jcfg), dict(kw, cfg=tcfg)


def src_dolphin(tmp):
    return _dolphin(tmp, False)


def src_dolphin_streaming(tmp):
    return _dolphin(tmp, True)


def _nemotron(tmp, **kw):
    from tests.test_nemotron_loader import TINY, _nemotron_sd, _write_nemo

    src = tmp / "nemo"
    src.mkdir()
    return "build_nemotron_artifact", _write_nemo(src, TINY, _nemotron_sd(TINY, np.random.default_rng(2))), kw, kw


def src_nemotron(tmp):
    return _nemotron(tmp)


def src_nemotron_streaming(tmp):
    return _nemotron(tmp, streaming=True, chunk_ms=150)


def src_xasr(tmp):
    from tests.test_zipformer_loader import TINY, _synthetic_state_dict

    src = tmp / "icefall"
    src.mkdir()
    torch.save({"model_avg": {k: torch.from_numpy(np.asarray(v)) for k, v in _synthetic_state_dict(TINY).items()}},
               src / "epoch-30.pt")
    (src / "bpe.model").write_bytes(b"spm")
    kw = dict(bpe_model=src / "bpe.model")
    return ("build_xasr_artifact", src / "epoch-30.pt", dict(kw, cfg=TINY),
            dict(kw, cfg=port_config(TINY, "models.zipformer")))


def _qwen(tmp, classify):
    from tests.test_qwen_loaders import _write_snapshot

    src, _, _ = _write_snapshot(tmp, classify=classify)
    hf_tokenizer(src / "tokenizer.json", QWEN_WORDS)
    return ("build_qwen_asr_artifact" if classify is None else "build_qwen_aligner_artifact"), src, {}, {}


def src_qwen_asr(tmp):
    return _qwen(tmp, None)


def src_qwen_aligner(tmp):
    return _qwen(tmp, 25)


def _fun_asr_nano(tmp, head):
    from tests.test_qwen_loaders import _nano_sd

    src = tmp / "Fun-ASR-Nano"
    src.mkdir()
    torch.save(_nano_sd(np.random.default_rng(3)), src / "model.pt")
    (src / "multilingual.tiktoken").write_text("aGU= 0\nbGxv 1\n")
    hf_tokenizer(src / "tokenizer.json", QWEN_WORDS)
    return "build_fun_asr_nano_artifact", src, {"head": head}, {"head": head}


def src_fun_asr_nano(tmp):
    return _fun_asr_nano(tmp, "ctc")


def src_fun_asr_nano_llm(tmp):
    return _fun_asr_nano(tmp, "llm")


def src_firered(tmp):
    src, tiny = write_firered_folder(tmp / "firered")
    return "build_firered_artifact", src, {"cfg": tiny}, {"cfg": port_config(tiny, "models.firered")}


def src_parakeet(tmp):
    from safetensors.numpy import save_file

    sd, tiny = parakeet_state_dict()
    src = tmp / "parakeet"
    src.mkdir()
    save_file({k: np.ascontiguousarray(v.numpy()) for k, v in sd.items()}, str(src / "model.safetensors"))
    hf_tokenizer(src / "tokenizer.json", ["a", "b"])
    return "build_parakeet_artifact", src, {"cfg": tiny}, {"cfg": port_config(tiny, "models.parakeet")}


SOURCES = {name.removeprefix("src_"): fn for name, fn in dict(globals()).items() if name.startswith("src_")}


# ── comparisons ─────────────────────────────────────────────────────────────
def read_flat(folder: Path) -> dict:
    """An artifact's weights with its aliases expanded, read by the port's
    own safetensors reader."""
    flat = tart.read_safetensors(folder / "weights.safetensors")
    meta = json.loads((folder / "metadata.json").read_text())
    for alias, canon in meta.get("extra", {}).get("weight_aliases", {}).items():
        flat[alias] = flat[canon]
    return flat


def assert_same_artifact(jdir: Path, tdir: Path):
    jflat, tflat = read_flat(jdir), read_flat(tdir)
    assert sorted(jflat) == sorted(tflat)
    for key, want in jflat.items():
        got = tflat[key]
        assert (got.dtype, got.shape) == (want.dtype, want.shape), key
        assert got.tobytes() == want.tobytes(), key
    assert json.loads((jdir / "metadata.json").read_text()) == json.loads((tdir / "metadata.json").read_text())
    jfiles = sorted(p.name for p in jdir.iterdir())
    assert jfiles == sorted(p.name for p in tdir.iterdir())
    for name in jfiles:
        if name != "weights.safetensors":
            assert (jdir / name).read_bytes() == (tdir / name).read_bytes(), name


@pytest.mark.parametrize("case", sorted(SOURCES))
def test_builder_matches_jax_and_loads_across(tmp_path, case):
    (tmp_path / "src").mkdir()
    builder, src, jkw, tkw = SOURCES[case](tmp_path / "src")
    jdir = getattr(jex, builder)(src, tmp_path / "jax", **jkw)
    tdir = getattr(tex, builder)(src, tmp_path / "port", **tkw)
    assert Path(tdir) == tmp_path / "port"
    assert_same_artifact(Path(jdir), Path(tdir))
    jparams, jmeta = jart.load_model(tdir)
    tparams, tmeta = tart.load_model(jdir, "cpu")
    assert jmeta.family == tmeta.family
    assert_same_tree(jparams, tparams)


def test_dolphin_language_catalog_matches():
    tokens = ["<blank>", "<asr>", "<zh>", "<ct>", "<ja>", "<CN>", "<TW>", "<x>", "<notimestamp>", "a"]
    assert jex.dolphin_language_catalog(tokens) == tex.dolphin_language_catalog(tokens)
    assert tex.dolphin_language_catalog(tokens)["aliases"]["Cantonese"] == "ct"
    assert tex.dolphin_language_catalog(["<asr>", "<notimestamp>"]) is None


def test_export_is_the_original_with_the_port_reader():
    """``export.py`` is the JAX package's file with its imports pointed
    inside the port and the port's own safetensors reader for Parakeet
    (the card machine has no ``safetensors`` package)."""
    from tests.test_torch_standalone import port_rewrite

    repo = Path(__file__).resolve().parent.parent
    want = port_rewrite((repo / "asr_tpu" / "export.py").read_text())
    assert (repo / "asr_tpu_torch" / "export.py").read_text() == want
