"""PyTorch port: the ``python -m asr_tpu_torch`` command line against the
JAX package's (``asr_tpu/cli.py``) on tiny artifact folders that the port's
``save_model`` writes, with ``--platform cpu``: ``inspect``, ``transcribe``
(one file and several: the ``transcribe_batch`` route), the ``quantize``
round trip, ``align``, ``serve``'s dispatch, the unknown-family refusal, the
card default, the AED families FireRed and Dolphin (``inspect`` and
``transcribe``, Dolphin with ``--language``), the offline families
Paraformer, Parakeet and Nemotron (``inspect``, ``transcribe``, Nemotron
with ``--language`` resolved to its prompt id, Parakeet through
``quantize``), the streaming families Paraformer, Nemotron (with
``--language``), Dolphin (with its catalog) and X-ASR (``inspect``,
``transcribe``, ``quantize``, and ``serve-stream``'s per-family settings
and a subprocess answering a stream), and the artifact tokenizers
(``_build_tokenizer``) of all six kinds, each decoding as the JAX package's
copy does.

Both command lines run f32 matmuls on the same weights, so the printed
token text is equal line by line (the timing columns differ).
"""

import dataclasses
import json
import subprocess
import sys
import time
import wave
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from asr_tpu import cli as jcli
from asr_tpu.ops import quant_matmul as jqm
from asr_tpu.runtime import metadata as jmeta
from asr_tpu_torch import cli
from asr_tpu_torch.layers import qwen3 as tq3
from asr_tpu_torch.models import dolphin as tdp
from asr_tpu_torch.models import firered as tfr
from asr_tpu_torch.models import forced_aligner as tfa
from asr_tpu_torch.frontend.nemo_mel import NemoMelConfig
from asr_tpu_torch.models import fun_asr_nano as tfn
from asr_tpu_torch.models import nemotron as tnm
from asr_tpu_torch.models import paraformer as tpf
from asr_tpu_torch.models import parakeet as tpk
from asr_tpu_torch.models import qwen_asr as tqa
from asr_tpu_torch.models import sensevoice as tsv
from asr_tpu_torch.models import zipformer as tzf
from asr_tpu_torch.ops import quant_matmul as tqm
from asr_tpu_torch.quant.quantize import cast_pytree
from asr_tpu_torch.runtime.artifact import ModelMetadata, read_safetensors, save_model
from asr_tpu_torch.runtime.metadata import LanguageProfile

REPO = Path(__file__).resolve().parent.parent
SV = dict(vocab_size=64, hidden=32, num_heads=4, head_dim=8, ffn_dim=48, num_encoders0=1,
          num_encoders=1, num_tp_encoders=1, fsmn_kernel=5)
LLM = dict(vocab_size=120, hidden=48, num_layers=1, num_heads=4, num_kv_heads=2, head_dim=16,
           ffn_dim=64, rope_theta=1e4)
FN = dict(hidden=32, num_heads=4, head_dim=8, ffn_dim=48, num_encoders0=1, num_encoders=1,
          num_tp_encoders=1, fsmn_kernel=5, adaptor_hidden=48, adaptor_blocks=1, adaptor_heads=4,
          adaptor_ffn=64, ctc_hidden=32, ctc_blocks=1, ctc_heads=4, ctc_ffn=48, ctc_vocab=64,
          eot_id=7)
TOWER = dict(n_mels=16, tower_dim=32, tower_layers=1, tower_heads=4, tower_ffn=48,
             downsample_hidden=8, chunks_per_window=2, output_dim=48, eot_id=-1)
FR = dict(vocab_size=64, d_model=64, enc_layers=1, enc_heads=4, conv_kernel=5, dec_layers=1,
          dec_heads=4, dec_ffn=96, sos_id=1, eos_id=2)
DP = dict(vocab_size=64, d_model=64, enc_layers=1, enc_heads=4, enc_ffn=96, cgmlp_dim=96,
          csgu_kernel=5, fusion_kernel=3, dec_layers=1, dec_heads=4, dec_ffn=96, sos_id=1, eos_id=2,
          language_token_start=40, language_token_end=45, region_token_start=45, region_token_end=50)
DP_CATALOG = {"languages": {"ja": 41, "zh": 43}, "regions": {"SICHUAN": 47},
              "aliases": {"Japanese": "ja", "Chinese": "zh"}}
PF = dict(vocab_size=50, hidden=32, num_heads=4, head_dim=8, ffn_dim=48, num_encoders0=1, num_encoders=1,
          num_decoders=1, num_decoder_ffn=1, fsmn_kernel=5, predictor_kernel=3)
PK = dict(vocab_size=40, blank_id=39, d_model=32, num_layers=1, num_heads=4, ffn_dim=48, conv_kernel=5,
          sub_channels=8, dec_hidden=32, lstm_layers=1, mel=NemoMelConfig(n_mels=80))
NM = dict(vocab_size=30, d_model=32, num_layers=1, num_heads=4, ffn_dim=48, conv_kernel=5, sub_channels=8,
          pred_hidden=32, joint_hidden=32, prompt_hidden=32, lstm_layers=1, num_prompts=8, left_context=6,
          right_context=3, mel=NemoMelConfig(n_mels=80))
ZF = dict(vocab_size=40, downsampling_factor=(1, 2), num_encoder_layers=(1, 1), encoder_dim=(32, 48),
          query_head_dim=(8, 8), pos_head_dim=(4, 4), value_head_dim=(8, 8), num_heads=(2, 2),
          feedforward_dim=(48, 64), cnn_module_kernel=(7, 7), left_context_frames=16, sub_layer1=4,
          sub_layer2=8, sub_layer3=16, decoder_dim=16, joiner_dim=16, decoder_conv_groups=4)
NM_LANGUAGES = [{"code": "en", "description": "English", "prompt_token_id": 3},
                {"code": "de", "description": "German", "aliases": ["deutsch"], "index": 5}]


@pytest.fixture(autouse=True)
def _restore_modes():
    """Both command lines set their package's process-wide matmul mode."""
    prev, jprev, threads = tqm._CONFIG["mm"], dict(jqm._CONFIG), torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    tqm._CONFIG["mm"] = prev
    jqm._CONFIG.update(jprev)
    torch.set_num_threads(threads)


def _g(seed):
    return torch.Generator().manual_seed(seed)


def _vocab_txt(folder: Path, n: int) -> dict:
    (folder / "vocab.txt").write_text("".join(f"t{i}\n" for i in range(n)), encoding="utf-8")
    return {"kind": "vocab_txt", "file": "vocab.txt"}


def _sensevoice(folder: Path) -> Path:
    cfg = tsv.SenseVoiceConfig(**SV)
    folder.mkdir()
    meta = ModelMetadata(family="sensevoice", tokenizer=_vocab_txt(folder, 64),
                         extra={"config": dataclasses.asdict(cfg)})
    save_model(folder, tsv.init_params(cfg, _g(0), "cpu"), meta)
    return folder


def _fun_asr_nano(folder: Path, head: str) -> Path:
    cfg = tfn.FunAsrNanoConfig(**FN, llm=tq3.Qwen3Config(**LLM))
    folder.mkdir()
    enc = tfn.init_params(cfg, _g(1), "cpu")
    params = enc if head == "ctc" else {"encoder": enc, "llm": tq3.init_params(cfg.llm, _g(2), "cpu")}
    meta = ModelMetadata(family="fun_asr_nano" if head == "ctc" else "fun_asr_nano_llm",
                         tokenizer=_vocab_txt(folder, 120),
                         extra={"config": dataclasses.asdict(cfg), "prompt_head_ids": [1, 2],
                                "prompt_suffix_ids": [3], "prompt_tail_ids": [4, 5]})
    save_model(folder, params, meta)
    return folder


def _aed(folder: Path, family: str) -> Path:
    """A tiny FireRed artifact with a ``firered_dict`` file, or a Dolphin one
    with a ``vocab_txt`` file and a language catalog."""
    folder.mkdir()
    if family == "firered":
        cfg = tfr.FireRedConfig(**FR)
        params = tfr.init_params(cfg, _g(4), "cpu")
        (folder / "dict.txt").write_text("<blank> 0\n<unk> 1\n<sos> 2\n<eos> 3\n"
                                         + "".join(f"w{i} {i}\n" for i in range(4, 64)),
                                         encoding="utf-8")
        meta = ModelMetadata(family="firered", tokenizer={"kind": "firered_dict", "file": "dict.txt"},
                             extra={"config": dataclasses.asdict(cfg)})
    else:
        cfg = tdp.DolphinConfig(**DP)
        params = tdp.init_params(cfg, _g(5), "cpu")
        meta = ModelMetadata(family="dolphin", tokenizer=_vocab_txt(folder, 64),
                             extra={"config": dataclasses.asdict(cfg),
                                    "dolphin_language_catalog": DP_CATALOG})
    save_model(folder, params, meta)
    return folder


def _offline(folder: Path, family: str) -> Path:
    """A tiny Paraformer, Parakeet or Nemotron artifact with a ``vocab_txt``
    file (Nemotron: two languages, one by prompt id, one by table row)."""
    folder.mkdir()
    mod, kw, seed = {"paraformer": (tpf, PF, 6), "parakeet": (tpk, PK, 7), "nemotron": (tnm, NM, 8)}[family]
    cfg = {"paraformer": tpf.ParaformerConfig, "parakeet": tpk.ParakeetConfig,
           "nemotron": tnm.NemotronConfig}[family](**kw)
    langs = [LanguageProfile(**{**p, "aliases": tuple(p.get("aliases", ()))}) for p in NM_LANGUAGES]
    meta = ModelMetadata(family=family, tokenizer=_vocab_txt(folder, 64), extra={"config": dataclasses.asdict(cfg)},
                         supported_languages=langs if family == "nemotron" else [])
    save_model(folder, mod.init_params(cfg, _g(seed), "cpu"), meta)
    return folder


def _wav(path: Path, n: int, seed: int, scale: float = 2000.0) -> str:
    pcm = np.clip(np.random.default_rng(seed).standard_normal(n) * scale, -32768, 32767)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.astype(np.int16).tobytes())
    return str(path)


def _text_lines(out: str) -> list[str]:
    """Every file's text line (the second of its two), and its audio length."""
    lines = out.strip().splitlines()
    return [(a.split("\t")[0], a.split("\t")[1].split(",")[0], b)
            for a, b in zip(lines[::2], lines[1::2])]


def _both(capsys, argv: list[str]) -> tuple[str, str]:
    assert cli.main(["--platform", "cpu", "--quant-mm", "f32", *argv]) == 0
    got = capsys.readouterr().out
    assert jcli.main(["--compile-cache", "", "--quant-mm", "f32", *argv]) == 0
    return got, capsys.readouterr().out


def test_inspect_matches_jax(tmp_path, capsys):
    folder = _sensevoice(tmp_path / "sv")
    got, want = _both(capsys, ["inspect", "--model-dir", str(folder)])
    assert json.loads(got) == json.loads(want)
    assert json.loads(got)["family"] == "sensevoice"


@pytest.mark.parametrize("family", ["sensevoice", "fun_asr_nano", "fun_asr_nano_llm"])
def test_transcribe_one_and_several_files_match_jax(tmp_path, capsys, family):
    folder = (_sensevoice(tmp_path / "m") if family == "sensevoice"
              else _fun_asr_nano(tmp_path / "m", "ctc" if family == "fun_asr_nano" else "llm"))
    files = [_wav(tmp_path / f"{i}.wav", n, i) for i, n in enumerate((12000, 20000))]
    for audio in (files[:1], files):
        got, want = _both(capsys, ["transcribe", "--model-dir", str(folder), *audio])
        assert _text_lines(got) == _text_lines(want)
        assert len(_text_lines(got)) == len(audio)
        assert all(t.startswith("t") for _, _, t in _text_lines(got))  # decoded text, not ids


@pytest.mark.parametrize("family,language", [("firered", None), ("dolphin", None),
                                             ("dolphin", "Chinese-Sichuan")])
def test_aed_families_transcribe_and_inspect(tmp_path, capsys, family, language):
    """``inspect`` prints what the JAX command line prints; ``transcribe``
    prints, for each file, the decode of ``session.transcribe``'s ids (the
    session ``_build_session`` makes, on the CPU in f32); Dolphin forces its
    language through the catalog with ``--language``."""
    folder = _aed(tmp_path / "m", family)
    got, want = _both(capsys, ["inspect", "--model-dir", str(folder)])
    assert json.loads(got) == json.loads(want) and json.loads(got)["family"] == family
    files = [_wav(tmp_path / f"{i}.wav", n, 20 + i) for i, n in enumerate((12000, 20000))]
    lang = ["--language", language] if language else []
    assert cli.main(["--platform", "cpu", "--quant-mm", "f32", "transcribe", *lang, "--model-dir",
                     str(folder), *files]) == 0
    lines = _text_lines(capsys.readouterr().out)
    sess = cli._build_session(folder, language=language, device="cpu")
    assert type(sess).__name__ == {"firered": "FireRedSession", "dolphin": "DolphinSession"}[family]
    if language:
        assert (sess.language_id, sess.region_id) == (43, 47)
    for f, (name, _, text) in zip(files, lines):
        ids = sess.transcribe(f).token_ids
        assert name == f and ids and text == sess.tokenizer.decode(ids)


@pytest.mark.parametrize("family,language", [("paraformer", None), ("parakeet", None), ("nemotron", None),
                                             ("nemotron", "deutsch")])
def test_offline_families_transcribe_and_inspect_as_jax(tmp_path, capsys, family, language):
    """``inspect`` and ``transcribe`` of two files (one batched forward)
    print what the JAX command line prints; each text is the decode of
    ``session.transcribe``'s ids; Nemotron's ``--language`` resolves through
    the metadata to a prompt id (a profile's ``prompt_token_id``, else its
    ``index``), as the JAX command line resolves it."""
    folder = _offline(tmp_path / "m", family)
    got, want = _both(capsys, ["inspect", "--model-dir", str(folder)])
    assert json.loads(got) == json.loads(want) and json.loads(got)["family"] == family
    files = [_wav(tmp_path / f"{i}.wav", n, 30 + i) for i, n in enumerate((12000, 20000))]
    lang = ["--language", language] if language else []
    got, want = _both(capsys, ["transcribe", *lang, "--model-dir", str(folder), *files])
    assert _text_lines(got) == _text_lines(want) and len(_text_lines(got)) == 2
    sess = cli._build_session(folder, language=language, device="cpu")
    assert type(sess).__name__ == f"{family.capitalize()}Session"
    if family == "nemotron":
        jsess = jcli._build_session(folder, language=language)
        assert sess.prompt_id == jsess.prompt_id == (5 if language else 0)
    for f, (name, _, text) in zip(files, _text_lines(got)):
        ids = sess.transcribe(f).token_ids
        assert name == f and ids and text == sess.tokenizer.decode(ids)


def test_parakeet_quantize_keeps_the_lstm_f32_and_transcribes_as_jax(tmp_path, capsys):
    folder = _offline(tmp_path / "pk", "parakeet")
    argv = ["quantize", "--model-dir", str(folder), "--bits", "8", "--min-size", "1024",
            "--refine-iters", "0"]
    assert cli.main(["--platform", "cpu", *argv, "--out", str(tmp_path / "t")]) == 0
    assert jcli.main(["--compile-cache", "", *argv, "--out", str(tmp_path / "j")]) == 0
    capsys.readouterr()
    got, want = read_safetensors(tmp_path / "t" / "weights.safetensors"), read_safetensors(
        tmp_path / "j" / "weights.safetensors")
    assert sorted(got) == sorted(want)
    assert "decoder/head/w/__quant__/q" in got and "decoder/lstm/0/w_ih" in got
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    wav = _wav(tmp_path / "a.wav", 16000, 3)
    got, want = _both(capsys, ["transcribe", "--model-dir", str(tmp_path / "t"), wav])
    assert _text_lines(got) == _text_lines(want)


def test_transcribe_batch_route_gives_each_file_its_own_ids(tmp_path, capsys):
    folder = _sensevoice(tmp_path / "sv")
    files = [_wav(tmp_path / f"{i}.wav", n, 10 + i) for i, n in enumerate((9000, 30000, 140000))]
    assert cli.main(["--platform", "cpu", "transcribe", "--model-dir", str(folder), *files]) == 0
    together = _text_lines(capsys.readouterr().out)
    for f, line in zip(files, together):
        assert cli.main(["--platform", "cpu", "transcribe", "--model-dir", str(folder), f]) == 0
        assert _text_lines(capsys.readouterr().out) == [line]
    assert cli.main(["--platform", "cpu", "transcribe", "--dtype", "float32", "--model-dir",
                     str(folder), files[0]]) == 0
    assert _text_lines(capsys.readouterr().out) == together[:1]


def test_quantize_round_trip_matches_jax(tmp_path, capsys):
    folder = _sensevoice(tmp_path / "sv")
    argv = ["quantize", "--model-dir", str(folder), "--bits", "8", "--min-size", "0",
            "--refine-iters", "0"]
    assert cli.main(["--platform", "cpu", *argv, "--out", str(tmp_path / "t")]) == 0
    assert jcli.main(["--compile-cache", "", *argv, "--out", str(tmp_path / "j")]) == 0
    capsys.readouterr()
    got, want = read_safetensors(tmp_path / "t" / "weights.safetensors"), read_safetensors(
        tmp_path / "j" / "weights.safetensors")
    assert sorted(got) == sorted(want) and any("__quant__" in k for k in got)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    tmeta = ModelMetadata.load(tmp_path / "t")
    assert tmeta.extra["quantization"] == jmeta.ModelMetadata.load(tmp_path / "j").extra["quantization"]
    assert (tmp_path / "t" / "vocab.txt").read_text() == (folder / "vocab.txt").read_text()
    wav = _wav(tmp_path / "a.wav", 16000, 3)
    got, want = _both(capsys, ["transcribe", "--model-dir", str(tmp_path / "t"), wav])
    assert _text_lines(got) == _text_lines(want)


def _aligner(folder: Path) -> Path:
    from tokenizers import Tokenizer, models, pre_tokenizers

    cfg = tfa.ForcedAlignerConfig(asr=tqa.QwenAsrConfig(**TOWER, llm=tq3.Qwen3Config(**LLM)),
                                  classify_num=25)
    folder.mkdir()
    g = _g(3)
    params = {"tower": tqa.init_tower_params(cfg.asr, g, "cpu"),
              "llm": tq3.init_params(cfg.asr.llm, g, "cpu"),
              "head": {"w": torch.randn((48, 25), generator=g) * 0.1}}
    words = ["[UNK]", "hello", "world", "again", "he", "llo"]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(str(folder / "tokenizer.json"))
    meta = ModelMetadata(family="qwen_aligner", tokenizer={"kind": "hf", "file": "tokenizer.json"},
                         special_token_ids={"timestamp": 110, "audio_start": 111, "audio_end": 112},
                         extra={"config": dataclasses.asdict(cfg), "timestamp_tokens_per_word": 2})
    save_model(folder, params, meta)
    return folder


def test_align_matches_jax(tmp_path, capsys):
    folder = _aligner(tmp_path / "fa")
    wav = _wav(tmp_path / "a.wav", 28000, 4, scale=3000.0)
    got, want = _both(capsys, ["align", "--model-dir", str(folder), "--text", "hello, world again",
                               wav])
    assert got == want
    assert [line.split()[-1] for line in got.strip().splitlines()] == ["hello", "world", "again"]
    folder_sv = _sensevoice(tmp_path / "sv")
    with pytest.raises(SystemExit, match="forced-aligner"):
        cli.main(["--platform", "cpu", "align", "--model-dir", str(folder_sv), "--text", "x", wav])


def test_serve_dispatch(tmp_path, monkeypatch):
    from asr_tpu_torch.parallel import http_server, llm_server

    calls = []
    monkeypatch.setattr(http_server, "serve_forever", lambda sess, **kw: calls.append(("mb", sess, kw)))
    monkeypatch.setattr(llm_server, "serve_continuous", lambda sess, **kw: calls.append(("cont", sess, kw)))
    sv = _sensevoice(tmp_path / "sv")
    llm = _fun_asr_nano(tmp_path / "llm", "llm")
    assert cli.main(["--platform", "cpu", "serve", "--model-dir", str(sv), "--max-batch", "4"]) == 0
    assert cli.main(["--platform", "cpu", "serve", "--model-dir", str(llm), "--continuous",
                     "--slots", "3", "--kv-dtype", "bf16", "--steps-per-tick", "2"]) == 0
    (k1, s1, kw1), (k2, s2, kw2) = calls
    assert k1 == "mb" and type(s1).__name__ == "SenseVoiceSession"
    assert kw1 == {"host": "127.0.0.1", "port": 8000, "max_batch": 4, "max_wait_ms": 5.0,
                   "language": None}
    assert k2 == "cont" and type(s2).__name__ == "FunAsrNanoLlmSession"
    assert kw2 == {"host": "127.0.0.1", "port": 8000, "n_slots": 3, "language": None, "context": "",
                   "kv_dtype": "bf16", "steps_per_tick": 2, "data_parallel": 1,
                   "tensor_parallel": 1, "devices": [torch.device("cpu")]}
    with pytest.raises(SystemExit, match="--continuous serves"):
        cli.main(["--platform", "cpu", "serve", "--model-dir", str(sv), "--continuous"])


def _streaming(folder: Path, family: str) -> Path:
    """A tiny streaming artifact with a ``vocab_txt`` file: Paraformer,
    Nemotron (its two languages), Dolphin (its catalog; a 64-frame history)
    or X-ASR."""
    from asr_tpu_torch.streaming import dolphin_stream as tds

    folder.mkdir()
    langs = []
    extra = {}
    if family == "paraformer_streaming":
        cfg = tpf.ParaformerConfig(**PF)
        params = tpf.init_params(cfg, _g(9), "cpu")
    elif family == "nemotron_streaming":
        cfg = tnm.NemotronConfig(**NM)
        params = tnm.init_params(cfg, _g(10), "cpu")
        langs = [LanguageProfile(**{**p, "aliases": tuple(p.get("aliases", ()))}) for p in NM_LANGUAGES]
    elif family == "dolphin_streaming":
        cfg = tds.DolphinStreamConfig(base=tdp.DolphinConfig(**DP), chunk_frames=8, max_frames=64)
        params = tdp.init_params(cfg.base, _g(11), "cpu")
        extra["dolphin_language_catalog"] = DP_CATALOG
    else:
        cfg = tzf.ZipformerConfig(**ZF)
        params = tzf.init_params(cfg, _g(12), "cpu")
    meta = ModelMetadata(family=family, tokenizer=_vocab_txt(folder, 64), supported_languages=langs,
                         extra={"config": dataclasses.asdict(cfg), **extra})
    save_model(folder, params, meta)
    return folder


STREAMING = [("paraformer_streaming", None), ("nemotron_streaming", None), ("nemotron_streaming", "deutsch"),
             ("dolphin_streaming", None), ("dolphin_streaming", "Chinese-Sichuan"), ("x_asr", None)]


@pytest.mark.parametrize("family,language", STREAMING)
def test_streaming_families_transcribe_and_inspect_as_jax(tmp_path, capsys, family, language):
    """``inspect`` and ``transcribe`` print what the JAX command line prints
    (the streaming session chunk by chunk); each text is the decode of the
    session's ids; Nemotron's ``--language`` resolves to a prompt id and
    Dolphin's through its catalog, as in the JAX command line."""
    folder = _streaming(tmp_path / "m", family)
    got, want = _both(capsys, ["inspect", "--model-dir", str(folder)])
    assert json.loads(got) == json.loads(want) and json.loads(got)["family"] == family
    scale = 300.0 if family == "nemotron_streaming" else 2000.0
    files = [_wav(tmp_path / f"{i}.wav", n, 40 + i, scale) for i, n in enumerate((12000, 20000))]
    lang = ["--language", language] if language else []
    got, want = _both(capsys, ["transcribe", *lang, "--model-dir", str(folder), *files])
    assert _text_lines(got) == _text_lines(want) and len(_text_lines(got)) == 2
    sess = cli._build_session(folder, language=language, device="cpu")
    jsess = jcli._build_session(folder, language=language)
    assert type(sess).__name__ == type(jsess).__name__
    if family == "nemotron_streaming":
        assert sess.prompt_id == jsess.prompt_id == (5 if language else 0)
    if family == "dolphin_streaming":
        assert (sess.language_id, sess.region_id) == (jsess.language_id, jsess.region_id)
    for f, (name, _, text) in zip(files, _text_lines(got)):
        ids = sess.transcribe(f).token_ids
        assert name == f and text == sess.tokenizer.decode(ids)
    assert any(t for _, _, t in _text_lines(got))


@pytest.mark.parametrize("family", ["paraformer_streaming", "x_asr"])
def test_streaming_quantize_matches_jax_and_transcribes(tmp_path, capsys, family):
    """``quantize`` of a streaming artifact writes the JAX command line's
    bytes; the q8 artifact transcribes as the JAX command line does."""
    folder = _streaming(tmp_path / "m", family)
    argv = ["quantize", "--model-dir", str(folder), "--bits", "8", "--min-size", "1024", "--refine-iters", "0"]
    assert cli.main(["--platform", "cpu", *argv, "--out", str(tmp_path / "t")]) == 0
    assert jcli.main(["--compile-cache", "", *argv, "--out", str(tmp_path / "j")]) == 0
    capsys.readouterr()
    got = read_safetensors(tmp_path / "t" / "weights.safetensors")
    want = read_safetensors(tmp_path / "j" / "weights.safetensors")
    assert sorted(got) == sorted(want) and any("__quant__" in k for k in got)
    for k in got:
        np.testing.assert_array_equal(got[k].reshape(want[k].shape), want[k], err_msg=k)
    wav = _wav(tmp_path / "a.wav", 16000, 50)
    t_out, j_out = _both(capsys, ["transcribe", "--model-dir", str(tmp_path / "t"), wav])
    assert _text_lines(t_out) == _text_lines(j_out)


def _serve_stream_settings(monkeypatch, main, module, argv):
    calls = []
    monkeypatch.setattr(module, "serve_streams", lambda runner, chunk, **kw: calls.append((runner, chunk, kw)))
    assert main(argv) == 0
    (runner, chunk, kw), = calls
    return runner, chunk, {k: v for k, v in kw.items() if k != "extract"}, kw["extract"]


@pytest.mark.parametrize("family", ["paraformer_streaming", "nemotron_streaming", "dolphin_streaming", "x_asr"])
def test_serve_stream_settings_match_jax(tmp_path, monkeypatch, family):
    """Each family's window, advance, PCM scale, tail pad, drain rule and
    extract, and the flags, as the JAX command line sets them."""
    from asr_tpu.parallel import stream_server as jss_mod
    from asr_tpu_torch.parallel import stream_server as tss_mod

    folder = _streaming(tmp_path / "m", family)
    argv = ["serve-stream", "--model-dir", str(folder), "--streams", "3", "--ticks-per-sync", "2", "--port", "0"]
    runner, chunk, kw, extract = _serve_stream_settings(monkeypatch, cli.main, tss_mod,
                                                        ["--platform", "cpu", *argv])
    jrunner, jchunk, jkw, jextract = _serve_stream_settings(monkeypatch, jcli.main, jss_mod,
                                                            ["--compile-cache", "", *argv])
    assert (chunk, kw) == (jchunk, jkw) and kw["ticks_per_sync"] == 2 and kw["port"] == 0
    assert runner.n_streams == jrunner.n_streams == 3
    assert (extract is None) == (jextract is None) == (family != "dolphin_streaming")
    if extract is not None:
        outs = {"ctc_ids": np.array([[0, 5, 5, 0, 7], [3, 3, 0, 0, 4]])}
        for i in range(2):
            st, jst = {"last": 5}, {"last": 5}
            assert extract(outs, i, st) == jextract(outs, i, jst) and st == jst
    with pytest.raises(SystemExit, match="serve-stream supports the streaming families"):
        cli.main(["--platform", "cpu", "serve-stream", "--model-dir", str(_offline(tmp_path / "p", "paraformer"))])


def test_serve_stream_subprocess_answers_a_stream_without_jax(tmp_path):
    """``serve-stream --platform cpu`` in a fresh process answers one
    chunked-HTTP stream with the session's ids, and the process, once
    serving, holds neither ``jax`` nor ``asr_tpu`` (it prints the modules
    it would leak)."""
    import select

    from asr_tpu_torch.parallel.stream_server import stream_pcm_over_http

    folder = _streaming(tmp_path / "m", "paraformer_streaming")
    script = ("import sys, threading\n"
              "from asr_tpu_torch.cli import main\n"
              "t = threading.Thread(target=main, args=(sys.argv[1:],), daemon=True)\n"
              "t.start()\n"
              "import time\n"
              "while not any(m == 'asr_tpu_torch.parallel.stream_server' for m in sys.modules): time.sleep(0.05)\n"
              "time.sleep(0.5)\n"
              "print('LEAKED', sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'asr_tpu')),"
              " flush=True)\n"
              "t.join()\n")
    proc = subprocess.Popen([sys.executable, "-u", "-c", script, "--platform", "cpu", "serve-stream",
                             "--model-dir", str(folder), "--port", "0", "--streams", "2"],
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port, leaked = None, None
        deadline = time.time() + 120
        while (port is None or leaked is None) and time.time() < deadline:
            ready, _, _ = select.select([proc.stdout], [], [], 1.0)
            if not ready:
                assert proc.poll() is None, proc.stderr.read()
                continue
            line = proc.stdout.readline()
            if line.startswith("streaming on http://"):
                port = int(line.split(":")[2].split()[0])
            elif line.startswith("LEAKED"):
                leaked = line.split(" ", 1)[1].strip()
        assert port and leaked == "[]", (port, leaked)
        pcm = (np.random.default_rng(60).standard_normal(3 * 8000) * 2000).astype(np.int16)
        evs = stream_pcm_over_http("127.0.0.1", port, pcm, send_chunk=4096)
        assert evs and evs[-1].get("done"), evs
        sess = cli._build_session(folder, device="cpu")
        want = [sess.push_chunk(pcm[i * 8000 : (i + 1) * 8000].astype(np.float32)) for i in range(3)]
        assert [e["ids"] for e in evs if "ids" in e] == [ids for ids in want if ids]
    finally:
        proc.kill()
        proc.wait(timeout=30)


def test_serve_continuous_takes_the_aed_families(tmp_path, monkeypatch):
    from asr_tpu_torch.parallel import llm_server

    calls = []
    monkeypatch.setattr(llm_server, "serve_continuous", lambda sess, **kw: calls.append((sess, kw)))
    for family in ("firered", "dolphin"):
        folder = _aed(tmp_path / family, family)
        assert cli.main(["--platform", "cpu", "serve", "--model-dir", str(folder), "--continuous",
                         "--slots", "2"]) == 0
    assert [type(sess).__name__ for sess, _ in calls] == ["FireRedSession", "DolphinSession"]
    assert all(kw["n_slots"] == 2 and hasattr(sess, "continuous_prefill") for sess, kw in calls)


def test_unknown_family_and_the_card_default(tmp_path, monkeypatch):
    """A family neither package knows raises the JAX package's refusal (the
    port now wires every family the JAX package does)."""
    for family in ("no_such_family",):
        folder = tmp_path / family
        folder.mkdir()
        save_model(folder, {"w": torch.zeros(2)}, ModelMetadata(family=family))
        with pytest.raises(SystemExit, match=f"no session wired for family '{family}'"):
            cli.main(["--platform", "cpu", "transcribe", "--model-dir", str(folder), "x.wav"])
    with pytest.raises(SystemExit, match="no session wired for family 'no_such_family'"):
        jcli.main(["--compile-cache", "", "transcribe", "--model-dir", str(folder), "x.wav"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["inspect", "--model-dir", str(folder)],
                 ["--platform", "gpu", "inspect", "--model-dir", str(folder)]):
        with pytest.raises(SystemExit, match="no CUDA card"):
            cli.main(argv)


def test_cast_pytree_matches_jax():
    from asr_tpu.quant.quantize import cast_pytree as jcast
    from asr_tpu.runtime import artifact as jart
    from asr_tpu_torch.runtime import artifact as tart

    tree = {"a": np.ones((2, 3), np.float32), "b": [np.arange(4, dtype=np.int32)],
            "c": {"d": np.zeros(5, np.float32)}}
    got = cast_pytree(tart.params_from_flat(tart.flatten_pytree(tree), "cpu"), "bfloat16")
    got = {"a": got["a"].dtype, "b/0": got["b"][0].dtype, "c/d": got["c"]["d"].dtype}
    want = jart.flatten_pytree(jcast(jax.tree.map(jax.numpy.asarray, tree), jax.numpy.bfloat16))
    assert {k: str(v).replace("torch.", "") for k, v in got.items()} == {
        k: str(v.dtype) for k, v in want.items()}


# ── artifact tokenizers (_build_tokenizer): six kinds ─────────────────────
def _tokenizer_files(folder: Path) -> dict:
    import base64

    from test_runtime import _sp_piece
    from tokenizers import Tokenizer, models, pre_tokenizers

    folder.mkdir(exist_ok=True)
    (folder / "sp.model").write_bytes(b"".join([
        _sp_piece("<unk>", 0.0, 2), _sp_piece("<s>", 0.0, 3), _sp_piece("▁hello", -1.0),
        _sp_piece("▁wor", -2.0), _sp_piece("ld", -3.0), _sp_piece("<0xE4>", 0.0, 6),
        _sp_piece("<0xB8>", 0.0, 6), _sp_piece("<0xAD>", 0.0, 6), _sp_piece("<|zh|>", 0.0, 4)]))
    (folder / "vocab.txt").write_text("<blank>\n你\n好\n</s>\nab@@\ncd\n", encoding="utf-8")
    tok = Tokenizer(models.WordLevel({"[UNK]": 0, "hello": 1, "world": 2}, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(str(folder / "tokenizer.json"))
    (folder / "vocab.json").write_text(json.dumps({"a": 0, "Ã¤": 1, "b": 2}), encoding="utf-8")
    (folder / "dict.txt").write_text("<blank> 0\n<unk> 1\n你 2\n▁he 3\nllo 4\n<space> 5\n",
                                     encoding="utf-8")
    (folder / "tiktoken.txt").write_text("".join(
        f"{base64.b64encode(t).decode()} {i}\n" for i, t in enumerate([b"he", b"llo", b" w", "中".encode()])))
    return {"sentencepiece": ("sp.model", [2, 3, 4, 5, 6, 7, 8, 1]),
            "vocab_txt": ("vocab.txt", [1, 2, 0, 4, 5, 3]),
            "hf": ("tokenizer.json", [1, 2, 0]),
            "json": ("vocab.json", [0, 1, 2, 9]),
            "firered_dict": ("dict.txt", [3, 4, 5, 2, 0, 1]),
            "tiktoken": ("tiktoken.txt", [0, 1, 2, 3, 5, 6, 4000])}


@pytest.mark.parametrize("kind", ["sentencepiece", "vocab_txt", "hf", "json", "firered_dict",
                                  "tiktoken"])
@pytest.mark.parametrize("decode_mode", ["zh", "en"])
def test_build_tokenizer_decodes_as_jax(tmp_path, kind, decode_mode):
    file, ids = _tokenizer_files(tmp_path)[kind]
    extra = {"decode_mode": decode_mode}
    tok = cli._build_tokenizer(tmp_path, ModelMetadata(family="x", tokenizer={"kind": kind, "file": file},
                                                       extra=extra))
    jtok = jcli._build_tokenizer(tmp_path, jmeta.ModelMetadata(
        family="x", tokenizer={"kind": kind, "file": file}, extra=extra))
    assert type(tok).__name__ == type(jtok).__name__
    assert tok.decode(ids) == jtok.decode(ids)
    assert tok.decode(ids)


def test_build_tokenizer_returns_none_without_a_file(tmp_path):
    _tokenizer_files(tmp_path)
    for tokenizer in ({}, {"kind": "vocab_txt", "file": "missing.txt"},
                      {"kind": "unknown", "file": "vocab.txt"}):
        assert cli._build_tokenizer(tmp_path, ModelMetadata(family="x", tokenizer=tokenizer)) is None


def test_module_help_runs():
    proc = subprocess.run([sys.executable, "-m", "asr_tpu_torch", "--help"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for word in ("transcribe", "inspect", "quantize", "align", "serve", "serve-stream", "build",
                 "optimize", "parity", "--platform", "--quant-mm"):
        assert word in proc.stdout
    for word in ("bench", "--compile-cache", "--quant-kernel"):
        assert word not in proc.stdout
