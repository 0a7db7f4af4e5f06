"""The port's ten checkpoint loaders against the JAX package's: the same
synthetic state dicts (the JAX loader tests' builders) go through both, and
every tree comes out bitwise equal, leaf for leaf and dtype for dtype, with
the port's leaves CPU tensors in the layout ``runtime/artifact`` gives. The
configs the loaders derive, the Kaldi CMVN parsers, the ``.nemo`` reader and
the X-ASR Zipformer2 baking helpers (numpy f64) match as well.

The source folders written here are shared with ``test_torch_export.py`` and
``test_torch_cli_build.py``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from asr_tpu.runtime import artifact as jart
from asr_tpu_torch.runtime import artifact as tart

transformers = pytest.importorskip("transformers")


@pytest.fixture(autouse=True)
def _torch_threads():
    """Two torch threads a test: the suite runs several workers at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ── comparison helpers ──────────────────────────────────────────────────────
def assert_same_tree(jtree, ttree):
    """Both packages' trees flatten to the same keys, dtypes and bytes; the
    port's leaves are CPU tensors (or quantized leaves of CPU tensors)."""
    jflat = jart.flatten_pytree(jtree)
    tflat = tart.flatten_pytree(ttree)
    assert sorted(jflat) == sorted(tflat)
    for key, want in jflat.items():
        got = tflat[key]
        assert got.dtype == want.dtype, (key, got.dtype, want.dtype)
        assert got.shape == want.shape, (key, got.shape, want.shape)
        assert got.tobytes() == np.ascontiguousarray(want).tobytes(), key

    def cpu_leaves(node):
        if isinstance(node, dict):
            for v in node.values():
                cpu_leaves(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                cpu_leaves(v)
        elif isinstance(node, torch.Tensor):
            assert node.device.type == "cpu"
    cpu_leaves(ttree)


def same_config(jcfg, tcfg):
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)


def _t(rng, *shape):
    return torch.tensor(rng.standard_normal(shape).astype(np.float32))


def hf_tokenizer(path, words: list[str]) -> None:
    """A word-level ``tokenizer.json`` (the installed ``tokenizers``)."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(["[UNK]", *words])}, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(str(path))


def write_mvn(path, f):
    path.write_text(
        "<Nnet>\n<AddShift> %d %d\n<LearnRateCoef> 0 [ %s ]\n"
        "<Rescale> %d %d\n<LearnRateCoef> 0 [ %s ]\n</Nnet>\n"
        % (f, f, " ".join(f"{-0.5 - 0.01 * i:.4f}" for i in range(f)),
           f, f, " ".join(f"{2.0 + 0.003 * i:.4f}" for i in range(f))))


# ── FunASR: SenseVoice, Paraformer, Fun-ASR-Nano ────────────────────────────
def test_funasr_sensevoice_config_and_params_bitwise():
    from asr_tpu.loaders import funasr as jl
    from asr_tpu_torch.loaders import funasr as tl
    from tests.test_loaders import SV_CFG, _sensevoice_sd

    rng = np.random.default_rng(0)
    sd = _sensevoice_sd(SV_CFG, rng)
    kw = dict(num_heads=SV_CFG.num_heads, head_dim=SV_CFG.head_dim)
    same_config(jl.sensevoice_config_from_state_dict(sd, **kw),
                tl.sensevoice_config_from_state_dict(sd, **kw))
    f = SV_CFG.feature_size
    neg, istd = rng.standard_normal(f).astype(np.float32), rng.uniform(0.5, 2, f).astype(np.float32)
    assert_same_tree(jl.sensevoice_params_from_state_dict(sd, SV_CFG, neg, istd),
                     tl.sensevoice_params_from_state_dict(sd, tl.SenseVoiceConfig(**dataclasses.asdict(SV_CFG)),
                                                          neg, istd))


def test_funasr_paraformer_config_and_params_bitwise():
    from asr_tpu.loaders import funasr as jl
    from asr_tpu_torch.loaders import funasr as tl
    from tests.test_loaders import PF_CFG, _paraformer_sd

    rng = np.random.default_rng(1)
    sd = _paraformer_sd(PF_CFG, rng)
    jcfg = jl.paraformer_config_from_state_dict(sd)
    tcfg = tl.paraformer_config_from_state_dict(sd)
    same_config(jcfg, tcfg)
    f = PF_CFG.feature_size
    neg, istd = rng.standard_normal(f).astype(np.float32), rng.uniform(0.5, 2, f).astype(np.float32)
    assert_same_tree(jl.paraformer_params_from_state_dict(sd, jcfg, neg, istd),
                     tl.paraformer_params_from_state_dict(sd, tcfg, neg, istd))


def test_funasr_fun_asr_nano_config_and_params_bitwise():
    from asr_tpu.loaders import funasr as jl, qwen3_hf as jq
    from asr_tpu_torch.loaders import funasr as tl, qwen3_hf as tq
    from tests.test_qwen_loaders import _nano_sd

    sd = _nano_sd(np.random.default_rng(2))
    jcfg = jl.fun_asr_nano_config_from_state_dict(sd)
    tcfg = tl.fun_asr_nano_config_from_state_dict(sd)
    same_config(jcfg, tcfg)
    assert_same_tree(jl.fun_asr_nano_params_from_state_dict(sd, jcfg),
                     tl.fun_asr_nano_params_from_state_dict(sd, tcfg))
    assert_same_tree(jq.params_from_state_dict(sd, jcfg.llm, prefix="llm.model."),
                     tq.params_from_state_dict(sd, tcfg.llm, prefix="llm.model."))


def test_funasr_mvn_and_checkpoint_file(tmp_path):
    from asr_tpu.loaders import funasr as jl
    from asr_tpu_torch.loaders import funasr as tl

    write_mvn(tmp_path / "am.mvn", 7)
    for a, b in zip(jl.parse_kaldi_mvn(tmp_path / "am.mvn"), tl.parse_kaldi_mvn(tmp_path / "am.mvn")):
        assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()
    rng = np.random.default_rng(3)
    torch.save({"state_dict": {"model.a.weight": _t(rng, 3, 2), "b": _t(rng, 4)}}, tmp_path / "model.pt")
    want, got = jl.load_checkpoint_file(tmp_path / "model.pt"), tl.load_checkpoint_file(tmp_path / "model.pt")
    assert list(want) == list(got) == ["a.weight", "b"]
    assert all(torch.equal(want[k], got[k]) for k in want)


# ── HF Whisper ──────────────────────────────────────────────────────────────
def whisper_hf_model(seed: int = 0):
    cfg = transformers.WhisperConfig(
        vocab_size=100, d_model=32, encoder_layers=1, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4,
        encoder_ffn_dim=64, decoder_ffn_dim=64, num_mel_bins=16,
        max_source_positions=40, max_target_positions=24,
        decoder_start_token_id=1, eos_token_id=2, pad_token_id=3,
    )
    torch.manual_seed(seed)
    return transformers.WhisperForConditionalGeneration(cfg)


def write_whisper_folder(path, dtype=torch.float32, seed: int = 0):
    """An HF Whisper snapshot: config.json, model.safetensors in ``dtype``,
    generation_config.json and a tokenizer.json."""
    model = whisper_hf_model(seed).to(dtype)
    path.mkdir(parents=True, exist_ok=True)
    model.save_pretrained(path, safe_serialization=True)
    (path / "generation_config.json").write_text(json.dumps({
        "suppress_tokens": [5, 6], "begin_suppress_tokens": [7],
        "lang_to_id": {"<|en|>": 10, "<|zh|>": 11}, "no_timestamps_token_id": 21,
        "no_speech_token_id": 22, "task_to_id": {"transcribe": 20, "translate": 19},
    }))
    hf_tokenizer(path / "tokenizer.json", ["a", "b"])
    return path


def test_whisper_hf_state_dict_and_config_bitwise():
    from asr_tpu.loaders import whisper_hf as jl
    from asr_tpu_torch.loaders import whisper_hf as tl

    model = whisper_hf_model()
    jcfg, tcfg = jl.config_from_hf(model.config), tl.config_from_hf(model.config.to_dict())
    same_config(jcfg, tcfg)
    sd = model.state_dict()
    assert_same_tree(jl.params_from_state_dict(sd, jcfg), tl.params_from_state_dict(sd, tcfg))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_whisper_hf_folder_bitwise(tmp_path, dtype):
    """The safetensors folder through the port's own reader: an F16 snapshot
    keeps its F16 leaves in both packages (this loader does not upcast)."""
    from asr_tpu.loaders import whisper_hf as jl
    from asr_tpu_torch.loaders import whisper_hf as tl

    src = write_whisper_folder(tmp_path / "hf", dtype)
    jp, jcfg = jl.load_from_pretrained_dir(src)
    tp, tcfg = tl.load_from_pretrained_dir(src)
    same_config(jcfg, tcfg)
    assert_same_tree(jp, tp)
    assert tp["encoder"]["pos"].dtype == (torch.float16 if dtype == torch.float16 else torch.float32)


def test_safetensors_bf16_read_by_jax_refused_by_the_port(tmp_path):
    """Once a known gap of the port, now closed: BF16 safetensors. In a
    process that has imported JAX, ``safetensors.numpy`` holds BF16 through
    ml_dtypes, so the JAX package's loaders keep bf16 leaves; the port's
    reader (numpy has no bf16 of its own) no longer refuses the file but
    keeps the same 16-bit patterns, and they load as ``torch.bfloat16``."""
    from safetensors.numpy import load_file
    from safetensors.torch import save_file

    import jax.numpy  # noqa: F401  (ml_dtypes registers bfloat16 with numpy)

    w = torch.randn(2, 3).to(torch.bfloat16)
    save_file({"w": w}, str(tmp_path / "m.safetensors"))
    want = load_file(str(tmp_path / "m.safetensors"))["w"]
    assert str(want.dtype) == "bfloat16"
    got = tart.read_safetensors(tmp_path / "m.safetensors")["w"]
    assert got.shape == want.shape and got.tobytes() == want.tobytes()
    assert torch.equal(tart.params_from_flat({"w": got}, "cpu")["w"], w)


# ── HF Qwen3, Qwen3-ASR, Qwen3 forced aligner ───────────────────────────────
def test_qwen3_hf_params_and_configs_bitwise():
    from asr_tpu.loaders import qwen3_hf as jl
    from asr_tpu_torch.loaders import qwen3_hf as tl

    hf = transformers.Qwen3Config(vocab_size=90, hidden_size=64, intermediate_size=96,
                                  num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                                  head_dim=16, tie_word_embeddings=True)
    torch.manual_seed(4)
    sd = transformers.Qwen3ForCausalLM(hf).state_dict()
    jcfg, tcfg = jl.config_from_state_dict(sd), tl.config_from_state_dict(sd)
    same_config(jcfg, tcfg)
    same_config(jl.config_from_hf(hf.to_dict()), tl.config_from_hf(hf.to_dict()))
    assert_same_tree(jl.params_from_state_dict(sd, jcfg), tl.params_from_state_dict(sd, tcfg))


@pytest.mark.parametrize("classify", [None, 25])
def test_qwen_asr_hf_snapshot_bitwise(tmp_path, classify):
    from asr_tpu.loaders import qwen_asr_hf as jl
    from asr_tpu_torch.loaders import qwen_asr_hf as tl
    from tests.test_qwen_loaders import _write_snapshot

    src, _, _ = _write_snapshot(tmp_path, classify=classify)
    same_config(jl.config_from_hf_dir(src), tl.config_from_hf_dir(src))
    if classify is None:
        *jtrees, jcfg = jl.load_qwen_asr_dir(src)
        *ttrees, tcfg = tl.load_qwen_asr_dir(src)
    else:
        *jtrees, jcfg = jl.load_aligner_dir(src)
        *ttrees, tcfg = tl.load_aligner_dir(src)
    same_config(jcfg, tcfg)
    for j, t in zip(jtrees, ttrees):
        assert_same_tree(j, t)


# ── FireRedASR-AED ──────────────────────────────────────────────────────────
def write_firered_folder(path, seed: int = 3):
    from tests.test_firered import TINY, _firered_sd

    rng = np.random.default_rng(seed)
    path.mkdir(parents=True, exist_ok=True)
    torch.save({"args": {"n_layers_enc": TINY.enc_layers}, "model_state_dict": _firered_sd(TINY, rng)},
               path / "model.pth.tar")
    x = rng.standard_normal((50, TINY.n_mels)) + 2.0
    row1 = " ".join(f"{v:.6f}" for v in x.sum(0)) + " 50"
    row2 = " ".join(f"{v:.6f}" for v in (x * x).sum(0)) + " 0"
    (path / "cmvn.ark").write_text(f" [ {row1}\n{row2} ]\n")
    (path / "dict.txt").write_text("\n".join(f"tok{i} {i}" for i in range(TINY.vocab_size)) + "\n")
    (path / "train_bpe1000.model").write_bytes(b"spm")
    return path, TINY


def test_firered_checkpoint_cmvn_config_and_params_bitwise(tmp_path):
    from asr_tpu.loaders import firered as jl
    from asr_tpu_torch.loaders import firered as tl

    src, tiny = write_firered_folder(tmp_path / "fr")
    jsd, jargs = jl.load_checkpoint(src / "model.pth.tar")
    tsd, targs = tl.load_checkpoint(src / "model.pth.tar")
    assert jargs == targs and list(jsd) == list(tsd)
    jm, ji = jl.parse_kaldi_cmvn_stats(src / "cmvn.ark")
    tm, ti = tl.parse_kaldi_cmvn_stats(src / "cmvn.ark")
    assert jm.tobytes() == tm.tobytes() and ji.tobytes() == ti.tobytes()
    kw = {k: getattr(tiny, k) for k in ("enc_heads", "dec_heads")}
    jcfg, tcfg = jl.config_from_state_dict(jsd, **kw), tl.config_from_state_dict(tsd, **kw)
    same_config(jcfg, tcfg)
    assert_same_tree(jl.firered_params_from_state_dict(jsd, jcfg, jm, ji),
                     tl.firered_params_from_state_dict(tsd, tcfg, tm, ti))
    assert_same_tree(jl.firered_params_from_state_dict(jsd, jcfg),
                     tl.firered_params_from_state_dict(tsd, tcfg))


# ── Dolphin (espnet) ────────────────────────────────────────────────────────
def dolphin_configs():
    from asr_tpu.models import dolphin as jd
    from asr_tpu_torch.models import dolphin as td

    kw = dict(vocab_size=60, d_model=32, enc_layers=1, enc_heads=4, enc_ffn=48, cgmlp_dim=64,
              csgu_kernel=5, fusion_kernel=3, dec_layers=1, dec_heads=4, dec_ffn=48, sos_id=50,
              eos_id=51, max_target_positions=16)
    return jd.DolphinConfig(**kw), td.DolphinConfig(**kw)


def test_dolphin_espnet_params_bitwise():
    from asr_tpu.loaders import dolphin_espnet as jl
    from asr_tpu_torch.loaders import dolphin_espnet as tl
    from tests.test_loaders import _dolphin_sd

    jcfg, tcfg = dolphin_configs()
    sd = _dolphin_sd(jcfg, np.random.default_rng(7))
    assert_same_tree(jl.params_from_state_dict(sd, jcfg), tl.params_from_state_dict(sd, tcfg))


# ── Parakeet-TDT (HF) ───────────────────────────────────────────────────────
def parakeet_state_dict(seed: int = 5):
    """A parakeet-tdt snapshot's keys: an HF ParakeetEncoder under
    ``encoder.``, the projector, the LSTM predictor and the joint head."""
    from tests.test_parakeet import TINY

    enc_cfg = transformers.ParakeetEncoderConfig(
        hidden_size=TINY.d_model, num_hidden_layers=TINY.num_layers,
        num_attention_heads=TINY.num_heads, intermediate_size=TINY.ffn_dim,
        conv_kernel_size=TINY.conv_kernel, subsampling_factor=8,
        subsampling_conv_channels=TINY.sub_channels, num_mel_bins=80,
        subsampling_conv_kernel_size=3, subsampling_conv_stride=2)
    torch.manual_seed(seed)
    sd = {f"encoder.{k}": v for k, v in transformers.ParakeetEncoder(enc_cfg).state_dict().items()}
    rng = np.random.default_rng(seed)
    h, d = TINY.dec_hidden, TINY.d_model
    sd["encoder_projector.weight"], sd["encoder_projector.bias"] = _t(rng, h, d), _t(rng, h)
    for li in range(TINY.lstm_layers):
        sd[f"decoder.lstm.weight_ih_l{li}"] = _t(rng, 4 * h, h)
        sd[f"decoder.lstm.weight_hh_l{li}"] = _t(rng, 4 * h, h)
        sd[f"decoder.lstm.bias_ih_l{li}"] = _t(rng, 4 * h)
        sd[f"decoder.lstm.bias_hh_l{li}"] = _t(rng, 4 * h)
    sd["decoder.embedding.weight"] = _t(rng, TINY.vocab_size, h)
    sd["decoder.decoder_projector.weight"], sd["decoder.decoder_projector.bias"] = _t(rng, h, h), _t(rng, h)
    n_out = TINY.vocab_size + len(TINY.durations)
    sd["joint.head.weight"], sd["joint.head.bias"] = _t(rng, n_out, h), _t(rng, n_out)
    return sd, TINY


def test_parakeet_hf_params_bitwise():
    from asr_tpu.loaders import parakeet_hf as jl
    from asr_tpu_torch.loaders import parakeet_hf as tl
    from asr_tpu_torch.models.parakeet import ParakeetConfig

    sd, tiny = parakeet_state_dict()
    tcfg = ParakeetConfig(**{k: v for k, v in tiny.__dict__.items() if k != "mel"})
    assert_same_tree(jl.tdt_params_from_state_dict(sd, tiny), tl.tdt_params_from_state_dict(sd, tcfg))
    enc = {k.removeprefix("encoder."): v for k, v in sd.items() if k.startswith("encoder.")}
    assert_same_tree(jl.encoder_params_from_state_dict(enc, tiny),
                     tl.encoder_params_from_state_dict(enc, tcfg))


# ── Nemotron (.nemo) ────────────────────────────────────────────────────────
def test_nemotron_archive_config_and_params_bitwise(tmp_path):
    from asr_tpu.loaders import nemotron_nemo as jl
    from asr_tpu_torch.loaders import nemotron_nemo as tl
    from tests.test_nemotron_loader import TINY, _nemotron_sd, _write_nemo

    nemo = _write_nemo(tmp_path, TINY, _nemotron_sd(TINY, np.random.default_rng(0)))
    jsd, jyaml, jassets = jl.read_nemo_archive(nemo, tmp_path / "j")
    tsd, tyaml, tassets = tl.read_nemo_archive(nemo, tmp_path / "t")
    assert jyaml == tyaml and list(jsd) == list(tsd)
    assert {k: v.name for k, v in jassets.items()} == {k: v.name for k, v in tassets.items()}
    for chunk_ms in (0, 150, 560):
        same_config(jl.config_from_model_config(jyaml, chunk_ms), tl.config_from_model_config(tyaml, chunk_ms))
        ctx = jyaml["encoder"]["att_context_size"]
        assert jl.select_att_context(ctx, chunk_ms, 80.0) == tl.select_att_context(ctx, chunk_ms, 80.0)
    jcfg, tcfg = jl.config_from_model_config(jyaml), tl.config_from_model_config(tyaml)
    assert_same_tree(jl.nemotron_params_from_state_dict(jsd, jcfg), tl.nemotron_params_from_state_dict(tsd, tcfg))


# ── X-ASR Zipformer2 (icefall) ──────────────────────────────────────────────
def test_zipformer_baking_helpers_bitwise():
    """The streaming tables are baked in numpy f64: the port's copy gives the
    same bytes."""
    from asr_tpu.loaders import zipformer_icefall as jl
    from asr_tpu_torch.loaders import zipformer_icefall as tl

    rng = np.random.default_rng(2)
    for seq, left in ((8, 16), (16, 64), (5, 0)):
        pos = jl.streaming_positions(seq, left)
        assert pos.tobytes() == tl.streaming_positions(seq, left).tobytes()
        for length_factor in (1.0, 2.0):
            a = jl.compact_rel_positional_encoding(pos, 48, length_factor)
            b = tl.compact_rel_positional_encoding(pos, 48, length_factor)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        w = rng.standard_normal((2 * 4, 48)).astype(np.float32)
        assert jl.build_pos_table(w, seq, left, 2, 4).tobytes() == tl.build_pos_table(w, seq, left, 2, 4).tobytes()
    c, kernel = 5, 7
    param = rng.standard_normal((2, c, kernel)).astype(np.float32)
    for seq in (4, 10):
        assert jl.chunk_scale(param, seq).tobytes() == tl.chunk_scale(param, seq).tobytes()
    args = (rng.standard_normal((c, kernel // 2 + 1)).astype(np.float32), rng.standard_normal(c).astype(np.float32),
            rng.standard_normal((c, kernel)).astype(np.float32), rng.standard_normal(c).astype(np.float32),
            jl.chunk_scale(param, 8))
    for a, b in zip(jl.fuse_streaming_conv(*args), tl.fuse_streaming_conv(*args)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_zipformer_params_bitwise_with_sorted_keys():
    """The whole baked tree, keys in the JAX tree map's sorted order (the
    order weight de-duplication walks)."""
    from asr_tpu.loaders import zipformer_icefall as jl
    from asr_tpu_torch.loaders import zipformer_icefall as tl
    from asr_tpu_torch.models.zipformer import ZipformerConfig
    from tests.test_zipformer_loader import TINY, _synthetic_state_dict

    sd = _synthetic_state_dict(TINY)
    jp = jl.zipformer_params_from_state_dict(sd, TINY)
    tp = tl.zipformer_params_from_state_dict(sd, ZipformerConfig(**dataclasses.asdict(TINY)))
    assert_same_tree(jp, tp)
    assert list(jart.flatten_pytree(jp)) == list(tart.flatten_pytree(tp))
    assert tp["embed"]["out_norm_log_scale"].shape == ()


def test_asarray_narrows_as_jax_does():
    """The port's stand-in for ``jnp.asarray``: 64-bit types narrow as JAX
    narrows them with 64-bit types off; every other dtype stays."""
    import jax.numpy as jnp

    from asr_tpu_torch.loaders._common import asarray

    for value in (np.ones(3, np.float64), np.arange(3, dtype=np.int64), np.arange(3, dtype=np.uint64),
                  np.ones(2, np.float16), np.ones(2, np.float32), np.array([True, False]),
                  np.arange(4, dtype=np.int8), 1.5, 3):
        want = np.asarray(jnp.asarray(value))
        got = asarray(value)
        assert got.numpy().dtype == want.dtype and got.numpy().tobytes() == want.tobytes()
