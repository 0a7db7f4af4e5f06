"""PyTorch port: Whisper end to end (log-mel, encoder, prefill and step
logits, the window pipeline on both decode routes, the session, artifact
folders with quantized embeddings) against the JAX package at a tiny
geometry, plus the check that the Whisper path never imports JAX or the JAX
package.

The per-weight path runs in the port's ``mm="f32"`` mode, the JAX package's
exact CPU product, so logits agree to f32 rounding (1e-4 of max|logit|;
measured below 1e-5). The fused route rounds as the JAX interpret kernel
does, and greedy ids are compared exactly.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.decode.ar import DecodeConfig as JaxDecodeConfig
from asr_tpu.frontend import whisper_mel as jmel
from asr_tpu.models import whisper as jwh
from asr_tpu.ops.fused_aed_step import stack_whisper_step_params as jstack
from asr_tpu.quant.quantize import quantize_pytree as jquantize_pytree
from asr_tpu.runtime import artifact as jart
from asr_tpu.runtime import whisper_session as jws
from asr_tpu.runtime.metadata import LanguageProfile, ModelMetadata, config_from_dict
from asr_tpu_torch.decode.ar import DecodeConfig
from asr_tpu_torch.frontend import whisper_mel as tmel
from asr_tpu_torch.layers import transformer as ttr
from asr_tpu_torch.models import whisper as twh
from asr_tpu_torch.ops import fused_aed_step as tfs
from asr_tpu_torch.ops import quant_matmul as tqm
from asr_tpu_torch.quant.quantize import QuantizedEmbedding, dequantize_pytree
from asr_tpu_torch.runtime import artifact as tart
from asr_tpu_torch.runtime import whisper_session as tws

REPO = Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=64, d_model=256, encoder_layers=1, decoder_layers=2, num_heads=4,
            ffn_dim=1024, n_mels=16, max_source_positions=24, max_target_positions=16,
            sot_id=1, eot_id=0, no_speech_id=2, first_language_id=8, num_languages=4,
            no_timestamps_id=7, transcribe_id=6, translate_id=5)
WINDOW_S = 48 * 160 / 16000  # 48 mel frames -> 24 encoder rows, the tiny max_source_positions
TOL = 1e-4


@pytest.fixture(autouse=True)
def _torch_mode():
    prev, mm = torch.get_num_threads(), tqm._CONFIG["mm"]
    torch.set_num_threads(2)
    tqm.set_quant_config(mm="f32")
    yield
    tqm._CONFIG["mm"] = mm
    torch.set_num_threads(prev)


def _models(quantized: bool, seed: int = 0, **over):
    jcfg, tcfg = jwh.WhisperConfig(**{**TINY, **over}), twh.WhisperConfig(**{**TINY, **over})
    jp = jwh.init_params(jcfg, jax.random.PRNGKey(seed))
    if quantized:
        jp = jquantize_pytree(jp, bits=8, block=128, min_size=0, refine_iters=0,
                              quantize_embeddings=True)
    return jcfg, jp, tcfg, tart.params_from_flat(jart.flatten_pytree(jp), "cpu")


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-6))


def test_config_fields_match():
    for jc, tc in ((jwh.WhisperConfig, twh.WhisperConfig), (jmel.WhisperMelConfig, tmel.WhisperMelConfig),
                   (jws.WhisperSessionConfig, tws.WhisperSessionConfig)):
        assert ([(f.name, f.default) for f in dataclasses.fields(jc)]
                == [(f.name, f.default) for f in dataclasses.fields(tc)])
    cfg = twh.WhisperConfig(**TINY)
    assert config_from_dict(twh.WhisperConfig, dataclasses.asdict(cfg)) == cfg
    assert cfg.mel_config() == tmel.WhisperMelConfig(n_mels=16)


@pytest.mark.parametrize("n_mels,samples,scale", [(128, 16000, 1.0), (80, 7000, 1.0),
                                                  (16, 4800, 1 / 32768)])
def test_log_mel_matches_jax(n_mels, samples, scale):
    np.testing.assert_array_equal(tmel.hann_window_periodic(400), jmel.hann_window_periodic(400))
    jcfg = jmel.WhisperMelConfig(n_mels=n_mels, input_scale=scale)
    tcfg = tmel.WhisperMelConfig(n_mels=n_mels, input_scale=scale)
    audio = np.random.default_rng(n_mels).standard_normal((2, samples)).astype(np.float32)
    audio *= 0.1 if scale == 1.0 else 3000.0
    want = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(audio), jcfg))
    got = tmel.log_mel_spectrogram(torch.from_numpy(audio), tcfg).numpy()
    assert got.shape == want.shape == (2, samples // 160, n_mels)
    # log10 of a power spectrum: f32 DFT sums in another order -> 1e-4 absolute
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_init_params_layout_matches_jax():
    jcfg, tcfg = jwh.WhisperConfig(**TINY), twh.WhisperConfig(**TINY)
    jflat = jart.flatten_pytree(jwh.init_params(jcfg, jax.random.PRNGKey(0)))
    tflat = tart.flatten_pytree(twh.init_params(tcfg, torch.Generator().manual_seed(0), "cpu"))
    assert {k: v.shape for k, v in jflat.items()} == {k: v.shape for k, v in tflat.items()}
    assert all(v.dtype == np.float32 for v in tflat.values())


def test_conv1d_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 11, 5)).astype(np.float32)
    w = rng.standard_normal((3, 5, 7)).astype(np.float32)
    b = rng.standard_normal(7).astype(np.float32)
    for stride in (1, 2):
        want = jwh.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride)
        got = twh.conv1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), stride)
        _close(got.numpy(), want, 1e-6)


def test_split_and_merge_heads():
    x = torch.arange(2 * 3 * 8, dtype=torch.float32).reshape(2, 3, 8)
    assert ttr.split_heads(x, 4).shape == (2, 3, 4, 2)
    assert torch.equal(ttr.merge_heads(ttr.split_heads(x, 4)), x)


@pytest.mark.parametrize("quantized", [False, True])
def test_encode_prefill_and_step_match_jax(quantized):
    jcfg, jp, tcfg, tp = _models(quantized, seed=1)
    mel = np.random.default_rng(4).standard_normal((2, 48, 16)).astype(np.float32)
    je = jwh.encode(jp, jcfg, jnp.asarray(mel))
    te = twh.encode(tp, tcfg, torch.from_numpy(mel))
    assert te.shape == (2, 24, 256)
    _close(te.numpy(), je)
    prompt = np.array([[1, 9, 6, 7], [1, 10, 6, 7]], np.int64)
    js = jwh.make_state(jp, jcfg, je)
    ts = twh.make_state(tp, tcfg, torch.from_numpy(np.array(je)))
    jl, js = jwh.prefill(jp, jcfg, js, jnp.asarray(prompt, jnp.int32))
    tl, ts = twh.prefill(tp, tcfg, ts, torch.from_numpy(prompt))
    _close(tl.numpy(), jl)
    for i, tok in enumerate((5, 11, 3)):
        pos = 4 + i
        jl, js = jwh.step(jp, jcfg, js, jnp.full((2, 1), tok, jnp.int32), jnp.asarray(pos, jnp.int32))
        tl, ts = twh.step(tp, tcfg, ts, torch.full((2, 1), tok), pos)
        _close(tl.numpy(), jl)
    for jlay, tlay in zip(js["layers"], ts["layers"]):
        for k in ("self_k", "self_v", "cross_k", "cross_v"):
            _close(tlay[k].numpy(), jlay[k])
    lang = jwh.detect_language(jl, jcfg)
    np.testing.assert_array_equal(twh.detect_language(tl, tcfg).numpy(), np.asarray(lang))
    _close(twh.no_speech_prob(tl, tcfg).numpy(), jwh.no_speech_prob(jl, jcfg), 1e-5)


def test_bf16_kv_cache_matches_jax():
    jcfg, jp, tcfg, tp = _models(True, seed=2, kv_dtype="bfloat16")
    enc = np.random.default_rng(5).standard_normal((1, 24, 256)).astype(np.float32) * 0.3
    js = jwh.make_state(jp, jcfg, jnp.asarray(enc))
    ts = twh.make_state(tp, tcfg, torch.from_numpy(enc))
    assert ts["layers"][0]["self_k"].dtype == ts["layers"][0]["cross_v"].dtype == torch.bfloat16
    jl, js = jwh.prefill(jp, jcfg, js, jnp.asarray([[1, 9, 6, 7]], jnp.int32))
    tl, ts = twh.prefill(tp, tcfg, ts, torch.tensor([[1, 9, 6, 7]]))
    _close(tl.numpy(), jl)
    jl, _ = jwh.step(jp, jcfg, js, jnp.asarray([[5]], jnp.int32), jnp.asarray(4, jnp.int32))
    tl, _ = twh.step(tp, tcfg, ts, torch.tensor([[5]]), 4)
    _close(tl.numpy(), jl)


def _window_inputs(seed, batch):
    mel = np.random.default_rng(seed).standard_normal((batch, 48, 16)).astype(np.float32)
    prompt = np.tile(np.array([[1, -1, 6, 7]], np.int64), (batch, 1))
    return mel, prompt


@pytest.mark.parametrize("batch", [1, 2])
def test_transcribe_window_per_weight_route_matches_jax(batch):
    jcfg, jp, tcfg, tp = _models(True, seed=3)
    mel, prompt = _window_inputs(6, batch)
    kw = dict(max_new_tokens=8, eot_id=13, suppress_ids=(2, 3))
    want = jwh.transcribe_window(jp, jcfg, jnp.asarray(mel), jnp.asarray(prompt, jnp.int32),
                                 JaxDecodeConfig(**kw), begin_suppress_ids=(4,))
    got = twh.transcribe_window(tp, tcfg, torch.from_numpy(mel), torch.from_numpy(prompt),
                                DecodeConfig(**kw), begin_suppress_ids=(4,))
    for k in ("tokens", "counts", "language"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    _close(got["no_speech_prob"].numpy(), want["no_speech_prob"], 1e-5)


def test_transcribe_window_fused_route_matches_jax():
    """The fused route (the plain version of the kernel on the CPU) against
    JAX's fused route in interpret mode, and both against the per-weight route."""
    jcfg, jp, tcfg, tp = _models(True, seed=2)
    mel, prompt = _window_inputs(4, 1)
    kw = dict(max_new_tokens=6, eot_id=-1)
    jmel_, jprompt = jnp.asarray(mel), jnp.asarray(prompt, jnp.int32)
    want = jwh.transcribe_window(jp, jcfg, jmel_, jprompt, JaxDecodeConfig(**kw),
                                 stacked=jstack(jp, jcfg), fused_interpret=True)
    stacked = tfs.stack_whisper_step_params(tp, tcfg)
    before = tfs.LAUNCHES
    got = twh.transcribe_window(tp, tcfg, torch.from_numpy(mel), torch.from_numpy(prompt),
                                DecodeConfig(**kw), stacked=stacked)
    per_weight = twh.transcribe_window(tp, tcfg, torch.from_numpy(mel), torch.from_numpy(prompt),
                                       DecodeConfig(**kw))
    assert tfs.LAUNCHES == before  # the CPU runs the plain version
    for k in ("tokens", "counts", "language"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        np.testing.assert_array_equal(per_weight[k].numpy(), got[k].numpy(), err_msg=k)
    assert int(got["counts"][0]) == 7


def _session_cfg(**kw):
    return dict(max_new_tokens=8, no_speech_threshold=None, **kw)


@pytest.mark.parametrize("samples", [3000, 17000])  # 1 window; 3 windows -> bucket 4
def test_session_transcribe_matches_jax_session(samples):
    jcfg, jp, tcfg, tp = _models(True, seed=4)
    audio = (np.random.default_rng(samples).standard_normal(samples) * 0.1).astype(np.float32)
    want = jws.WhisperSession(jp, jcfg, session_cfg=jws.WhisperSessionConfig(**_session_cfg()),
                              window_seconds=WINDOW_S).transcribe(audio)
    sess = tws.WhisperSession(tp, tcfg, session_cfg=tws.WhisperSessionConfig(**_session_cfg()),
                              window_seconds=WINDOW_S)
    assert sess.stacked is None  # parameters on the CPU: no stacked copy
    got = sess.transcribe(audio)
    assert got.token_ids == want.token_ids and len(got.token_ids) > 0
    assert got.audio_seconds == want.audio_seconds


def _whisper_meta(cfg):
    return ModelMetadata(family="whisper", extra={
        "config": dataclasses.asdict(cfg), "suppress_tokens": [2, 3], "begin_suppress_tokens": [4]},
        supported_languages=[LanguageProfile("en", "English", prompt_token_id=9),
                             LanguageProfile("xx", "none")])


def test_load_whisper_session_from_jax_artifact(tmp_path):
    jcfg, jp, tcfg, _ = _models(True, seed=5)
    jart.save_model(tmp_path, jp, _whisper_meta(jcfg))
    sess = tws.load_whisper_session(tmp_path, "cpu", window_seconds=WINDOW_S)
    assert sess.cfg == tcfg
    assert sess.scfg.suppress_ids == (2, 3) and sess.scfg.begin_suppress_ids == (4,)
    assert sess.language_id_map == {"en": 9}
    assert isinstance(sess.params["decoder"]["embed"], QuantizedEmbedding)
    sess.scfg.max_new_tokens = 8
    jsess = jws.WhisperSession(jp, jcfg, session_cfg=jws.WhisperSessionConfig(
        **_session_cfg(suppress_ids=(2, 3), begin_suppress_ids=(4,))),
        language_id_map={"en": 9}, window_seconds=WINDOW_S)
    audio = (np.random.default_rng(8).standard_normal(6000) * 0.1).astype(np.float32)
    sess.scfg.no_speech_threshold = None
    for lang in (None, "en"):
        assert sess.transcribe(audio, language=lang).token_ids == \
            jsess.transcribe(audio, language=lang).token_ids
    with pytest.raises(KeyError):
        sess.transcribe(audio, language="fr")
    jart.save_model(tmp_path / "sv", jp, ModelMetadata(family="sensevoice"))
    with pytest.raises(ValueError):
        tws.load_whisper_session(tmp_path / "sv", "cpu")


def test_qembed_artifacts_round_trip_both_ways(tmp_path):
    jcfg, jp, tcfg, tp = _models(True, seed=6)
    emb = tp["decoder"]["embed"]
    assert emb.q_t.shape == (256, 512) and emb.bits == 8 and emb.block == 128
    # JAX-written folder -> port: the stored leaves are equal and the tied copy is derived.
    jart.save_model(tmp_path / "jax", jp, _whisper_meta(jcfg))
    params, _ = tart.load_model(tmp_path / "jax", "cpu")
    want, got = jart.flatten_pytree(jp), tart.flatten_pytree(params)
    assert sorted(got) == sorted(want)
    assert "decoder/embed/__qembed__/tied" in got
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    jemb = jp["decoder"]["embed"]
    for k in ("q_t", "scale_t", "zero_t"):
        np.testing.assert_array_equal(getattr(params["decoder"]["embed"], k).numpy(),
                                      np.asarray(getattr(jemb, k)), err_msg=k)
    # Port-written folder -> JAX and back to the port.
    tart.save_model(tmp_path / "port", tp, _whisper_meta(tcfg))
    jparams, _ = jart.load_model(tmp_path / "port")
    jflat = jart.flatten_pytree(jparams)
    assert sorted(jflat) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(jflat[k], v, err_msg=k)
    back, _ = tart.load_model(tmp_path / "port", "cpu")
    np.testing.assert_array_equal(back["decoder"]["embed"].q_t.numpy(), emb.q_t.numpy())


def test_quantized_embedding_matches_jax():
    _, jp, _, tp = _models(True, seed=7)
    jemb, temb = jp["decoder"]["embed"], tp["decoder"]["embed"]
    ids = np.array([[0, 5, 63], [7, 7, 1]])
    np.testing.assert_array_equal(temb[torch.from_numpy(ids)].numpy(), np.asarray(jemb[jnp.asarray(ids)]))
    np.testing.assert_array_equal(temb.dequant().numpy(), np.asarray(jemb.dequant()))
    np.testing.assert_array_equal(dequantize_pytree(tp)["decoder"]["embed"].numpy(),
                                  np.asarray(jemb.dequant()))
    y = np.random.default_rng(9).standard_normal((2, 3, 256)).astype(np.float32)
    from asr_tpu.quant.quantize import embedding_logits as jlogits
    from asr_tpu_torch.quant.quantize import embedding_logits as tlogits

    want = np.asarray(jlogits(jemb, jnp.asarray(y)))
    _close(tlogits(temb, torch.from_numpy(y)).numpy(), want)  # the tied copy, through quant_dense
    untied = QuantizedEmbedding(temb.q, temb.scale, temb.zero, temb.bits, temb.block)
    _close(tlogits(untied, torch.from_numpy(y)).numpy(), want)  # the blockwise form


def test_quantize_pytree_embeddings_match_jax():
    from asr_tpu_torch.quant.quantize import quantize_pytree, tied_head_arrays

    jcfg, jp, tcfg, tp = _models(False, seed=8)
    want = jart.flatten_pytree(jquantize_pytree(jp, bits=8, block=128, min_size=4096,
                                                quantize_embeddings=True))
    got = tart.flatten_pytree(quantize_pytree(tp, bits=8, block=128, min_size=4096,
                                              quantize_embeddings=True))
    assert sorted(got) == sorted(want)
    for k in want:
        if "__qembed__" in k:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the 4-bit tied head is nibble-packed, as the JAX package packs it
    from asr_tpu.quant.quantize import tied_head_arrays as jtied_head_arrays

    q = np.random.default_rng(8).integers(-128, -112, (256, 64)).astype(np.int8)
    s = np.random.default_rng(9).random((4, 64)).astype(np.float32)
    z = np.random.default_rng(10).integers(-128, -112, (4, 64)).astype(np.float32)
    got = tied_head_arrays(torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(z),
                           bits=4, block=64)
    want = jtied_head_arrays(jnp.asarray(q), jnp.asarray(s), jnp.asarray(z), bits=4, block=64)
    assert got[3] is True and want[3] is True
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_remove_repeated_tail_matches_jax():
    rng = np.random.default_rng(10)
    cases = [[1, 2, 3, 3, 3, 3], [5, 6, 7, 8, 7, 8, 7, 8], [1, 2, 3], []]
    cases += [list(rng.integers(0, 4, size=n)) for n in range(2, 30)]
    for ids in cases:
        ids = [int(i) for i in ids]
        assert tws.remove_repeated_tail(ids) == jws.remove_repeated_tail(ids)


_NO_JAX = """
import sys
import numpy as np, torch
from asr_tpu_torch.models import whisper as wh
from asr_tpu_torch.ops import fused_aed_step as fs
from asr_tpu_torch.quant.quantize import quantize_pytree
from asr_tpu_torch.runtime.whisper_session import WhisperSession, WhisperSessionConfig
cfg = wh.WhisperConfig(vocab_size=64, d_model=256, encoder_layers=1, decoder_layers=1, num_heads=4,
                       ffn_dim=256, n_mels=16, max_source_positions=24, max_target_positions=16,
                       sot_id=1, eot_id=0, no_speech_id=2, first_language_id=8, num_languages=4,
                       no_timestamps_id=7, transcribe_id=6, translate_id=5)
params = quantize_pytree(wh.init_params(cfg, torch.Generator().manual_seed(0), "cpu"), min_size=0,
                         quantize_embeddings=True)
assert fs.stack_whisper_step_params(params, cfg) is not None
sess = WhisperSession(params, cfg, session_cfg=WhisperSessionConfig(max_new_tokens=4),
                      window_seconds=0.48)
res = sess.transcribe(np.zeros(4000, np.float32))
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "asr_tpu"))
assert not leaked, leaked
print("NO_JAX_OK", len(res.token_ids))
"""


def test_whisper_path_never_imports_jax():
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX_OK" in proc.stdout
