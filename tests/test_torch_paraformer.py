"""PyTorch port: Paraformer (the compensated cumsum, integrate-and-fire,
the predictor, the non-AR decoder, the forward and the session) against the
JAX package at its tests' tiny geometry.

Tolerances: the compensated prefix sums bitwise (the same Neumaier steps in
f32), so the fire positions and counts are equal; the fired embeddings
within 1e-5 of max|reference|; f32 model values within 1e-4 of
max|reference| (JAX at ``highest`` precision); ids and counts of the
forward exactly, in f32 and q8 (``mm="f32"``: JAX's exact CPU product) on
a padded batch of two.
"""

import dataclasses
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.decode import cif as jcif
from asr_tpu.models import paraformer as jpf
from asr_tpu.ops import quant_matmul as jqm
from asr_tpu.quant.quantize import quantize_pytree as jquantize_pytree
from asr_tpu.runtime import artifact as jart
from asr_tpu.runtime import transducer_session as jts
from asr_tpu_torch.decode import cif as tcif
from asr_tpu_torch.models import paraformer as tpf
from asr_tpu_torch.ops import quant_matmul as tqm
from asr_tpu_torch.runtime import artifact as tart
from asr_tpu_torch.runtime import transducer_session as tts
from asr_tpu_torch.runtime.metadata import config_from_dict

TINY = dict(vocab_size=50, hidden=32, num_heads=4, head_dim=8, ffn_dim=48, num_encoders0=1,
            num_encoders=2, num_decoders=2, num_decoder_ffn=1, fsmn_kernel=5, predictor_kernel=3)
TOL = 1e-4
EMBED_TOL = 1e-5


@pytest.fixture(autouse=True)
def _modes():
    prev, jprev, threads = tqm._CONFIG["mm"], dict(jqm._CONFIG), torch.get_num_threads()
    torch.set_num_threads(2)
    tqm.set_quant_config(mm="f32")
    jqm.set_quant_config(mm="f32")
    yield
    tqm._CONFIG["mm"] = prev
    jqm._CONFIG.update(jprev)
    torch.set_num_threads(threads)


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-6))


def _models(quant: str = "f32", seed: int = 0, **over):
    """(JAX cfg, JAX params, port cfg, port params): f32 or the whole tree q8,
    with random CMVN and predictor biases (the init has zeros and ones)."""
    jcfg, tcfg = jpf.ParaformerConfig(**{**TINY, **over}), tpf.ParaformerConfig(**{**TINY, **over})
    jp = jpf.init_params(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    fs = jcfg.feature_size
    jp["cmvn_means"] = jnp.asarray(-8.0 + 0.5 * rng.standard_normal(fs), jnp.float32)
    jp["cmvn_istd"] = jnp.asarray(0.25 + 0.05 * rng.random(fs), jnp.float32)
    jp["predictor"]["out"]["b"] = jnp.asarray([0.3], jnp.float32)
    if quant == "q8":
        jp = jquantize_pytree(jp, bits=8, block=128, min_size=1024, refine_iters=0)
    return jcfg, jp, tcfg, tart.params_from_flat(jart.flatten_pytree(jp), "cpu")


def _audio(seed, batch=1, n=16000):
    return (np.random.default_rng(seed).standard_normal((batch, n)) * 2000).astype(np.float32)


# ── the compensated cumsum and integrate-and-fire ─────────────────────────
def test_compensated_cumsum_bitwise_jax():
    x = np.random.default_rng(0).random((3, 257, 5)).astype(np.float32)
    for axis in (1, -1, 0):
        np.testing.assert_array_equal(tcif.compensated_cumsum(torch.from_numpy(x), axis).numpy(),
                                      np.asarray(jcif.compensated_cumsum(jnp.asarray(x), axis)))


def _near_boundary_alphas() -> np.ndarray:
    """499 alphas of 0.002, whose running f32 sum drifts ~97 ulps low, then
    one planted to bring the exact prefix a fifth of that drift above 1."""
    a = np.full(499, 0.002, np.float32)
    exact = np.cumsum(a.astype(np.float64))[-1]
    drift = np.cumsum(a, dtype=np.float32)[-1] - exact
    return np.append(a, np.float32(1.0 - exact + 0.2 * abs(drift)))


def test_near_boundary_fire_needs_the_compensation():
    """A plain f32 running sum (numpy's sequential f32 cumsum, the sum torch
    forms for f32 on a card) stays below 1 at the last frame and misses the
    fire; f64, JAX's compensated scan and the port's all fire there."""
    a = _near_boundary_alphas()
    assert np.floor(np.cumsum(a, dtype=np.float32))[-1] == 0.0
    assert np.floor(np.cumsum(a.astype(np.float64)))[-1] == 1.0
    got = tcif.compensated_cumsum(torch.from_numpy(a), 0).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcif.compensated_cumsum(jnp.asarray(a), 0)))
    assert np.floor(got[-1]) == 1.0
    hidden = np.random.default_rng(1).standard_normal((1, len(a), 4)).astype(np.float32)
    for mod, t in ((jcif, jnp.asarray), (tcif, torch.from_numpy)):
        emb, cnt = mod.cif_fire(t(a[None]), t(hidden), t(np.array([len(a)])), 4, 0.45)
        assert int(np.asarray(cnt)[0]) == 1


CIF_CASES = {  # name: (b, t, valid, max_tokens, alpha scale)
    "padded_batch": (3, 40, [40, 23, 1], 32, 1.0),
    "max_tokens_overflow": (2, 40, [40, 31], 6, 1.0),
    "no_frames": (2, 12, [0, 12], 8, 0.6),
}


@pytest.mark.parametrize("case", list(CIF_CASES))
def test_cif_fire_positions_equal_jax(case):
    b, t, valid, max_tokens, scale = CIF_CASES[case]
    rng = np.random.default_rng(2)
    alphas = (rng.random((b, t)) * scale).astype(np.float32)
    hidden = rng.standard_normal((b, t, 6)).astype(np.float32)
    je, jc = jcif.cif_fire(jnp.asarray(alphas), jnp.asarray(hidden), jnp.asarray(valid), max_tokens, 0.45)
    te, tc = tcif.cif_fire(torch.from_numpy(alphas), torch.from_numpy(hidden), torch.tensor(valid),
                           max_tokens, 0.45)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert te.shape == je.shape == (b, max_tokens, 6)
    _close(te.numpy(), je, EMBED_TOL)
    # the fire positions: the floors of the two packages' prefix sums
    ext = np.zeros((b, t + 1), np.float32)
    for i, n in enumerate(valid):
        ext[i, :n] = alphas[i, :n]
        ext[i, n] = 0.45
    np.testing.assert_array_equal(np.floor(tcif.compensated_cumsum(torch.from_numpy(ext), 1).numpy()),
                                  np.floor(np.asarray(jcif.compensated_cumsum(jnp.asarray(ext), 1))))
    if case == "max_tokens_overflow":
        assert (tc.numpy() == max_tokens).all() and np.floor(ext.sum(1)).min() > max_tokens + 1


# ── the model ─────────────────────────────────────────────────────────────
def test_config_and_init_layout_match_jax():
    assert dataclasses.asdict(jpf.ParaformerConfig()) == dataclasses.asdict(tpf.ParaformerConfig())
    tcfg = tpf.ParaformerConfig(**TINY)
    assert config_from_dict(tpf.ParaformerConfig, dataclasses.asdict(tcfg)) == tcfg
    jflat = jart.flatten_pytree(jpf.init_params(jpf.ParaformerConfig(**TINY), jax.random.PRNGKey(0)))
    tflat = tart.flatten_pytree(tpf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu"))
    assert {k: v.shape for k, v in jflat.items()} == {k: v.shape for k, v in tflat.items()}


def test_predictor_and_decoder_match_jax():
    jcfg, jp, tcfg, tp = _models("f32", seed=3)
    rng = np.random.default_rng(4)
    enc = rng.standard_normal((2, 17, 32)).astype(np.float32)
    valid = np.array([17, 9])
    ja = jpf.predict_alphas(jp, jcfg, jnp.asarray(enc), jnp.asarray(valid))
    ta = tpf.predict_alphas(tp, tcfg, torch.from_numpy(enc), torch.from_numpy(valid))
    _close(ta.numpy(), ja)
    assert not ta[1, 9:].any()
    emb = rng.standard_normal((2, 7, 32)).astype(np.float32)
    counts = np.array([7, 3])
    jl = jpf.decode_tokens(jp, jcfg, jnp.asarray(emb), jnp.asarray(counts), jnp.asarray(enc), jnp.asarray(valid))
    tl = tpf.decode_tokens(tp, tcfg, torch.from_numpy(emb), torch.from_numpy(counts), torch.from_numpy(enc),
                           torch.from_numpy(valid))
    for i, n in enumerate(counts):
        _close(tl[i, :n].numpy(), np.asarray(jl)[i, :n])


@pytest.mark.parametrize("quant", ["f32", "q8"])
def test_forward_matches_jax_on_a_padded_batch(quant):
    jcfg, jp, tcfg, tp = _models(quant, seed=1)
    if quant == "q8":
        assert type(tp["output"]["w"]).__name__ == "QuantizedLinear"
        assert isinstance(tp["predictor"]["conv"]["w"], torch.Tensor)  # kept f32 by its parent
    audio = _audio(5, batch=2, n=16000)
    valid = np.array([16000, 9000])
    _, jf, jv = jpf.frontend_features(jp, jcfg, jnp.asarray(audio), jnp.asarray(valid, jnp.int32))
    _, tf, tv = tpf.frontend_features(tp, tcfg, torch.from_numpy(audio), torch.from_numpy(valid))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    je = jpf.encode(jp, jcfg, jf, jv)
    te = tpf.encode(tp, tcfg, tf, tv)
    for i, n in enumerate(tv.tolist()):
        _close(tf[i, :n].numpy(), np.asarray(jf)[i, :n])
        _close(te[i, :n].numpy(), np.asarray(je)[i, :n])
    jt, jc = jpf.forward(jp, jcfg, jnp.asarray(audio), jnp.asarray(valid, jnp.int32), max_tokens=24)
    tt, tc = tpf.forward(tp, tcfg, torch.from_numpy(audio), torch.from_numpy(valid), max_tokens=24)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tc.min() > 0


def test_session_transcribes_a_file_of_two_windows_as_jax(tmp_path):
    jcfg, jp, tcfg, tp = _models("f32", seed=2)
    pcm = np.clip(np.random.default_rng(8).standard_normal(int(1.6 * 16000)) * 3000, -32768, 32767)
    path = tmp_path / "a.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.astype(np.int16).tobytes())
    jsess = jts.ParaformerSession(jp, jcfg, max_tokens=16, window_seconds=1.0)
    tsess = tts.ParaformerSession(tp, tcfg, max_tokens=16, window_seconds=1.0)
    assert tsess.pcm_scale == jsess.pcm_scale == 32768.0
    want, got = jsess.transcribe(str(path)), tsess.transcribe(str(path))
    assert got.token_ids == want.token_ids and len(got.token_ids) > 0
