"""PyTorch port: Parakeet-TDT and the pieces it brings (the LSTM stack, the
NeMo mel front end, the FastConformer block and subsampling, the TDT greedy
loop) against the JAX package at its tests' tiny geometry.

Tolerances: f32 values within 1e-4 of max|reference| (JAX at ``highest``
precision; the log-mel and its per-feature norm within 2e-4 absolute, the
DFT's sums run in another order), config, layout and valid counts exactly;
the greedy loop on a scripted joint (an exact table lookup) bitwise, ids and
counts, for every host-sync period tested; the forward's ids and counts
exactly, in f32 and q8 (``mm="f32"``: JAX's exact CPU product) on a padded
batch of two.
"""

import dataclasses
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.decode import tdt as jtdt
from asr_tpu.frontend import nemo_mel as jnm
from asr_tpu.layers import conformer as jconf
from asr_tpu.layers import lstm as jlstm
from asr_tpu.layers.attention import NEG_INF
from asr_tpu.models import parakeet as jpk
from asr_tpu.ops import quant_matmul as jqm
from asr_tpu.quant.quantize import quantize_pytree as jquantize_pytree
from asr_tpu.runtime import artifact as jart
from asr_tpu.runtime import transducer_session as jts
from asr_tpu_torch.decode import tdt as ttdt
from asr_tpu_torch.frontend import nemo_mel as tnm
from asr_tpu_torch.layers import conformer as tconf
from asr_tpu_torch.layers import lstm as tlstm
from asr_tpu_torch.models import parakeet as tpk
from asr_tpu_torch.ops import quant_matmul as tqm
from asr_tpu_torch.runtime import artifact as tart
from asr_tpu_torch.runtime import transducer_session as tts
from asr_tpu_torch.runtime.metadata import config_from_dict

TINY = dict(vocab_size=40, blank_id=39, d_model=64, num_layers=2, num_heads=4, ffn_dim=96, conv_kernel=9,
            sub_channels=32, dec_hidden=48, lstm_layers=2)
TOL = 1e-4
MEL_TOL = 2e-4
SYNC_PERIODS = (1, 3, 8, 64)


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


def _configs(**over):
    mel = dict(n_mels=80)
    return (jpk.ParakeetConfig(**{**TINY, **over}, mel=jnm.NemoMelConfig(**mel)),
            tpk.ParakeetConfig(**{**TINY, **over}, mel=tnm.NemoMelConfig(**mel)))


def _models(quant: str = "f32", seed: int = 0, **over):
    """(JAX cfg, JAX params, port cfg, port params): f32 or the whole tree q8."""
    jcfg, tcfg = _configs(**over)
    jp = jpk.init_params(jcfg, jax.random.PRNGKey(seed))
    if quant == "q8":
        jp = jquantize_pytree(jp, bits=8, block=128, min_size=1024, refine_iters=0)
    return jcfg, jp, tcfg, tart.params_from_flat(jart.flatten_pytree(jp), "cpu")


def _audio(seed, batch=1, n=16000):
    return (np.random.default_rng(seed).standard_normal((batch, n)) * 0.1).astype(np.float32)


# ── the LSTM stack ────────────────────────────────────────────────────────
@pytest.mark.parametrize("container", [tuple, list])
def test_lstm_step_stack_matches_jax(container):
    """Both the init's tuple and an artifact's list of layers."""
    rng = np.random.default_rng(0)
    layers = jlstm.init_lstm_params(jax.random.PRNGKey(1), 12, 16, 2)
    layers = [{k: np.asarray(v) + (0.1 * rng.standard_normal(v.shape).astype(np.float32) if k[0] == "b" else 0)
               for k, v in p.items()} for p in layers]
    x = rng.standard_normal((3, 12)).astype(np.float32)
    h = rng.standard_normal((2, 3, 16)).astype(np.float32)
    c = rng.standard_normal((2, 3, 16)).astype(np.float32)
    jy, jh, jc = jlstm.lstm_step_stack(jnp.asarray(x), jnp.asarray(h), jnp.asarray(c),
                                       tuple(jax.tree.map(jnp.asarray, p) for p in layers))
    tlayers = container({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in p.items()} for p in layers)
    ty, th, tc = tlstm.lstm_step_stack(torch.from_numpy(x), torch.from_numpy(h), torch.from_numpy(c), tlayers)
    for got, want in ((ty, jy), (th, jh), (tc, jc)):
        assert got.shape == want.shape
        _close(got.numpy(), want)


# ── the NeMo mel front end ────────────────────────────────────────────────
def test_mel_config_window_and_constants_match():
    assert ([(f.name, f.default) for f in dataclasses.fields(jnm.NemoMelConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(tnm.NemoMelConfig)])
    np.testing.assert_array_equal(tnm.hann_window_symmetric(400), jnm.hann_window_symmetric(400))
    for n_mels in (80, 128):
        jb, jm = jnm._nemo_constants(jnm.NemoMelConfig(n_mels=n_mels))
        tb, tm = tnm._nemo_constants(tnm.NemoMelConfig(n_mels=n_mels))
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tm, jm)


@pytest.mark.parametrize("n_mels,scale", [(80, 1.0), (128, 1 / 32768)])
def test_log_mel_and_per_feature_norm_on_a_padded_batch(n_mels, scale):
    jcfg, tcfg = jnm.NemoMelConfig(n_mels=n_mels, input_scale=scale), tnm.NemoMelConfig(n_mels=n_mels,
                                                                                          input_scale=scale)
    audio = _audio(2, batch=3, n=9000) * (1.0 if scale == 1.0 else 3e5)
    valid = np.array([9000, 5050, 150])  # the last: 0 valid frames (the count clamps at 2)
    audio[1, 5050:] = 0.0
    jmel = jnm.log_mel(jnp.asarray(audio), jcfg)
    tmel = tnm.log_mel(torch.from_numpy(audio), tcfg)
    assert tmel.shape == jmel.shape == (3, 9000 // 160, n_mels)
    np.testing.assert_allclose(tmel.numpy(), np.asarray(jmel), rtol=0, atol=MEL_TOL)
    jv = jcfg.valid_frames(jnp.asarray(valid))
    tv = tcfg.valid_frames(torch.from_numpy(valid))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # the same log-mel into both norms, then each norm's own output
    want = np.asarray(jnm.per_feature_norm(jmel, jv, jcfg.norm_eps))
    got = tnm.per_feature_norm(torch.from_numpy(np.array(jmel)), tv, tcfg.norm_eps).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())
    assert not got[1, int(tv[1]):].any() and not got[2].any()
    full = tnm.per_feature_norm(tmel, tv, tcfg.norm_eps).numpy()
    np.testing.assert_allclose(full, want, rtol=0, atol=MEL_TOL)


def test_log_mel_keeps_f32_exact_with_tf32_requested():
    """The DFT's products run at "highest" precision (TF32 off) whatever the
    process asks for, and the setting is restored."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        seen = []
        orig = torch.Tensor.__matmul__

        def spy(a, b):
            seen.append(torch.get_float32_matmul_precision())
            return orig(a, b)

        torch.Tensor.__matmul__ = spy
        try:
            tnm.log_mel(torch.from_numpy(_audio(3, n=1600)), tnm.NemoMelConfig(n_mels=80))
        finally:
            torch.Tensor.__matmul__ = orig
        assert seen == ["highest", "highest"]
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)


# ── the FastConformer block and subsampling ───────────────────────────────
def test_conformer_block_and_subsampling_with_a_key_mask():
    _, jp, _, _ = _models("f32", seed=3)
    rng = np.random.default_rng(4)
    # random norms, biases and BatchNorm affines, so each reaches the check
    flat = jart.flatten_pytree(jp)
    for k, v in flat.items():
        if k.endswith(("/b", "/bias", "/shift", "bias_u", "bias_v")):
            flat[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k.endswith(("/scale",)):
            flat[k] = (1 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    tp = tart.params_from_flat(flat, "cpu")
    feats = rng.standard_normal((2, 45, 80)).astype(np.float32)
    valid = np.array([45, 23])
    tx, tv = tconf.subsample_conv2d(torch.from_numpy(feats), tp["subsample"], torch.from_numpy(valid))
    jsub = _nest({k[len("subsample/"):]: jnp.asarray(a) for k, a in flat.items() if k.startswith("subsample/")})
    jx, jv = jconf.subsample_conv2d(jnp.asarray(feats), jsub, jnp.asarray(valid))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tx.shape == jx.shape == (2, 6, 64)
    for i, n in enumerate(tv.tolist()):
        _close(tx[i, :n].numpy(), np.asarray(jx)[i, :n])

    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    v = np.array([9, 4])
    pe = jconf.relative_position_embedding(9, 64)
    mask = np.arange(9)[None] < v[:, None]
    bias = np.where(mask, 0.0, NEG_INF)[:, None, None].astype(np.float32)
    jblock = _nest({k[len("blocks/0/"):]: jnp.asarray(a) for k, a in flat.items() if k.startswith("blocks/0/")})
    want = jconf.conformer_block(jnp.asarray(x), jblock, 4, jnp.asarray(pe), jnp.asarray(bias),
                                 jnp.asarray(mask))
    got = tconf.conformer_block(torch.from_numpy(x), tp["blocks"][0], 4, torch.from_numpy(pe),
                                torch.from_numpy(bias), torch.from_numpy(mask))
    for i, n in enumerate(v):
        _close(got[i, :n].numpy(), np.asarray(want)[i, :n])


def _nest(flat: dict) -> dict:
    """``{"a/b": x}`` -> ``{"a": {"b": x}}``."""
    out: dict = {}
    for key, value in flat.items():
        node = out
        *head, last = key.split("/")
        for p in head:
            node = node.setdefault(p, {})
        node[last] = value
    return out


# ── the TDT greedy loop on a scripted joint ───────────────────────────────
def _scripted(seed, b, t, v, nd, blank_p, stay=False):
    """Tables of a scripted joint: logits by (row * T + frame, last token);
    h counts the state updates, c adds the frame id. Everything is exact in
    f32, so JAX and torch pick the same argmax at every step. ``stay``: every
    duration is 0 (a token never leaves its frame)."""
    rng = np.random.default_rng(seed)
    tok = rng.standard_normal((b * t, v, v)).astype(np.float32)
    blank = rng.random((b * t, v)) < blank_p
    tok[..., v - 1] = np.where(blank, 10.0, -10.0)  # blank is the last id
    dur = rng.standard_normal((b * t, v, nd)).astype(np.float32)
    if stay:
        dur[..., 0] = 10.0
    enc = (np.arange(b)[:, None] * t + np.arange(t)[None, :]).astype(np.float32)[..., None]
    return tok, dur, enc


def _joint(mod, tok, dur, calls=None):
    def step(token, h, c, enc_frame):
        if calls is not None:
            calls.append(1)
        fid = enc_frame[:, 0].astype(mod.int32) if mod is jnp else enc_frame[:, 0].to(torch.int64)
        return tok[fid, token], dur[fid, token], h + 1, c + enc_frame[:, :1][None]
    return step


TDT_CASES = {  # name: (b, t, blank share, valid, max_tokens, max_symbols, eos_id, stay)
    "rows_end_apart": (3, 9, 0.4, [9, 5, 2], 40, 10, None, False),
    "stops_at_max_steps": (2, 4, 0.0, [4, 4], 64, 2, None, True),
    "stops_at_max_tokens": (2, 12, 0.2, [12, 7], 5, 10, None, False),
    "eos_and_zero_frames": (3, 6, 0.3, [6, 0, 3], 30, 4, 2, False),
}


@pytest.mark.parametrize("case", list(TDT_CASES))
def test_tdt_greedy_bitwise_jax_for_every_sync_period(case, monkeypatch):
    b, t, blank_p, valid, max_tokens, max_sym, eos, stay = TDT_CASES[case]
    v, durations = 6, (0, 1, 2, 4)
    tok, dur, enc = _scripted(7, b, t, v, len(durations), blank_p, stay)
    h0 = np.zeros((2, b, 3), np.float32)
    kw = dict(start_token=v - 1, blank_id=v - 1, durations=durations, max_tokens=max_tokens,
              max_symbols_per_step=max_sym, eos_id=eos)
    jbuf, jcnt = jtdt.tdt_greedy(_joint(jnp, jnp.asarray(tok), jnp.asarray(dur)), jnp.asarray(enc),
                                 jnp.asarray(valid, jnp.int32), jnp.asarray(h0), jnp.asarray(h0), **kw)
    tt = (torch.from_numpy(tok), torch.from_numpy(dur))
    first = None
    for k in SYNC_PERIODS:
        calls = []
        before = ttdt.SYNCS
        monkeypatch.setattr(ttdt, "SYNC_EVERY", k)
        buf, cnt = ttdt.tdt_greedy(_joint(torch, *tt, calls), torch.from_numpy(enc), torch.tensor(valid),
                                   torch.from_numpy(h0), torch.from_numpy(h0), **kw)
        np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
        steps = len(calls)
        first = first or steps  # k = 1: the per-step loop's step count
        assert steps == min(max_sym * t, -(-first // k) * k)  # never past JAX's max_steps
        assert ttdt.SYNCS - before == -(-steps // k)
    if case == "stops_at_max_steps":
        assert first == max_sym * t and (np.asarray(jcnt) < max_tokens).all()
    if case == "stops_at_max_tokens":
        assert (np.asarray(jcnt) == max_tokens).any()


# ── the model ─────────────────────────────────────────────────────────────
def test_config_and_init_layout_match_jax():
    assert dataclasses.asdict(jpk.ParakeetConfig()) == dataclasses.asdict(tpk.ParakeetConfig())
    assert [f.name for f in dataclasses.fields(jpk.ParakeetConfig)] == \
        [f.name for f in dataclasses.fields(tpk.ParakeetConfig)]
    jcfg, tcfg = _configs()
    assert config_from_dict(tpk.ParakeetConfig, dataclasses.asdict(tcfg)) == tcfg
    jflat = jart.flatten_pytree(jpk.init_params(jcfg, jax.random.PRNGKey(0)))
    tflat = tart.flatten_pytree(tpk.init_params(tcfg, torch.Generator().manual_seed(0), "cpu"))
    assert {k: v.shape for k, v in jflat.items()} == {k: v.shape for k, v in tflat.items()}


@pytest.mark.parametrize("quant", ["f32", "q8"])
def test_forward_matches_jax_on_a_padded_batch(quant):
    jcfg, jp, tcfg, tp = _models(quant, seed=1)
    if quant == "q8":
        assert type(tp["decoder"]["head"]["w"]).__name__ == "QuantizedLinear"
        assert isinstance(tp["decoder"]["lstm"][0]["w_ih"], torch.Tensor)  # the gates stay f32
    audio = _audio(5, batch=2, n=12000)
    valid = np.array([12000, 7000])
    je, jv = jpk.encode(jp, jcfg, jnp.asarray(audio), jnp.asarray(valid, jnp.int32))
    te, tv = tpk.encode(tp, tcfg, torch.from_numpy(audio), torch.from_numpy(valid))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for i, n in enumerate(tv.tolist()):
        _close(te[i, :n].numpy(), np.asarray(je)[i, :n])
    jt, jc = jpk.forward(jp, jcfg, jnp.asarray(audio), jnp.asarray(valid, jnp.int32), max_tokens=24)
    tt, tc = tpk.forward(tp, tcfg, torch.from_numpy(audio), torch.from_numpy(valid), max_tokens=24)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tc.min() > 0


def _wav(path, seconds, seed, scale=3000.0):
    pcm = np.clip(np.random.default_rng(seed).standard_normal(int(seconds * 16000)) * scale, -32768, 32767)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.astype(np.int16).tobytes())
    return str(path)


def test_session_transcribes_a_file_of_two_windows_as_jax(tmp_path):
    jcfg, jp, tcfg, tp = _models("f32", seed=2)
    path = _wav(tmp_path / "a.wav", 1.3, 9)
    jsess = jts.ParakeetSession(jp, jcfg, window_seconds=0.8)
    tsess = tts.ParakeetSession(tp, tcfg, window_seconds=0.8)
    assert tts.ParakeetSession.window_seconds == jts.ParakeetSession.window_seconds == 24.0
    want, got = jsess.transcribe(path), tsess.transcribe(path)
    assert got.token_ids == want.token_ids and len(got.token_ids) > 0
    assert got.audio_seconds == want.audio_seconds
