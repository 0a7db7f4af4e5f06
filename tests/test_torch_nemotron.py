"""PyTorch port: Nemotron offline (the causal pre-encode, the chunked
attention mask, the causal conv module, the prompt, the RNN-T greedy loop,
the session) against the JAX package at its tests' tiny geometry.

Tolerances: f32 values within 1e-4 of max|reference| (JAX at ``highest``
precision), the chunk mask, configs, layouts and valid counts exactly; the
greedy loop on a scripted joint (an exact table lookup) bitwise, ids and
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

from asr_tpu.decode import rnnt as jrnnt
from asr_tpu.frontend.nemo_mel import NemoMelConfig as JMel
from asr_tpu.models import nemotron as jnm
from asr_tpu.ops import quant_matmul as jqm
from asr_tpu.quant.quantize import quantize_pytree as jquantize_pytree
from asr_tpu.runtime import artifact as jart
from asr_tpu.runtime import transducer_session as jts
from asr_tpu_torch.decode import rnnt as trnnt
from asr_tpu_torch.decode import tdt as ttdt
from asr_tpu_torch.frontend.nemo_mel import NemoMelConfig as TMel
from asr_tpu_torch.models import nemotron as tnm
from asr_tpu_torch.ops import quant_matmul as tqm
from asr_tpu_torch.runtime import artifact as tart
from asr_tpu_torch.runtime import transducer_session as tts
from asr_tpu_torch.runtime.metadata import config_from_dict

TINY = dict(vocab_size=30, d_model=64, num_layers=2, num_heads=4, ffn_dim=96, conv_kernel=5,
            sub_channels=16, pred_hidden=32, joint_hidden=32, prompt_hidden=32, lstm_layers=1,
            num_prompts=8, left_context=6, right_context=3)
TOL = 1e-4
SYNC_PERIODS = (1, 4, 11, 64)


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


def _models(quant: str = "f32", seed: int = 0, randomize: bool = False, **over):
    """(JAX cfg, JAX params, port cfg, port params): f32 or the whole tree q8;
    ``randomize`` draws the norms' and biases' values (the init has ones and
    zeros) so each reaches the comparison."""
    jcfg = jnm.NemotronConfig(**{**TINY, **over}, mel=JMel(n_mels=80))
    tcfg = tnm.NemotronConfig(**{**TINY, **over}, mel=TMel(n_mels=80))
    jp = jnm.init_params(jcfg, jax.random.PRNGKey(seed))
    if randomize:
        rng = np.random.default_rng(seed)
        flat = jart.flatten_pytree(jp)
        for k, v in flat.items():
            if k.endswith(("/b", "/bias", "bias_u", "bias_v")):
                flat[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            elif k.endswith("/scale"):
                flat[k] = (1 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        jp = _nest({k: jnp.asarray(v) for k, v in flat.items()})
    if quant == "q8":
        jp = jquantize_pytree(jp, bits=8, block=128, min_size=512, refine_iters=0)
    return jcfg, jp, tcfg, tart.params_from_flat(jart.flatten_pytree(jp), "cpu")


def _nest(flat: dict):
    """``{"a/0/b": x}`` -> ``{"a": [{"b": x}]}`` (digit keys become lists)."""
    out: dict = {}
    for key, value in flat.items():
        node = out
        *head, last = key.split("/")
        for p in head:
            node = node.setdefault(p, {})
        node[last] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(out)


def _audio(seed, batch=1, n=16000):
    return (np.random.default_rng(seed).standard_normal((batch, n)) * 0.1).astype(np.float32)


# ── the causal pre-encode and the chunk mask ──────────────────────────────
def test_pre_encode_and_chunk_mask_match_jax():
    jcfg, jp, tcfg, tp = _models("f32", seed=1, randomize=True)
    feats = np.random.default_rng(2).standard_normal((2, 61, 80)).astype(np.float32)
    valid = np.array([61, 30])
    jx, jv = jnm.pre_encode(jp, jcfg, jnp.asarray(feats), jnp.asarray(valid, jnp.int32))
    tx, tv = tnm.pre_encode(tp, tcfg, torch.from_numpy(feats), torch.from_numpy(valid))
    assert tx.shape == jx.shape
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for i, n in enumerate(tv.tolist()):
        _close(tx[i, :n].numpy(), np.asarray(jx)[i, :n])
    for t, chunk, left, right in ((9, 4, 6, 3), (40, 14, 70, 13), (31, 2, 1, 1)):
        np.testing.assert_array_equal(tnm._chunk_mask_np(t, chunk, left, right),
                                      jnm._chunk_mask_np(t, chunk, left, right))


def test_causal_conv_module_with_a_key_mask_matches_jax():
    _, jp, _, tp = _models("f32", seed=3, randomize=True)
    x = np.random.default_rng(4).standard_normal((2, 11, 64)).astype(np.float32)
    mask = np.arange(11)[None] < np.array([11, 6])[:, None]
    jc = jax.tree.map(jnp.asarray, jp["blocks"][0]["conv"])
    want = jnm.conv_module_causal(jnp.asarray(x), jc, jnp.asarray(mask))
    got = tnm.conv_module_causal(torch.from_numpy(x), tp["blocks"][0]["conv"], torch.from_numpy(mask))
    for i, n in enumerate((11, 6)):
        _close(got[i, :n].numpy(), np.asarray(want)[i, :n])
    conv = {**tp["blocks"][0]["conv"], "dw": {**tp["blocks"][0]["conv"]["dw"], "b": torch.full((64,), 0.3)}}
    jconv = {**jc, "dw": {**jc["dw"], "b": jnp.full((64,), 0.3)}}
    _close(tnm.conv_module_causal(torch.from_numpy(x), conv, None).numpy(),
           jnm.conv_module_causal(jnp.asarray(x), jconv, None))


# ── the RNN-T greedy loop on a scripted joint ─────────────────────────────
def _scripted(seed, b, t, v, blank_p):
    """Logits by (row * T + frame, last token), blank the last id; h counts
    the state updates, c adds the frame id: exact in f32 in both packages."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b * t, v, v)).astype(np.float32)
    logits[..., v - 1] = np.where(rng.random((b * t, v)) < blank_p, 10.0, -10.0)
    enc = (np.arange(b)[:, None] * t + np.arange(t)[None, :]).astype(np.float32)[..., None]
    return logits, enc


def _joint(mod, table, calls=None):
    def step(token, h, c, enc_frame):
        if calls is not None:
            calls.append(1)
        fid = enc_frame[:, 0].astype(jnp.int32) if mod is jnp else enc_frame[:, 0].to(torch.int64)
        return table[fid, token], h + 1, c + enc_frame[:, :1][None]
    return step


RNNT_CASES = {  # name: (b, t, blank share, valid, max_tokens, max_symbols)
    "rows_end_apart": (3, 8, 0.5, [8, 5, 1], 50, 3),
    "stops_at_max_steps": (2, 3, 0.0, [3, 3], 64, 4),  # the cap per frame moves the frames
    "stops_at_max_tokens": (2, 10, 0.3, [10, 6], 4, 2),
    "zero_frames": (2, 5, 0.4, [0, 5], 20, 10),
}


@pytest.mark.parametrize("case", list(RNNT_CASES))
def test_rnnt_greedy_bitwise_jax_for_every_sync_period(case, monkeypatch):
    b, t, blank_p, valid, max_tokens, max_sym = RNNT_CASES[case]
    v = 7
    table, enc = _scripted(11, b, t, v, blank_p)
    h0 = np.zeros((1, b, 3), np.float32)
    kw = dict(start_token=v - 1, blank_id=v - 1, max_tokens=max_tokens, max_symbols_per_frame=max_sym)
    jbuf, jcnt = jrnnt.rnnt_greedy(_joint(jnp, jnp.asarray(table)), jnp.asarray(enc),
                                   jnp.asarray(valid, jnp.int32), jnp.asarray(h0), jnp.asarray(h0), **kw)
    max_steps = (max_sym + 1) * t
    first = None
    for k in SYNC_PERIODS:
        calls = []
        before = ttdt.SYNCS
        monkeypatch.setattr(ttdt, "SYNC_EVERY", k)
        buf, cnt = trnnt.rnnt_greedy(_joint(torch, torch.from_numpy(table), calls), torch.from_numpy(enc),
                                     torch.tensor(valid), torch.from_numpy(h0), torch.from_numpy(h0), **kw)
        np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
        steps = len(calls)
        first = first or steps  # k = 1: the per-step loop's step count
        assert steps == min(max_steps, -(-first // k) * k)  # never past JAX's max_steps
        assert ttdt.SYNCS - before == -(-steps // k)
    if case == "stops_at_max_steps":
        # every step emits until a frame's cap; (max_sym + 1) T steps just cover T frames
        assert first == max_steps and (np.asarray(jcnt) == max_sym * t).all()
    if case == "stops_at_max_tokens":
        assert (np.asarray(jcnt) == max_tokens).any()


# ── the model ─────────────────────────────────────────────────────────────
def test_config_and_init_layout_match_jax():
    assert dataclasses.asdict(jnm.NemotronConfig()) == dataclasses.asdict(tnm.NemotronConfig())
    assert tnm.NemotronConfig().blank_id == 8192 and tnm.NemotronConfig().chunk == 14
    tcfg = tnm.NemotronConfig(**TINY, mel=TMel(n_mels=80))
    assert config_from_dict(tnm.NemotronConfig, dataclasses.asdict(tcfg)) == tcfg
    jflat = jart.flatten_pytree(jnm.init_params(jnm.NemotronConfig(**TINY, mel=JMel(n_mels=80)),
                                                jax.random.PRNGKey(0)))
    tflat = tart.flatten_pytree(tnm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu"))
    assert {k: v.shape for k, v in jflat.items()} == {k: v.shape for k, v in tflat.items()}


@pytest.mark.parametrize("quant", ["f32", "q8"])
def test_forward_matches_jax_on_a_padded_batch(quant):
    jcfg, jp, tcfg, tp = _models(quant, seed=5, randomize=True)
    if quant == "q8":
        assert type(tp["decoder"]["joint_net"]["w"]).__name__ == "QuantizedLinear"
        assert isinstance(tp["prompt"]["w0_enc"], torch.Tensor)  # kept f32 by its key name
    audio = _audio(6, batch=2, n=14000)
    valid = np.array([14000, 8000])
    pid = np.array([3, 5])
    je, jv = jnm.encode(jp, jcfg, jnp.asarray(audio), jnp.asarray(valid, jnp.int32), jnp.asarray(pid))
    te, tv = tnm.encode(tp, tcfg, torch.from_numpy(audio), torch.from_numpy(valid), torch.from_numpy(pid))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for i, n in enumerate(tv.tolist()):
        _close(te[i, :n].numpy(), np.asarray(je)[i, :n])
    jt, jc = jnm.forward(jp, jcfg, jnp.asarray(audio), jnp.asarray(valid, jnp.int32), jnp.asarray(pid),
                         max_tokens=32)
    tt, tc = tnm.forward(tp, tcfg, torch.from_numpy(audio), torch.from_numpy(valid), torch.from_numpy(pid),
                         max_tokens=32)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tc.min() > 0


class _TagTokenizer:
    """Decodes id 3 as a language tag, every other id as "w<id> "."""

    def decode(self, ids):
        return "".join("<en-US>" if i == 3 else f"w{i} " for i in ids)


def test_session_transcribes_a_file_of_two_windows_as_jax(tmp_path):
    jcfg, jp, tcfg, tp = _models("f32", seed=7, randomize=True)
    pcm = np.clip(np.random.default_rng(8).standard_normal(int(1.5 * 16000)) * 3000, -32768, 32767)
    path = tmp_path / "a.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.astype(np.int16).tobytes())
    jsess = jts.NemotronSession(jp, jcfg, tokenizer=_TagTokenizer(), prompt_id=2, window_seconds=0.9)
    tsess = tts.NemotronSession(tp, tcfg, tokenizer=_TagTokenizer(), prompt_id=2, window_seconds=0.9)
    want, got = jsess.transcribe(str(path)), tsess.transcribe(str(path))
    assert got.token_ids == want.token_ids and len(got.token_ids) > 0
    assert got.text == want.text and "<" not in got.text
    assert tts.strip_language_tags("<zh-CN>w1 <en>w2") == jts.strip_language_tags("<zh-CN>w1 <en>w2")
