"""PyTorch port: cache-aware Nemotron streaming (the snip-edges mel, the
rel-shift index, the encoder step over a leading stream axis, the RNN-T
continuation, the session) against the JAX package at its tests' tiny
geometry.

Tolerances: every state leaf and output after each chunk within 1e-4 of
max|JAX| (JAX at ``highest`` precision), counters, tokens, counts and ids
exactly, for every host-sync period tested; the session's ids exactly; q8
ids equal to the dequantized f32 ids (``mm="f32"``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.frontend.nemo_mel import NemoMelConfig as JMel
from asr_tpu.models import nemotron as jnm
from asr_tpu.ops import quant_matmul as jqm
from asr_tpu.runtime import artifact as jart
from asr_tpu.runtime import streaming_session as jss
from asr_tpu.streaming import nemotron_stream as jns
from asr_tpu_torch.decode import tdt as ttdt
from asr_tpu_torch.frontend.nemo_mel import NemoMelConfig as TMel
from asr_tpu_torch.models import nemotron as tnm
from asr_tpu_torch.ops import quant_matmul as tqm
from asr_tpu_torch.quant.quantize import QuantizedLinear, dequantize_pytree, quantize_pytree
from asr_tpu_torch.runtime import artifact as tart
from asr_tpu_torch.runtime import streaming_session as tss
from asr_tpu_torch.streaming import nemotron_stream as tns
from tests.test_torch_paraformer_streaming import _close, close_state

TINY = dict(vocab_size=30, d_model=32, num_layers=2, num_heads=4, ffn_dim=48, conv_kernel=5, sub_channels=8,
            pred_hidden=16, joint_hidden=16, prompt_hidden=16, lstm_layers=1, num_prompts=4,
            left_context=8, right_context=3)  # chunk = 4 encoder frames
SYNC_PERIODS = (1, 3, 8, 64)
CHUNKS = 6


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


def _models(seed=0):
    jcfg = jns.NemotronStreamConfig(base=jnm.NemotronConfig(**TINY, mel=JMel(n_mels=40)))
    tcfg = tns.NemotronStreamConfig(base=tnm.NemotronConfig(**TINY, mel=TMel(n_mels=40)))
    jp = jnm.init_params(jcfg.base, jax.random.PRNGKey(seed))
    return jcfg, jp, tcfg, tart.params_from_flat(jart.flatten_pytree(jp), "cpu")


def _windows(seed, cfg, n):
    return (np.random.default_rng(seed).standard_normal((n, cfg.window_samples)) * 0.1).astype(np.float32)


def test_config_and_rel_index_match_jax():
    j, t = jns.NemotronStreamConfig(), tns.NemotronStreamConfig()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (t.chunk, t.mel_chunk, t.kv_len, t.window_samples) == (14, 112, 84, 18273)
    assert t.window_samples == j.window_samples and t.mel_cache == j.mel_cache
    for chunk, kv in ((4, 12), (14, 84)):
        np.testing.assert_array_equal(tns._stream_rel_index(chunk, kv), jns._stream_rel_index(chunk, kv))


def test_stream_mel_matches_jax():
    jcfg, _, tcfg, _ = _models()
    audio = _windows(1, tcfg, 2)
    want = jns._stream_mel(jcfg, jnp.asarray(audio))
    _close(tns._stream_mel(tcfg, torch.from_numpy(audio)).numpy(), want)


def test_rel_k_cache_equals_in_graph_projection():
    jcfg, jp, tcfg, tp = _models(seed=2)
    cache = tns.precompute_rel_k(tp, tcfg)
    _close(cache.numpy(), jns.precompute_rel_k(jp, jcfg))
    state = tns.init_state(tcfg)
    audio = torch.from_numpy(_windows(3, tcfg, 1))
    pid = torch.tensor([1])
    _, with_cache = tns.encoder_step(tp, tcfg, state, audio, pid, cache)
    _, in_graph = tns.encoder_step(tp, tcfg, state, audio, pid, None)
    _close(with_cache.numpy(), in_graph.numpy())


@pytest.mark.parametrize("max_new", [32, 3])
def test_steps_match_jax_chunk_by_chunk(max_new):
    """Six chunks through both packages' encoder and RNN-T steps; at
    max_new = 3 every chunk ends on ``count == max_new`` (the clamp case:
    the rest of the chunk's frames are dropped, the state carries on)."""
    jcfg, jp, tcfg, tp = _models(seed=4)
    rel_k = tns.precompute_rel_k(tp, tcfg)
    jrel = jns.precompute_rel_k(jp, jcfg)
    jstate = {**jns.init_state(jcfg), "token": jnp.asarray([jcfg.base.blank_id], jnp.int32)}
    tstate = tns.init_state(tcfg)
    tstate["token"][:] = tcfg.base.blank_id
    at_cap = 0
    for c, win in enumerate(_windows(5, tcfg, CHUNKS)):
        jstate, jenc = jns.encoder_step(jp, jcfg, jstate, jnp.asarray(win)[None], jnp.asarray([2]), jrel)
        tstate, tenc = tns.encoder_step(tp, tcfg, tstate, torch.from_numpy(win)[None], torch.tensor([2]), rel_k)
        _close(tenc.numpy(), jenc)
        jstate, jids, jcount = jns.rnnt_stream_step(jp, jcfg, jstate, jenc, max_new=max_new)
        tstate, tids, tcount = tns.rnnt_stream_step(tp, tcfg, tstate, tenc, max_new=max_new)
        assert int(tcount[0]) == int(jcount)
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
        close_state(tstate, jstate)
        at_cap += int(jcount) == max_new
    assert (at_cap == CHUNKS or max_new != 3) and int(tstate["cache_len"][0]) == 8


@pytest.mark.parametrize("k", SYNC_PERIODS)
def test_rnnt_stream_step_bitwise_jax_for_every_sync_period(k, monkeypatch):
    """The greedy continuation on one encoder output, at max_new 64 (the
    step cap (10 + 1) x 4 ends the loop) and 5: ids, counts, tokens and
    nsym bitwise JAX's, the LSTM state within TOL, one host read of
    all(done) every k steps."""
    jcfg, jp, tcfg, tp = _models(seed=6)
    win = _windows(7, tcfg, 1)
    jstate = {**jns.init_state(jcfg), "token": jnp.asarray([jcfg.base.blank_id], jnp.int32),
              "nsym": jnp.asarray(4, jnp.int32)}
    jstate, jenc = jns.encoder_step(jp, jcfg, jstate, jnp.asarray(win), jnp.asarray([0]))
    tstate = tns.init_state(tcfg)
    tstate["token"][:] = tcfg.base.blank_id
    tstate["nsym"][:] = 4
    tstate, tenc = tns.encoder_step(tp, tcfg, tstate, torch.from_numpy(win), torch.tensor([0]))
    monkeypatch.setattr(ttdt, "SYNC_EVERY", k)
    for max_new in (64, 5):
        calls = []
        orig = tns.joint_step

        def counting(*a):
            calls.append(1)
            return orig(*a)

        monkeypatch.setattr(tns, "joint_step", counting)
        before = ttdt.SYNCS
        js, jids, jcount = jns.rnnt_stream_step(jp, jcfg, jstate, jenc, max_new=max_new)
        ts, tids, tcount = tns.rnnt_stream_step(tp, tcfg, tstate, tenc, max_new=max_new)
        monkeypatch.setattr(tns, "joint_step", orig)
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
        assert int(tcount[0]) == int(jcount)
        close_state(ts, js)
        steps = len(calls)
        assert steps <= (tcfg.base.max_symbols_per_frame + 1) * tcfg.chunk  # never past JAX's max_steps
        assert ttdt.SYNCS - before == -(-steps // k)


def test_batched_rows_equal_each_stream_alone():
    _, _, tcfg, tp = _models(seed=8)
    wins = _windows(9, tcfg, 3)
    state = tns.init_state(tcfg, 3)
    state, enc = tns.encoder_step(tp, tcfg, state, torch.from_numpy(wins), torch.tensor([0, 1, 2]))
    state, ids, count = tns.rnnt_stream_step(tp, tcfg, state, enc)
    for i in range(3):
        s1, e1 = tns.encoder_step(tp, tcfg, tns.init_state(tcfg), torch.from_numpy(wins[i : i + 1]),
                                  torch.tensor([i]))
        _close(enc[i].numpy(), e1[0].numpy())
        s1, i1, c1 = tns.rnnt_stream_step(tp, tcfg, s1, e1)
        assert int(c1[0]) == int(count[i])
        np.testing.assert_array_equal(i1[0].numpy(), ids[i].numpy())


class _TagTokenizer:
    def decode(self, ids):
        return "".join("<en-US>" if i == 3 else f"w{i} " for i in ids)


def test_session_transcribe_matches_jax():
    jcfg, jp, tcfg, tp = _models(seed=10)
    audio = (np.random.default_rng(11).standard_normal(3 * tcfg.window_samples + 777) * 0.1).astype(np.float32)
    want = jss.NemotronStreamingSession(jp, jcfg, tokenizer=_TagTokenizer(), prompt_id=2).transcribe(audio)
    got = tss.NemotronStreamingSession(tp, tcfg, tokenizer=_TagTokenizer(), prompt_id=2).transcribe(audio)
    assert got.token_ids == want.token_ids and len(got.token_ids) > 0
    assert got.text == want.text and "<" not in got.text


def test_q8_session_ids_equal_dequantized_f32():
    _, _, tcfg, tp = _models(seed=12)
    q = quantize_pytree(tp, bits=8, block=8, min_size=0, refine_iters=0)
    blk = q["blocks"][0]
    hot = [blk["ff1"]["w1"]["w"], blk["attn"]["q"]["w"], blk["attn"]["rel_k"]["w"], blk["conv"]["pw1"]["w"],
           q["pre_encode"]["out"]["w"], q["prompt"]["joint_enc"]["w"], q["decoder"]["joint_net"]["w"]]
    assert all(isinstance(w, QuantizedLinear) for w in hot)
    assert isinstance(q["prompt"]["w0_enc"], torch.Tensor)  # a bare matrix: a plain product
    audio = (np.random.default_rng(13).standard_normal(3 * tcfg.window_samples) * 0.1).astype(np.float32)
    got = tss.NemotronStreamingSession(q, tcfg).transcribe(audio)
    want = tss.NemotronStreamingSession(dequantize_pytree(q), tcfg).transcribe(audio)
    assert got.token_ids == want.token_ids and len(got.token_ids) > 0
