"""PyTorch port: Dolphin streaming (the clamped history append, the encoder
step over a leading stream axis, the rescoring decode, the session)
against the JAX package at its tests' tiny geometry.

Tolerances: every state leaf and output after each chunk within 1e-4 of
max|JAX| (JAX at ``highest`` precision), CTC ids, valid counts and the
rescored ids exactly; the append bitwise equal to both JAX write paths;
q8 ids equal to the dequantized f32 ids (``mm="f32"``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.decode.ar import DecodeConfig as JDecodeConfig
from asr_tpu.models import dolphin as jdp
from asr_tpu.ops import quant_matmul as jqm
from asr_tpu.runtime import artifact as jart
from asr_tpu.runtime import streaming_session as jss
from asr_tpu.streaming import dolphin_stream as jds
from asr_tpu_torch.decode.ar import DecodeConfig
from asr_tpu_torch.models import dolphin as tdp
from asr_tpu_torch.ops import quant_matmul as tqm
from asr_tpu_torch.quant.quantize import QuantizedLinear, dequantize_pytree, quantize_pytree
from asr_tpu_torch.runtime import artifact as tart
from asr_tpu_torch.runtime import streaming_session as tss
from asr_tpu_torch.streaming import dolphin_stream as tds
from tests.test_torch_paraformer_streaming import _close, close_state

TINY = dict(vocab_size=60, d_model=32, enc_layers=2, enc_heads=4, enc_ffn=48, cgmlp_dim=64, csgu_kernel=5,
            fusion_kernel=3, dec_layers=2, dec_heads=4, dec_ffn=48, sos_id=50, eos_id=51,
            max_target_positions=24)
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


def _models(seed=0, max_frames=64):
    jcfg = jds.DolphinStreamConfig(base=jdp.DolphinConfig(**TINY), chunk_frames=8, max_frames=max_frames)
    tcfg = tds.DolphinStreamConfig(base=tdp.DolphinConfig(**TINY), chunk_frames=8, max_frames=max_frames)
    jp = jdp.init_params(jcfg.base, jax.random.PRNGKey(seed))
    return jcfg, jp, tcfg, tart.params_from_flat(jart.flatten_pytree(jp), "cpu")


def _audio(seed, cfg, chunks):
    n = cfg.advance_samples * (chunks - 1) + cfg.window_samples
    return (np.random.default_rng(seed).standard_normal(n) * 2000).astype(np.float32)


def _windows(cfg, audio):
    w, a = cfg.window_samples, cfg.advance_samples
    return [audio[c * a : c * a + w] for c in range((len(audio) - (w - a)) // a)]


def test_config_matches_jax():
    j, t = jds.DolphinStreamConfig(), tds.DolphinStreamConfig()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    for name in ("mel_per_chunk", "window_mel", "window_samples", "advance_samples"):
        assert getattr(j, name) == getattr(t, name), name
    assert (t.window_samples, t.advance_samples) == (10960, 10240)


def test_append_rows_matches_both_jax_write_paths_including_the_clamp():
    """The port's one write path against JAX's dynamic_update_slice
    (scatter_free=False) and its one-hot spread (scatter_free=True), at
    mixed starts including past T - n, where JAX clamps the start."""
    nl, t, h, d, n, b = 3, 12, 2, 4, 5, 4
    rng = np.random.default_rng(0)
    buf = rng.standard_normal((b, nl, t, h, d)).astype(np.float32)
    new = rng.standard_normal((b, n, h, d)).astype(np.float32)
    starts = np.array([0, 3, t - n, t])  # t clamps to t - n
    for li in range(nl):
        got = torch.from_numpy(buf.copy())
        tds._append_rows(got, torch.from_numpy(new), li, torch.from_numpy(starts))
        dus = np.stack([np.asarray(jds._append_rows(jnp.asarray(buf[i]), jnp.asarray(new[i]), li,
                                                    int(starts[i]), scatter_free=False)) for i in range(b)])
        fn = functools.partial(jds._append_rows, li=li, scatter_free=True)
        spread = jax.vmap(lambda bb, v, s: fn(bb, v, start=s))(jnp.asarray(buf), jnp.asarray(new),
                                                               jnp.asarray(starts))
        np.testing.assert_array_equal(got.numpy(), dus)
        np.testing.assert_array_equal(got.numpy(), np.asarray(spread))
    np.testing.assert_array_equal(got[3, nl - 1, t - n :].numpy(), new[3])  # the clamped write


def _run_both(jcfg, jp, tcfg, tp, audio):
    jrel, trel = jds.precompute_rel_k(jp, jcfg), tds.precompute_rel_k(tp, tcfg)
    _close(trel.numpy(), jrel)
    jstate, tstate = jds.init_state(jcfg), tds.init_state(tcfg)
    for win in _windows(tcfg, audio):
        jstate, jids, jenc = jds.encoder_step(jp, jcfg, jstate, jnp.asarray(win), jrel)
        tstate, tids, tenc = tds.encoder_step(tp, tcfg, tstate, torch.from_numpy(win)[None], trel)
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
        _close(tenc.numpy(), jenc)
        close_state(tstate, jstate)
    return jstate, tstate


def test_steps_match_jax_chunk_by_chunk():
    jcfg, jp, tcfg, tp = _models(seed=1)
    _run_both(jcfg, jp, tcfg, tp, _audio(2, tcfg, CHUNKS))


def test_history_past_max_frames_overwrites_the_last_rows_as_jax():
    """Six chunks of 8 frames into a 40-frame history: from the fifth chunk
    on, the write start clamps to T - n = 32 and the chunk overwrites the
    buffer's last rows (dynamic_update_slice's clamp), valid stays 40."""
    jcfg, jp, tcfg, tp = _models(seed=3, max_frames=40)
    jstate, tstate = _run_both(jcfg, jp, tcfg, tp, _audio(4, tcfg, CHUNKS))
    assert int(tstate["valid"][0]) == 40


def test_rel_k_cache_equals_in_graph_projection():
    _, _, tcfg, tp = _models(seed=5)
    win = torch.from_numpy(_windows(tcfg, _audio(6, tcfg, 1))[0])[None]
    s0 = tds.init_state(tcfg)
    a = tds.encoder_step(tp, tcfg, s0, win, tds.precompute_rel_k(tp, tcfg))
    b = tds.encoder_step(tp, tcfg, s0, win, None)
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())
    _close(a[2].numpy(), b[2].numpy())


def test_rescore_decode_matches_jax():
    jcfg, jp, tcfg, tp = _models(seed=7)
    jstate, tstate = _run_both(jcfg, jp, tcfg, tp, _audio(8, tcfg, 3))
    for prompt in ([[50, -1, -2]], [[50, 3, 4]]):  # probe slots fed as they are, and forced ids
        jt, jc = jds.rescore_decode(jp, jcfg, jstate, jnp.asarray(prompt, jnp.int32),
                                    JDecodeConfig(max_new_tokens=8, eot_id=51, strategy="greedy"))
        tt, tc = tds.rescore_decode(tp, tcfg, tstate, torch.tensor(prompt),
                                    DecodeConfig(max_new_tokens=8, eot_id=51, strategy="greedy"))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tt[:, 3:].numpy(), np.asarray(jt)[:, 3:])


def test_session_transcribe_and_partials_match_jax():
    jcfg, jp, tcfg, tp = _models(seed=9)
    audio = _audio(10, tcfg, 4)[:-1234]
    js, ts = jss.DolphinStreamingSession(jp, jcfg), tss.DolphinStreamingSession(tp, tcfg)
    want, got = js.transcribe(audio), ts.transcribe(audio)
    assert got.token_ids == want.token_ids and len(got.token_ids) > 0
    assert ts.partial_ids == js.partial_ids
    assert tds.collapse_stream_ctc([[0, 5, 5, 0], [5, 7, 0, 0], [7, 7, 9, 0]]) == \
        jds.collapse_stream_ctc([[0, 5, 5, 0], [5, 7, 0, 0], [7, 7, 9, 0]])


def test_session_named_language_forcing():
    cat = {"languages": {"zh": 41, "ja": 42}, "regions": {"CN": 44}, "aliases": {"Japanese": "ja"}}
    _, _, tcfg, tp = _models()
    sess = tss.DolphinStreamingSession(tp, tcfg, language_catalog=cat, language="Japanese")
    assert (sess.language_id, sess.region_id) == (42, -2)
    sess = tss.DolphinStreamingSession(tp, tcfg, language_catalog=cat, language="zh-CN")
    assert (sess.language_id, sess.region_id) == (41, 44)
    with pytest.raises(KeyError):
        tss.DolphinStreamingSession(tp, tcfg, language_catalog=cat, language="Klingon")


def test_q8_session_ids_equal_dequantized_f32():
    _, _, tcfg, tp = _models(seed=11)
    q = quantize_pytree(tp, bits=8, block=8, min_size=0, refine_iters=0)
    blk = q["enc_blocks"][0]
    hot = [blk["attn"]["q"]["w"], blk["attn"]["rel_k"]["w"], blk["cgmlp"]["proj1"]["w"], blk["merge_proj"]["w"],
           q["subsample"]["out"]["w"], q["ctc"]["w"], q["decoder"]["blocks"][0]["cross"]["k"]["w"]]
    assert all(isinstance(w, QuantizedLinear) for w in hot)
    # depthwise / fusion conv kernels stay raw (consumed elementwise)
    assert not isinstance(blk["cgmlp"]["csgu"]["conv"]["w"], QuantizedLinear)
    assert not isinstance(blk["fusion"]["w"], QuantizedLinear)
    audio = _audio(12, tcfg, 3)
    got = tss.DolphinStreamingSession(q, tcfg).transcribe(audio)
    want = tss.DolphinStreamingSession(dequantize_pytree(q), tcfg).transcribe(audio)
    assert got.token_ids == want.token_ids
