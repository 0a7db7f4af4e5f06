"""PyTorch port: streaming Paraformer (the chunk LFR, the incremental CIF,
the encoder and decoder steps over a leading stream axis, the session)
against the JAX package at its tests' tiny geometry.

Tolerances: every state leaf and output after each chunk within 1e-4 of
max|JAX| (JAX at ``highest`` precision; the port's leaf is JAX's with a
leading stream axis), fire flags, counts and ids exactly; the session's ids
exactly; q8 ids equal to the dequantized f32 ids (``mm="f32"``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.models import paraformer as jpf
from asr_tpu.ops import quant_matmul as jqm
from asr_tpu.runtime import artifact as jart
from asr_tpu.runtime import streaming_session as jss
from asr_tpu.streaming import paraformer_online as jpo
from asr_tpu_torch.models import paraformer as tpf
from asr_tpu_torch.ops import quant_matmul as tqm
from asr_tpu_torch.quant.quantize import QuantizedLinear, dequantize_pytree, quantize_pytree
from asr_tpu_torch.runtime import artifact as tart
from asr_tpu_torch.runtime import streaming_session as tss
from asr_tpu_torch.streaming import paraformer_online as tpo

TINY = dict(vocab_size=50, hidden=32, num_heads=4, head_dim=8, ffn_dim=48, num_encoders0=1, num_encoders=1,
            num_decoders=1, num_decoder_ffn=1, fsmn_kernel=5, predictor_kernel=3)
TOL = 1e-4
CHUNKS = 7


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


def close_state(tstate, jstate, row: int = 0):
    """Every leaf of the port's state (row ``row`` of the stream axis)
    against the JAX state's: integers exactly, floats within TOL."""
    if isinstance(jstate, dict):
        assert set(tstate) == set(jstate), (set(tstate), set(jstate))
        for k in jstate:
            close_state(tstate[k], jstate[k], row)
        return
    if isinstance(jstate, (list, tuple)):
        assert len(tstate) == len(jstate)
        for t, j in zip(tstate, jstate):
            close_state(t, j, row)
        return
    got, want = tstate[row].numpy(), np.asarray(jstate)
    assert got.shape == want.shape, (got.shape, want.shape)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        _close(got, want)


def _models(seed=0, quant=None, fire_bias=0.5, **over):
    base_j, base_t = jpf.ParaformerConfig(**TINY), tpf.ParaformerConfig(**TINY)
    jcfg = jpo.ParaformerStreamConfig(base=base_j, **over)
    tcfg = tpo.ParaformerStreamConfig(base=base_t, **over)
    jp = jpf.init_params(base_j, jax.random.PRNGKey(seed))
    # the predictor's bias sets how often the tiny model's CIF fires (0.5: every chunk)
    jp["predictor"]["out"]["b"] = jnp.full_like(jp["predictor"]["out"]["b"], fire_bias)
    tp = tart.params_from_flat(jart.flatten_pytree(jp), "cpu")
    if quant == "q8":
        tp = quantize_pytree(tp, bits=8, block=8, min_size=0, refine_iters=0)
    return jcfg, jp, tcfg, tp


def _audio(seed, n):
    return (np.random.default_rng(seed).standard_normal(n) * 2000).astype(np.float32)


def test_config_matches_jax():
    j, t = jpo.ParaformerStreamConfig(), tpo.ParaformerStreamConfig()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    for name in ("stft_len", "t_lfr", "look_back_b", "look_back_c", "carry_feats", "chunk_positions",
                 "enc_cache_len", "dec_cache_len", "max_fires"):
        assert getattr(j, name) == getattr(t, name), name
    assert (t.t_lfr, t.chunk_positions, t.enc_cache_len, t.max_fires) == (9, 13, 36, 10)
    np.testing.assert_array_equal(tpo._lfr_index(t), np.asarray(
        np.clip(np.arange(0, 54, 6)[:, None] + np.arange(7)[None] - 3, 0, 47)).reshape(-1))


def test_cif_chunk_scan_matches_jax():
    rng = np.random.default_rng(1)
    n, steps, d = 4, 9, 6
    alphas = rng.uniform(0, 0.9, (n, steps)).astype(np.float32)
    hidden = rng.standard_normal((n, steps, d)).astype(np.float32)
    avg = rng.standard_normal((n, 1, 1, d)).astype(np.float32)
    carried = np.array([[0.3], [1.2], [0.99], [0.0]], np.float32)  # row 1 fires at the boundary step
    got = tpo._cif_chunk_scan(torch.from_numpy(alphas), torch.from_numpy(hidden), torch.from_numpy(avg),
                              torch.from_numpy(carried))
    for i in range(n):
        want = jpo._cif_chunk_scan(jnp.asarray(alphas[i]), jnp.asarray(hidden[i]), jnp.asarray(avg[i]),
                                   jnp.asarray(carried[i]))
        _close(got[0][i].numpy(), want[0])
        np.testing.assert_array_equal(got[1][i].numpy(), np.asarray(want[1]))
        _close(got[2][i].numpy(), want[2])
        _close(got[3][i].numpy(), want[3])
    assert bool(got[1][1, 0]) and not bool(got[1][0, 0])


def _run_both(jcfg, jp, tcfg, tp, audio, chunks):
    """Both packages' steps chunk by chunk (the decoder only on a fire, as
    the sessions run it), holding state and outputs after every chunk."""
    jstate, tstate = jpo.init_state(jcfg, jp), tpo.init_state(tcfg, tp)
    w, fired_total = tcfg.chunk_samples, 0
    for c in range(chunks):
        chunk = audio[c * w : (c + 1) * w]
        jstate, jfired, jcount, jenc = jpo.encoder_step(jp, jcfg, jstate, jnp.asarray(chunk)[None])
        tstate, tfired, tcount, tenc = tpo.encoder_step(tp, tcfg, tstate, torch.from_numpy(chunk)[None])
        assert int(tcount[0]) == int(jcount)
        _close(tenc[0].numpy(), jenc[0])
        n = int(jcount)
        _close(tfired[0, :n].numpy(), np.asarray(jfired)[0, :n])
        if n:
            fired_total += n
            jstate, jids, _ = jpo.decoder_step(jp, jcfg, jstate, jenc, jfired, jcount)
            tstate, tids, _ = tpo.decoder_step(tp, tcfg, tstate, tenc, tfired, tcount)
            np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
        close_state(tstate, jstate)
    return tstate, fired_total


def test_steps_match_jax_chunk_by_chunk():
    jcfg, jp, tcfg, tp = _models(seed=2)
    _, fired = _run_both(jcfg, jp, tcfg, tp, _audio(3, CHUNKS * tcfg.chunk_samples), CHUNKS)
    assert fired > 0


def test_position_clamp_past_max_positions():
    """A stream past ``max_positions``: JAX's dynamic_slice clamps the start
    of the position rows to max_positions - t_lfr and repeats the table's
    last rows; the port's gather does the same per stream."""
    jcfg, jp, tcfg, tp = _models(seed=4, max_positions=20)
    tstate, _ = _run_both(jcfg, jp, tcfg, tp, _audio(5, 6 * tcfg.chunk_samples), 6)
    assert int(tstate["start_idx"][0]) == 6 * tcfg.t_lfr > tcfg.max_positions - tcfg.t_lfr


def test_batched_rows_equal_each_stream_alone():
    _, _, tcfg, tp = _models(seed=6)
    audios = [_audio(7 + i, 2 * tcfg.chunk_samples) for i in range(3)]
    w = tcfg.chunk_samples
    state = tpo.init_state(tcfg, tp, 3)
    alone = [tpo.init_state(tcfg, tp) for _ in audios]
    for c in range(2):
        batch = torch.from_numpy(np.stack([a[c * w : (c + 1) * w] for a in audios]))
        state, fired, count, enc = tpo.encoder_step(tp, tcfg, state, batch)
        for i in range(3):
            alone[i], f1, c1, e1 = tpo.encoder_step(tp, tcfg, alone[i], batch[i : i + 1])
            assert int(c1[0]) == int(count[i])
            _close(enc[i].numpy(), e1[0].numpy())


def test_session_transcribe_matches_jax():
    jcfg, jp, tcfg, tp = _models(seed=8)
    audio = _audio(9, 5 * tcfg.chunk_samples + 3100)  # the last chunk takes the RMS-matched noise pad
    want = jss.ParaformerStreamingSession(jp, jcfg).transcribe(audio)
    got = tss.ParaformerStreamingSession(tp, tcfg).transcribe(audio)
    assert got.token_ids == want.token_ids and len(got.token_ids) > 0
    assert got.audio_seconds == want.audio_seconds


def test_q8_session_ids_equal_dequantized_f32():
    _, _, tcfg, q = _models(seed=10, quant="q8")
    hot = [q["encoders0"][0]["qkv"]["w"], q["encoders"][0]["ffn"]["w1"], q["decoders"][0]["cross"]["kv"]["w"],
           q["output"]["w"], q["predictor"]["out"]["w"]]
    assert all(isinstance(w, QuantizedLinear) for w in hot)
    assert not isinstance(q["predictor"]["conv"]["w"], QuantizedLinear)  # consumed by the conv
    audio = _audio(11, 4 * tcfg.chunk_samples)
    got = tss.ParaformerStreamingSession(q, tcfg).transcribe(audio)
    want = tss.ParaformerStreamingSession(dequantize_pytree(q), tcfg).transcribe(audio)
    assert got.token_ids == want.token_ids and len(got.token_ids) > 0
