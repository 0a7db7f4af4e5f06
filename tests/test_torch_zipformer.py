"""PyTorch port: X-ASR Zipformer2 (the activations and BiasNorm, the
subsampling with its cached ConvNeXt pad, the encoder step over a leading
stream axis, the stateless decoder, greedy search, the session) against
the JAX package at its tests' tiny geometry.

Tolerances: values within 1e-4 of max|JAX| (JAX at ``highest`` precision)
after every chunk, every state leaf included; counters, contexts, counts
and ids exactly; q8 ids equal to the dequantized f32 ids (``mm="f32"``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.models import zipformer as jzf
from asr_tpu.ops import quant_matmul as jqm
from asr_tpu.runtime import artifact as jart
from asr_tpu.runtime import streaming_session as jss
from asr_tpu_torch.models import zipformer as tzf
from asr_tpu_torch.ops import quant_matmul as tqm
from asr_tpu_torch.quant.quantize import QuantizedLinear, dequantize_pytree, quantize_pytree
from asr_tpu_torch.runtime import artifact as tart
from asr_tpu_torch.runtime import streaming_session as tss
from tests.test_torch_paraformer_streaming import _close, close_state

TINY = dict(vocab_size=40, downsampling_factor=(1, 2), num_encoder_layers=(1, 1), encoder_dim=(32, 48),
            query_head_dim=(8, 8), pos_head_dim=(4, 4), value_head_dim=(8, 8), num_heads=(2, 2),
            feedforward_dim=(48, 64), cnn_module_kernel=(7, 7), chunk_size=8, left_context_frames=16,
            sub_layer1=4, sub_layer2=8, sub_layer3=16, decoder_dim=16, joiner_dim=16, context_size=2,
            decoder_conv_groups=4)
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


def _models(seed=0, **over):
    jcfg, tcfg = jzf.ZipformerConfig(**{**TINY, **over}), tzf.ZipformerConfig(**{**TINY, **over})
    jp = jzf.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, tcfg, tart.params_from_flat(jart.flatten_pytree(jp), "cpu")


def _windows(seed, cfg, n):
    return (np.random.default_rng(seed).standard_normal((n, cfg.window_samples)) * 2000).astype(np.float32)


def test_config_layout_and_activations_match_jax():
    j, t = jzf.ZipformerConfig(), tzf.ZipformerConfig()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (t.window_samples, t.advance_samples, t.embed_width, sum(t.num_encoder_layers)) == (4880, 2560, 19, 19)
    for s in range(t.num_stacks):
        assert t.stack_geom(s) == j.stack_geom(s)
    _, _, tcfg, tp = _models()
    tflat = tart.flatten_pytree(tzf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu"))
    assert {k: v.shape for k, v in tart.flatten_pytree(tp).items()} == {k: v.shape for k, v in tflat.items()}
    assert tp["embed"]["out_norm_log_scale"].shape == ()  # JAX's flatten stores it as (1,)
    x = np.linspace(-8, 8, 101).astype(np.float32)
    _close(tzf.swoosh_l(torch.from_numpy(x)).numpy(), jzf.swoosh_l(jnp.asarray(x)))
    _close(tzf.swoosh_r(torch.from_numpy(x)).numpy(), jzf.swoosh_r(jnp.asarray(x)))
    y = np.random.default_rng(0).standard_normal((3, 5, 12)).astype(np.float32)
    bias = np.random.default_rng(1).standard_normal(12).astype(np.float32)
    _close(tzf.bias_norm(torch.from_numpy(y), torch.from_numpy(bias), torch.tensor(0.3)).numpy(),
           jzf.bias_norm(jnp.asarray(y), jnp.asarray(bias), jnp.asarray(0.3)))


def test_subsample_with_the_cached_pad_matches_jax():
    jcfg, jp, tcfg, tp = _models(seed=1)
    mel = np.random.default_rng(2).standard_normal((tcfg.mel_per_chunk, 80)).astype(np.float32)
    pad = np.random.default_rng(3).standard_normal((3, tcfg.embed_width, 16)).astype(np.float32)
    jx, jpad = jzf._subsample(jp, jcfg, jnp.asarray(mel), jnp.asarray(pad))
    tx, tpad = tzf._subsample(tp, tcfg, torch.from_numpy(mel)[None], torch.from_numpy(pad)[None])
    _close(tx[0].numpy(), jx)
    _close(tpad[0].numpy(), jpad)


def test_encoder_step_matches_jax_chunk_by_chunk():
    """Seven chunks: the left context fills (16 frames, 2 chunks) and
    ``processed_lens`` passes it, so the per-row padding mask is seen in
    every state; enc, every cache and the decoder context after each chunk."""
    jcfg, jp, tcfg, tp = _models(seed=4)
    jstate, tstate = jzf.init_state(jcfg), tzf.init_state(tcfg)
    for win in _windows(5, tcfg, CHUNKS):
        jstate, jenc = jzf.encoder_step(jp, jcfg, jstate, jnp.asarray(win))
        tstate, tenc = tzf.encoder_step(tp, tcfg, tstate, torch.from_numpy(win)[None])
        _close(tenc[0].numpy(), jenc)
        jstate, jids, jcount = jzf.greedy_chunk(jp, jcfg, jstate, jenc)
        tstate, tids, tcount = tzf.greedy_chunk(tp, tcfg, tstate, tenc)
        assert int(tcount[0]) == int(jcount)
        np.testing.assert_array_equal(tids[0].numpy(), np.asarray(jids))
        close_state(tstate, jstate)


def test_decoder_out_with_startup_ids_matches_jax():
    jcfg, jp, tcfg, tp = _models(seed=6)
    ctx = np.array([[-1, -1], [-1, 7], [3, 39]])
    got = tzf.decoder_out(tp, tcfg, torch.from_numpy(ctx))
    for i in range(3):
        _close(got[i].numpy(), jzf.decoder_out(jp, jcfg, jnp.asarray(ctx[i], jnp.int32)))


@pytest.mark.parametrize("max_new", [8, 2])
def test_greedy_chunk_matches_jax_at_max_new(max_new):
    """The greedy search on four frames, its blank made rare so most frames
    emit: at max_new = 2 the emissions past the cap go to the dump slot
    and still move the context (the clamp case)."""
    jcfg, jp, tcfg, tp = _models(seed=7)
    jp["joiner"]["out"]["b"] = jp["joiner"]["out"]["b"].at[0].set(-30.0)
    tp["joiner"]["out"]["b"][0] = -30.0
    enc = np.random.default_rng(8).standard_normal((3, 4, 16)).astype(np.float32)
    ctx = np.array([[-1, -1], [5, 6], [-1, 2]])
    tstate = {"context": torch.from_numpy(ctx)}
    ts, tids, tcount = tzf.greedy_chunk(tp, tcfg, tstate, torch.from_numpy(enc), max_new=max_new)
    for i in range(3):
        js, jids, jcount = jzf.greedy_chunk(jp, jcfg, {"context": jnp.asarray(ctx[i], jnp.int32)},
                                            jnp.asarray(enc[i]), max_new=max_new)
        np.testing.assert_array_equal(tids[i].numpy(), np.asarray(jids))
        assert int(tcount[i]) == int(jcount)
        np.testing.assert_array_equal(ts["context"][i].numpy(), np.asarray(js["context"]))
    if max_new == 2:
        assert (tcount == 2).all()


def test_batched_rows_equal_each_stream_alone():
    _, _, tcfg, tp = _models(seed=9)
    wins = _windows(10, tcfg, 3)
    state = tzf.init_state(tcfg, 3)
    state, ids, count = tzf.transcribe_chunk(tp, tcfg, state, torch.from_numpy(wins))
    for i in range(3):
        s1, i1, c1 = tzf.transcribe_chunk(tp, tcfg, tzf.init_state(tcfg), torch.from_numpy(wins[i : i + 1]))
        assert int(c1[0]) == int(count[i])
        np.testing.assert_array_equal(i1[0].numpy(), ids[i].numpy())


def test_session_transcribe_matches_jax():
    jcfg, jp, tcfg, tp = _models(seed=11)
    audio = (np.random.default_rng(12).standard_normal(20000) * 2000).astype(np.float32)
    want = jss.XasrStreamingSession(jp, jcfg).transcribe(audio)
    got = tss.XasrStreamingSession(tp, tcfg).transcribe(audio)
    assert got.token_ids == want.token_ids and len(got.token_ids) > 0
    pad = jss.snip_edges_false_pad(audio, 400, 160)
    np.testing.assert_array_equal(tss.snip_edges_false_pad(audio, 400, 160), pad)


def test_q8_session_ids_equal_dequantized_f32():
    _, _, tcfg, tp = _models(seed=13)
    q = quantize_pytree(tp, bits=8, block=8, min_size=0, refine_iters=0)
    lay = q["stacks"][1]["layers"][0]
    hot = [lay["attn_in_proj"]["w"], lay["ff1"]["in"]["w"], lay["nonlin"]["in"]["w"], lay["sa1"]["out"]["w"],
           lay["conv1"]["in"]["w"], q["embed"]["out"]["w"], q["embed"]["convnext"]["pw1"]["w"],
           q["encoder_proj"]["w"], q["decoder"]["proj"]["w"], q["joiner"]["out"]["w"]]
    assert all(isinstance(w, QuantizedLinear) for w in hot)
    assert not isinstance(q["embed"]["convnext"]["dw"]["w"], QuantizedLinear)  # a conv kernel
    audio = (np.random.default_rng(14).standard_normal(16000) * 2000).astype(np.float32)
    got = tss.XasrStreamingSession(q, tcfg).transcribe(audio)
    want = tss.XasrStreamingSession(dequantize_pytree(q), tcfg).transcribe(audio)
    assert got.token_ids == want.token_ids and len(got.token_ids) > 0
