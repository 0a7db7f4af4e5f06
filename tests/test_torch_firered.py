"""PyTorch port: FireRedASR-AED (and the conformer layer pieces it uses)
against the JAX package at a tiny geometry: the relative-position table,
the rel-shift skew and rel-pos attention, the NHWC conv2d, the encoder on
padded batches, greedy decode on both routes, the fused batch-1 loop against
JAX's interpret-mode Pallas kernel, continuous batching, the session, JAX-
written q8 artifacts and the quantized leaves.

Tolerances: f32 values within 1e-4 of max|reference| (JAX at ``highest``
precision), tables and the skew exactly, ids exactly; quantized leaves of
the round-to-nearest fit as ``tests/test_torch_quant.py`` holds them (q
exactly, scales and zeros within 1e-6 relative).
The per-weight route runs the port's ``mm="f32"`` (JAX's exact CPU
product); the fused route runs the bf16 mode, where it applies, against
JAX's fused route in interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.decode.ar import DecodeConfig as JDecodeConfig
from asr_tpu.layers import conformer as jconf
from asr_tpu.layers.attention import NEG_INF
from asr_tpu.models import firered as jfr
from asr_tpu.ops import quant_matmul as jqm
from asr_tpu.ops.fused_aed_step import AedGeom as JAedGeom
from asr_tpu.ops.fused_aed_step import stack_aed_step_params as jstack
from asr_tpu.quant.quantize import quantize_pytree as jquantize_pytree
from asr_tpu.runtime import artifact as jart
from asr_tpu.runtime import transducer_session as jts
from asr_tpu.runtime.metadata import ModelMetadata as JModelMetadata
from asr_tpu_torch.decode.ar import DecodeConfig
from asr_tpu_torch.layers import conformer as tconf
from asr_tpu_torch.models import firered as tfr
from asr_tpu_torch.ops import fused_aed_multi as tfm
from asr_tpu_torch.ops import fused_aed_step as tfs
from asr_tpu_torch.ops import quant_matmul as tqm
from asr_tpu_torch.parallel import aed_batcher as tab
from asr_tpu_torch.quant.quantize import quantize_pytree
from asr_tpu_torch.runtime import artifact as tart
from asr_tpu_torch.runtime import transducer_session as tts
from asr_tpu_torch.runtime.metadata import config_from_dict

TINY = dict(vocab_size=96, d_model=256, enc_layers=1, enc_heads=4, dec_layers=2, dec_heads=4,
            dec_ffn=768, max_target_positions=16, sos_id=1, eos_id=2)
WINDOW_S = 0.5  # 8000 samples -> 48 fbank frames + 6 lookahead -> 12 encoder rows
TOL = 1e-4


@pytest.fixture(autouse=True)
def _modes():
    prev, jprev, threads = tqm._CONFIG["mm"], dict(jqm._CONFIG), torch.get_num_threads()
    torch.set_num_threads(2)
    tqm.set_quant_config(mm="f32")
    yield
    tqm._CONFIG["mm"] = prev
    jqm._CONFIG.update(jprev)
    torch.set_num_threads(threads)


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-6))


def _models(quant: str = "f32", seed: int = 0, **over):
    """(JAX cfg, JAX params, port cfg, port params): f32, the whole tree q8
    (``"q8"``), or the decoder only q8 with its tied head (``"dec_q8"``)."""
    jcfg, tcfg = jfr.FireRedConfig(**{**TINY, **over}), tfr.FireRedConfig(**{**TINY, **over})
    jp = jfr.init_params(jcfg, jax.random.PRNGKey(seed))
    if quant == "q8":
        jp = jquantize_pytree(jp, bits=8, block=128, min_size=4096, refine_iters=0,
                              quantize_embeddings=True)
    elif quant == "dec_q8":
        jp["decoder"] = jquantize_pytree({"decoder": jp["decoder"]}, bits=8, block=128, min_size=0,
                                         refine_iters=0, quantize_embeddings=True)["decoder"]
    return jcfg, jp, tcfg, tart.params_from_flat(jart.flatten_pytree(jp), "cpu")


def _audio(seed, batch=1, n=8000):
    return (np.random.default_rng(seed).standard_normal((batch, n)) * 2000).astype(np.float32)


# ── the conformer layer pieces ────────────────────────────────────────────
def test_relative_position_table_and_rel_shift_exact():
    for s, d in ((1, 8), (5, 8), (12, 256), (448, 1280)):
        np.testing.assert_array_equal(tconf.relative_position_embedding(s, d),
                                      jconf.relative_position_embedding(s, d))
    table = jconf.relative_position_embedding(16, 64)[:16][::-1]
    np.testing.assert_array_equal(tconf.absolute_positions(16, 64, torch.device("cpu")).numpy(), table)
    x = np.random.default_rng(0).standard_normal((2, 3, 7, 13)).astype(np.float32)
    np.testing.assert_array_equal(tconf.rel_shift(torch.from_numpy(x)).numpy(),
                                  np.asarray(jconf.rel_shift(jnp.asarray(x))))
    lens = np.array([0, 5, 6, 7, 11, 12, 13, 600])
    np.testing.assert_array_equal(tconf.subsampled_length(torch.from_numpy(lens)).numpy(),
                                  ((lens - 3) // 2 + 1 - 3) // 2 + 1)


def test_rel_pos_attention_with_key_mask_matches_jax():
    rng = np.random.default_rng(1)
    b, s, d, h = 2, 9, 64, 4

    def lin(bias=True):
        p = {"w": rng.standard_normal((d, d)).astype(np.float32) * d ** -0.5}
        if bias:
            p["b"] = rng.standard_normal(d).astype(np.float32) * 0.1
        return p

    p = {"q": lin(), "k": lin(), "v": lin(), "o": lin(), "rel_k": lin(False),
         "bias_u": rng.standard_normal((h, d // h)).astype(np.float32) * 0.1,
         "bias_v": rng.standard_normal((h, d // h)).astype(np.float32) * 0.1}
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    pe = jconf.relative_position_embedding(s, d)
    valid = np.array([9, 5])
    bias = np.where(np.arange(s)[None] < valid[:, None], 0.0, NEG_INF)[:, None, None].astype(np.float32)
    want = jconf.rel_pos_attention(jnp.asarray(x), jax.tree.map(jnp.asarray, p), h, jnp.asarray(pe),
                                   jnp.asarray(bias))
    got = tconf.rel_pos_attention(torch.from_numpy(x), jax.tree.map(torch.from_numpy, p), h,
                                  torch.from_numpy(pe), torch.from_numpy(bias))
    _close(got.numpy(), want)
    _close(tconf.rel_pos_attention(torch.from_numpy(x), jax.tree.map(torch.from_numpy, p), h,
                                   torch.from_numpy(pe), None).numpy(),
           jconf.rel_pos_attention(jnp.asarray(x), jax.tree.map(jnp.asarray, p), h, jnp.asarray(pe), None))


@pytest.mark.parametrize("stride,padding,groups", [((2, 2), (0, 0), 1), ((1, 2), (1, 0), 1),
                                                   ((1, 1), (1, 1), 4)])
def test_conv2d_matches_jax(stride, padding, groups):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 11, 9, 8)).astype(np.float32)
    w = rng.standard_normal((3, 3, 8 // groups, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    want = jconf.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride, padding, groups)
    got = tconf.conv2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), stride, padding,
                       groups)
    assert got.shape == want.shape
    _close(got.numpy(), want)


# ── the model ─────────────────────────────────────────────────────────────
def test_config_and_init_layout_match_jax():
    assert dataclasses.asdict(jfr.FireRedConfig()) == dataclasses.asdict(tfr.FireRedConfig())
    assert [f.name for f in dataclasses.fields(jfr.FireRedConfig)] == \
        [f.name for f in dataclasses.fields(tfr.FireRedConfig)]
    cfg = tfr.FireRedConfig(**TINY)
    assert config_from_dict(tfr.FireRedConfig, dataclasses.asdict(cfg)) == cfg
    jflat = jart.flatten_pytree(jfr.init_params(jfr.FireRedConfig(**TINY), jax.random.PRNGKey(0)))
    tflat = tart.flatten_pytree(tfr.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    assert {k: v.shape for k, v in jflat.items()} == {k: v.shape for k, v in tflat.items()}


@pytest.mark.parametrize("quant", ["f32", "q8"])
def test_encode_matches_jax_on_a_padded_batch(quant):
    jcfg, jp, tcfg, tp = _models(quant, seed=1)
    audio = _audio(3, batch=3, n=9000)
    valid = np.array([9000, 5200, 2000])
    je, jv = jfr.encode(jp, jcfg, jnp.asarray(audio), jnp.asarray(valid, jnp.int32))
    te, tv = tfr.encode(tp, tcfg, torch.from_numpy(audio), torch.from_numpy(valid))
    assert te.shape == je.shape == (3, 14, 256)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for i, n in enumerate(tv.tolist()):
        _close(te[i, :n].numpy(), np.asarray(je)[i, :n])


@pytest.mark.parametrize("batch", [1, 2])
def test_transcribe_per_weight_route_matches_jax(batch):
    jcfg, jp, tcfg, tp = _models("f32", seed=2)
    audio = _audio(4, batch=batch)
    valid = np.array([8000, 6100][:batch])
    kw = dict(max_new_tokens=6, eot_id=5, suppress_ids=(3,))
    jt, jc = jfr.transcribe(jp, jcfg, jnp.asarray(audio), jnp.asarray(valid, jnp.int32),
                            JDecodeConfig(**kw))
    tt, tc = tfr.transcribe(tp, tcfg, torch.from_numpy(audio), torch.from_numpy(valid),
                            DecodeConfig(**kw))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_fused_loop_matches_jax_interpret_kernel_and_the_per_weight_route():
    """Decoder-only q8 (biased k, bias-free o: the zero-filled bias stacking
    Whisper never needs) at batch 1 with fewer valid encoder rows than the
    window holds: the port's ``fused_ar_decode`` (the plain step on the
    CPU, over ``enc_valid`` cross rows) against JAX's ``transcribe(stacked=...,
    fused_interpret=True)`` and the port's per-weight route, all in bf16."""
    jcfg, jp, tcfg, tp = _models("dec_q8", seed=7)
    tqm.set_quant_config(mm="bf16")
    jqm.set_quant_config(mm="bf16")
    audio, valid = _audio(1), np.array([6000])
    kw = dict(max_new_tokens=5, eot_id=-1)
    jstacked = jstack(jp["decoder"], JAedGeom(256, 768, 4))
    want = jfr.transcribe(jp, jcfg, jnp.asarray(audio), jnp.asarray(valid, jnp.int32),
                          JDecodeConfig(**kw), stacked=jstacked, fused_interpret=True)
    stacked = tfs.stack_aed_step_params(tp["decoder"], tfs.AedGeom(256, 768, 4))
    assert stacked is not None and not stacked["ba"][0, 0, 3 * 256 : 4 * 256].any()  # no o bias
    a, v = torch.from_numpy(audio), torch.from_numpy(valid)
    pre = tfr.prefill_window(tp, tcfg, a, v, DecodeConfig(**kw))
    assert int(pre["enc_valid"][0]) < pre["enc"].shape[1]
    before = tfs.LAUNCHES
    got = tfr.transcribe(tp, tcfg, a, v, DecodeConfig(**kw), stacked=stacked)
    per_weight = tfr.transcribe(tp, tcfg, a, v, DecodeConfig(**kw))
    assert tfs.LAUNCHES == before  # CPU tensors: the plain version, no launch
    for g, p, w in zip(got, per_weight, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(p.numpy(), g.numpy())
    assert int(got[1][0]) == 6
    # where the route does not apply, the caller's per-weight step runs
    first = torch.zeros(1, dtype=torch.int64)
    args = (tp, tcfg, pre["state"], pre["enc"], pre["enc_valid"], first,
            torch.zeros((1, 8), dtype=torch.int64), DecodeConfig(**kw))
    assert tfs.fused_ar_decode(*args, stacked=None) is None
    tqm.set_quant_config(mm="f32")
    assert tfs.fused_ar_decode(*args, stacked=stacked) is None


def _session(tp, tcfg, **kw):
    return tts.FireRedSession(tp, tcfg, decode_cfg=DecodeConfig(max_new_tokens=5, eot_id=tcfg.eos_id),
                              window_seconds=WINDOW_S, **kw)


def _drain(bat, slots, got):
    for _ in range(bat.gen_cap + 2):
        events = bat.step()
        if not events:
            return
        for slot, _tok, fin in events:
            if fin and slot in slots:
                got[slots.pop(slot)] = bat.take_result(slot)


@pytest.mark.parametrize("route", ["rowwise", "fused"])
def test_continuous_ids_equal_each_request_alone(route):
    """Requests prefilled by the session join a running batch mid-flight;
    each one's ids equal it alone through the batcher and the session's own
    decode: ``session.transcribe`` (per-weight, f32) for the rowwise route,
    the batch-1 fused loop (bf16) for the multi-slot step's plain version."""
    jcfg, jp, tcfg, tp = _models("f32" if route == "rowwise" else "dec_q8", seed=3)
    sess = _session(tp, tcfg)
    stacked = None
    if route == "fused":
        tqm.set_quant_config(mm="bf16")
        stacked = tfs.stack_aed_step_params(tp["decoder"], tfs.AedGeom(256, 768, 4))
    audios = [_audio(30 + i)[0, : n] for i, n in enumerate((8000, 7000, 4000))]

    def solo(a):
        if route == "rowwise":
            return [t for t in sess.transcribe(a).token_ids]
        toks, counts = tfr.transcribe(tp, tcfg, torch.from_numpy(np.pad(a, (0, 8000 - len(a))))[None],
                                      torch.tensor([len(a)]), sess.decode_cfg, stacked=stacked)
        return toks[0, 1 : 1 + int(counts[0])].tolist()

    want = [solo(a) for a in audios]
    spec = sess.aed_engine_spec()
    bat = tab.ContinuousAedBatcher(tp, spec, sess.decode_cfg, n_slots=2, stacked=stacked)
    assert (bat.stacked is not None) == (route == "fused")

    def submit(r):
        pre = sess.continuous_prefill(audios[r])
        return bat.try_submit(pre["state"], pre["p_len"], pre["logits0"], pre["tc_valid"])

    slots, got = {}, [None] * 3
    before = tfm.LAUNCHES
    slots[submit(0)] = 0
    bat.step()
    slots[submit(1)] = 1  # joins mid-flight
    _drain(bat, slots, got)
    slots[submit(2)] = 2
    _drain(bat, slots, got)
    assert tfm.LAUNCHES == before
    assert got == want
    for r in range(3):
        alone, out = {submit(r): r}, [None] * 3
        _drain(bat, alone, out)
        assert out[r] == want[r]


@pytest.mark.parametrize("window_s", [None, 2.3])
def test_engine_tc_max_equals_the_prefill_cross_length(window_s):
    """``aed_engine_spec().tc_max`` is computed on the host from the window
    (fbank frames, lookahead, the two stem convs); it must equal the cross
    length ``continuous_prefill`` really produces, or the engine's slots
    would be sized wrong. The JAX package computes the same number with no
    test of it (``asr_tpu/runtime/transducer_session.py:200-212``); this is
    the port's."""
    _, _, tcfg, tp = _models("f32", seed=4, dec_layers=1)
    kw = {} if window_s is None else {"window_seconds": window_s}
    sess = tts.FireRedSession(tp, tcfg, decode_cfg=DecodeConfig(max_new_tokens=2, eot_id=2), **kw)
    assert sess.window_samples == int((window_s or 30.0) * 16000)
    pre = sess.continuous_prefill(np.ones(3000, np.float32))
    assert sess.aed_engine_spec().tc_max == pre["state"]["layers"][0]["cross_k"].shape[1]
    assert sess.aed_engine_spec().tc_max == (750 if window_s is None else 57)
    assert pre["p_len"] == 1 and pre["tc_valid"] < sess.aed_engine_spec().tc_max


def test_q8_artifact_from_jax_transcribes_as_the_jax_session(tmp_path):
    jcfg, jp, tcfg, _ = _models("q8", seed=5)
    jqm.set_quant_config(mm="f32")
    meta = JModelMetadata(family="firered", extra={"config": dataclasses.asdict(jcfg)})
    jart.save_model(tmp_path, jp, meta)
    params, tmeta = tart.load_model(tmp_path, "cpu")
    cfg = config_from_dict(tfr.FireRedConfig, tmeta.extra["config"])
    assert cfg == tcfg
    sess = _session(params, cfg)
    assert sess.stacked is None  # parameters on the CPU: no stacked copy
    jsess = jts.FireRedSession(jp, jcfg, decode_cfg=JDecodeConfig(max_new_tokens=5, eot_id=jcfg.eos_id),
                               window_seconds=WINDOW_S)
    audio = (np.random.default_rng(6).standard_normal(17000) * 2000).astype(np.float32)  # 3 windows
    got, want = sess.transcribe(audio), jsess.transcribe(audio)
    assert got.token_ids == want.token_ids and len(got.token_ids) > 0
    assert got.audio_seconds == want.audio_seconds


def test_quantized_leaves_match_jax():
    """The rel-pos ``pos`` projections, the subsampling linear and the tied
    head quantize; the conv2d stems (4-D) and the depthwise taps (parent
    ``dw``) stay plain, in both packages alike."""
    jcfg, jp, tcfg, tp = _models("f32", seed=8)
    kw = dict(bits=8, block=128, min_size=4096, refine_iters=0, quantize_embeddings=True)
    want = jart.flatten_pytree(jquantize_pytree(jp, **kw))
    got = tart.flatten_pytree(quantize_pytree(tp, **kw))
    assert sorted(got) == sorted(want)
    for k in want:  # the round-to-nearest fit: scales and zeros to 1e-6, the rest exactly
        if "__quant__/scale" in k or "__quant__/zero" in k:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert "enc_blocks/0/attn/pos/w/__quant__/q" in got
    assert "decoder/embed/__qembed__/q" in got
    assert "subsample/conv0/w" in got and "enc_blocks/0/conv/dw/w" in got
