"""PyTorch port: Dolphin (E-Branchformer encoder, AR decoder with language
and region probes, CTC head) against the JAX package at a tiny geometry:
the E-Branchformer block, the encoder on padded batches, the probes and
greedy decode on both routes, the CTC head, the fused batch-1 loop against
JAX's interpret-mode Pallas kernel, continuous batching with per-request
probes, the session's language catalog, JAX-written q8 artifacts and the
quantized leaves.

Tolerances: f32 values within 1e-4 of max|reference| (JAX at ``highest``
precision), ids, probes and counts exactly; quantized leaves of the
round-to-nearest fit as ``tests/test_torch_quant.py`` holds them (q exactly,
scales and zeros within 1e-6 relative). The per-weight route runs the
port's ``mm="f32"``; the fused route the bf16 mode against JAX's fused
route in interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.decode.ar import DecodeConfig as JDecodeConfig
from asr_tpu.layers import conformer as jconf
from asr_tpu.layers import ebranchformer as jeb
from asr_tpu.layers.attention import NEG_INF
from asr_tpu.models import dolphin as jdp
from asr_tpu.ops import quant_matmul as jqm
from asr_tpu.ops.fused_aed_step import AedGeom as JAedGeom
from asr_tpu.ops.fused_aed_step import stack_aed_step_params as jstack
from asr_tpu.quant.quantize import quantize_pytree as jquantize_pytree
from asr_tpu.runtime import artifact as jart
from asr_tpu.runtime import transducer_session as jts
from asr_tpu.runtime.metadata import ModelMetadata as JModelMetadata
from asr_tpu_torch.decode.ar import DecodeConfig
from asr_tpu_torch.layers import ebranchformer as teb
from asr_tpu_torch.models import dolphin as tdp
from asr_tpu_torch.ops import fused_aed_multi as tfm
from asr_tpu_torch.ops import fused_aed_step as tfs
from asr_tpu_torch.ops import quant_matmul as tqm
from asr_tpu_torch.parallel import aed_batcher as tab
from asr_tpu_torch.quant.quantize import quantize_pytree
from asr_tpu_torch.runtime import artifact as tart
from asr_tpu_torch.runtime import transducer_session as tts
from asr_tpu_torch.runtime.metadata import config_from_dict

TINY = dict(vocab_size=96, d_model=256, enc_layers=1, enc_heads=4, enc_ffn=320, cgmlp_dim=320,
            csgu_kernel=7, fusion_kernel=3, dec_layers=2, dec_heads=4, dec_ffn=768, sos_id=1,
            eos_id=2, language_token_start=40, language_token_end=50, region_token_start=50,
            region_token_end=60, max_target_positions=16)
WINDOW_S = 0.5  # 8000 samples -> 51 mel frames -> 12 encoder rows
CATALOG = {"languages": {"ja": 41, "zh": 44}, "regions": {"SICHUAN": 55, "JP": 52},
           "aliases": {"Japanese": "ja", "Chinese": "zh"}}
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
    jcfg, tcfg = jdp.DolphinConfig(**{**TINY, **over}), tdp.DolphinConfig(**{**TINY, **over})
    jp = jdp.init_params(jcfg, jax.random.PRNGKey(seed))
    if quant == "q8":
        jp = jquantize_pytree(jp, bits=8, block=128, min_size=4096, refine_iters=0,
                              quantize_embeddings=True)
    elif quant == "dec_q8":
        jp["decoder"] = jquantize_pytree({"decoder": jp["decoder"]}, bits=8, block=128, min_size=0,
                                         refine_iters=0, quantize_embeddings=True)["decoder"]
    return jcfg, jp, tcfg, tart.params_from_flat(jart.flatten_pytree(jp), "cpu")


def _audio(seed, batch=1, n=8000):
    return (np.random.default_rng(seed).standard_normal((batch, n)) * 2000).astype(np.float32)


def _prompt(batch, lang=-1, region=-2):
    return np.tile(np.array([[1, lang, region]], np.int64), (batch, 1))


def test_ebranchformer_block_matches_jax():
    """Random norms and biases (the init has ones and zeros) and a key mask."""
    d, h = 64, 4
    p = jeb.init_block_params(jax.random.PRNGKey(3), d, h, 96, 80, 5, 3)
    flat = jart.flatten_pytree(p)
    rng = np.random.default_rng(3)
    flat = {k: v + rng.standard_normal(v.shape).astype(np.float32) * 0.1 for k, v in flat.items()}
    jp = jax.tree.map(jnp.asarray, jart.unflatten_pytree(flat))
    tp = tart.params_from_flat(flat, "cpu")
    assert {k: v.shape for k, v in tart.flatten_pytree(
        teb.init_block_params(torch.Generator().manual_seed(0), d, h, 96, 80, 5, 3, "cpu")).items()} \
        == {k: v.shape for k, v in flat.items()}
    x = rng.standard_normal((2, 11, d)).astype(np.float32)
    valid = np.array([11, 6])
    keep = np.arange(11)[None] < valid[:, None]
    bias = np.where(keep, 0.0, NEG_INF)[:, None, None].astype(np.float32)
    pe = jconf.relative_position_embedding(11, d)
    want = jeb.ebranchformer_block(jnp.asarray(x), jp, h, jnp.asarray(pe), jnp.asarray(bias),
                                   jnp.asarray(keep))
    got = teb.ebranchformer_block(torch.from_numpy(x), tp, h, torch.from_numpy(pe),
                                  torch.from_numpy(bias), torch.from_numpy(keep))
    for i, n in enumerate(valid):
        _close(got[i, :n].numpy(), np.asarray(want)[i, :n])
    g0 = rng.standard_normal((2, 11, 80)).astype(np.float32)
    _close(teb.csgu(torch.from_numpy(g0), tp["cgmlp"]["csgu"], torch.from_numpy(keep)).numpy(),
           jeb.csgu(jnp.asarray(g0), jp["cgmlp"]["csgu"], jnp.asarray(keep)))


def test_config_and_init_layout_match_jax():
    assert dataclasses.asdict(jdp.DolphinConfig()) == dataclasses.asdict(tdp.DolphinConfig())
    assert [f.name for f in dataclasses.fields(jdp.DolphinConfig)] == \
        [f.name for f in dataclasses.fields(tdp.DolphinConfig)]
    cfg = tdp.DolphinConfig(**TINY)
    assert config_from_dict(tdp.DolphinConfig, dataclasses.asdict(cfg)) == cfg
    jflat = jart.flatten_pytree(jdp.init_params(jdp.DolphinConfig(**TINY), jax.random.PRNGKey(0)))
    tflat = tart.flatten_pytree(tdp.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    assert {k: v.shape for k, v in jflat.items()} == {k: v.shape for k, v in tflat.items()}


@pytest.mark.parametrize("quant", ["f32", "q8"])
def test_encode_and_ctc_match_jax_on_a_padded_batch(quant):
    jcfg, jp, tcfg, tp = _models(quant, seed=1)
    audio = _audio(3, batch=3, n=9000)
    valid = np.array([9000, 5200, 2000])
    je, jv = jdp.encode(jp, jcfg, jnp.asarray(audio), jnp.asarray(valid, jnp.int32))
    te, tv = tdp.encode(tp, tcfg, torch.from_numpy(audio), torch.from_numpy(valid))
    assert te.shape == je.shape == (3, 13, 256)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for i, n in enumerate(tv.tolist()):
        _close(te[i, :n].numpy(), np.asarray(je)[i, :n])
    # the CTC head on the JAX encoder output, so both heads see the same input
    jt, jc = jdp.ctc_decode(jp, jcfg, je, jv)
    tt, tc = tdp.ctc_decode(tp, tcfg, torch.from_numpy(np.array(je)), tv)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for i, n in enumerate(tc.tolist()):
        np.testing.assert_array_equal(tt[i, :n].numpy(), np.asarray(jt)[i, :n])
    assert int(tc.sum()) > 0


@pytest.mark.parametrize("batch,probes", [(1, "both"), (2, "both"), (2, "language"), (1, "none")])
def test_transcribe_and_probes_match_jax(batch, probes):
    over = {"both": {}, "language": {"region_token_end": 50}, "none": {"language_token_end": 40}}[probes]
    jcfg, jp, tcfg, tp = _models("f32", seed=2, **over)
    audio = _audio(4, batch=batch)
    valid = np.array([8000, 6100][:batch])
    prompt = _prompt(batch) if probes != "none" else _prompt(batch, 47, 53)
    kw = dict(max_new_tokens=6, eot_id=5, suppress_ids=(3,))
    want = jdp.transcribe(jp, jcfg, jnp.asarray(audio), jnp.asarray(valid, jnp.int32),
                          jnp.asarray(prompt, jnp.int32), JDecodeConfig(**kw))
    got = tdp.transcribe(tp, tcfg, torch.from_numpy(audio), torch.from_numpy(valid),
                         torch.from_numpy(prompt), DecodeConfig(**kw))
    assert sorted(got) == sorted(want)
    assert ("language" in got) == (probes != "none") and ("region" in got) == (probes == "both")
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    if probes == "both":  # the probed ids stand in the prompt slots
        np.testing.assert_array_equal(got["tokens"][:, 1].numpy(), got["language"].numpy())
        np.testing.assert_array_equal(got["tokens"][:, 2].numpy(), got["region"].numpy())


def test_fused_loop_matches_jax_interpret_kernel_and_the_per_weight_route():
    """Decoder-only q8 at batch 1 with both probes and fewer valid encoder
    rows than the window holds: the port's ``fused_ar_decode`` (the plain
    step on the CPU, over ``enc_valid`` cross rows) against JAX's
    ``transcribe(stacked=..., fused_interpret=True)`` and the port's
    per-weight route, all in bf16."""
    jcfg, jp, tcfg, tp = _models("dec_q8", seed=7)
    tqm.set_quant_config(mm="bf16")
    jqm.set_quant_config(mm="bf16")
    audio, valid, prompt = _audio(1), np.array([6000]), _prompt(1)
    kw = dict(max_new_tokens=5, eot_id=-1)
    want = jdp.transcribe(jp, jcfg, jnp.asarray(audio), jnp.asarray(valid, jnp.int32),
                          jnp.asarray(prompt, jnp.int32), JDecodeConfig(**kw),
                          stacked=jstack(jp["decoder"], JAedGeom(256, 768, 4)), fused_interpret=True)
    stacked = tfs.stack_aed_step_params(tp["decoder"], tfs.AedGeom(256, 768, 4))
    a, v, pr = torch.from_numpy(audio), torch.from_numpy(valid), torch.from_numpy(prompt)
    before = tfs.LAUNCHES
    got = tdp.transcribe(tp, tcfg, a, v, pr, DecodeConfig(**kw), stacked=stacked)
    per_weight = tdp.transcribe(tp, tcfg, a, v, pr, DecodeConfig(**kw))
    assert tfs.LAUNCHES == before  # CPU tensors: the plain version, no launch
    for k in ("tokens", "counts", "language", "region"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        np.testing.assert_array_equal(per_weight[k].numpy(), got[k].numpy(), err_msg=k)
    assert int(got["counts"][0]) == 6


def _session(tp, tcfg, **kw):
    return tts.DolphinSession(tp, tcfg, decode_cfg=DecodeConfig(max_new_tokens=5, eot_id=tcfg.eos_id),
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
def test_continuous_ids_equal_each_request_alone_with_probes(route):
    """Each request probes its own language and region in its prefill, then
    joins a running batch; its ids equal it alone through the batcher and
    the session's own decode (``session.transcribe`` per-weight in f32 for
    the rowwise route, the batch-1 fused loop in bf16 for the multi-slot
    step's plain version). One request forces its language by name."""
    _, _, tcfg, tp = _models("f32" if route == "rowwise" else "dec_q8", seed=3)
    sess = _session(tp, tcfg, language_catalog=CATALOG)
    stacked = None
    if route == "fused":
        tqm.set_quant_config(mm="bf16")
        stacked = tfs.stack_aed_step_params(tp["decoder"], tfs.AedGeom(256, 768, 4))
    audios = [_audio(30 + i)[0, :n] for i, n in enumerate((8000, 7000, 4000))]
    langs = [None, "Japanese-JP", None]

    def solo(a, lang):
        """(ids, the prompt's language id, the probed language)."""
        lid, rid = sess.resolve_language(lang) if lang else (-1, -2)
        out = tdp.transcribe(tp, tcfg, torch.from_numpy(np.pad(a, (0, 8000 - len(a))))[None],
                             torch.tensor([len(a)]), torch.tensor([[1, lid, rid]]), sess.decode_cfg,
                             stacked=stacked)
        return (out["tokens"][0, 3 : 3 + int(out["counts"][0])].tolist(), int(out["tokens"][0, 1]),
                int(out["language"][0]))

    want = [solo(a, lang) for a, lang in zip(audios, langs)]
    assert want[1][1] == 41 != want[1][2]  # forced; the probe still runs and is reported
    if route == "rowwise":
        assert [sess.transcribe(a).token_ids for a in (audios[0], audios[2])] == \
            [want[i][0] for i in (0, 2)]
    bat = tab.ContinuousAedBatcher(tp, sess.aed_engine_spec(), sess.decode_cfg, n_slots=2,
                                   stacked=stacked)
    assert (bat.stacked is not None) == (route == "fused")

    def submit(r):
        pre = sess.continuous_prefill(audios[r], language=langs[r])
        assert pre["p_len"] == 3 and sess.last_language == want[r][2]
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
    assert got == [w[0] for w in want]
    for r in range(3):
        alone, out = {submit(r): r}, [None] * 3
        _drain(bat, alone, out)
        assert out[r] == want[r][0]


@pytest.mark.parametrize("window_s", [None, 2.3])
def test_engine_tc_max_equals_the_prefill_cross_length(window_s):
    """``aed_engine_spec().tc_max`` is computed on the host from the window
    (``1 + S // hop`` mel frames through the two stem convs, 749 rows at
    30 s: an odd count); it must equal the cross length
    ``continuous_prefill`` really produces. The JAX package computes the
    same number with no test of it
    (``asr_tpu/runtime/transducer_session.py:327-339``); this is the port's."""
    _, _, tcfg, tp = _models("f32", seed=4, dec_layers=1)
    kw = {} if window_s is None else {"window_seconds": window_s}
    sess = tts.DolphinSession(tp, tcfg, decode_cfg=DecodeConfig(max_new_tokens=2, eot_id=2), **kw)
    pre = sess.continuous_prefill(np.ones(3000, np.float32))
    assert sess.aed_engine_spec().tc_max == pre["state"]["layers"][0]["cross_k"].shape[1]
    assert sess.aed_engine_spec().tc_max == (749 if window_s is None else 57)
    assert pre["p_len"] == 3 and pre["tc_valid"] < sess.aed_engine_spec().tc_max


def test_resolve_language_matches_jax():
    _, _, tcfg, tp = _models("f32", seed=5, dec_layers=1)
    sess = _session(tp, tcfg, language_catalog=CATALOG)
    jsess = jts.DolphinSession(None, jdp.DolphinConfig(**TINY), language_catalog=CATALOG)
    for name in ("ja", "Japanese", "zh-SICHUAN", "Chinese-Sichuan", "Japanese-jp", "auto",
                 "auto-auto", "zh-auto"):
        assert sess.resolve_language(name) == jsess.resolve_language(name), name
    for name in ("fr", "ja-XX"):
        with pytest.raises(KeyError):
            sess.resolve_language(name)
    forced = _session(tp, tcfg, language_catalog=CATALOG, language="Chinese-Sichuan")
    assert (forced.language_id, forced.region_id) == (44, 55)
    with pytest.raises(KeyError):
        _session(tp, tcfg, language="ja")  # no catalog: forcing never falls back


def test_q8_artifact_from_jax_transcribes_as_the_jax_session(tmp_path):
    jcfg, jp, tcfg, _ = _models("q8", seed=5)
    jqm.set_quant_config(mm="f32")
    meta = JModelMetadata(family="dolphin", extra={"config": dataclasses.asdict(jcfg),
                                                   "dolphin_language_catalog": CATALOG})
    jart.save_model(tmp_path, jp, meta)
    params, tmeta = tart.load_model(tmp_path, "cpu")
    cfg = config_from_dict(tdp.DolphinConfig, tmeta.extra["config"])
    assert cfg == tcfg
    catalog = tmeta.extra["dolphin_language_catalog"]
    audio = (np.random.default_rng(6).standard_normal(17000) * 2000).astype(np.float32)  # 3 windows
    for lang in (None, "zh"):
        sess = _session(params, cfg, language_catalog=catalog, language=lang)
        assert sess.stacked is None  # parameters on the CPU: no stacked copy
        jsess = jts.DolphinSession(jp, jcfg, decode_cfg=JDecodeConfig(max_new_tokens=5, eot_id=2),
                                   window_seconds=WINDOW_S, language_catalog=CATALOG, language=lang)
        got, want = sess.transcribe(audio), jsess.transcribe(audio)
        assert got.token_ids == want.token_ids and len(got.token_ids) > 0
        assert (sess.last_language, sess.last_region) == (jsess.last_language, jsess.last_region)
        assert sess.last_language is not None and sess.last_region is not None


def test_quantized_leaves_match_jax():
    """The rel-pos ``rel_k`` projections, the cgMLP, merge and subsampling
    linears, the CTC head and the tied head quantize; the conv2d stems
    (4-D), the CSGU depthwise taps (parent ``conv``) and the fusion conv
    (parent ``fusion``) stay plain, in both packages alike."""
    _, jp, _, tp = _models("f32", seed=8)
    kw = dict(bits=8, block=128, min_size=4096, refine_iters=0, quantize_embeddings=True)
    want = jart.flatten_pytree(jquantize_pytree(jp, **kw))
    got = tart.flatten_pytree(quantize_pytree(tp, **kw))
    assert sorted(got) == sorted(want)
    for k in want:  # the round-to-nearest fit: scales and zeros to 1e-6, the rest exactly
        if "__quant__/scale" in k or "__quant__/zero" in k:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("enc_blocks/0/attn/rel_k/w/__quant__/q", "ctc/w/__quant__/q",
              "enc_blocks/0/cgmlp/proj1/w/__quant__/q", "decoder/embed/__qembed__/q",
              "subsample/conv0/w", "enc_blocks/0/cgmlp/csgu/conv/w", "enc_blocks/0/fusion/w"):
        assert k in got, k
