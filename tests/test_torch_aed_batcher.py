"""PyTorch port: continuous AED batching against the JAX package's batcher.

Both batchers take the same prefilled requests (the JAX package's
``prefill_window``, its state carried over to torch) on the same schedule of
joins, so the ids they generate compare directly. Geometries: the JAX
batcher test's Whisper (d 32, 4 heads: the rowwise step) and the JAX
multi-kernel test's q8 Whisper (d 256, head_dim 64: the fused step, whose
plain version runs on the CPU, against JAX's interpret-mode kernel).

Tolerances: the rowwise step runs f32 matmuls in both packages, so hidden
states and caches agree to f32 rounding (1e-5 of max|value|); ids are
compared exactly (greedy argmax, the sampler on the same noise).

Deliberate divergence from the JAX package: an explicit request seed N
there derives the same stream as the N-th automatic seed
(``asr_tpu/parallel/aed_batcher.py:441``); the port keeps the two apart
(``test_explicit_seed_never_meets_an_automatic_one``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.decode.ar import DecodeConfig as JDecodeConfig
from asr_tpu.models import whisper as jwh
from asr_tpu.ops.fused_aed_step import stack_whisper_step_params as jstack
from asr_tpu.parallel import aed_batcher as jab
from asr_tpu.quant.quantize import quantize_pytree as jquantize_pytree
from asr_tpu.runtime import artifact as jart
from asr_tpu_torch.decode.ar import DecodeConfig
from asr_tpu_torch.models import whisper as twh
from asr_tpu_torch.ops import fused_aed_multi as tfm
from asr_tpu_torch.ops import quant_matmul as tqm
from asr_tpu_torch.ops.fused_aed_step import stack_whisper_step_params as tstack
from asr_tpu_torch.parallel import aed_batcher as tab
from asr_tpu_torch.parallel.slot_engine import _request_seed
from asr_tpu_torch.runtime import artifact as tart

WTINY = dict(vocab_size=96, d_model=32, encoder_layers=1, decoder_layers=2, num_heads=4,
             n_mels=16, ffn_dim=48, max_source_positions=40, max_target_positions=24, sot_id=1,
             eot_id=2, first_language_id=10, num_languages=4, no_speech_id=30,
             no_timestamps_id=5, transcribe_id=6, translate_id=7)
JCFG, TCFG = jwh.WhisperConfig(**WTINY), twh.WhisperConfig(**WTINY)
DC = dict(max_new_tokens=6, eot_id=2, suppress_ids=(3, 4))
BEGIN_SUPPRESS = (8, 9)
WINDOW = 12800  # 0.8 s -> 80 mel frames -> 40 encoder rows == max_source_positions
TOL = 1e-5


@pytest.fixture(autouse=True)
def _torch_mode():
    prev, mm = torch.get_num_threads(), tqm._CONFIG["mm"]
    torch.set_num_threads(2)
    tqm.set_quant_config(mm="f32")
    yield
    tqm._CONFIG["mm"] = mm
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def wparams():
    jp = jwh.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, tart.params_from_flat(jart.flatten_pytree(jp), "cpu")


def _audio(seed):
    return (np.random.default_rng(seed).standard_normal(WINDOW) * 0.05).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _prefill(jp, jcfg, audio, dc, prompt=None):
    """One request prefilled by the JAX package, for both batchers."""
    mel = jwh.mel_for_audio(jcfg, jnp.asarray(audio)[None])
    prompt = prompt if prompt is not None else jnp.asarray(
        [[jcfg.sot_id, -1, jcfg.transcribe_id, jcfg.no_timestamps_id]], jnp.int32)
    pre = jwh.prefill_window(jp, jcfg, mel, prompt, dc, begin_suppress_ids=BEGIN_SUPPRESS)
    tc = pre["state"]["layers"][0]["cross_k"].shape[1]
    tstate = {"layers": tuple({k: _t(v) for k, v in ls.items()} for ls in pre["state"]["layers"])}
    return (pre["state"], pre["logits0"]), (tstate, _t(pre["logits0"])), tc


def _run(bat, reqs, schedule, seeds=None):
    """Submit requests on ``schedule`` (request -> ticks after the previous
    submit), draining finished slots; returns each request's ids."""
    got = [None] * len(reqs)
    slots = {}

    def tick():
        for slot, _tok, fin in bat.step_tick():
            if fin and slot in slots:
                got[slots.pop(slot)] = bat.take_result(slot)

    for r, wait in schedule:
        for _ in range(wait):
            tick()
        state, lg0, tc = reqs[r]
        seed = None if seeds is None else seeds[r]
        s = bat.try_submit(state, 4, lg0, tc, seed=seed)
        assert s is not None
        slots[s] = r
    for _ in range(40):
        if not slots:
            break
        tick()
    return got


def _both(jp, tp, audios, dc_kw, n_slots, schedule, **kw):
    jdc, tdc = JDecodeConfig(**dc_kw), DecodeConfig(**dc_kw)
    pre = [_prefill(jp, JCFG, a, jdc) for a in audios]
    jbat = jab.ContinuousAedBatcher(jp, jab.spec_for_whisper(JCFG), jdc, n_slots=n_slots,
                                    **kw.get("jax", {}))
    tbat = tab.ContinuousAedBatcher(tp, tab.spec_for_whisper(TCFG), tdc, n_slots=n_slots,
                                    **kw.get("port", {}))
    jgot = _run(jbat, [(p[0][0], p[0][1], p[2]) for p in pre], schedule, kw.get("seeds"))
    tgot = _run(tbat, [(p[1][0], p[1][1], p[2]) for p in pre], schedule, kw.get("seeds"))
    return jgot, tgot, tbat


def test_spec_matches_jax():
    assert tab.spec_for_whisper(TCFG).__dict__ == jab.spec_for_whisper(JCFG).__dict__


def test_rowwise_step_matches_jax(wparams):
    """Mixed positions, one parked row, a short tc_valid: hidden states and
    written caches against JAX's ``aed_decoder_step_rowwise``; the parked
    row writes nowhere."""
    jp, tp = wparams
    dc = JDecodeConfig(**DC)
    jstates = [_prefill(jp, JCFG, _audio(s), dc)[0][0] for s in (1, 2, 3)]
    jstate = {"layers": tuple({k: jnp.concatenate([st["layers"][l][k] for st in jstates])
                               for k in jstates[0]["layers"][l]} for l in range(2))}
    tstate = {"layers": tuple({k: _t(v) for k, v in ls.items()} for ls in jstate["layers"])}
    pos, tcv, act = [4, 6, 5], [40, 25, 40], [True, True, False]
    toks = [11, 17, 23]
    jspec, tspec = jab.spec_for_whisper(JCFG), tab.spec_for_whisper(TCFG)
    jx = jab._embed_rows(jp["decoder"], jspec, jnp.asarray(toks), jnp.asarray(pos))
    tx = tab._embed_rows(tp["decoder"], tspec, torch.tensor(toks), torch.tensor(pos))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-7)
    jh, jst = jab.aed_decoder_step_rowwise(jp["decoder"], jspec, jx[:, None], jstate,
                                           jnp.asarray(pos, jnp.int32), jnp.asarray(tcv, jnp.int32),
                                           jnp.asarray(act))
    before = [ls["self_k"].clone() for ls in tstate["layers"]]
    th, tst = tab.aed_decoder_step_rowwise(tp["decoder"], tspec, tx[:, None], tstate,
                                           torch.tensor(pos, dtype=torch.int32),
                                           torch.tensor(tcv, dtype=torch.int32),
                                           torch.tensor(act))
    jh = np.asarray(jh)
    np.testing.assert_allclose(th.numpy(), jh, rtol=0, atol=TOL * np.abs(jh).max())
    for a, b, old in zip(tst["layers"], jst["layers"], before):
        for key in ("self_k", "self_v"):
            want = np.asarray(b[key])
            np.testing.assert_allclose(a[key].numpy(), want, rtol=0, atol=TOL * np.abs(want).max())
        assert torch.equal(a["self_k"][2], old[2])  # the parked row wrote nowhere
    # FireRed / Dolphin's input math (sqrt(d)-scaled embeddings + sinusoid
    # positions) on the same decoder rows
    jrel = jab._embed_rows(jp["decoder"], jab.AedEngineSpec(32, 48, 4, 96, 24, 40, "scaled_relpos"),
                           jnp.asarray(toks + [5]), jnp.asarray(pos + [30]))
    trel = tab._embed_rows(tp["decoder"], tab.AedEngineSpec(32, 48, 4, 96, 24, 40, "scaled_relpos"),
                           torch.tensor(toks + [5]), torch.tensor(pos + [30]))
    np.testing.assert_allclose(trel.numpy(), np.asarray(jrel), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="input math"):
        tab._embed_rows(tp["decoder"], tab.AedEngineSpec(32, 48, 4, 96, 24, 40, "other"),
                        torch.tensor([1]), torch.tensor([0]))


@pytest.mark.parametrize("strategy", ["greedy", "penalty"])
def test_staggered_joins_match_jax(wparams, strategy):
    """Two requests, two steps mid-flight, a third joins; two late requests
    reuse freed slots."""
    jp, tp = wparams
    kw = dict(DC, strategy=strategy, penalty=1.5 if strategy == "penalty" else 1.0,
              penalty_range=4)
    schedule = [(0, 0), (1, 0), (2, 2), (3, 9), (4, 0)]
    jgot, tgot, _ = _both(jp, tp, [_audio(s) for s in range(5)], kw, 3, schedule)
    assert all(g is not None for g in tgot)
    assert tgot == jgot


def test_steps_per_tick_gives_the_same_stream(wparams):
    jp, tp = wparams
    schedule = [(0, 0), (1, 0), (2, 0)]
    audios = [_audio(s) for s in (11, 12, 13)]
    jgot, t3, _ = _both(jp, tp, audios, DC, 3, schedule, jax={"steps_per_tick": 3},
                        port={"steps_per_tick": 3})
    _, t1, _ = _both(jp, tp, audios, DC, 3, schedule)
    assert t3 == t1 == jgot


def test_slot_exhaustion_returns_none(wparams):
    jp, tp = wparams
    dc = JDecodeConfig(**DC)
    bat = tab.ContinuousAedBatcher(tp, tab.spec_for_whisper(TCFG), DecodeConfig(**DC), n_slots=1)
    (_, (st0, lg0), tc), (_, (st1, lg1), _) = (_prefill(jp, JCFG, _audio(s), dc) for s in (20, 21))
    s0 = bat.try_submit(st0, 4, lg0, tc)
    assert s0 is not None
    assert bat.try_submit(st1, 4, lg1, tc) is None  # full
    while bat.is_active(s0):
        bat.step()
    assert bat.n_active == 0
    bat.take_result(s0)
    assert bat.try_submit(st1, 4, lg1, tc) is not None  # freed
    with pytest.raises(ValueError, match="exceeds t_max"):
        tab.ContinuousAedBatcher(tp, tab.spec_for_whisper(TCFG),
                                 DecodeConfig(**dict(DC, max_new_tokens=30)), n_slots=1
                                 ).try_submit(st0, 4, lg0, tc)


def test_fused_route_matches_jax_fused_batcher():
    """q8 weights at head_dim 64: the port's batcher steps through
    ``fused_aed_step_multi`` (its plain version on the CPU), JAX's through
    the interpret-mode multi-slot kernel; a request joins mid-flight."""
    qtiny = dict(vocab_size=64, d_model=256, encoder_layers=1, decoder_layers=2, num_heads=4,
                 ffn_dim=1024, n_mels=16, max_source_positions=24, max_target_positions=16,
                 sot_id=1, eot_id=-1, no_speech_id=2, first_language_id=8, num_languages=4)
    jcfg, tcfg = jwh.WhisperConfig(**qtiny), twh.WhisperConfig(**qtiny)
    jp = jquantize_pytree(jwh.init_params(jcfg, jax.random.PRNGKey(2)), bits=8, block=128,
                          min_size=0, refine_iters=0, quantize_embeddings=True)
    tp = tart.params_from_flat(jart.flatten_pytree(jp), "cpu")
    kw = dict(max_new_tokens=5, eot_id=-1)
    jdc = JDecodeConfig(**kw)
    prompt = jnp.asarray([[jcfg.sot_id, -1, 5, 6]], jnp.int32)
    pre = []
    for s in range(3):
        mel = jax.random.normal(jax.random.PRNGKey(40 + s), (1, 48, jcfg.n_mels), jnp.float32)
        p = jwh.prefill_window(jp, jcfg, mel, prompt, jdc)
        tstate = {"layers": tuple({k: _t(v) for k, v in ls.items()} for ls in p["state"]["layers"])}
        pre.append(((p["state"], p["logits0"]), (tstate, _t(p["logits0"])), 24))
    jbat = jab.ContinuousAedBatcher(jp, jab.spec_for_whisper(jcfg), jdc, n_slots=2,
                                    stacked=jstack(jp, jcfg), fused_interpret=True)
    tbat = tab.ContinuousAedBatcher(tp, tab.spec_for_whisper(tcfg), DecodeConfig(**kw), n_slots=2,
                                    stacked=tstack(tp, tcfg))
    assert jbat.stacked is not None and tbat.stacked is not None
    assert tbat.state["k"].shape == (2, 2, 16, 256)  # (NL, slots, T, D)
    schedule = [(0, 0), (1, 1), (2, 7)]
    before = tfm.LAUNCHES
    jgot = _run(jbat, [(p[0][0], p[0][1], p[2]) for p in pre], schedule)
    tgot = _run(tbat, [(p[1][0], p[1][1], p[2]) for p in pre], schedule)
    assert tfm.LAUNCHES == before  # CPU tensors: the plain version, no launch
    assert all(g is not None and len(g) == 6 for g in tgot)
    assert tgot == jgot


def _jax_draw(seed, k, shape, device):
    """The JAX batcher's k-th draw for a request of explicit seed ``seed``
    (base key PRNGKey(0)): the first token's, then one per step."""
    k_first, k_slot = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), seed))
    if k == 0:
        key = jax.random.split(k_first)[1]
    else:
        key = k_slot
        for _ in range(k - 1):
            key = jax.random.split(key)[1]
        key = jax.random.split(key)[0]
    return _t(jax.random.uniform(key, shape, jnp.float32, 1e-20, 1.0))


SAMPLING = dict(DC, strategy="sampling", temperature=1.0, top_k=8, top_p=0.9)


def test_sampling_on_jax_draws_matches_jax(wparams):
    jp, tp = wparams
    schedule = [(0, 0), (1, 1), (2, 3)]
    jgot, tgot, _ = _both(jp, tp, [_audio(s) for s in (31, 32, 33)], SAMPLING, 3, schedule,
                          port={"noise": _jax_draw}, seeds=[42, 7, 1000])
    assert tgot == jgot


def test_sampled_ids_do_not_depend_on_siblings(wparams):
    """A request's sampled ids depend only on its seed and its own step
    index, not on the engine's history or the other slots."""
    jp, tp = wparams
    dc = JDecodeConfig(**SAMPLING)
    (_, (st, lg), tc), (_, (st2, lg2), _) = (_prefill(jp, JCFG, _audio(s), dc) for s in (34, 35))

    def run(prewarm):
        bat = tab.ContinuousAedBatcher(tp, tab.spec_for_whisper(TCFG), DecodeConfig(**SAMPLING),
                                       n_slots=2, seed=3)
        if prewarm:  # another engine history and a live sibling slot
            bat.try_submit(st2, 4, lg2, tc, seed=999)
            bat.step()
            bat.step()
        slot = bat.try_submit(st, 4, lg, tc, seed=42)
        while bat.is_active(slot):
            bat.step()
        return bat.take_result(slot)

    assert run(False) == run(True)


def test_explicit_seed_never_meets_an_automatic_one():
    """Deliberate divergence from the JAX package, where seed N collides with
    the N-th automatic seed: the port derives them apart."""
    assert _request_seed(0, True, 0) != _request_seed(0, False, 0)
    assert _request_seed(0, True, 5) != _request_seed(0, False, 5)
    assert _request_seed(0, True, 5) == _request_seed(0, True, 5)
    assert _request_seed(1, True, 5) != _request_seed(0, True, 5)
