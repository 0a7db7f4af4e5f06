"""PyTorch port: continuous LLM batching against the JAX package's batcher.

Both batchers take the same prompt embeddings on the same schedule of joins,
so the ids they generate compare directly. Geometries: the JAX batcher
test's Qwen3 (hidden 48, 4/2 heads of 16: the rowwise step, f32) and the JAX
multi-kernel test's q4 Qwen3 (hidden 256, head width 128: the kernel route,
whose plain version runs on the CPU, against JAX's interpret-mode kernel,
both in the ``bf16`` matmul mode).

Ids are compared exactly: greedy and penalty argmax, and the sampler on the
same noise (JAX's per-slot draws fed through the port's ``noise`` hook).

Deliberate divergence from the JAX package: an explicit request seed N
there derives the same stream as the N-th automatic seed
(``asr_tpu/parallel/llm_batcher.py:398``); the port keeps the two apart
(``test_explicit_seed_never_meets_an_automatic_one``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.decode.ar import DecodeConfig as JDecodeConfig
from asr_tpu.layers import qwen3 as jq3
from asr_tpu.ops import fused_decode as jfd
from asr_tpu.ops import quant_matmul as jqm
from asr_tpu.parallel import llm_batcher as jlb
from asr_tpu.quant.quantize import quantize_pytree as jquantize_pytree
from asr_tpu.runtime import artifact as jart
from asr_tpu_torch.decode.ar import DecodeConfig
from asr_tpu_torch.layers import qwen3 as tq3
from asr_tpu_torch.models import qwen_asr as tqa
from asr_tpu_torch.ops import fused_decode as tfd
from asr_tpu_torch.ops import fused_decode_multi as tfm
from asr_tpu_torch.ops import quant_matmul as tqm
from asr_tpu_torch.parallel import llm_batcher as tlb
from asr_tpu_torch.parallel.mesh import make_mesh
from asr_tpu_torch.runtime import artifact as tart

SIZE = dict(vocab_size=96, hidden=48, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            ffn_dim=64, rope_theta=10000.0, max_seq_len=128)
JCFG, TCFG = jq3.Qwen3Config(**SIZE), tq3.Qwen3Config(**SIZE)
EOT = 7
DC = dict(max_new_tokens=8, eot_id=EOT)
T_MAX = 64
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _torch_mode():
    prev, mm = torch.get_num_threads(), tqm._CONFIG["mm"]
    torch.set_num_threads(2)
    tqm.set_quant_config(mm="f32")
    yield
    tqm._CONFIG["mm"] = mm
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def params():
    jp = jq3.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, tart.params_from_flat(jart.flatten_pytree(jp), "cpu")


def _prompts(seed, lens, vocab=96):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, vocab, size=n)) for n in lens]


def _embeds(jp, tp, ids):
    """(JAX (L, H), port (L, H)) prompt embeddings of one request."""
    return jp["embed"][jnp.asarray(ids, jnp.int32)], tp["embed"][torch.tensor(ids)]


def _run(bat, reqs, schedule, seeds=None):
    """Submit requests on ``schedule`` (request, ticks to run before it),
    draining finished slots; returns each request's ids and the event
    stream."""
    got, slots, stream = [None] * len(reqs), {}, []
    bat.steps_run = 0

    def tick():
        events = bat.step_tick()
        bat.steps_run += bat.last_tick_substeps
        stream.extend(events)
        for slot, _tok, fin in events:
            if fin and slot in slots:
                got[slots.pop(slot)] = bat.take_result(slot)

    for r, wait in schedule:
        for _ in range(wait):
            tick()
        emb, valid = reqs[r]
        s = bat.try_submit(emb, valid, seed=None if seeds is None else seeds[r])
        assert s is not None
        if not bat.is_active(s):  # the first token ended it
            got[r] = bat.take_result(s)
        else:
            slots[s] = r
    for _ in range(60):
        if not slots:
            break
        tick()
    return got, stream


def _both(params, prompts, dc_kw, n_slots, schedule, jax_kw=None, port_kw=None, seeds=None):
    jp, tp = params
    embs = [_embeds(jp, tp, p) for p in prompts]
    jbat = jlb.ContinuousLlmBatcher(jp, JCFG, JDecodeConfig(**dc_kw), n_slots=n_slots, t_max=T_MAX,
                                    **(jax_kw or {}))
    tbat = tlb.ContinuousLlmBatcher(tp, TCFG, DecodeConfig(**dc_kw), n_slots=n_slots, t_max=T_MAX,
                                    **(port_kw or {}))
    jgot, jstream = _run(jbat, [(e[0], len(p)) for e, p in zip(embs, prompts)], schedule, seeds)
    tgot, tstream = _run(tbat, [(e[1], len(p)) for e, p in zip(embs, prompts)], schedule, seeds)
    return (jgot, jstream), (tgot, tstream), tbat


def _solo(tp, ids, dc_kw):
    """The port's lockstep batch-1 path on one prompt."""
    emb = tp["embed"][torch.tensor([ids])]
    acfg = tqa.QwenAsrConfig(llm=TCFG, eot_id=EOT)
    tokens, counts, start = tqa.transcribe_embeds(tp, acfg, emb, torch.tensor([len(ids)]),
                                                  DecodeConfig(**dc_kw))
    lf = int(start[0])
    return [int(t) for t in tokens[0, lf : lf + int(counts[0])]]


def test_bucket_matches_jax():
    assert [tlb._bucket(n) for n in (1, 32, 33, 100, 300)] == [jlb._bucket(n) for n in
                                                                (1, 32, 33, 100, 300)]


@pytest.mark.parametrize("strategy", ["greedy", "penalty"])
def test_staggered_joins_match_jax_and_solo(params, strategy):
    """Two requests, two steps mid-flight, a third joins; two late requests
    reuse freed slots. Each request's ids equal JAX's batcher's and the
    port's solo path's."""
    kw = dict(DC, strategy=strategy, penalty=1.5 if strategy == "penalty" else 1.0,
              penalty_range=4)
    prompts = _prompts(0, (3, 6, 11, 4, 9))
    schedule = [(0, 0), (1, 0), (2, 2), (3, 12), (4, 0)]
    (jgot, _), (tgot, _), _ = _both(params, prompts, kw, 3, schedule)
    assert all(g is not None for g in tgot)
    assert tgot == jgot
    assert tgot == [_solo(params[1], p, kw) for p in prompts]


def test_slot_exhaustion_and_reuse(params):
    jp, tp = params
    prompts = _prompts(1, (5, 5, 5))
    bat = tlb.ContinuousLlmBatcher(tp, TCFG, DecodeConfig(**DC), n_slots=2, t_max=T_MAX)
    emb = [_embeds(jp, tp, p)[1] for p in prompts]
    s0, s1 = bat.try_submit(emb[0], 5), bat.try_submit(emb[1], 5)
    assert s0 is not None and s1 is not None
    assert bat.try_submit(emb[2], 5) is None  # full
    while bat.n_active:
        bat.step()
    got = [bat.take_result(s0), bat.take_result(s1)]
    s2 = bat.try_submit(emb[2], 5)  # a freed slot is reused
    assert s2 is not None
    while bat.is_active(s2):
        bat.step()
    got.append(bat.take_result(s2))
    assert got == [_solo(tp, p, DC) for p in prompts]
    with pytest.raises(ValueError, match="exceeds t_max"):
        tlb.ContinuousLlmBatcher(tp, TCFG, DecodeConfig(**dict(DC, max_new_tokens=40)),
                                 n_slots=1, t_max=T_MAX).try_submit(emb[0], 5)
    with pytest.raises(ValueError, match=r"\(1, T\) mesh"):  # the engine takes one data position
        tlb.ContinuousLlmBatcher(tp, TCFG, DecodeConfig(**DC),
                                 mesh=make_mesh(4, model_parallel=2, devices=[CPU] * 4))


def test_bf16_cache_slot_layout_invariance(params):
    """bf16 caches: a request's ids do not depend on which slot it lands in
    or on the other live requests, and equal JAX's bf16 batcher's."""
    jp, tp = params
    prompts = _prompts(3, (5, 8, 3))
    port_kw, jax_kw = {"kv_dtype": torch.bfloat16}, {"kv_dtype": jnp.bfloat16}

    def alone(p):
        bat = tlb.ContinuousLlmBatcher(tp, TCFG, DecodeConfig(**DC), n_slots=3, t_max=T_MAX,
                                       **port_kw)
        return _run(bat, [(_embeds(jp, tp, p)[1], len(p))], [(0, 0)])[0][0]

    # request 2 first, so requests 0 and 1 land in other slots than alone
    (jgot, _), (tgot, _), tbat = _both(params, prompts, DC, 3, [(2, 0), (0, 0), (1, 1)],
                                       jax_kw=jax_kw, port_kw=port_kw)
    assert tbat.state["layers"][0]["k"].dtype == torch.bfloat16
    assert tgot == [alone(p) for p in prompts]
    assert tgot == jgot


def test_snapshot_is_a_growing_prefix(params):
    jp, tp = params
    prompt = [3, 14, 15, 92, 65]
    bat = tlb.ContinuousLlmBatcher(tp, TCFG, DecodeConfig(**DC), n_slots=1, t_max=T_MAX)
    slot = bat.try_submit(_embeds(jp, tp, prompt)[1], len(prompt))
    seen = bat.snapshot(slot)
    assert len(seen) == 1  # the first token right after the prefill
    final = None
    while final is None:
        evs = bat.step()
        snap = bat.snapshot(slot)
        assert snap[: len(seen)] == seen
        seen = snap
        for s, _tok, fin in evs:
            if fin:
                final = bat.take_result(s)
    assert final == seen == _solo(tp, prompt, DC)


def test_steps_per_tick_gives_the_same_event_stream(params):
    """K = 4 and K = 1 report the same (slot, token, finished) stream, with a
    join on a tick boundary and a slot finishing mid-tick; JAX's K = 4 too."""
    prompts = _prompts(4, (3, 9, 6))
    schedule = [(0, 0), (1, 0), (2, 1)]
    (jgot, jstream), (t4, s4), _ = _both(params, prompts, DC, 3, schedule,
                                         jax_kw={"steps_per_tick": 4},
                                         port_kw={"steps_per_tick": 4})
    jp, tp = params
    bat = tlb.ContinuousLlmBatcher(tp, TCFG, DecodeConfig(**DC), n_slots=3, t_max=T_MAX)
    embs = [(_embeds(jp, tp, p)[1], len(p)) for p in prompts]
    t1, s1 = _run(bat, embs, [(0, 0), (1, 0), (2, 4)])  # one K = 4 tick = 4 steps
    assert s4 == s1 and t4 == t1 == jgot
    assert s4 == jstream


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
    return torch.from_numpy(np.array(jax.random.uniform(key, shape, jnp.float32, 1e-20, 1.0)))


SAMPLING = dict(DC, strategy="sampling", temperature=1.0, top_k=8, top_p=0.9)


def test_sampling_on_jax_draws_matches_jax(params):
    prompts = _prompts(5, (4, 7, 5))
    (jgot, _), (tgot, _), _ = _both(params, prompts, SAMPLING, 3, [(0, 0), (1, 1), (2, 3)],
                                    port_kw={"noise": _jax_draw}, seeds=[42, 7, 1000])
    assert tgot == jgot


def test_sampled_ids_do_not_depend_on_siblings(params):
    """A request's sampled ids depend only on its seed and its own step
    index, not on the engine's history or the other slots."""
    jp, tp = params
    ids, other = [3, 11, 42], [9, 1]

    def run(prewarm):
        bat = tlb.ContinuousLlmBatcher(tp, TCFG, DecodeConfig(**SAMPLING), n_slots=2,
                                       t_max=T_MAX, seed=3)
        if prewarm:  # another engine history and a live sibling slot
            bat.try_submit(_embeds(jp, tp, other)[1], 2, seed=999)
            bat.step()
            bat.step()
        slot = bat.try_submit(_embeds(jp, tp, ids)[1], len(ids), seed=42)
        while bat.is_active(slot):
            bat.step()
        return bat.take_result(slot)

    assert run(False) == run(True)


def test_explicit_seed_never_meets_an_automatic_one(params):
    """Deliberate divergence from the JAX package: there, a request with the
    explicit seed 0 samples the same stream as the first automatic request;
    the port derives the two apart."""
    jp, tp = params
    ids = [5, 21, 33, 2]

    def run(bat, emb, seed):
        slot = bat.try_submit(emb, len(ids), seed=seed)
        while bat.is_active(slot):
            bat.step()
        return bat.take_result(slot)

    jemb, temb = _embeds(jp, tp, ids)
    jax_runs = [run(jlb.ContinuousLlmBatcher(jp, JCFG, JDecodeConfig(**SAMPLING), n_slots=1,
                                             t_max=T_MAX), jemb, s) for s in (None, 0)]
    assert jax_runs[0] == jax_runs[1]  # the JAX package's collision
    port_runs = [run(tlb.ContinuousLlmBatcher(tp, TCFG, DecodeConfig(**SAMPLING), n_slots=1,
                                              t_max=T_MAX), temb, s) for s in (None, 0)]
    assert port_runs[0] != port_runs[1]


QSIZE = dict(vocab_size=64, hidden=256, num_layers=2, num_heads=2, num_kv_heads=1, head_dim=128,
             ffn_dim=512, rope_theta=1e4, max_seq_len=64)


def test_kernel_route_matches_jax_fused_batcher():
    """q4 weights at head width 128: the port's batcher steps through
    ``fused_decode_step_multi`` (its plain version on the CPU, one call a
    step, no kernel launch), JAX's through the interpret-mode multi-slot
    kernel; bf16 caches, a request joins mid-flight and one reuses a slot."""
    jcfg, tcfg = jq3.Qwen3Config(**QSIZE), tq3.Qwen3Config(**QSIZE)
    jp = jq3.fuse_params(jquantize_pytree(jq3.init_params(jcfg, jax.random.PRNGKey(3)), bits=4,
                                          block=128, min_size=0, pack=True, refine_iters=0,
                                          quantize_embeddings=True), jcfg)
    tp = tart.params_from_flat(jart.flatten_pytree(jp), "cpu")
    kw = dict(max_new_tokens=4, eot_id=-1)
    prompts = _prompts(6, (3, 5, 2), vocab=64)
    embs = [_embeds(jp, tp, p) for p in prompts]
    schedule = [(0, 0), (1, 1), (2, 5)]
    jprev = jqm._CONFIG["mm"]
    jqm.set_quant_config(mm="bf16")
    tqm.set_quant_config(mm="bf16")
    calls = []
    ref = tfm.fused_decode_step_multi_reference

    def counted(*a, **k):
        calls.append(1)
        return ref(*a, **k)

    tfm.fused_decode_step_multi_reference = counted
    try:
        jbat = jlb.ContinuousLlmBatcher(jp, jcfg, JDecodeConfig(**kw), n_slots=2, t_max=40,
                                        kv_dtype=jnp.bfloat16, stacked=jfd.stack_decode_params(jp, jcfg),
                                        fused_interpret=True)
        tbat = tlb.ContinuousLlmBatcher(tp, tcfg, DecodeConfig(**kw), n_slots=2, t_max=40,
                                        kv_dtype=torch.bfloat16,
                                        stacked=tfd.stack_decode_params(tp, tcfg))
        assert jbat.stacked is not None and tbat.stacked is not None
        assert tbat.state["k"].shape == (2, 2, 40, 128)  # (NL, slots, T, kvw)
        before = tfm.LAUNCHES
        jgot, _ = _run(jbat, [(e[0], len(p)) for e, p in zip(embs, prompts)], schedule)
        tgot, tstream = _run(tbat, [(e[1], len(p)) for e, p in zip(embs, prompts)], schedule)
    finally:
        tfm.fused_decode_step_multi_reference = ref
        jqm._CONFIG["mm"] = jprev
    assert tfm.LAUNCHES == before  # CPU tensors: the plain version, no launch
    assert len(calls) == tbat.steps_run > 0  # one multi-slot step per decode step
    assert all(g is not None and len(g) == 5 for g in tgot)
    assert tgot == jgot
    # one slot: the multi-slot kernel takes >= 2, so the rowwise route steps
    one = tlb.ContinuousLlmBatcher(tp, tcfg, DecodeConfig(**kw), n_slots=1, t_max=40,
                                   stacked=tfd.stack_decode_params(tp, tcfg))
    assert one.stacked is None and "layers" in one.state


def test_tensor_parallel_batcher_identity(params):
    """tp = 2 on a (1, 2) mesh of the CPU: Megatron weight shards and caches
    at each rank's kv heads give the ids and event stream of the unsharded
    batcher and of JAX's tensor-parallel batcher, a mid-run join and slot
    reuse included (JAX: ``test_tensor_parallel_batcher_identity``)."""
    from asr_tpu.parallel import mesh as jmesh

    prompts = _prompts(11, (4, 7, 5))
    schedule = [(0, 0), (1, 4), (2, 6)]  # 1 joins mid-run, 2 takes the slot 0 frees
    (jgot, jstream), (tgot, tstream), tbat = _both(
        params, prompts, DC, 2, schedule, jax_kw={"mesh": jmesh.make_mesh(2, model_parallel=2)},
        port_kw={"mesh": make_mesh(2, model_parallel=2, devices=[CPU] * 2)})
    assert tbat.state is None and tbat.stacked is None
    assert [s["layers"][0]["k"].shape[2] for s in tbat._rank_states] == [1, 1]  # kv heads 2 / 2
    assert tgot == jgot and tstream == jstream
    _, tp = params
    base = tlb.ContinuousLlmBatcher(tp, TCFG, DecodeConfig(**DC), n_slots=2, t_max=T_MAX)
    embs = [_embeds(params[0], tp, p)[1] for p in prompts]
    got, stream = _run(base, [(e, len(p)) for e, p in zip(embs, prompts)], schedule)
    assert got == tgot and stream == tstream


def test_tensor_parallel_requires_divisible_heads(params):
    _, tp = params
    with pytest.raises(ValueError, match="divide"):
        tlb.ContinuousLlmBatcher(tp, TCFG, DecodeConfig(**DC), n_slots=2, t_max=T_MAX,
                                 mesh=make_mesh(8, model_parallel=8, devices=[CPU] * 8))


@pytest.mark.parametrize("strategy", ["greedy", "sampling"])
def test_tensor_parallel_composes_with_steps_per_tick(params, strategy):
    """tp = 2 and steps_per_tick = 3: the same event stream as the unsharded
    per-step engine; under sampling the draws happen once, on rank 0's
    logits, from the request's own stream (JAX:
    ``test_tensor_parallel_composes_with_steps_per_tick``)."""
    _, tp = params
    jp = params[0]
    dc = DecodeConfig(**DC, strategy=strategy, temperature=0.9, top_k=12)
    prompt = [3, 50, 12, 77, 8]

    def run(mesh, k):
        bat = tlb.ContinuousLlmBatcher(tp, TCFG, dc, n_slots=2, t_max=T_MAX, mesh=mesh,
                                       steps_per_tick=k, seed=5)
        bat.try_submit(_embeds(jp, tp, prompt)[1], len(prompt), seed=9)
        stream = []
        for _ in range(DC["max_new_tokens"] + 2):
            evs = bat.step_tick()
            if not evs:
                break
            stream.extend(evs)
        return stream

    want = run(None, 1)
    assert want and run(make_mesh(2, model_parallel=2, devices=[CPU] * 2), 3) == want
