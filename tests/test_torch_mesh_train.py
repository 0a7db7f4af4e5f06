"""The port's training over a mesh (``parallel/train.py``'s mesh branch,
``parallel/mesh.py``'s ``own`` layouts and ``gather_params``, and
``parallel/checkpoint.py`` on laid-out trees) against the JAX package's
sharded steps on the 8 virtual CPU devices of ``tests/conftest.py``.

The port runs each step on ``[torch.device("cpu")] * n`` mesh positions:
SenseVoice CTC at dp 4 x tp 2 (``tests/test_parallel.py``'s tp-2 step) and
at the dryrun's config on (4, 2), Whisper AED cross-entropy at dp 4 x tp 2
with target lengths that differ between the data slices (the slices'
weights in the global masked mean), Parakeet RNN-T at dp 2 with replicated
parameters. Each is held to JAX's sharded step: the first loss within rtol
1e-5, ``gather_params`` of the reduced gradients within ``test_torch_train``'s gate
(each leaf 1e-4 of its own max|g| + 1e-7 of the tree's), the losses of
several steps within rtol 1e-4 and falling; every position's copy of a leaf
and of its moments bitwise the same after the steps; and no backward enters
a collective (the model groups' exchange counts are the same before and
after ``torch.autograd.grad``: on one card every rank's CUDA backward runs
on one autograd thread, where a collective would deadlock).

Also: ``gather_params`` inverts ``shard_params`` bitwise; an undivided batch
and shared leaves are refused; a failing rank leaves every leaf unchanged;
``fit`` on a mesh resumes bitwise, and its checkpoint is the unsharded
layout's file, which resumes at any layout."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.models import parakeet as jpk
from asr_tpu.models import sensevoice as jsv
from asr_tpu.models import whisper as jwh
from asr_tpu.parallel import mesh as jmesh
from asr_tpu.parallel import train as jt
from asr_tpu.parallel.rnnt_loss import rnnt_loss_from_logits as jrnnt_from_logits
from asr_tpu_torch.layers import qwen3 as tq3
from asr_tpu_torch.models import sensevoice as tsv
from asr_tpu_torch.models import whisper as twh
from asr_tpu_torch.parallel import checkpoint as tck
from asr_tpu_torch.parallel import mesh as pm
from asr_tpu_torch.parallel import train as tt
from asr_tpu_torch.quant.quantize import QuantizedLinear, quantize_pytree
from tests.test_torch_train import (SV_TINY, WH_TINY, _clone, _falling, _grads_close, _parakeet_case, _port,
                                    _sensevoice_case, _whisper_case)

CPU = torch.device("cpu")
DRYRUN = dict(vocab_size=128, hidden=64, num_heads=4, head_dim=16, ffn_dim=128, num_encoders0=1,
              num_encoders=2, num_tp_encoders=1, fsmn_kernel=5)  # __graft_entry__._dryrun_impl's


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def cpu_mesh(dp, tp):
    return pm.make_mesh(dp * tp, model_parallel=tp, devices=[CPU] * (dp * tp))


@pytest.fixture
def backward_exchanges(monkeypatch):
    """Records every model group a grid makes and, around each
    ``torch.autograd.grad``, their exchange counts: -> a list of (before,
    after) pairs of totals."""
    made, seen = [], []
    real_group, real_grad = pm.ModelGroup, torch.autograd.grad

    class Recorded(real_group):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    def grad(*a, **k):
        before = sum(g.exchanges for g in made)
        out = real_grad(*a, **k)
        seen.append((before, sum(g.exchanges for g in made)))
        return out

    monkeypatch.setattr(pm, "ModelGroup", Recorded)
    monkeypatch.setattr(torch.autograd, "grad", grad)
    return seen


def same_on_every_position(sharded):
    """Every position's copy of a leaf bitwise the copy at (0, its rank),
    and a replicated leaf's at (0, 0)."""
    splits = pm.layout_leaves(sharded.layout)
    for d, m in sharded.positions():
        mine = tck.tree_leaves(sharded.local(d, m))
        for i, (split, t) in enumerate(zip(splits, mine)):
            ref = tck.tree_leaves(sharded.local(0, 0 if split.whole else m))[i]
            assert torch.equal(t, ref), (d, m, i, split)


# ── the three steps against JAX's sharded steps ──────────────────────────


def _sv_jloss(jcfg):
    def jloss(p, audio, valid, lang, labels, label_valid):
        logits, vs = jsv.encode_logits(p, jcfg, audio, valid, lang)
        return jt.ctc_loss_from_logits(logits.astype(jnp.float32), vs, labels, label_valid, jcfg.blank_id)
    return jloss


def _sensevoice():
    """``test_torch_train``'s SenseVoice batch: 4 rows of mixed lengths,
    languages and label counts, a repeated label."""
    jcfg, tcfg, params, batch, *_ = _sensevoice_case()
    return (jcfg, tcfg, params, batch, _sv_jloss(jcfg), tt.sensevoice_ctc_loss, jt.train_step, tt.train_step,
            "sensevoice_param_specs")


def _dryrun():
    """``__graft_entry__._dryrun_impl``'s step at n = 8: batch 2 x data of
    4800 samples, 8 labels, drawn in its order from seed 0."""
    jcfg, tcfg = jsv.SenseVoiceConfig(**DRYRUN), tsv.SenseVoiceConfig(**DRYRUN)
    params = jsv.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((8, 4800)) * 2000).astype(np.float32)
    batch = (audio, np.full(8, 4800, np.int32), np.zeros(8, np.int32),
             rng.integers(1, jcfg.vocab_size, (8, 8), dtype=np.int32), np.full(8, 8, np.int32))
    return (jcfg, tcfg, params, batch, _sv_jloss(jcfg), tt.sensevoice_ctc_loss, jt.train_step, tt.train_step,
            "sensevoice_param_specs")


def _whisper():
    """``test_torch_train``'s Whisper batch: target lengths 10, 8, 10, 6."""
    jcfg, tcfg, params, batch, *_ = _whisper_case()

    def jloss(p, mel, tokens, valid):
        enc = jwh.encode(p, jcfg, mel)
        logits, _ = jwh._decoder_pass(p, jcfg, jwh.make_state(p, jcfg, enc), tokens[:, :-1],
                                      jnp.asarray(0, jnp.int32))
        return jt.aed_ce_loss(logits, tokens[:, 1:], valid - 1, 0.1)

    return (jcfg, tcfg, params, batch, jloss, tt.whisper_ce_loss, jt.whisper_train_step,
            tt.whisper_train_step, "whisper_param_specs")


def _parakeet():
    """``test_torch_train``'s Parakeet batch: 2 rows; no spec tree (JAX has
    none for Parakeet), so the parameters replicate."""
    jcfg, tcfg, params, batch, *_ = _parakeet_case()

    def jloss(p, audio, valid, labels, lv):
        enc, t_valid = jpk.encode(p, jcfg, audio, valid)
        dec = jt.predictor_states(p, labels, jcfg.blank_id)
        logits = jt.transducer_joint_logits(p, enc, dec, jcfg.vocab_size)
        return jrnnt_from_logits(logits.astype(jnp.float32), labels, t_valid, lv, jcfg.blank_id)

    return (jcfg, tcfg, params, batch, jloss, tt.transducer_loss, jt.transducer_train_step,
            tt.transducer_train_step, None)


# name: (case, dp, tp, steps, lr)
MESH_CASES = {
    "sensevoice_dp4_tp2": (_sensevoice, 4, 2, 4, 1e-3),
    "sensevoice_dryrun_4x2": (_dryrun, 4, 2, 3, 1e-3),
    "whisper_dp4_tp2": (_whisper, 4, 2, 4, 1e-3),
    "parakeet_dp2": (_parakeet, 2, 1, 4, 3e-3),
}


@pytest.mark.parametrize("name", sorted(MESH_CASES))
def test_mesh_step_matches_jax_sharded_step(name, backward_exchanges):
    make, dp, tp, n_steps, lr = MESH_CASES[name]
    jcfg, tcfg, params, batch, jloss, tloss, jstep, tstep, specs_fn = make()
    jm = jmesh.make_mesh(dp * tp, model_parallel=tp)
    jspecs = getattr(jmesh, specs_fn)(params) if specs_fn else None
    jparams = jmesh.shard_params(params, jm, jspecs)
    jbatch = [jax.device_put(jnp.asarray(a), jmesh.batch_sharded(jm)) for a in batch]
    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(jparams, *jbatch)

    whole = _port(params)
    specs = getattr(pm, specs_fn)(whole) if specs_fn else None
    lay = pm.shard_params(whole, cpu_mesh(dp, tp), specs, own=True)
    got_loss, got_grads = tt.value_and_grad(tloss, lay, tcfg, *batch)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    _grads_close(want_grads, pm.gather_params(got_grads, CPU))
    same_on_every_position(got_grads)

    jopt, topt = jt.make_optimizer(lr=lr), tt.make_optimizer(lr=lr)
    jo, to = jopt.init(jparams), topt.init(lay)
    # the count on every device, as the step returns it: the first step's compile serves every step
    jo = jax.tree.map(lambda a: jax.device_put(a, jmesh.replicated(jm)) if a.ndim == 0 else a, jo)
    laid_out = jax.tree.map(lambda a: a.sharding, (jparams, jo))
    want, got = [], []
    for _ in range(n_steps):
        jparams, jo, loss = jstep(jparams, jo, jcfg, jopt, *jbatch)
        jparams, jo = jax.device_put((jparams, jo), laid_out)
        want.append(float(loss))
        lay, to, loss = tstep(lay, to, tcfg, topt, *batch)
        got.append(loss.item())
    np.testing.assert_allclose(got, want, rtol=1e-4)
    _falling(got)
    assert int(to["count"]) == n_steps
    for tree in (lay, to["mu"], to["nu"]):
        same_on_every_position(tree)

    assert len(backward_exchanges) == 1 + n_steps
    assert all(after == before for before, after in backward_exchanges), backward_exchanges
    if tp > 1:  # the forward met at its collectives
        assert backward_exchanges[0][0] > 0


def test_aed_loss_on_a_mesh_is_the_global_masked_mean():
    """Slices of 9, 7, 9 and 5 target positions: the mesh loss is
    sum(nll * mask) / sum(mask) over the whole batch, as the unsharded
    port's, not the mean of the slices' own means."""
    jcfg, tcfg, params, batch, *_ = _whisper()
    whole = _port(params)
    want, _ = tt.value_and_grad(tt.whisper_ce_loss, whole, tcfg, *batch)
    lay = pm.shard_params(whole, cpu_mesh(4, 1), own=True)
    got, _ = tt.value_and_grad(tt.whisper_ce_loss, lay, tcfg, *batch)
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-6)
    slices = tt.split_batch(batch, {}, 4)
    assert [tt._target_positions({"tokens": a[1], "token_valid": a[2]}) for a, _ in slices] == [9, 7, 9, 5]
    with torch.no_grad():
        means = [tt.whisper_ce_loss(whole, tcfg, *a).item() for a, _ in slices]
    # the slices' plain mean misses by ten times the 1e-5 the JAX comparisons allow (a random
    # model's per-token losses are all near log V, so the weights move the loss by ~1.5e-4)
    assert abs(np.mean(means) - want.item()) > 1e-4 * abs(want.item())


def test_backward_enters_no_collective(backward_exchanges):
    """dp 2 x tp 2 SenseVoice: the forward exchanges at its row sums and
    gathers; ``torch.autograd.grad`` exchanges nothing."""
    cfg = tsv.SenseVoiceConfig(**SV_TINY)
    params = tsv.init_params(cfg, torch.Generator().manual_seed(3))
    lay = pm.shard_params(params, cpu_mesh(2, 2), pm.sensevoice_param_specs(params), own=True)
    rng = np.random.default_rng(3)
    batch = ((rng.standard_normal((2, 3200)) * 2000).astype(np.float32), np.full(2, 3200, np.int32),
             np.zeros(2, np.int32), rng.integers(1, 64, (2, 4)).astype(np.int32), np.full(2, 4, np.int32))
    tt.value_and_grad(tt.sensevoice_ctc_loss, lay, cfg, *batch)
    [(before, after)] = backward_exchanges
    assert before > 0 and after == before


# ── layouts ──────────────────────────────────────────────────────────────


def _uneven_sensevoice():
    cfg = tsv.SenseVoiceConfig(**dict(SV_TINY, vocab_size=63))
    return tsv.init_params(cfg, torch.Generator().manual_seed(5)), pm.sensevoice_param_specs


def _q8_sensevoice():
    tree, specs = _uneven_sensevoice()
    return quantize_pytree(tree, bits=8, block=16, min_size=0, refine_iters=0), specs


def _q8_qwen3():
    cfg = tq3.Qwen3Config(vocab_size=64, hidden=32, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
                          ffn_dim=48)
    tree = tq3.fuse_params(quantize_pytree(tq3.init_params(cfg, torch.Generator().manual_seed(6)), bits=8,
                                           block=16, min_size=0, refine_iters=0), cfg)
    return tree, pm.qwen3_param_specs


def _whisper_tree():
    return twh.init_params(twh.WhisperConfig(**WH_TINY), torch.Generator().manual_seed(7)), pm.whisper_param_specs


def _leaf_parts(leaf):
    if isinstance(leaf, QuantizedLinear):
        return [leaf.q, leaf.scale, leaf.zero, leaf.bits, leaf.block, leaf.packed, leaf.dynamic]
    return [leaf]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("own", [False, True], ids=["shared", "own"])
@pytest.mark.parametrize("tree", [_uneven_sensevoice, _q8_sensevoice, _q8_qwen3, _whisper_tree],
                         ids=["sensevoice_uneven_ctc", "sensevoice_q8_rows", "qwen3_q8_fused", "whisper"])
def test_gather_params_inverts_shard_params_bitwise(tree, own, tp):
    """Fused q|k|v and gate|up split by heads, an uneven CTC head, the FSMN
    taps, int8 column pieces and row shards at block boundaries: joined
    back leaf for leaf bitwise, in tensors of their own."""
    params, specs_fn = tree()
    lay = pm.shard_params(params, cpu_mesh(2, tp), specs_fn(params), own=own)
    kinds = {s.kind for s in pm.layout_leaves(lay.layout)}
    assert "whole" in kinds and kinds & {"col", "qcol"}
    back = pm.gather_params(lay, CPU)
    want, got = {}, {}
    pm.map_tree(lambda path, leaf: want.__setitem__(path, leaf), params)
    pm.map_tree(lambda path, leaf: got.__setitem__(path, leaf), back)
    assert list(got) == list(want)
    for path, w in want.items():
        for a, b in zip(_leaf_parts(got[path]), _leaf_parts(w)):
            if isinstance(b, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a, b) and a is not b, path
            else:
                assert a == b, path
        assert not hasattr(got[path], "tp_role"), path


def test_own_layout_gives_every_position_its_own_tensors():
    params, specs_fn = _uneven_sensevoice()
    lay = pm.shard_params(params, cpu_mesh(2, 2), specs_fn(params), own=True)
    seen = {}
    for d, m in lay.positions():
        for t in tck.tree_leaves(lay.local(d, m)):
            assert t.data_ptr() not in seen, (d, m, seen.get(t.data_ptr()))
            seen[t.data_ptr()] = (d, m)
    assert all(t.data_ptr() not in seen for t in tck.tree_leaves(params))


def test_refusals():
    """A batch the data axis does not divide, and a layout whose positions
    share leaves (AdamW would update a shared leaf once for each)."""
    cfg = tsv.SenseVoiceConfig(**SV_TINY)
    params = tsv.init_params(cfg, torch.Generator().manual_seed(8))
    rng = np.random.default_rng(8)
    batch = ((rng.standard_normal((3, 3200)) * 2000).astype(np.float32), np.full(3, 3200, np.int32),
             np.zeros(3, np.int32), rng.integers(1, 64, (3, 4)).astype(np.int32), np.full(3, 4, np.int32))
    lay = pm.shard_params(params, cpu_mesh(2, 1), own=True)
    with pytest.raises(ValueError, match="does not split over 2"):
        tt.value_and_grad(tt.sensevoice_ctc_loss, lay, cfg, *batch)
    shared = pm.shard_params(params, cpu_mesh(3, 1))
    with pytest.raises(ValueError, match="own=True"):
        tt.value_and_grad(tt.sensevoice_ctc_loss, shared, cfg, *batch)


def test_a_failing_rank_aborts_the_step_and_leaves_every_leaf_unchanged(monkeypatch):
    """Model rank 1 raises in its forward: the step raises that error at
    once, and no leaf, moment or count moves."""
    cfg = tsv.SenseVoiceConfig(**SV_TINY)
    params = tsv.init_params(cfg, torch.Generator().manual_seed(9))
    lay = pm.shard_params(params, cpu_mesh(2, 2), pm.sensevoice_param_specs(params), own=True)
    opt = tt.make_optimizer(lr=1e-3)
    state = opt.init(lay)
    before = [[_clone(lay.local(d, m)) for m in range(2)] for d in range(2)]
    real = tsv.encode_logits

    def failing(p, *a, **k):
        if pm.model_rank() == 1:
            time.sleep(0.1)
            raise RuntimeError("rank 1 failed")
        return real(p, *a, **k)

    monkeypatch.setattr(tsv, "encode_logits", failing)
    rng = np.random.default_rng(9)
    batch = ((rng.standard_normal((2, 3200)) * 2000).astype(np.float32), np.full(2, 3200, np.int32),
             np.zeros(2, np.int32), rng.integers(1, 64, (2, 4)).astype(np.int32), np.full(2, 4, np.int32))
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        tt.train_step(lay, state, cfg, opt, *batch)
    assert time.perf_counter() - t0 < 30.0
    assert int(state["count"]) == 0
    for d, m in lay.positions():
        for a, b in zip(tck.tree_leaves(lay.local(d, m)), tck.tree_leaves(before[d][m])):
            assert torch.equal(a, b)
        assert not any(t.any() for t in tck.tree_leaves(state["mu"].local(d, m)))


# ── fit and checkpoints across layouts ───────────────────────────────────


def _fit_setup(seed):
    cfg = tsv.SenseVoiceConfig(**SV_TINY)
    params = tsv.init_params(cfg, torch.Generator().manual_seed(seed))
    optimizer = tt.make_optimizer(lr=1e-3)

    def batches():
        r = np.random.default_rng(42)  # deterministic -> resume replays
        while True:
            yield ((r.standard_normal((4, 3200)) * 2000).astype(np.float32), np.full(4, 3200, np.int32),
                   np.zeros(4, np.int32), r.integers(1, 64, (4, 5)).astype(np.int32), np.full(4, 5, np.int32))

    def step_fn(params, opt_state, optimizer, *batch):
        return tt.train_step(params, opt_state, cfg, optimizer, *batch)

    return params, optimizer, batches, step_fn


def _lay(params, dp, tp):
    specs = pm.sensevoice_param_specs(params) if tp > 1 else None
    return pm.shard_params(params, cpu_mesh(dp, tp), specs, own=True)


def _positions_equal(a, b):
    for d, m in a.positions():
        for x, y in zip(tck.tree_leaves(a.local(d, m)), tck.tree_leaves(b.local(d, m))):
            assert x.dtype == y.dtype and torch.equal(x, y), (d, m)


def test_fit_on_a_mesh_resumes_bitwise(tmp_path):
    """dp 2 x tp 2: 4 steps straight against 2 steps + a checkpoint + a
    restore into a fresh layout + 2 steps: losses, every position's leaves
    and moments bitwise."""
    params, optimizer, batches, step_fn = _fit_setup(10)
    p1, o1, l1 = tt.fit(step_fn, _lay(params, 2, 2), optimizer, batches(), num_steps=4, log_every=0)
    ck = tmp_path / "ck"
    _, _, la = tt.fit(step_fn, _lay(params, 2, 2), optimizer, batches(), num_steps=2, ckpt_dir=ck, log_every=0)
    logs = []
    p2, o2, lb = tt.fit(step_fn, _lay(params, 2, 2), optimizer, batches(), num_steps=4, ckpt_dir=ck,
                        log_every=0, log_fn=logs.append)
    assert logs == ["resumed from step 2"] and la + lb == l1
    assert isinstance(p2, pm.ShardedParams) and isinstance(o2["mu"], pm.ShardedParams) and p2.own
    for a, b in ((p1, p2), (o1["mu"], o2["mu"]), (o1["nu"], o2["nu"])):
        _positions_equal(a, b)
    assert int(o2["count"]) == 4


def test_checkpoints_do_not_depend_on_the_layout(tmp_path):
    """A mesh writes the unsharded layout's file (the gathered leaves, read
    back bitwise into an unsharded template); mesh (dp 2 x tp 2) ->
    unsharded -> mesh (tp 4) resumes through both, each restore bitwise
    the state it continues from, the losses within 1e-4 of an
    uninterrupted unsharded run."""
    params, optimizer, batches, step_fn = _fit_setup(11)
    _, _, straight = tt.fit(step_fn, _clone(params), optimizer, batches(), num_steps=6, log_every=0)

    ck = tmp_path / "ck"
    p_a, o_a, l_a = tt.fit(step_fn, _lay(params, 2, 2), optimizer, batches(), num_steps=2, ckpt_dir=ck,
                           log_every=0)
    whole = {"params": _clone(params), "opt_state": optimizer.init(params)}
    p_w, o_w, step = tck.restore_train_state(ck, whole)
    assert step == 2
    for name, t in tck.named_leaves({"params": pm.gather_params(p_a), "mu": pm.gather_params(o_a["mu"]),
                                     "nu": pm.gather_params(o_a["nu"])}):
        kind, rest = name.split("/", 1)
        src = p_w if kind == "params" else o_w[kind]
        assert torch.equal(dict(tck.named_leaves(src))[rest], t), name

    p_b, o_b, l_b = tt.fit(step_fn, _clone(params), optimizer, batches(), num_steps=4, ckpt_dir=ck, log_every=0)
    lay4 = _lay(params, 1, 4)
    p_c, o_c, step = tck.restore_train_state(ck, {"params": lay4, "opt_state": optimizer.init(lay4)})
    assert step == 4 and isinstance(p_c, pm.ShardedParams) and p_c.mesh.shape == {"data": 1, "model": 4}
    for got, want in ((p_c, p_b), (o_c["mu"], o_b["mu"]), (o_c["nu"], o_b["nu"])):
        for (name, x), (_, y) in zip(tck.named_leaves(pm.gather_params(got)), tck.named_leaves(want)):
            assert torch.equal(x, y), name
    _, _, l_c = tt.fit(step_fn, _lay(params, 1, 4), optimizer, batches(), num_steps=6, ckpt_dir=ck, log_every=0)
    np.testing.assert_allclose(l_a + l_b + l_c, straight, rtol=1e-4)
    _falling(l_a + l_b + l_c)
