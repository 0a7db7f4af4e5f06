"""PyTorch port: the batched multi-stream runner against JAX's vmapped
``MultiStreamRunner`` for the four streaming factories, with staggered
``active`` masks and a ``reset``.

Checks: every active slot's outputs (ids and counts, or per-chunk CTC ids)
exactly JAX's, the runner's state within 1e-4 of max|JAX| (counters
exactly); an inactive slot's state bitwise untouched by a masked tick;
``step_n`` over K ticks bitwise equal to K ``step`` calls, an all-inactive
tick a no-op; a non-firing Paraformer stream's decoder state bitwise kept;
the Nemotron runner's streams started from blank, as the session starts
them (JAX's runner is given the same start).
"""

import jax
import numpy as np
import pytest
import torch

from asr_tpu.streaming import multistream as jms
from asr_tpu_torch.ops import quant_matmul as tqm
from asr_tpu_torch.streaming import multistream as tms
from tests import test_torch_dolphin_streaming as dol
from tests import test_torch_nemotron_streaming as nem
from tests import test_torch_paraformer_streaming as par
from tests import test_torch_zipformer as zip_
from tests.test_torch_paraformer_streaming import _close

N = 3
# Ticks: (active mask, or None for an unmasked step); a reset of slot 0 comes before the fourth.
ACTIVE = (None, (True, False, True), (False, True, True), (True, True, False), (True, True, True))


@pytest.fixture(autouse=True)
def _modes():
    from asr_tpu.ops import quant_matmul as jqm

    prev, jprev, threads = tqm._CONFIG["mm"], dict(jqm._CONFIG), torch.get_num_threads()
    torch.set_num_threads(2)
    tqm.set_quant_config(mm="f32")
    jqm.set_quant_config(mm="f32")
    yield
    tqm._CONFIG["mm"] = prev
    jqm._CONFIG.update(jprev)
    torch.set_num_threads(threads)


def _family(name):
    """(JAX runner, port runner factory, chunks (ticks, N, samples), output keys)."""
    if name == "paraformer":
        jcfg, jp, tcfg, tp = par._models(seed=20, fire_bias=-2.3)  # some chunks fire nothing
        samples, scale = tcfg.chunk_samples, 2000.0
        make_j, make_t = (lambda: jms.paraformer_multistream(jp, jcfg, N)), \
            (lambda: tms.paraformer_multistream(tp, tcfg, N))
    elif name == "zipformer":
        jcfg, jp, tcfg, tp = zip_._models(seed=21)
        samples, scale = tcfg.window_samples, 2000.0
        make_j, make_t = (lambda: jms.zipformer_multistream(jp, jcfg, N)), \
            (lambda: tms.zipformer_multistream(tp, tcfg, N))
    elif name == "dolphin":
        jcfg, jp, tcfg, tp = dol._models(seed=22, max_frames=32)  # the history clamps at the fourth tick
        samples, scale = tcfg.window_samples, 2000.0
        make_j, make_t = (lambda: jms.dolphin_multistream(jp, jcfg, N)), \
            (lambda: tms.dolphin_multistream(tp, tcfg, N))
    else:
        jcfg, jp, tcfg, tp = nem._models(seed=23)
        samples, scale = tcfg.window_samples, 0.1
        make_j, make_t = (lambda: _blank_start(jms.nemotron_multistream(jp, jcfg, N, prompt_id=1), jcfg)), \
            (lambda: tms.nemotron_multistream(tp, tcfg, N, prompt_id=1))
    chunks = (np.random.default_rng(24).standard_normal((len(ACTIVE), N, samples)) * scale).astype(np.float32)
    return make_j, make_t, chunks


def _blank_start(runner, cfg):
    """JAX's Nemotron runner with its streams' predictor started from blank,
    as the session starts it and as the port's runner does (JAX's runner
    starts it from token 0)."""
    import jax.numpy as jnp

    from asr_tpu.streaming import nemotron_stream as jns

    runner._init_state_fn = lambda: {**jns.init_state(cfg), "token": jnp.asarray([cfg.base.blank_id], jnp.int32)}
    runner.states = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (N,) + x.shape), runner._init_state_fn())
    return runner


def _rows(tree):
    """The runner's state leaves, flattened in order."""
    out = []
    tms.tree_map(lambda x: out.append(x.clone()), tree)
    return out


def _same_rows(before, after, row):
    return all(torch.equal(b[row], a[row]) for b, a in zip(before, after))


def _outputs_equal(got, want, active):
    for key, value in want.items():
        value = np.asarray(value)
        for i in range(N):
            if active is None or active[i]:
                np.testing.assert_array_equal(got[key][i], value[i], err_msg=f"{key} slot {i}")


def _close_states(tstates, jstates):
    """The runner's (N, ...) state against the vmapped JAX runner's, leaf by
    leaf in key order: counters exactly, floats within TOL."""
    if isinstance(jstates, dict):
        assert set(tstates) == set(jstates)
        for k in jstates:
            _close_states(tstates[k], jstates[k])
    elif isinstance(jstates, (list, tuple)):
        for t, j in zip(tstates, jstates, strict=True):
            _close_states(t, j)
    else:
        j = np.asarray(jstates)
        assert tuple(tstates.shape) == j.shape, (tstates.shape, j.shape)
        if np.issubdtype(j.dtype, np.integer):
            np.testing.assert_array_equal(tstates.numpy(), j)
        else:
            _close(tstates.numpy(), j)


@pytest.mark.parametrize("name", ["paraformer", "zipformer", "dolphin", "nemotron"])
def test_runner_matches_jax_with_staggered_ticks_and_a_reset(name):
    make_j, make_t, chunks = _family(name)
    jr, tr = make_j(), make_t()
    fired_kept = 0
    for t, active in enumerate(ACTIVE):
        if t == 3:
            jr.reset(0)
            tr.reset(0)
        mask = None if active is None else np.array(active)
        before = _rows(tr.states)
        dec_before = {k: v.clone() for k, v in tr.states.items() if k.startswith("dec_")}
        want = jr.step(chunks[t], mask)
        got = tr.step(chunks[t], mask)
        _outputs_equal(got, want, mask)
        _close_states(tr.states, jr.states)
        after = _rows(tr.states)
        for i in range(N):
            if mask is not None and not mask[i]:
                assert _same_rows(before, after, i), f"inactive slot {i} changed at tick {t}"
        if name == "paraformer":
            for i in range(N):
                if (mask is None or mask[i]) and got["count"][i] == 0:
                    fired_kept += 1
                    assert all(torch.equal(dec_before[k][i], tr.states[k][i]) for k in dec_before), \
                        f"slot {i} fired nothing at tick {t} but its decoder state changed"
    if name == "paraformer":
        assert fired_kept > 0  # some active stream fired nothing on some tick


@pytest.mark.parametrize("name", ["paraformer", "zipformer", "dolphin", "nemotron"])
def test_step_n_equals_k_steps(name):
    _, make_t, chunks = _family(name)
    masks = np.array([[True] * N] + [list(a) for a in ACTIVE[1:]])
    masks[2] = False  # an all-inactive tick inside the burst: a no-op
    one, burst = make_t(), make_t()
    want = [one.step(chunks[t], masks[t]) for t in range(len(masks)) if masks[t].any()]
    got = burst.step_n(chunks, masks)
    live = [t for t in range(len(masks)) if masks[t].any()]
    for w, t in zip(want, live):
        for key in w:
            np.testing.assert_array_equal(got[key][t], w[key])
    for a, b in zip(_rows(one.states), _rows(burst.states)):
        assert torch.equal(a, b)
