"""The port's training path (``asr_tpu_torch/parallel/train.py`` and
``checkpoint.py``) against the JAX package's at the JAX tests' tiny
geometries: the CTC and AED cross-entropy losses, AdamW against optax on
JAX's own gradients, the three train steps (first-step loss and every
leaf's gradient, then the losses of several steps), ``fit`` with
checkpoint / resume (JAX's scenario and log lines; a resumed run bitwise
the uninterrupted one), the checkpoint round trip, a mismatched template
refused and an interrupted save left invisible.

Weights are JAX's ``init_params`` draws carried over by
``params_from_flat(flatten_pytree(...))``; inputs come from numpy with a
seed. The port's steps update leaves in place, so each comparison clones
what it needs first.

Gradient tolerance: each leaf within 1e-4 of its own max|g|, plus 1e-7 of
the largest |g| of the tree: a leaf whose gradient is zero in exact
arithmetic (an attention key bias: softmax does not see a shift shared by
every key) holds rounding noise in both packages (4e-8 against a tree max
of 4e3 for Parakeet's), which no relative bound of its own can hold."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from asr_tpu.frontend.nemo_mel import NemoMelConfig as JNemoMel
from asr_tpu.models import parakeet as jpk
from asr_tpu.models import sensevoice as jsv
from asr_tpu.models import whisper as jwh
from asr_tpu.parallel import train as jt
from asr_tpu.parallel.rnnt_loss import rnnt_loss_from_logits as jrnnt_from_logits
from asr_tpu.runtime.artifact import flatten_pytree as jflat
from asr_tpu_torch.frontend.nemo_mel import NemoMelConfig as TNemoMel
from asr_tpu_torch.models import parakeet as tpk
from asr_tpu_torch.models import sensevoice as tsv
from asr_tpu_torch.models import whisper as twh
from asr_tpu_torch.parallel import checkpoint as tck
from asr_tpu_torch.parallel import train as tt
from asr_tpu_torch.runtime.artifact import flatten_pytree as tflat
from asr_tpu_torch.runtime.artifact import params_from_flat

SV_TINY = dict(vocab_size=64, hidden=32, num_heads=4, head_dim=8, ffn_dim=64,
               num_encoders0=1, num_encoders=1, num_tp_encoders=1, fsmn_kernel=5)
WH_TINY = dict(vocab_size=96, d_model=32, encoder_layers=1, decoder_layers=1, num_heads=4, n_mels=16,
               max_source_positions=20, max_target_positions=16, sot_id=1, eot_id=2, first_language_id=10,
               num_languages=4, transcribe_id=20, translate_id=21, no_timestamps_id=22, no_speech_id=30)
PK_TINY = dict(vocab_size=24, blank_id=23, d_model=32, num_layers=1, num_heads=4, ffn_dim=48,
               sub_channels=8, dec_hidden=16, lstm_layers=1)


def _port(jparams):
    return params_from_flat(jflat(jparams), "cpu")


def _clone(tree):
    return tck.unflatten(tree, [t.clone() for t in tck.tree_leaves(tree)])


def _grads_close(want_tree, got_tree, rel=1e-4, floor=1e-7):
    want, got = jflat(want_tree), tflat(got_tree)
    assert sorted(want) == sorted(got)
    top = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        gap = np.abs(got[k] - w).max()
        assert gap <= rel * np.abs(w).max() + floor * top, (k, gap, np.abs(w).max(), top)


def _falling(losses):
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


# ── losses ───────────────────────────────────────────────────────────────


def test_ctc_loss_from_logits_matches_optax():
    """Padded logits and labels, repeated labels (a blank between them), the
    mean over sequences not divided by label counts; the gradient too."""
    rng = np.random.default_rng(0)
    b, t, n, v = 3, 12, 5, 9
    logits = rng.standard_normal((b, t, v)).astype(np.float32)
    labels = rng.integers(1, v, (b, n)).astype(np.int32)
    labels[0, 1] = labels[0, 2] = labels[0, 0]  # a run of three: needs 2 blanks
    valid_seq = np.array([12, 9, 6], np.int32)
    label_valid = np.array([5, 3, 2], np.int32)

    def jloss(x):
        return jt.ctc_loss_from_logits(x, jnp.asarray(valid_seq), jnp.asarray(labels), jnp.asarray(label_valid))

    x = torch.tensor(logits, requires_grad=True)
    got = tt.ctc_loss_from_logits(x, torch.tensor(valid_seq), torch.tensor(labels), torch.tensor(label_valid))
    got.backward()
    want, grad = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(logits))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert np.abs(x.grad.numpy() - np.asarray(grad)).max() <= 1e-5 * np.abs(np.asarray(grad)).max()


def test_ctc_infeasible_alignment_is_inf_where_optax_is_finite():
    """The named divergence: 4 frames cannot hold 3 repeated labels (they need
    5); torch returns inf, optax its log_epsilon-bounded ~1e5."""
    logits = np.zeros((1, 4, 5), np.float32)
    labels = np.array([[2, 2, 2]], np.int32)
    args = (np.array([4], np.int32), labels, np.array([3], np.int32))
    got = tt.ctc_loss_from_logits(torch.tensor(logits), *(torch.tensor(a) for a in args))
    want = jt.ctc_loss_from_logits(jnp.asarray(logits), *(jnp.asarray(a) for a in args))
    assert torch.isinf(got) and np.isfinite(float(want)) and float(want) > 1e4


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_aed_ce_loss_matches_jax(smoothing):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 3
    targets = rng.integers(0, 11, (3, 7)).astype(np.int32)
    valid = np.array([7, 4, 0], np.int32)
    got = tt.aed_ce_loss(torch.tensor(logits), torch.tensor(targets), torch.tensor(valid), smoothing)
    want = jt.aed_ce_loss(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(valid), smoothing)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


# ── AdamW ────────────────────────────────────────────────────────────────


def test_adamw_matches_optax_on_jax_gradients():
    """Three updates fed JAX's own gradients (of the tiny SenseVoice CTC
    loss at three points), from a fresh state and from optax's state carried
    over after one step; the count and the moments follow optax's."""
    jcfg = jsv.SenseVoiceConfig(**SV_TINY)
    params = jsv.init_params(jcfg, jax.random.PRNGKey(2))
    rng = np.random.default_rng(2)
    audio = jnp.asarray((rng.standard_normal((2, 4800)) * 2000).astype(np.float32))
    labels = jnp.asarray(rng.integers(1, 64, (2, 6)), jnp.int32)

    def loss(p):
        logits, vs = jsv.encode_logits(p, jcfg, audio, jnp.asarray([4800, 4000]), jnp.asarray([0, 1]))
        return jt.ctc_loss_from_logits(logits, vs, labels, jnp.asarray([6, 4]))

    lr = 1e-3
    jopt, topt = jt.make_optimizer(lr=lr), tt.make_optimizer(lr=lr)
    assert (topt.learning_rate, topt.weight_decay, topt.b1, topt.b2, topt.eps) == (lr, 0.01, 0.9, 0.999, 1e-8)
    jstate = jopt.init(params)
    grad = jax.jit(jax.grad(loss))
    tparams, tstate = _port(params), topt.init(_port(params))
    jp = params
    for step in range(3):
        grads = grad(jp)
        jupd, jstate = jopt.update(grads, jstate, jp)
        tupd, tstate = topt.update(_port(grads), tstate, tparams)
        want, got = jflat(jupd), tflat(tupd)
        for k, w in want.items():
            assert np.abs(got[k] - w).max() <= 1e-6 * np.abs(w).max() + 1e-7 * lr, (step, k)
        assert int(tstate["count"]) == int(jstate[0].count) == step + 1
        jp = optax.apply_updates(jp, jupd)
        tparams = tt.apply_updates(tparams, tupd)
        if step == 0:  # carry optax's own state over and go on from it
            adam = jstate[0]
            tstate = tt.adamw_state_from_numpy(np.asarray(adam.count), jflat(adam.mu), jflat(adam.nu), "cpu")
            tparams = _port(jp)
    for name in ("mu", "nu"):
        want, got = jflat(getattr(jstate[0], name)), tflat(tstate[name])
        for k, w in want.items():
            assert np.abs(got[k] - w).max() <= 1e-6 * np.abs(w).max(), (name, k)


# ── the three train steps ────────────────────────────────────────────────


def _sensevoice_case():
    jcfg, tcfg = jsv.SenseVoiceConfig(**SV_TINY), tsv.SenseVoiceConfig(**SV_TINY)
    params = jsv.init_params(jcfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(1)
    audio = (rng.standard_normal((4, 4800)) * 2000).astype(np.float32)
    labels = rng.integers(1, 64, (4, 6)).astype(np.int32)
    labels[0, 2] = labels[0, 1]
    batch = (audio, np.array([4800, 4000, 4800, 3000], np.int32), np.array([0, 1, 2, 0], np.int32),
             labels, np.array([6, 4, 6, 3], np.int32))

    def jloss(p):
        logits, vs = jsv.encode_logits(p, jcfg, *(jnp.asarray(a) for a in batch[:3]))
        return jt.ctc_loss_from_logits(logits.astype(jnp.float32), vs, jnp.asarray(batch[3]),
                                       jnp.asarray(batch[4]), jcfg.blank_id)

    return (jcfg, tcfg, params, batch, jloss, tt.sensevoice_ctc_loss, jt.train_step, tt.train_step, 4, 1e-3)


def _whisper_case():
    jcfg, tcfg = jwh.WhisperConfig(**WH_TINY), twh.WhisperConfig(**WH_TINY)
    params = jwh.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = ((rng.standard_normal((4, 40, 16)) * 0.3).astype(np.float32),
             rng.integers(3, 96, (4, 10)).astype(np.int32), np.array([10, 8, 10, 6], np.int32))

    def jloss(p):
        enc = jwh.encode(p, jcfg, jnp.asarray(batch[0]))
        logits, _ = jwh._decoder_pass(p, jcfg, jwh.make_state(p, jcfg, enc), jnp.asarray(batch[1])[:, :-1],
                                      jnp.asarray(0, jnp.int32))
        return jt.aed_ce_loss(logits, jnp.asarray(batch[1])[:, 1:], jnp.asarray(batch[2]) - 1, 0.1)

    return (jcfg, tcfg, params, batch, jloss, tt.whisper_ce_loss, jt.whisper_train_step,
            tt.whisper_train_step, 4, 1e-3)


def _parakeet_case():
    jcfg = jpk.ParakeetConfig(**PK_TINY, mel=JNemoMel(n_mels=40))
    tcfg = tpk.ParakeetConfig(**PK_TINY, mel=TNemoMel(n_mels=40))
    params = jpk.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = ((rng.standard_normal((2, 8000)) * 0.1).astype(np.float32), np.array([8000, 6000], np.int32),
             rng.integers(0, 23, (2, 5)).astype(np.int32), np.array([5, 3], np.int32))

    def jloss(p):
        enc, t_valid = jpk.encode(p, jcfg, jnp.asarray(batch[0]), jnp.asarray(batch[1]))
        dec = jt.predictor_states(p, jnp.asarray(batch[2]), jcfg.blank_id)
        logits = jt.transducer_joint_logits(p, enc, dec, jcfg.vocab_size)
        return jrnnt_from_logits(logits.astype(jnp.float32), jnp.asarray(batch[2]), t_valid,
                                 jnp.asarray(batch[3]), jcfg.blank_id)

    return (jcfg, tcfg, params, batch, jloss, tt.transducer_loss, jt.transducer_train_step,
            tt.transducer_train_step, 6, 3e-3)


@pytest.mark.parametrize("case", [_sensevoice_case, _whisper_case, _parakeet_case],
                         ids=["sensevoice_ctc", "whisper_aed", "parakeet_rnnt"])
def test_train_step_matches_jax(case):
    jcfg, tcfg, params, batch, jloss, tloss, jstep, tstep, n_steps, lr = case()
    tparams = _port(params)
    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(params)
    got_loss, got_grads = tt.value_and_grad(tloss, tparams, tcfg, *batch)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    _grads_close(want_grads, got_grads)

    jopt, topt = jt.make_optimizer(lr=lr), tt.make_optimizer(lr=lr)
    jp, jo, to = params, jopt.init(params), topt.init(tparams)
    want, got = [], []
    for _ in range(n_steps):
        jp, jo, loss = jstep(jp, jo, jcfg, jopt, *(jnp.asarray(a) for a in batch))
        want.append(float(loss))
        tparams, to, loss = tstep(tparams, to, tcfg, topt, *batch)
        got.append(loss.item())
    np.testing.assert_allclose(got, want, rtol=1e-4)
    _falling(got)
    assert int(to["count"]) == n_steps


def test_steps_update_the_leaves_in_place():
    jcfg, tcfg, params, batch, *_ = _sensevoice_case()
    tparams = _port(params)
    before = _clone(tparams)
    opt = tt.make_optimizer(lr=1e-3)
    state = opt.init(tparams)
    out, state2, _ = tt.train_step(tparams, state, tcfg, opt, *batch)
    assert out is tparams and state2["mu"] is state["mu"]
    leaf, old = tparams["ctc"]["w"], before["ctc"]["w"]
    assert not torch.equal(leaf, old) and out["ctc"]["w"] is leaf


# ── fit and the checkpoint ───────────────────────────────────────────────


def _fit_setup(seed=0):
    cfg = tsv.SenseVoiceConfig(**SV_TINY)
    params = _port(jsv.init_params(jsv.SenseVoiceConfig(**SV_TINY), jax.random.PRNGKey(seed)))
    optimizer = tt.make_optimizer(lr=1e-3)

    def batches():
        r = np.random.default_rng(42)  # deterministic -> resume replays
        while True:
            audio = (r.standard_normal((2, 4800)) * 2000).astype(np.float32)
            yield (cfg, optimizer, audio, np.array([4800, 4800]), np.zeros((2,), np.int32),
                   r.integers(1, cfg.vocab_size, (2, 6)).astype(np.int32), np.array([6, 6]))

    def step_fn(params, opt_state, optimizer, cfg, _opt, *batch):
        return tt.train_step(params, opt_state, cfg, optimizer, *batch)

    return params, optimizer, batches, step_fn


def test_fit_with_checkpoint_resume(tmp_path):
    """JAX's ``test_fit_with_checkpoint_resume``: its log lines and
    ``latest_step`` values."""
    params, optimizer, batches, step_fn = _fit_setup()
    fresh = _clone(params)
    ck = str(tmp_path / "ck")
    logs = []
    _, _, losses1 = tt.fit(step_fn, params, optimizer, batches(), num_steps=4, ckpt_dir=ck, ckpt_every=2,
                           log_every=2, log_fn=logs.append)
    assert len(losses1) == 4 and any("step 2/4" in line for line in logs)
    assert logs == [f"step 2/4 loss {losses1[1]:.4f}", f"step 4/4 loss {losses1[3]:.4f}"]
    assert tck.latest_step(ck) == 4
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["step_00000002", "step_00000004"]

    logs2 = []
    _, _, losses2 = tt.fit(step_fn, fresh, optimizer, batches(), num_steps=6, ckpt_dir=ck, ckpt_every=10,
                           log_every=0, log_fn=logs2.append)
    assert logs2 == ["resumed from step 4"]
    assert len(losses2) == 2
    assert tck.latest_step(ck) == 6


def test_fit_resumed_is_bitwise_the_uninterrupted_run(tmp_path):
    """4 steps straight against 2 steps + a checkpoint + a restore into
    fresh tensors + 2 steps: losses, parameters and AdamW state bitwise."""
    params, optimizer, batches, step_fn = _fit_setup(3)
    fresh = _clone(params)
    p1, o1, l1 = tt.fit(step_fn, _clone(params), optimizer, batches(), num_steps=4, log_every=0)
    ck = tmp_path / "ck"
    _, _, la = tt.fit(step_fn, params, optimizer, batches(), num_steps=2, ckpt_dir=ck, log_every=0)
    p2, o2, lb = tt.fit(step_fn, fresh, optimizer, batches(), num_steps=4, ckpt_dir=ck, log_every=0)
    assert la + lb == l1
    a, b = tck.named_leaves({"p": p1, "o": o1}), tck.named_leaves({"p": p2, "o": o2})
    assert [n for n, _ in a] == [n for n, _ in b]
    for (name, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), name


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    params, optimizer, batches, step_fn = _fit_setup(4)
    params, state, _ = tt.fit(step_fn, params, optimizer, batches(), num_steps=1, log_every=0)
    tck.save_train_state(tmp_path / "ck", params, state, step=7)
    assert tck.latest_step(tmp_path / "ck") == 7
    with pytest.raises(FileExistsError):
        tck.save_train_state(tmp_path / "ck", params, state, step=7)
    template = {"params": _clone(params), "opt_state": optimizer.init(params), "step": torch.tensor(0)}
    p2, o2, step = tck.restore_train_state(tmp_path / "ck", template)
    assert step == 7
    want = tck.named_leaves({"params": params, "opt_state": state})
    got = tck.named_leaves({"params": p2, "opt_state": o2})
    assert [n for n, _ in want] == [n for n, _ in got] and "opt_state/count" in dict(got)
    for (name, x), (_, y) in zip(want, got):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y), name
    assert isinstance(p2["encoders"], list) and int(o2["count"]) == 1


@pytest.mark.parametrize("change", ["name", "shape", "dtype"])
def test_restore_refuses_a_mismatched_template(tmp_path, change):
    params, optimizer, *_ = _fit_setup(5)
    tck.save_train_state(tmp_path, params, optimizer.init(params), step=1)
    other = _clone(params)
    if change == "name":
        other["extra"] = torch.zeros(3)
    elif change == "shape":
        other["ctc"]["b"] = torch.zeros(other["ctc"]["b"].shape[0] + 1)
    else:
        other["ctc"]["b"] = other["ctc"]["b"].double()
    with pytest.raises(ValueError, match="template"):
        tck.restore_train_state(tmp_path, {"params": other, "opt_state": optimizer.init(other)})


def test_an_interrupted_save_leaves_no_step_folder(tmp_path, monkeypatch):
    params, optimizer, *_ = _fit_setup(6)
    state = optimizer.init(params)
    tck.save_train_state(tmp_path, params, state, step=2)

    def torn(path, tensors, metadata=None):
        with open(path, "wb") as fh:
            fh.write(b"\0" * 100)
        raise OSError("disk full")

    monkeypatch.setattr(tck, "write_safetensors", torn)
    with pytest.raises(OSError, match="disk full"):
        tck.save_train_state(tmp_path, params, state, step=4)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_00000002"]
    assert tck.latest_step(tmp_path) == 2
    monkeypatch.undo()
    tck.save_train_state(tmp_path, params, state, step=4)  # the next save of that step clears the rest
    assert tck.latest_step(tmp_path) == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000002", "step_00000004"]
