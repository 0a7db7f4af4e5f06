"""The port's RNN-T and TDT losses (``asr_tpu_torch/parallel/rnnt_loss.py``)
against the JAX package's and against a brute-force float64 lattice DP (the
one ``tests/test_rnnt_loss.py`` uses, copied here), in NLL and in the
gradient w.r.t. the log-probs and logits, padded batches included; and the
wavefront's checkpointed steps keep O(T+U) slabs for the backward pass."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.parallel import rnnt_loss as jr
from asr_tpu_torch.parallel import rnnt_loss as tr

RTOL = 1e-5
LENS = [(8, 5), (5, 2), (3, 0)]  # (T, U) of a padded batch at T_max 8, U_max 5
DURATIONS = (0, 1, 2)


def _ref_nll(lp, label, T, U, blank):
    """O(T*U) float64 forward DP, the textbook recursion."""
    alpha = np.full((T, U + 1), -np.inf)
    alpha[0, 0] = 0.0
    for t in range(T):
        for u in range(U + 1):
            if t == 0 and u == 0:
                continue
            cands = []
            if t > 0:
                cands.append(alpha[t - 1, u] + lp[t - 1, u, blank])
            if u > 0:
                cands.append(alpha[t, u - 1] + lp[t, u - 1, label[u - 1]])
            alpha[t, u] = np.logaddexp.reduce(cands)
    return -(alpha[T - 1, U] + lp[T - 1, U, blank])


def _ref_tdt_nll(tok_lp, dur_lp, label, T, U, durations, blank):
    """float64 brute-force TDT lattice DP with the same boundary
    convention: paths land on cells, final blank (d>=1) exits at (T-1, U)."""
    alpha = np.full((T, U + 1), -np.inf)
    alpha[0, 0] = 0.0
    for s in range(1, T + U + 1):
        for t in range(T):
            u = s - t
            if not (0 <= u <= U):
                continue
            cands = []
            for di, d in enumerate(durations):
                ts = t - d
                if ts >= 0 and d >= 1:  # blank
                    cands.append(alpha[ts, u] + tok_lp[ts, u, blank] + dur_lp[ts, u, di])
                if ts >= 0 and u >= 1:  # label
                    cands.append(alpha[ts, u - 1] + tok_lp[ts, u - 1, label[u - 1]]
                                 + dur_lp[ts, u - 1, di])
            if cands:
                alpha[t, u] = np.logaddexp.reduce(cands)
    final = np.logaddexp.reduce([dur_lp[T - 1, U, di]
                                 for di, d in enumerate(durations) if d >= 1])
    return -(alpha[T - 1, U] + tok_lp[T - 1, U, blank] + final)


def _log_softmax(x):
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


def _batch(seed, v=7, t_max=8, u_max=5, blank=0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((len(LENS), t_max, u_max + 1, v))
    # labels avoid blank; the padded tail holds ids too, as a padded batch does
    labels = rng.integers(1, v, (len(LENS), u_max))
    t_valid = np.array([t for t, _ in LENS], np.int32)
    u_valid = np.array([u for _, u in LENS], np.int32)
    return logits, labels.astype(np.int32), t_valid, u_valid


def _close(got, want, rel=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), (got, want)


def test_rnnt_nll_matches_jax_and_the_bruteforce_dp():
    logits, labels, tv, uv = _batch(0)
    lp = _log_softmax(logits).astype(np.float32)
    got = tr.rnnt_loss(torch.tensor(lp), torch.tensor(labels), torch.tensor(tv), torch.tensor(uv), 0)
    want = jr.rnnt_loss(jnp.asarray(lp), jnp.asarray(labels), jnp.asarray(tv), jnp.asarray(uv), 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    dp = [_ref_nll(lp[i].astype(np.float64), labels[i], t, u, 0) for i, (t, u) in enumerate(LENS)]
    np.testing.assert_allclose(got.numpy(), dp, rtol=RTOL)


def test_rnnt_gradient_matches_jax():
    """d(sum_b w_b * nll_b) / d(log_probs) and / d(logits), a weight per
    sample so each sample's gradient counts apart."""
    logits, labels, tv, uv = _batch(1)
    lp = _log_softmax(logits).astype(np.float32)
    w = np.arange(1, len(LENS) + 1, dtype=np.float32)

    def jloss(x):
        return jnp.sum(jr.rnnt_loss(x, jnp.asarray(labels), jnp.asarray(tv), jnp.asarray(uv), 0) * w)

    x = torch.tensor(lp, requires_grad=True)
    (tr.rnnt_loss(x, torch.tensor(labels), torch.tensor(tv), torch.tensor(uv), 0) * torch.tensor(w)).sum().backward()
    _close(x.grad.numpy(), jax.grad(jloss)(jnp.asarray(lp)))

    lg = logits.astype(np.float32)
    x = torch.tensor(lg, requires_grad=True)
    loss = tr.rnnt_loss_from_logits(x, torch.tensor(labels), torch.tensor(tv), torch.tensor(uv), 0)
    loss.backward()
    jl, jg = jax.value_and_grad(lambda z: jr.rnnt_loss_from_logits(
        z, jnp.asarray(labels), jnp.asarray(tv), jnp.asarray(uv), 0))(jnp.asarray(lg))
    np.testing.assert_allclose(loss.detach().item(), float(jl), rtol=RTOL)
    _close(x.grad.numpy(), jg)


def test_rnnt_perfect_model_low_loss():
    t, u, v, blank = 5, 3, 6, 0
    label = np.array([2, 3, 4])
    logits = np.full((t, u + 1, v), -15.0, np.float32)
    for uu in range(u):  # every label at frame 0, then blanks down the last column
        logits[0, uu, label[uu]] = 15.0
    for frame in range(t):
        logits[frame, u, blank] = 15.0
    loss = tr.rnnt_loss_from_logits(torch.tensor(logits)[None], torch.tensor(label)[None],
                                    torch.tensor([t]), torch.tensor([u]))
    assert float(loss) < 0.1


def _tdt_batch(seed):
    logits, labels, tv, uv = _batch(seed)
    rng = np.random.default_rng(seed + 100)
    dur = rng.standard_normal(logits.shape[:3] + (len(DURATIONS),))
    return (_log_softmax(logits).astype(np.float32), _log_softmax(dur).astype(np.float32), labels, tv, uv)


def test_tdt_nll_matches_jax_and_the_bruteforce_dp():
    tok, dur, labels, tv, uv = _tdt_batch(5)
    got = tr.tdt_loss(torch.tensor(tok), torch.tensor(dur), torch.tensor(labels), torch.tensor(tv),
                      torch.tensor(uv), durations=DURATIONS, blank_id=0)
    want = jr.tdt_loss(jnp.asarray(tok), jnp.asarray(dur), jnp.asarray(labels), jnp.asarray(tv),
                       jnp.asarray(uv), durations=DURATIONS, blank_id=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    dp = [_ref_tdt_nll(tok[i].astype(np.float64), dur[i].astype(np.float64), labels[i], t, u, DURATIONS, 0)
          for i, (t, u) in enumerate(LENS)]
    np.testing.assert_allclose(got.numpy(), dp, rtol=RTOL)
    # the same sample alone in a lattice of its own size
    t, u = LENS[1]
    alone = tr.tdt_loss(torch.tensor(tok[1:2, :t, :u + 1]), torch.tensor(dur[1:2, :t, :u + 1]),
                        torch.tensor(labels[1:2, :max(u, 1)]), torch.tensor([t]), torch.tensor([u]),
                        durations=DURATIONS, blank_id=0)
    np.testing.assert_allclose(alone.numpy(), got.numpy()[1:2], rtol=RTOL)


def test_tdt_gradient_matches_jax():
    tok, dur, labels, tv, uv = _tdt_batch(6)
    w = np.arange(1, len(LENS) + 1, dtype=np.float32)

    def jloss(a, b):
        return jnp.sum(jr.tdt_loss(a, b, jnp.asarray(labels), jnp.asarray(tv), jnp.asarray(uv),
                                   durations=DURATIONS, blank_id=0) * w)

    x, y = torch.tensor(tok, requires_grad=True), torch.tensor(dur, requires_grad=True)
    loss = tr.tdt_loss(x, y, torch.tensor(labels), torch.tensor(tv), torch.tensor(uv),
                       durations=DURATIONS, blank_id=0)
    (loss * torch.tensor(w)).sum().backward()
    gx, gy = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(tok), jnp.asarray(dur))
    _close(x.grad.numpy(), gx)
    _close(y.grad.numpy(), gy)


@pytest.mark.parametrize("loss", ["rnnt", "tdt"])
def test_wavefront_steps_are_checkpointed(loss):
    """Autograd keeps one (B, T, U+1) slab a step (each step's input, from
    which the backward pass recomputes it) plus the masked emission slabs,
    not every step's intermediates; the gradient equals the one of the same
    scan run without checkpoints."""
    b, t_max, u_max, v = 2, 24, 9, 5
    rng = np.random.default_rng(7)
    lp = torch.tensor(_log_softmax(rng.standard_normal((b, t_max, u_max + 1, v))).astype(np.float32))
    dur = torch.tensor(_log_softmax(rng.standard_normal((b, t_max, u_max + 1, 3))).astype(np.float32))
    labels = torch.tensor(rng.integers(1, v, (b, u_max)))
    tv, uv = torch.tensor([t_max, 17]), torch.tensor([u_max, 4])

    def run(x, y):
        if loss == "rnnt":
            return tr.rnnt_loss(x, labels, tv, uv).sum()
        return tr.tdt_loss(x, y, labels, tv, uv, durations=DURATIONS).sum()

    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    x, y = lp.clone().requires_grad_(True), dur.clone().requires_grad_(True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = run(x, y)
    slab = b * t_max * (u_max + 1) * 4
    n_steps = t_max + u_max
    # the steps' inputs, the emission slabs and the log-prob gathers; without the
    # checkpoint a step saves ~10 slabs (rnnt) or ~40 (tdt)
    assert sum(saved) <= (n_steps + 16) * slab + 4 * lp.numel() * 4, (sum(saved), slab, n_steps)
    out.backward()

    plain = tr._scan

    def unchecked(step, alpha, n):
        for d in range(1, n):
            alpha = step(alpha, d)
        return alpha

    x2, y2 = lp.clone().requires_grad_(True), dur.clone().requires_grad_(True)
    try:
        tr._scan = unchecked
        run(x2, y2).backward()
    finally:
        tr._scan = plain
    torch.testing.assert_close(x.grad, x2.grad, rtol=0, atol=0)
    if loss == "tdt":
        torch.testing.assert_close(y.grad, y2.grad, rtol=0, atol=0)
