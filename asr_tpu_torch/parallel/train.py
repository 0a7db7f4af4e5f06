"""Training: CTC, AED cross-entropy and RNN-T steps, AdamW and ``fit``.

Counterpart of ``asr_tpu/parallel/train.py``: the same names, signatures
and return values. Each step computes its loss from the port's own forward
functions (the ones inference uses, so padded-batch masking is shared) on
the parameters' device, takes the gradient of every leaf with
``torch.autograd.grad`` and applies :class:`AdamW`, ``optax.adamw``'s law.

Where JAX returns new arrays, the port updates the parameter leaves and the
optimizer's moments in place (under ``torch.no_grad``) and returns the same
trees: a caller that needs the values before a step clones them.

Over a mesh (``params`` a ``parallel/mesh.ShardedParams`` laid out with
``own=True``: JAX's dp x tp steps, whose sharding comes from where the
parameters and the batch lie) a step splits every batch array over the
data positions (JAX's ``P("data")``), runs the loss at every position in
``mesh.run_grid(..., grad=True)``, and takes one backward, in the calling
thread, from ``sum_d w_d * loss(d, rank 0)``, where ``w_d`` is slice d's
share of what the loss is a mean over (its rows; the AED loss: its target
positions), so the root is the global loss JAX returns. The backward meets
no collective: the model ranks' graphs are joined by the forward's
collectives, which are plain sums and concatenations. The gradients are
then reduced outside autograd in a fixed order (a replicated leaf summed
over the model ranks, every leaf over the data positions) and the sum is
written to every position, so AdamW, run on every position's tree, keeps
every copy of a leaf bitwise the same.

Parameters and optimizer state come across from the JAX package as numpy
arrays under ``flatten_pytree``'s names: ``runtime/artifact.params_from_flat``
for the parameters, :func:`adamw_state_from_numpy` for optax's state.
"""

from __future__ import annotations

import inspect
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from asr_tpu_torch.models import sensevoice as sv
from asr_tpu_torch.parallel.checkpoint import tree_leaves, unflatten
from asr_tpu_torch.parallel.mesh import ShardedParams, layout_leaves, run_grid

# seconds a rank of a training grid waits at a collective: a step that hangs
# fails fast (a serving grid waits mesh.COLLECTIVE_TIMEOUT_S)
TRAIN_COLLECTIVE_TIMEOUT_S = 60.0


def ctc_loss_from_logits(
    logits: torch.Tensor,
    valid_seq: torch.Tensor,
    labels: torch.Tensor,
    label_valid: torch.Tensor,
    blank_id: int = 0,
) -> torch.Tensor:
    """Mean over the batch of each sequence's CTC negative log-likelihood
    (``optax.ctc_loss``'s, not divided by the label count). An alignment
    that cannot exist gives ``inf`` where optax gives ~1e5 (its
    ``log_epsilon``)."""
    log_probs = torch.log_softmax(logits, dim=-1)
    per_seq = F.ctc_loss(log_probs.transpose(0, 1), labels.to(torch.int64), valid_seq.to(torch.int64),
                         label_valid.to(torch.int64), blank=blank_id, reduction="none")
    return per_seq.mean()


class AdamW:
    """``optax.adamw(lr, weight_decay=wd)`` (b1 0.9, b2 0.999, eps 1e-8,
    eps_root 0): bias-corrected moments, the update ``-lr * (m_hat /
    (sqrt(v_hat) + eps) + wd * p)``, decay on every leaf (optax's mask is
    None).

    The state is ``{"count", "mu", "nu"}``, optax's ``ScaleByAdamState``:
    ``count`` a 0-d int32 host tensor (the bias corrections are computed on
    the host, in f32 as optax computes them), ``mu`` / ``nu`` trees shaped
    as the parameters. The arithmetic runs as ``torch._foreach_*`` ops over
    the leaf lists."""

    b1, b2, eps = 0.9, 0.999, 1e-8  # optax's defaults, the only values the package uses

    def __init__(self, learning_rate: float, weight_decay: float = 1e-4):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay

    def init(self, params: Any) -> dict:
        """Zero moments shaped as ``params`` (on a mesh: every position's own)."""
        def zeros(tree):
            return unflatten(tree, [torch.zeros_like(p) for p in tree_leaves(tree)])

        return {"count": torch.zeros((), dtype=torch.int32),
                "mu": _per_position(zeros, params), "nu": _per_position(zeros, params)}

    def update(self, grads: Any, state: dict, params: Any) -> tuple[Any, dict]:
        """-> (updates, state): the updates are new tensors; ``state``'s
        moments are updated in place and returned with the next count. On
        a mesh every position's tree is updated from its own moments."""
        count = int(state["count"]) + 1
        if isinstance(params, ShardedParams):
            upd = params.map(lambda d, m: self._update(grads.local(d, m), state["mu"].local(d, m),
                                                       state["nu"].local(d, m), params.local(d, m), count))
        else:
            upd = self._update(grads, state["mu"], state["nu"], params, count)
        return upd, {"count": torch.tensor(count, dtype=torch.int32), "mu": state["mu"], "nu": state["nu"]}

    def _update(self, grads: Any, mu: Any, nu: Any, params: Any, count: int) -> Any:
        p = tree_leaves(params)
        g, mu, nu = (tree_leaves(t, like=params) for t in (grads, mu, nu))
        with torch.no_grad():
            # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1 - self.b1))
            sq = torch._foreach_mul(g, g)
            torch._foreach_mul_(sq, 1 - self.b2)
            torch._foreach_mul_(nu, self.b2)
            torch._foreach_add_(nu, sq)
            del sq
            # 1 - b**count in f32, as optax's bias correction (an f64 value is 1.3e-5 off at count 1)
            bc1, bc2 = (float(np.float32(1) - np.float32(b) ** np.float32(count)) for b in (self.b1, self.b2))
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            upd = torch._foreach_div(mu, bc1)
            torch._foreach_div_(upd, den)
            del den
            torch._foreach_add_(upd, torch._foreach_mul(p, self.weight_decay))
            torch._foreach_mul_(upd, -self.learning_rate)
        return unflatten(params, upd)


def _per_position(fn, params: Any) -> Any:
    """``fn(tree)`` of a tree, or of every position's tree of a mesh's."""
    if isinstance(params, ShardedParams):
        return params.map(lambda d, m: fn(params.local(d, m)))
    return fn(params)


def apply_updates(params: Any, updates: Any) -> Any:
    """``optax.apply_updates``: ``p + u`` on every leaf (on a mesh, of every
    position), in place."""
    with torch.no_grad():
        if isinstance(params, ShardedParams):
            for d, m in params.positions():
                torch._foreach_add_(tree_leaves(params.local(d, m)),
                                    tree_leaves(updates.local(d, m), like=params.local(d, m)))
        else:
            torch._foreach_add_(tree_leaves(params), tree_leaves(updates, like=params))
    return params


def adamw_state_from_numpy(count, mu: dict[str, np.ndarray], nu: dict[str, np.ndarray], device) -> dict:
    """optax's ``ScaleByAdamState`` as numpy (the count, and the ``mu`` /
    ``nu`` trees under ``flatten_pytree``'s names) -> the port's
    :class:`AdamW` state, the moments on ``device``."""
    from asr_tpu_torch.runtime.artifact import params_from_flat

    return {"count": torch.tensor(int(np.asarray(count)), dtype=torch.int32),
            "mu": params_from_flat(mu, device), "nu": params_from_flat(nu, device)}


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.01) -> AdamW:
    return AdamW(lr, weight_decay=weight_decay)


def _params_device(params: Any) -> torch.device:
    return tree_leaves(params)[0].device


def _on(x, device, dtype=None) -> torch.Tensor:
    t = torch.as_tensor(x, device=device)
    return t if dtype is None else t.to(dtype)


def value_and_grad(loss_fn, params: Any, *args, **kwargs) -> tuple[torch.Tensor, Any]:
    """(``loss_fn(params, *args, **kwargs)``, its gradient w.r.t. every leaf
    as a tree shaped as ``params``; an unused leaf's gradient is zero).

    With ``params`` a :class:`ShardedParams`: the global loss over the
    mesh's data positions and the reduced gradient, the same on every
    position (the module docstring says how)."""
    if isinstance(params, ShardedParams):
        return _mesh_value_and_grad(loss_fn, params, args, kwargs)
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss = loss_fn(unflatten(params, live), *args, **kwargs)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), unflatten(params, grads)


# ── the mesh branch ──────────────────────────────────────────────────────


def _is_batch(a) -> bool:
    return isinstance(a, (torch.Tensor, np.ndarray)) and a.ndim >= 1


def split_batch(args: tuple, kwargs: dict, n_data: int) -> list[tuple[tuple, dict]]:
    """The (args, kwargs) of each data position: every batch array (a
    tensor or numpy array of rank >= 1) cut on axis 0 into ``n_data``
    contiguous slices, other arguments as they are. Refuses a batch the
    data axis does not divide, as JAX's ``device_put`` on ``P("data")``."""
    rows = {a.shape[0] for a in (*args, *kwargs.values()) if _is_batch(a)}
    if len(rows) != 1:
        raise ValueError(f"the batch arrays disagree on their rows: {sorted(rows)}")
    b = rows.pop()
    if b % n_data:
        raise ValueError(f"a batch of {b} rows does not split over {n_data} data positions")
    k = b // n_data

    def cut(a, d):
        return a[d * k : (d + 1) * k] if _is_batch(a) else a

    return [(tuple(cut(a, d) for a in args), {n: cut(v, d) for n, v in kwargs.items()}) for d in range(n_data)]


def _rows(bound: dict) -> int:
    """What a loss that is a mean over its batch rows (CTC, RNN-T) divides
    by; a data slice's weight in the global loss is its share of this."""
    return next(a for a in bound.values() if _is_batch(a)).shape[0]


def _target_positions(bound: dict) -> int:
    """:func:`aed_ce_loss`'s denominator: the masked target positions."""
    s = bound["tokens"].shape[1] - 1
    valid = np.asarray(torch.as_tensor(bound["token_valid"]).cpu(), np.int64) - 1
    return int(np.clip(valid, 0, s).sum())


def _live(t: torch.Tensor) -> torch.Tensor:
    """A leaf that requires grad, sharing ``t``'s storage and its rank role."""
    x = t.detach().requires_grad_(True)
    role = getattr(t, "tp_role", None)
    if role is not None:
        x.tp_role = role
    return x


def _sum_lists(lists: list[list[torch.Tensor]], device: torch.device) -> list[torch.Tensor]:
    """Elementwise sums of equal-length tensor lists on ``device``, added in
    list order."""
    acc = [t.to(device) for t in lists[0]]
    for more in lists[1:]:
        acc = torch._foreach_add(acc, [t.to(device) for t in more])
    return acc


def reduce_gradients(sharded: ShardedParams, grads: list[list[list[torch.Tensor]]]) -> list[list[list[torch.Tensor]]]:
    """Every position's gradient leaves (``grads[d][m]``, in the order of
    ``tree_leaves``) -> the reduced ones: a replicated leaf's summed over
    the model ranks in rank order, then over the data positions in order; a
    sharded leaf's over the data positions; each sum copied to every
    position holding that leaf (a position on the summing device shares
    the tensor)."""
    mesh = sharded.mesh
    n_d, n_m = mesh.shape["data"], mesh.shape["model"]
    splits = layout_leaves(sharded.layout)
    whole = [i for i, s in enumerate(splits) if s.whole]
    pieces = [i for i, s in enumerate(splits) if not s.whole]
    out = [[[None] * len(splits) for _ in range(n_m)] for _ in range(n_d)]

    def put(idx, sums, ranks):
        for d in range(n_d):
            for m in ranks:
                for i, t in zip(idx, sums):
                    out[d][m][i] = t.to(mesh.devices[d][m])

    with torch.no_grad():
        if whole:
            per_data = [_sum_lists([[grads[d][m][i] for i in whole] for m in range(n_m)], mesh.devices[d][0])
                        for d in range(n_d)]
            put(whole, _sum_lists(per_data, mesh.devices[0][0]), range(n_m))
        for m in range(n_m) if pieces else ():
            put(pieces, _sum_lists([[grads[d][m][i] for i in pieces] for d in range(n_d)], mesh.devices[0][m]),
                [m])
    return out


def _mesh_value_and_grad(loss_fn, sharded: ShardedParams, args: tuple, kwargs: dict):
    if not sharded.own or sharded.layout is None:
        raise ValueError("training on a mesh needs every position's own leaves: "
                         "lay the parameters out with shard_params(..., own=True)")
    mesh = sharded.mesh
    n_d, n_m = mesh.shape["data"], mesh.shape["model"]
    slices = split_batch(args, kwargs, n_d)
    signature = inspect.signature(loss_fn)
    count = _target_positions if loss_fn is whisper_ce_loss else _rows
    counts = [count(signature.bind(None, *a, **k).arguments) for a, k in slices]
    total = max(sum(counts), 1)
    live = [[[_live(t) for t in tree_leaves(sharded.local(d, m))] for m in range(n_m)] for d in range(n_d)]

    def forward(d, m):
        a, k = slices[d]
        return loss_fn(unflatten(sharded.local(d, m), live[d][m]), *a, **k)

    losses = run_grid(mesh, forward, timeout=TRAIN_COLLECTIVE_TIMEOUT_S, grad=True)
    dev = mesh.devices[0][0]
    with torch.enable_grad():
        root = losses[0][0].to(dev) * (counts[0] / total)
        for d in range(1, n_d):
            root = root + losses[d][0].to(dev) * (counts[d] / total)
        flat = [t for row in live for pos in row for t in pos]
        got = torch.autograd.grad(root, flat, allow_unused=True)
    del losses
    it = iter(torch.zeros_like(t) if g is None else g for t, g in zip(flat, got))
    grads = [[[next(it) for _ in pos] for pos in row] for row in live]
    reduced = reduce_gradients(sharded, grads)
    return root.detach(), sharded.map(lambda d, m: unflatten(sharded.local(d, m), reduced[d][m]))


def _apply(params: Any, opt_state: dict, optimizer: AdamW, loss: torch.Tensor, grads: Any):
    updates, opt_state = optimizer.update(grads, opt_state, params)
    return apply_updates(params, updates), opt_state, loss


def train_step(
    params: Any,
    opt_state: Any,
    cfg: sv.SenseVoiceConfig,
    optimizer,
    audio: torch.Tensor,
    valid_samples: torch.Tensor,
    language_idx: torch.Tensor,
    labels: torch.Tensor,
    label_valid: torch.Tensor,
):
    """One CTC training step of a SenseVoice-style encoder on the params'
    device. Returns (params, opt_state, loss); the leaves and the moments
    are updated in place."""
    loss, grads = value_and_grad(sensevoice_ctc_loss, params, cfg, audio, valid_samples, language_idx,
                                 labels, label_valid)
    return _apply(params, opt_state, optimizer, loss, grads)


def sensevoice_ctc_loss(params: Any, cfg: sv.SenseVoiceConfig, audio, valid_samples, language_idx,
                        labels, label_valid) -> torch.Tensor:
    """:func:`train_step`'s loss: ``encode_logits`` -> CTC, on the params' device."""
    dev = _params_device(params)
    logits, valid_seq = sv.encode_logits(params, cfg, _on(audio, dev, torch.float32), _on(valid_samples, dev),
                                         _on(language_idx, dev))
    return ctc_loss_from_logits(logits.to(torch.float32), valid_seq, _on(labels, dev), _on(label_valid, dev),
                                cfg.blank_id)


def aed_ce_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    target_valid: torch.Tensor,
    label_smoothing: float = 0.1,
) -> torch.Tensor:
    """Masked teacher-forced cross-entropy with label smoothing for AED
    decoders. logits (B, S, V) at positions predicting ``targets`` (B, S)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, targets.to(torch.int64)[..., None])[..., 0]
    if label_smoothing:
        uniform = -torch.mean(logp, dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * uniform
    positions = torch.arange(targets.shape[1], device=logits.device)[None, :]
    mask = (positions < target_valid[:, None]).to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def whisper_train_step(
    params: Any,
    opt_state: Any,
    cfg,
    optimizer,
    mel: torch.Tensor,
    tokens: torch.Tensor,
    token_valid: torch.Tensor,
    label_smoothing: float = 0.1,
):
    """Teacher-forced AED fine-tuning step for Whisper-style models.

    ``tokens`` (B, S): [prompt... text... eot] padded; the loss predicts
    ``tokens[:, 1:]`` from ``tokens[:, :-1]`` over ``token_valid - 1``
    positions. Returns (params, opt_state, loss), updated in place."""
    loss, grads = value_and_grad(whisper_ce_loss, params, cfg, mel, tokens, token_valid, label_smoothing)
    return _apply(params, opt_state, optimizer, loss, grads)


def whisper_ce_loss(params: Any, cfg, mel, tokens, token_valid, label_smoothing: float = 0.1) -> torch.Tensor:
    """:func:`whisper_train_step`'s loss on the params' device. The decoder
    pass writes its self-KV rows into fresh caches (``make_state``) in
    place; autograd follows those writes."""
    from asr_tpu_torch.models import whisper as wh

    dev = _params_device(params)
    tokens = _on(tokens, dev, torch.int64)
    enc = wh.encode(params, cfg, _on(mel, dev))
    state = wh.make_state(params, cfg, enc)
    logits, _ = wh._decoder_pass(params, cfg, state, tokens[:, :-1], 0)
    return aed_ce_loss(logits, tokens[:, 1:], _on(token_valid, dev) - 1, label_smoothing)


def predictor_states(params: Any, labels: torch.Tensor, blank_id: int) -> torch.Tensor:
    """Teacher-forced transducer predictor: the LSTM stepped over [blank,
    labels] -> (B, U+1, joint_dim) projected decoder states (the state
    threading of ``models/parakeet.joint_step``, so training and greedy
    inference share predictor semantics). A host loop of U+1 steps in place
    of the JAX package's ``lax.scan``."""
    from asr_tpu_torch.layers.lstm import lstm_step_stack
    from asr_tpu_torch.layers.transformer import dense

    dec = params["decoder"]
    b = labels.shape[0]
    tokens = torch.cat([torch.full((b, 1), blank_id, dtype=labels.dtype, device=labels.device), labels],
                       dim=1).to(torch.int64)  # (B, U+1)
    n_layers = len(dec["lstm"])
    hidden = dec["lstm"][0]["w_hh"].shape[0]
    h = torch.zeros((n_layers, b, hidden), dtype=torch.float32, device=labels.device)
    c = torch.zeros_like(h)
    ys = []
    for tok in tokens.T:
        y, h, c = lstm_step_stack(dec["embed"][tok], h, c, dec["lstm"])
        ys.append(y)
    return dense(torch.stack(ys, dim=1), dec["proj"])  # (B, U+1, joint_dim)


def transducer_joint_logits(params: Any, enc: torch.Tensor, dec_states: torch.Tensor,
                            vocab_size: int) -> torch.Tensor:
    """Full-lattice joint: relu(enc[:, :, None] + dec[:, None, :]) -> head
    token logits (B, T, U+1, V) (duration logits of TDT heads are dropped:
    plain RNN-T likelihood trains the token distribution)."""
    from asr_tpu_torch.layers.transformer import dense

    z = torch.relu(enc[:, :, None, :] + dec_states[:, None, :, :])
    return dense(z, params["decoder"]["head"])[..., :vocab_size]


def transducer_train_step(
    params: Any,
    opt_state: Any,
    cfg,
    optimizer,
    audio: torch.Tensor,
    valid_samples: torch.Tensor,
    labels: torch.Tensor,
    label_valid: torch.Tensor,
):
    """One RNN-T training step for the Parakeet family (FastConformer
    encoder + LSTM predictor + joint) on the params' device. Returns
    (params, opt_state, loss), updated in place."""
    loss, grads = value_and_grad(transducer_loss, params, cfg, audio, valid_samples, labels, label_valid)
    return _apply(params, opt_state, optimizer, loss, grads)


def transducer_loss(params: Any, cfg, audio, valid_samples, labels, label_valid) -> torch.Tensor:
    """:func:`transducer_train_step`'s loss on the params' device: the
    encoder, the teacher-forced predictor, the full-lattice joint, RNN-T."""
    from asr_tpu_torch.models import parakeet as pk
    from asr_tpu_torch.parallel.rnnt_loss import rnnt_loss_from_logits

    dev = _params_device(params)
    labels = _on(labels, dev, torch.int64)
    enc, t_valid = pk.encode(params, cfg, _on(audio, dev, torch.float32), _on(valid_samples, dev))
    dec_states = predictor_states(params, labels, cfg.blank_id)
    logits = transducer_joint_logits(params, enc, dec_states, cfg.vocab_size)
    return rnnt_loss_from_logits(logits.to(torch.float32), labels, t_valid, _on(label_valid, dev), cfg.blank_id)


def fit(
    step_fn,
    params: Any,
    optimizer,
    data_iter,
    num_steps: int,
    ckpt_dir: str | None = None,
    ckpt_every: int = 100,
    log_every: int = 10,
    resume: bool = True,
    log_fn=print,
):
    """Minimal fine-tuning loop: ``step_fn(params, opt_state, optimizer,
    *batch) -> (params, opt_state, loss)`` over batches from ``data_iter``,
    with checkpoint/resume (``parallel/checkpoint.py``).

    Returns (params, opt_state, losses). With ``resume=True`` and an
    existing ``ckpt_dir``, training continues from the latest step (batches
    already consumed are skipped by fast-forwarding the iterator); the
    restored leaves are new tensors on the devices of ``params``' leaves.
    """
    from asr_tpu_torch.parallel import checkpoint as ckpt

    opt_state = optimizer.init(params)
    start = 0
    if resume and ckpt_dir is not None:
        latest = ckpt.latest_step(ckpt_dir)
        if latest is not None:
            params, opt_state, start = ckpt.restore_train_state(
                ckpt_dir, {"params": params, "opt_state": opt_state, "step": torch.tensor(0)})
            log_fn(f"resumed from step {start}")

    losses = []
    it = iter(data_iter)
    for _ in range(start):  # deterministic iterators replay consumed batches
        next(it, None)
    for step in range(start, num_steps):
        batch = next(it, None)
        if batch is None:
            break
        params, opt_state, loss = step_fn(params, opt_state, optimizer, *batch)
        losses.append(float(loss))
        if log_every and (step + 1) % log_every == 0:
            log_fn(f"step {step + 1}/{num_steps} loss {losses[-1]:.4f}")
        if ckpt_dir is not None and ckpt_every and (step + 1) % ckpt_every == 0:
            ckpt.save_train_state(ckpt_dir, params, opt_state, step + 1)
    if ckpt_dir is not None:
        final = start + len(losses)
        if ckpt.latest_step(ckpt_dir) != final:
            ckpt.save_train_state(ckpt_dir, params, opt_state, final)
    return params, opt_state, losses
