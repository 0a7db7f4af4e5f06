"""Multi-stream batched streaming: N concurrent real-time sessions, one
batched step per chunk tick.

Counterpart of ``asr_tpu/streaming/multistream.py``. The JAX package
vmaps a single-stream step; here each family's step is written once over
a leading stream axis (``models/zipformer.py``, ``streaming/*.py``), so
the runner calls that step with N = ``n_streams`` and every linear carries
all streams' rows in one call of the int8 kernel (the kernel has no
batching rule for ``torch.func.vmap``, and a loop over streams would lose
the row batching).

A masked tick runs the step on every slot and keeps an inactive slot's
state with ``torch.where(active, new, old)`` on every state leaf, so that
state stays bitwise untouched and its outputs are to be dropped. The
Paraformer factory runs the decoder on the batch and keeps a non-firing
stream's decoder state the same way (JAX's ``lax.cond`` under ``vmap``
runs both branches and selects). ``step_n`` runs K masked ticks back to
back and reads their outputs to the host once.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


def tree_map(fn, *trees):
    """``fn`` over the tensor leaves of matching dict / list / tuple trees."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        out = [tree_map(fn, *items) for items in zip(*trees)]
        return tuple(out) if isinstance(first, tuple) else out
    return fn(*trees)


def select_rows(keep: torch.Tensor, new, old):
    """``new`` where ``keep`` (N,) is True, else ``old``, on every leaf."""
    return tree_map(lambda n, o: torch.where(keep.view((-1,) + (1,) * (n.ndim - 1)), n, o), new, old)


class MultiStreamRunner:
    """Run N independent streams as one device batch.

    ``init_state_fn() -> state`` builds ONE stream's state (leading axis 1);
    ``step_fn(params, states, chunks) -> (states', outputs)`` advances every
    stream by one chunk (``chunks`` (N, samples) on the device; outputs a
    dict of tensors with a leading N axis). All streams share ``params``,
    whose device is the runner's."""

    def __init__(self, params, n_streams: int, init_state_fn: Callable[[], Any],
                 step_fn: Callable[..., Any]):
        from asr_tpu_torch.runtime.transducer_session import _params_device

        self.params = params
        self.n_streams = int(n_streams)
        self.device = _params_device(params)
        self._init_state_fn = init_state_fn
        self._step_fn = step_fn
        with torch.inference_mode():
            one = init_state_fn()
            self.states = tree_map(lambda x: x.repeat((self.n_streams,) + (1,) * (x.ndim - 1)), one)

    def _chunks(self, chunks) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(chunks, np.float32)).to(self.device)

    def _tick(self, chunks: torch.Tensor, active: np.ndarray | None):
        new, outs = self._step_fn(self.params, self.states, chunks)
        if active is None:
            self.states = new
        else:
            keep = torch.from_numpy(np.asarray(active, bool)).to(self.device)
            self.states = select_rows(keep, new, self.states)
        return outs

    @torch.inference_mode()
    def step(self, chunks: np.ndarray, active: np.ndarray | None = None) -> dict:
        """chunks (n_streams, samples) -> outputs on the host, each with a
        leading ``n_streams`` axis: one batched step, one host read.

        ``active``: optional (n_streams,) bool; a False slot runs in the
        batch but its state is left untouched (a connection without fresh
        audio this tick does not advance its caches) and its outputs are to
        be dropped by the caller."""
        assert chunks.shape[0] == self.n_streams, (chunks.shape, self.n_streams)
        outs = self._tick(self._chunks(chunks), active)
        return {k: v.cpu().numpy() for k, v in outs.items()}

    @torch.inference_mode()
    def step_n(self, chunks: np.ndarray, active: np.ndarray) -> dict:
        """K ticks: ``chunks (K, n_streams, samples)``, ``active (K,
        n_streams)`` -> outputs on the host with leading (K, n_streams)
        axes. The ticks launch back to back and the host reads the outputs
        once, at the end; an all-False tick is a no-op (no step runs, its
        outputs are zeros), so callers pad short bursts to a fixed K."""
        assert chunks.ndim == 3 and chunks.shape[1] == self.n_streams
        dev_chunks = self._chunks(chunks)
        per_tick: list = []
        for t in range(chunks.shape[0]):
            per_tick.append(self._tick(dev_chunks[t], active[t]) if np.asarray(active[t]).any() else None)
        ran = next((o for o in per_tick if o is not None), None)
        if ran is None:
            return {}
        stacked = {k: torch.stack([o[k] if o is not None else torch.zeros_like(v) for o in per_tick])
                   for k, v in ran.items()}
        return {k: v.cpu().numpy() for k, v in stacked.items()}

    @torch.inference_mode()
    def reset(self, stream: int) -> None:
        """Reset one stream's state (a new utterance) without touching the others."""
        fresh = self._init_state_fn()

        def put(s, f):
            s[stream] = f[0].to(s.dtype)
            return s

        self.states = tree_map(put, self.states, fresh)


def paraformer_multistream(params, cfg, n_streams: int) -> MultiStreamRunner:
    """N concurrent streaming-Paraformer sessions (0.5 s chunks).

    Step outputs: {"ids": (N, max_fires) int32, "count": (N,)}: the tokens
    each stream fired this chunk (count 0 = nothing fired; such a stream's
    decoder state is kept)."""
    from asr_tpu_torch.streaming import paraformer_online as po

    dec_keys = ("dec_fsmn", "dec_k", "dec_v", "dec_valid")

    def step(p, state, chunks):
        state, fired, count, enc_out = po.encoder_step(p, cfg, state, chunks)
        dec_state, ids, _ = po.decoder_step(p, cfg, state, enc_out, fired, count)
        fire = count > 0
        kept = select_rows(fire, {k: dec_state[k] for k in dec_keys}, {k: state[k] for k in dec_keys})
        return {**state, **kept}, {"ids": ids, "count": count.to(torch.int32)}

    return MultiStreamRunner(params, n_streams, lambda: po.init_state(cfg, params, 1), step)


def zipformer_multistream(params, cfg, n_streams: int) -> MultiStreamRunner:
    """N concurrent X-ASR Zipformer2 transducer streams (one window a tick).

    Step outputs: {"ids": (N, max_new), "count": (N,)}."""
    from asr_tpu_torch.models import zipformer as zf
    from asr_tpu_torch.runtime.transducer_session import _params_device

    device = _params_device(params)

    def step(p, state, windows):
        state, enc = zf.encoder_step(p, cfg, state, windows)
        state, ids, count = zf.greedy_chunk(p, cfg, state, enc)
        return state, {"ids": ids, "count": count}

    return MultiStreamRunner(params, n_streams, lambda: zf.init_state(cfg, 1, device), step)


def dolphin_multistream(params, cfg, n_streams: int) -> MultiStreamRunner:
    """N concurrent Dolphin CN-Dialect streaming encoders (per-chunk CTC).

    Step outputs: {"ctc_ids": (N, chunk_frames) int32}: raw per-chunk CTC
    ids (collapsed across chunks per stream, as the session does). The
    projected position keys are computed once for the runner."""
    from asr_tpu_torch.runtime.transducer_session import _params_device
    from asr_tpu_torch.streaming import dolphin_stream as ds

    device = _params_device(params)
    with torch.inference_mode():
        rel_k = ds.precompute_rel_k(params, cfg)

    def step(p, state, windows):
        state, ctc_ids, _enc = ds.encoder_step(p, cfg, state, windows, rel_k)
        return state, {"ctc_ids": ctc_ids}

    return MultiStreamRunner(params, n_streams, lambda: ds.init_state(cfg, 1, device), step)


def nemotron_multistream(params, cfg, n_streams: int, prompt_id: int = 0) -> MultiStreamRunner:
    """N concurrent cache-aware Nemotron RNN-T streams.

    Step outputs: {"ids": (N, max_new), "count": (N,)}. The projected
    position keys are computed once for the runner. Each stream's predictor
    starts from blank, as the single-stream session starts it (the JAX
    package's runner starts it from token 0, so its slots' ids differ from
    its session's)."""
    from asr_tpu_torch.runtime.transducer_session import _params_device
    from asr_tpu_torch.streaming import nemotron_stream as ns

    device = _params_device(params)
    with torch.inference_mode():
        rel_k = ns.precompute_rel_k(params, cfg)

    def step(p, state, windows):
        pid = torch.full((windows.shape[0],), prompt_id, dtype=torch.int64, device=windows.device)
        state, enc_proj = ns.encoder_step(p, cfg, state, windows, pid, rel_k)
        state, ids, count = ns.rnnt_stream_step(p, cfg, state, enc_proj)
        return state, {"ids": ids, "count": count}

    def init():
        state = ns.init_state(cfg, 1, device)
        state["token"].fill_(cfg.base.blank_id)
        return state

    return MultiStreamRunner(params, n_streams, init, step)
