"""The slot bookkeeping shared by the continuous batchers.

A continuous batcher keeps ``n_slots`` requests in one running decode batch
on the device: per-slot ``gen_buf`` / ``pos`` / ``last`` / ``count`` /
``active`` tensors, a free-slot list, and host mirrors of each slot's ids and
liveness, so reading results never waits for the device. A family's batcher
(``aed_batcher.ContinuousAedBatcher``, ``llm_batcher.ContinuousLlmBatcher``)
supplies the prefill, the slot insert and one step's logits; this module
supplies the rest of the JAX package's engine API: ``step``, ``step_tick``,
``take_result``, ``cancel``, ``is_active``, ``snapshot``, ``n_active`` and
``last_tick_substeps``.

A tick runs ``steps_per_tick`` steps with no host synchronisation between
them, then fetches one ``(3, K, n_slots)`` event tensor (active, token,
finished). Sampling draws each request's noise from its own
``torch.Generator``, seeded from (base seed, request seed) with automatic
seeds kept apart from explicit ones, so a request's tokens depend only on
its seed and its own step index; a ``noise`` hook can replace the draws.

Thread model: every method from one thread (the server's decode thread),
as in the JAX package; only the free-slot list is locked.
"""

from __future__ import annotations

import threading
from typing import Callable

import numpy as np
import torch

from asr_tpu_torch.decode.ar import DecodeConfig, select_token
from asr_tpu_torch.decode.strategies import suppress_tokens, uniform_noise

# noise(request seed, draw index, shape, device) -> uniform f32 draw in
# [1e-20, 1); draw 0 picks the first token, draw k the k-th step's.
SlotNoise = Callable[[int | None, int, tuple, torch.device], torch.Tensor]


def _request_seed(base: int, explicit: bool, seed: int) -> int:
    """The generator seed of one request: (base seed, explicit or automatic,
    request seed) mixed, so an explicit seed N never meets the Nth automatic
    one."""
    words = np.random.SeedSequence([base, int(explicit), seed]).generate_state(2, np.uint32)
    return int(words[0]) << 31 ^ int(words[1])


class SlotEngine:
    """Slots, their bookkeeping and the engine API; a subclass calls
    :meth:`_init_slots` and implements :meth:`_logits`."""

    def _init_slots(self, n_slots: int, decode_cfg: DecodeConfig, t_max: int, vocab: int,
                    device: torch.device, seed: int, steps_per_tick: int,
                    noise: SlotNoise | None) -> None:
        self.n_slots = int(n_slots)
        if self.n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        self.dc = decode_cfg
        self.gen_cap = decode_cfg.max_new_tokens + 1
        self.device = device
        self._t_max, self._vocab = t_max, vocab
        n = self.n_slots

        def zeros(dtype):
            return torch.zeros((n,), dtype=dtype, device=device)

        self.gen_buf = torch.zeros((n, self.gen_cap), dtype=torch.int64, device=device)
        self.pos = zeros(torch.int32)  # the cache row the next token takes
        self.last = zeros(torch.int64)
        self.count = zeros(torch.int64)
        self.active = zeros(torch.bool)
        self._base_seed = int(seed)
        self._noise = noise
        self._seed_counter = 0  # automatic request seeds
        self._req_seed: list[int | None] = [None] * n
        self._gens: list[torch.Generator | None] = [None] * n
        self._draws = [0] * n
        self._free = list(range(n))
        self._active_host = np.zeros(n, bool)
        self._gen_host: list[list[int]] = [[] for _ in range(n)]
        self._lock = threading.Lock()
        self.steps_per_tick = max(int(steps_per_tick), 1)
        self.last_tick_substeps = 0

    # ── joining ──────────────────────────────────────────────────────────
    def _claim(self, seed: int | None) -> tuple[int, bool, int] | None:
        """A free slot and the request's seed: (slot, explicit, seed), or
        None when every slot is busy."""
        with self._lock:
            if not self._free:
                return None
            slot = self._free.pop(0)
            explicit = seed is not None
            seed_i = int(seed) if explicit else self._seed_counter
            self._seed_counter += not explicit
        return slot, explicit, seed_i

    def _unclaim(self, slot: int) -> None:
        with self._lock:
            self._free.insert(0, slot)

    def _first_token(self, slot: int, explicit: bool, seed_i: int,
                     logits0: torch.Tensor) -> torch.Tensor:
        """Reseed the slot's sampling stream for a new request and pick its
        first token from the (suppressed) prefill logits (1, V)."""
        self._req_seed[slot] = seed_i if explicit else None
        self._draws[slot] = 0
        self._gens[slot] = None
        if self.dc.strategy == "sampling" and self._noise is None:
            self._gens[slot] = torch.Generator(device=self.device).manual_seed(
                _request_seed(self._base_seed, explicit, seed_i))
        empty = torch.zeros((1, self.gen_cap), dtype=torch.int64, device=self.device)
        return select_token(logits0.to(torch.float32), empty, 0, self.dc, history_start=0,
                            noise=lambda shape, dev: self._noise_row(slot, shape))[0]

    def _start(self, slot: int, first: torch.Tensor, pos: int) -> None:
        """Slot bookkeeping of a request that joins with its first token,
        its next token taking cache row ``pos``."""
        self.gen_buf[slot] = 0
        self.gen_buf[slot, 0] = first
        self.pos[slot] = pos
        self.last[slot] = first
        self.count[slot] = 1
        first_h = int(first)
        live = first_h != self.dc.eot_id and self.gen_cap > 1
        self.active[slot] = live
        self._active_host[slot] = live
        self._gen_host[slot] = [first_h]

    # ── sampling noise ───────────────────────────────────────────────────
    def _noise_row(self, slot: int, shape: tuple) -> torch.Tensor:
        k = self._draws[slot]
        self._draws[slot] += 1
        if self._noise is not None:
            return self._noise(self._req_seed[slot], k, shape, self.device)
        return uniform_noise(shape, self.device, self._gens[slot])

    def _step_noise(self) -> torch.Tensor | None:
        """(n_slots, V) draws for one step: a row from each live slot's own
        stream, a constant for the others (their tokens are discarded)."""
        if self.dc.strategy != "sampling":
            return None
        shape = (1, self._vocab)
        return torch.cat([self._noise_row(i, shape) if self._active_host[i]
                          else torch.full(shape, 0.5, device=self.device)
                          for i in range(self.n_slots)])

    # ── one device step (no host sync) ───────────────────────────────────
    def _logits(self) -> torch.Tensor:
        """(n_slots, V) logits of every slot's next token; writes each active
        slot's fresh cache row."""
        raise NotImplementedError

    def _step_body(self, noise: torch.Tensor | None) -> torch.Tensor:
        dc = self.dc
        logits = suppress_tokens(self._logits().to(torch.float32), dc.suppress_ids)
        tok = select_token(logits, self.gen_buf, self.count, dc, history_start=0,
                           noise=None if noise is None else lambda shape, dev: noise)
        act = self.active.clone()
        tok = torch.where(act, tok, dc.eot_id)
        col = torch.clamp(self.count, max=self.gen_cap - 1)[:, None]
        self.gen_buf.scatter_(1, col, torch.where(act[:, None], tok[:, None],
                                                  self.gen_buf.gather(1, col)))
        self.count += act
        self.pos += act.to(torch.int32)
        still = act & (tok != dc.eot_id) & (self.count < self.gen_cap) & (self.pos < self._t_max)
        self.last.copy_(tok)
        self.active.copy_(still)
        return torch.stack([act.to(torch.int64), tok, (act & ~still).to(torch.int64)])

    # ── engine API ───────────────────────────────────────────────────────
    @torch.inference_mode()
    def step(self) -> list[tuple[int, int, bool]]:
        """Advance every active slot one token: ``[(slot, token, finished),
        ...]`` for the slots that were active; a finished slot frees when the
        caller drains it with :meth:`take_result`."""
        was_active = self._active_host.copy()
        if not was_active.any():
            self.last_tick_substeps = 0
            return []
        self.last_tick_substeps = 1
        _, tok_h, fin_h = self._step_body(self._step_noise()).cpu().numpy()  # ONE fetch
        fin_h = fin_h.astype(bool)
        self._active_host = was_active & ~fin_h
        events = [(i, int(tok_h[i]), bool(fin_h[i])) for i in range(self.n_slots) if was_active[i]]
        for i, t, _f in events:
            self._gen_host[i].append(t)
        return events

    @torch.inference_mode()
    def step_tick(self) -> list[tuple[int, int, bool]]:
        """``steps_per_tick`` steps and one host fetch; the same event stream
        as that many :meth:`step` calls, in substep order."""
        if self.steps_per_tick == 1:
            return self.step()
        if not self._active_host.any():
            self.last_tick_substeps = 0
            return []
        outs = [self._step_body(self._step_noise()) for _ in range(self.steps_per_tick)]
        act_h, tok_h, fin_h = torch.stack(outs, dim=1).cpu().numpy()  # ONE fetch: (3, K, n)
        act_h = act_h.astype(bool)
        fin_h = fin_h.astype(bool)
        self.last_tick_substeps = int(act_h.any(axis=1).sum())
        self._active_host = act_h[-1] & ~fin_h[-1]
        events = [(i, int(tok_h[s, i]), bool(fin_h[s, i]))
                  for s in range(act_h.shape[0]) for i in range(self.n_slots) if act_h[s, i]]
        for i, t, _f in events:
            self._gen_host[i].append(t)
        return events

    def take_result(self, slot: int) -> list[int]:
        """A finished slot's ids (EOT included when produced); frees the slot."""
        ids = list(self._gen_host[slot])
        with self._lock:
            if slot not in self._free:
                self._free.append(slot)
        return ids

    @torch.inference_mode()
    def cancel(self, slot: int) -> None:
        """Park a slot without draining it (warm-up, or the client left)."""
        self.active[slot] = False
        self._active_host[slot] = False
        with self._lock:
            if slot not in self._free:
                self._free.append(slot)

    def is_active(self, slot: int) -> bool:
        """Whether the slot is still generating (False right after submit:
        the first token already ended the request; drain it now)."""
        return bool(self._active_host[slot])

    def snapshot(self, slot: int) -> list[int]:
        """The ids generated so far (the host mirror: no device fetch)."""
        return list(self._gen_host[slot])

    @property
    def n_active(self) -> int:
        return int(self._active_host.sum())
