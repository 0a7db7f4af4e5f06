"""Continuous batching for the LLM-decoder ASR families (Qwen3-ASR).

Counterpart of ``asr_tpu/parallel/llm_batcher.py``. Requests join and leave
a running decode batch mid-flight:

- Each slot has its own compact KV cache (its prompt at rows ``[0, L)``, so
  a row is its logical position) and its own position, so slots never see
  each other. One step advances every active slot by one token; a parked
  slot writes nowhere and its finite garbage is discarded.
- A new request prefills alone (its prompt bucketed to a power of two, the
  causal prefill bias masking the pad), then its cache rows are copied into
  a free slot and it decodes on the very next step.
- A finished slot (EOT or budget) frees as soon as the host sees it.

With stacked q4 weights (``ops.fused_decode.stack_decode_params``) and a
geometry and slot count the multi-slot kernel takes
(``ops.fused_decode_multi.kernel_takes``), the state is ``(NL, n_slots, T,
n_kv * 128)`` planes and each step is one call of
``ops.fused_decode_multi.fused_decode_step_multi`` (the hand-written kernel
on a card), the packed tied head inside it. Otherwise the state is the
decoder's ``make_kv_state`` layout with a slot axis and each step runs
``layers/qwen3.decoder_step_rowwise``, whose linears go through ``dense``
at M = n_slots (on a card, the int2 kernel for a q2 LLM, the int4 kernel
for unstacked q4 weights). Both layouts are updated in place.

The slot bookkeeping, sampling streams (each request's own
``torch.Generator``; the JAX package's explicit seed N meeting its N-th
automatic seed is not copied), ticks and the rest of the engine API are
``slot_engine.SlotEngine``'s. Per-slot output equals the request run alone.

With ``mesh=`` (a (1, T) mesh, ``parallel/mesh.py``) the batcher is
tensor parallel: the weights shard by ``parallel/mesh.qwen3_param_specs``,
each rank keeps the caches of its kv heads on its device, and every prefill
and step runs rowwise on all ranks at once (one thread each, meeting at the
row-parallel sums); sampling and the argmax happen once, on rank 0's
gathered logits (bitwise those of every rank), and the tokens feed all
ranks. The multi-slot kernel is single-device, so ``stacked`` is ignored.
"""

from __future__ import annotations

import torch

from asr_tpu_torch.decode.ar import DecodeConfig
from asr_tpu_torch.decode.strategies import suppress_tokens
from asr_tpu_torch.layers import qwen3
from asr_tpu_torch.layers.rope import rope_tables
from asr_tpu_torch.ops.fused_decode_multi import fused_decode_step_multi, kernel_takes
from asr_tpu_torch.parallel.mesh import qwen3_param_specs, run_grid, shard_params
from asr_tpu_torch.parallel.slot_engine import SlotEngine, SlotNoise


def _bucket(n: int, lo: int = 32) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class ContinuousLlmBatcher(SlotEngine):
    """Slot-based continuous decode over one Qwen3 decoder.

    The engine API (``try_submit`` / ``step`` / ``step_tick`` /
    ``take_result`` / ``cancel`` / ``is_active`` / ``snapshot`` /
    ``n_active`` / ``last_tick_substeps``) is the JAX package's.

    Args:
      llm_params: the (fused) Qwen3 params the session holds; only the KV
        state is the batcher's own.
      cfg: ``qwen3.Qwen3Config``.
      decode_cfg: strategy/penalty/sampling and ``max_new_tokens``, the solo
        decode's semantics (a slot generates up to ``max_new_tokens + 1``
        ids, EOT included).
      n_slots: concurrent requests riding one step.
      t_max: cache rows per slot (>= the longest prompt bucket + the
        budget), rounded up to a multiple of 8 as in the JAX package.
      seed: base seed of the requests' sampling generators.
      kv_dtype: cache storage dtype.
      stacked: stacked q4 weights; with them (and a geometry and slot count
        the multi-slot kernel takes) each step is one
        ``fused_decode_step_multi`` call.
      steps_per_tick: decode steps per host fetch.
      noise: optional ``SlotNoise`` hook replacing the generators' draws
        (tests feed the JAX package's own per-slot draws through it).
      mesh: a (1, T) mesh: the tensor-parallel engine (T must divide the
        q and kv head counts).
    """

    @torch.inference_mode()
    def __init__(self, llm_params: dict, cfg: qwen3.Qwen3Config, decode_cfg: DecodeConfig,
                 n_slots: int = 8, t_max: int = 1024, seed: int = 0,
                 kv_dtype: torch.dtype = torch.float32, stacked: dict | None = None,
                 steps_per_tick: int = 1, noise: SlotNoise | None = None, mesh=None):
        self.mesh = mesh
        self.params = llm_params
        self.cfg = cfg
        self.kv_dtype = kv_dtype
        t_max = -(-int(t_max) // 8) * 8
        self.t_max = t_max
        dev = llm_params["final_norm"]["scale"].device
        if mesh is not None:
            tp = mesh.shape["model"]
            if cfg.num_heads % tp or cfg.num_kv_heads % tp:
                raise ValueError(f"tensor-parallel size {tp} must divide num_heads={cfg.num_heads} "
                                 f"and num_kv_heads={cfg.num_kv_heads}")
            if mesh.shape["data"] != 1:
                raise ValueError(f"the tensor-parallel engine takes a (1, T) mesh, got {mesh.shape}")
            self._sharded = shard_params(llm_params, mesh, qwen3_param_specs(llm_params))
            dev = mesh.devices[0][0]
            stacked = None  # the multi-slot kernel is single-device
        self._init_slots(n_slots, decode_cfg, t_max, cfg.vocab_size, dev, seed, steps_per_tick,
                         noise)
        self.stacked = (stacked if stacked is not None and kernel_takes(cfg, self.n_slots)
                        else None)
        if mesh is not None:
            # each rank's caches hold its kv heads, on its device
            self.state = None
            self._rank_states = run_grid(mesh, lambda d, m: qwen3.make_kv_state(
                cfg, self.n_slots, t_max, kv_dtype, mesh.devices[d][m]))[0]
        elif self.stacked is not None:
            kvw = cfg.num_kv_heads * cfg.head_dim
            self.state = {key: torch.zeros((cfg.num_layers, self.n_slots, t_max, kvw),
                                           dtype=kv_dtype, device=dev) for key in ("k", "v")}
        else:
            self.state = qwen3.make_kv_state(cfg, self.n_slots, t_max, kv_dtype, dev)
        self._rope = torch.from_numpy(rope_tables(t_max, cfg.head_dim, cfg.rope_theta)).to(dev)

    def _on_ranks(self, fn):
        """``fn(local params, rank state, device)`` on every model rank of
        the mesh; returns the ranks' results."""
        mesh = self.mesh
        return run_grid(mesh, lambda d, m: fn(self._sharded.local(d, m), self._rank_states[m],
                                              mesh.devices[d][m]))[0]

    def _logits(self) -> torch.Tensor:
        cfg = self.cfg
        if self.mesh is not None:
            last, pos, active = self.last, self.pos, self.active

            def rank(p, state, dev):
                emb = p["embed"][last.to(dev)].to(torch.float32)
                hidden, _ = qwen3.decoder_step_rowwise(p, cfg, emb[:, None], state, pos.to(dev),
                                                       active.to(dev))
                return qwen3.logits_from_hidden(p, cfg, hidden[:, -1])

            return self._on_ranks(rank)[0]  # bitwise the same on every rank
        emb = self.params["embed"][self.last].to(torch.float32)  # (B, H)
        if self.stacked is not None:
            logical = torch.clamp(self.pos, 0, self.t_max - 1).to(torch.int64)
            posf = torch.where(self.active, self.pos, -1)  # parked slots write nowhere
            hn, lg, _, _ = fused_decode_step_multi(self.stacked, cfg, emb, self.state["k"],
                                                   self.state["v"], posf, self._rope[0][logical],
                                                   self._rope[1][logical])
            if lg is not None:  # the head ran in the kernel; pad columns are 0
                return lg[:, : cfg.vocab_size]
            return qwen3.logits_from_normalized(self.params, cfg, hn)
        hidden, _ = qwen3.decoder_step_rowwise(self.params, cfg, emb[:, None], self.state,
                                               self.pos, self.active)
        return qwen3.logits_from_hidden(self.params, cfg, hidden[:, -1])

    def _prefill(self, embeds: torch.Tensor, valid: int):
        """(1, Lb, H) end-padded prompt embeds -> (batch-1 cache state,
        first-token logits (1, V), suppressed), the rows at their logical
        positions (compact layout)."""
        cfg = self.cfg

        def prefill(params, dev):
            state = qwen3.make_kv_state(cfg, 1, self.t_max, self.kv_dtype, dev)
            bias = qwen3.causal_prefill_bias(torch.tensor([valid], device=dev), embeds.shape[1],
                                             self.t_max)
            hidden, state = qwen3.decoder_pass(params, cfg, embeds.to(dev), state, 0, bias)
            return state, qwen3.logits_from_hidden(params, cfg, hidden[:, valid - 1])

        if self.mesh is not None:  # a list of the ranks' states
            ranks = self._on_ranks(lambda p, _state, dev: prefill(p, dev))
            state, logits0 = [r[0] for r in ranks], ranks[0][1]
        else:
            state, logits0 = prefill(self.params, self.device)
        return state, suppress_tokens(logits0.to(torch.float32), self.dc.suppress_ids)

    @torch.inference_mode()
    def try_submit(self, embeds: torch.Tensor, valid_len: int,
                   seed: int | None = None) -> int | None:
        """Prefill one request and join the running batch.

        Args:
          embeds: (L, H) or (1, L, H) prompt embeds, valid prefix first
            (``assemble_prompt``'s end-padded layout).
          valid_len: number of valid leading positions.
          seed: optional request seed for sampling; automatic seeds (a
            counter) never collide with explicit ones.

        Returns the slot id, or None when all slots are busy. The first
        generated token is available at once through :meth:`snapshot`.
        """
        claim = self._claim(seed)
        if claim is None:
            return None
        slot, explicit, seed_i = claim
        embeds = torch.as_tensor(embeds, device=self.device)
        if embeds.ndim == 2:
            embeds = embeds[None]
        lb = _bucket(embeds.shape[1])
        if lb + self.gen_cap > self.t_max:
            self._unclaim(slot)
            raise ValueError(f"prompt bucket {lb} + budget {self.gen_cap} exceeds t_max "
                             f"{self.t_max}")
        if embeds.shape[1] != lb:
            embeds = torch.nn.functional.pad(embeds, (0, 0, 0, lb - embeds.shape[1]))
        valid = int(valid_len)
        small, logits0 = self._prefill(embeds, valid)
        first = self._first_token(slot, explicit, seed_i, logits0)
        if self.mesh is not None:
            for big_state, sm_state in zip(self._rank_states, small):
                for big, sm in zip(big_state["layers"], sm_state["layers"]):
                    for key in ("k", "v"):
                        big[key][slot] = sm[key][0]
        elif self.stacked is not None:
            # the prefill's per-layer state -> this slot's (NL, T, kvw) planes
            for key in ("k", "v"):
                self.state[key][:, slot] = torch.stack(
                    [ls[key][0].reshape(self.t_max, -1) for ls in small["layers"]])
        else:
            for big, sm in zip(self.state["layers"], small["layers"]):
                for key in ("k", "v"):
                    big[key][slot] = sm[key][0]
        self._start(slot, first, valid)
        return slot
