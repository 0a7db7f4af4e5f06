"""Continuous batching for the AED encoder-decoder families.

Counterpart of ``asr_tpu/parallel/aed_batcher.py``: Whisper's ``"learned"``
input math and FireRed's and Dolphin's ``"scaled_relpos"`` one. Requests
join and leave a running decode batch mid-flight:

- Decode state lives on the device at fixed shapes: per-slot self-KV and
  per-slot cross-KV (each request's own encoder output), with per-slot
  ``pos`` / ``tc_valid`` / ``count`` / ``active`` tensors. One step advances
  every active slot by one token; parked slots write nowhere and their
  finite garbage is discarded.
- A new request prefills alone through the family's solo path (the
  session's ``continuous_prefill``: encoder, probe, prompt prefill), then
  its KV rows and cross planes are copied into a free slot; it decodes on
  the very next step.
- A finished slot (EOT or budget) frees as soon as the host sees it.

With stacked q8 weights (``ops.fused_aed_step.stack_aed_step_params``) the
state is ``(NL, n_slots, T, D)`` self planes and ``(NL, n_slots, Tc, D)``
cross planes, head-major as the multi-slot kernel reads them, and each step
is one call of ``ops.fused_aed_multi.fused_aed_step_multi`` (the
hand-written kernel on a card). Otherwise the state is the solo
``make_state`` layout with a slot axis and each step runs
:func:`aed_decoder_step_rowwise`, whose linears go through ``dense`` (the
int8 kernel on a card for q8 weights). Both layouts are updated in place.

The slot bookkeeping, sampling streams, ticks and the rest of the engine
API are ``slot_engine.SlotEngine``'s. Per-slot output equals the request run
alone: greedy and penalty bitwise up to the batch's summation order,
sampling by construction (each request's own noise stream).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from asr_tpu_torch.decode.ar import DecodeConfig
from asr_tpu_torch.layers.attention import NEG_INF, mha
from asr_tpu_torch.layers.conformer import absolute_positions
from asr_tpu_torch.layers.norms import layer_norm
from asr_tpu_torch.layers.transformer import dense, merge_heads, split_heads
from asr_tpu_torch.ops.fused_aed_multi import fused_aed_step_multi, kernel_takes
from asr_tpu_torch.ops.fused_aed_step import AedGeom
from asr_tpu_torch.parallel.slot_engine import SlotEngine, SlotNoise
from asr_tpu_torch.quant.quantize import embedding_logits


@dataclasses.dataclass(frozen=True)
class AedEngineSpec:
    """Decoder geometry + input-math convention."""

    d_model: int
    ffn_dim: int
    num_heads: int
    vocab_size: int
    t_max: int                 # self-cache length == solo max_target_positions
    tc_max: int                # cross length (fixed window -> fixed encoder len)
    embed: str                 # "learned" (Whisper) | "scaled_relpos" (FireRed/Dolphin)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def spec_for_whisper(cfg) -> AedEngineSpec:
    return AedEngineSpec(
        d_model=cfg.d_model, ffn_dim=cfg.ffn_dim, num_heads=cfg.num_heads,
        vocab_size=cfg.vocab_size, t_max=cfg.max_target_positions,
        tc_max=cfg.max_source_positions, embed="learned")


def spec_for_aed(cfg, tc_max: int) -> AedEngineSpec:
    """FireRed / Dolphin: sqrt(d)-scaled embeds + reversed-relative PE."""
    return AedEngineSpec(
        d_model=cfg.d_model, ffn_dim=cfg.dec_ffn, num_heads=cfg.dec_heads,
        vocab_size=cfg.vocab_size, t_max=cfg.max_target_positions,
        tc_max=tc_max, embed="scaled_relpos")


def _embed_rows(dec: dict, spec: AedEngineSpec, tokens: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
    """Family input math for one token per slot -> (B, D) f32 rows.

    learned: ``embed[token] + pos_table[pos]`` (Whisper,
    ``models/whisper._decoder_pass``); scaled_relpos:
    ``embed[token] * sqrt(d) + reversed-relative-PE[pos]``
    (``models/firered._decoder_pass`` / ``models/dolphin._decoder_pass``)."""
    logical = torch.clamp(pos, 0, spec.t_max - 1).to(torch.int64)
    if spec.embed == "learned":
        x = dec["embed"][tokens] + dec["pos"][logical]
    elif spec.embed == "scaled_relpos":
        pos_table = absolute_positions(spec.t_max, spec.d_model, tokens.device)
        x = dec["embed"][tokens] * (spec.d_model ** 0.5) + pos_table[logical]
    else:
        raise ValueError(f"unknown input math {spec.embed!r}")
    return x.to(torch.float32)


def aed_decoder_step_rowwise(dec: dict, spec: AedEngineSpec, x: torch.Tensor, state: dict,
                             pos: torch.Tensor, tc_valid: torch.Tensor,
                             active: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One decode token through all AED decoder blocks with per-row cache
    positions; per row the math of ``layers/transformer.decoder_block`` run
    alone (same padded cache length, masked slots at exactly zero
    probability).

    Args:
      x: (B, 1, D) current-token rows (family input math applied).
      state: ``{"layers": ({"self_k"/"self_v" (B, T, H, hd), "cross_k"/
        "cross_v" (B, Tc, H, hd)}, ...)}``; row ``pos[b]`` of an active slot's
        self caches is written in place.
      pos: (B,) cache slot each row writes; tc_valid: (B,) valid cross rows;
      active: (B,) bool, parked rows write nowhere.

    Returns (hidden (B, 1, D) final-normalized, state).
    """
    t_max = state["layers"][0]["self_k"].shape[1]
    tc = state["layers"][0]["cross_k"].shape[1]
    dev = x.device
    bidx = torch.arange(x.shape[0], device=dev)
    logical = torch.clamp(pos, 0, t_max - 1).to(torch.int64)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    kpos = torch.arange(t_max, device=dev)[None, :]
    self_bias = torch.where(kpos <= logical[:, None], zero, NEG_INF)[:, None, None]
    cpos = torch.arange(tc, device=dev)[None, :]
    cross_bias = torch.where(cpos < tc_valid[:, None], zero, NEG_INF)[:, None, None]
    keep = active[:, None, None]
    h = spec.num_heads
    for p, ls in zip(dec["blocks"], state["layers"]):
        y = layer_norm(x, p["ln1"]["scale"], p["ln1"]["bias"])
        q = split_heads(dense(y, p["attn"]["q"]), h)
        k = split_heads(dense(y, p["attn"]["k"]), h)
        v = split_heads(dense(y, p["attn"]["v"]), h)
        for cache, new in ((ls["self_k"], k), (ls["self_v"], v)):
            cache[bidx, logical] = torch.where(keep, new[:, 0].to(cache.dtype),
                                               cache[bidx, logical])
        attn = mha(q, ls["self_k"], ls["self_v"], bias=self_bias)
        x = x + dense(merge_heads(attn), p["attn"]["o"])

        y = layer_norm(x, p["ln_cross"]["scale"], p["ln_cross"]["bias"])
        qc = split_heads(dense(y, p["cross"]["q"]), h)
        xc = mha(qc, ls["cross_k"], ls["cross_v"], bias=cross_bias)
        x = x + dense(merge_heads(xc), p["cross"]["o"])

        y = layer_norm(x, p["ln2"]["scale"], p["ln2"]["bias"])
        hh = F.gelu(dense(y, p["mlp"]["fc1"]), approximate="none")
        x = x + dense(hh, p["mlp"]["fc2"])
    return layer_norm(x, dec["ln"]["scale"], dec["ln"]["bias"]), state


class ContinuousAedBatcher(SlotEngine):
    """Slot-based continuous decode over one AED decoder.

    The engine API (``try_submit`` / ``step`` / ``step_tick`` /
    ``take_result`` / ``cancel`` / ``is_active`` / ``snapshot`` /
    ``n_active`` / ``last_tick_substeps``) is the JAX package's.

    Args:
      params: the family's params (``params["decoder"]`` holds the
        ``layers/transformer.decoder_block`` blocks + embed/ln[/pos][/out]).
      spec: :class:`AedEngineSpec`.
      decode_cfg: strategy/penalty/sampling + ``max_new_tokens``, the solo
        ``ar_decode`` loop's semantics.
      n_slots: concurrent requests riding one step.
      seed: base seed of the requests' sampling generators.
      kv_dtype: self/cross cache storage dtype.
      stacked: stacked q8 weights; with them (and a geometry and slot count
        the multi-slot kernel takes) each step is one
        ``fused_aed_step_multi`` call.
      steps_per_tick: decode steps per host fetch.
      noise: optional :data:`SlotNoise` hook replacing the generators' draws
        (tests feed the JAX package's own per-slot draws through it).
    """

    @torch.inference_mode()
    def __init__(self, params: dict, spec: AedEngineSpec, decode_cfg: DecodeConfig,
                 n_slots: int = 8, seed: int = 0, kv_dtype: torch.dtype = torch.float32,
                 stacked: dict | None = None, steps_per_tick: int = 1,
                 noise: SlotNoise | None = None):
        self.dec = params["decoder"]
        self.spec = spec
        self.kv_dtype = kv_dtype
        self._init_slots(n_slots, decode_cfg, spec.t_max, spec.vocab_size,
                         self.dec["ln"]["scale"].device, seed, steps_per_tick, noise)
        self._geom = AedGeom(spec.d_model, spec.ffn_dim, spec.num_heads)
        self.stacked = (stacked if stacked is not None and kernel_takes(self._geom, self.n_slots)
                        else None)
        n, t, d, dev = self.n_slots, spec.t_max, spec.d_model, self.device

        def zeros(*shape, dtype=kv_dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        nl = len(self.dec["blocks"])
        if self.stacked is not None:
            self.state = {"k": zeros(nl, n, t, d), "v": zeros(nl, n, t, d),
                          "ck": zeros(nl, n, spec.tc_max, d), "cv": zeros(nl, n, spec.tc_max, d)}
        else:
            h, hd = spec.num_heads, spec.head_dim
            self.state = {"layers": tuple(
                {"self_k": zeros(n, t, h, hd), "self_v": zeros(n, t, h, hd),
                 "cross_k": zeros(n, spec.tc_max, h, hd), "cross_v": zeros(n, spec.tc_max, h, hd)}
                for _ in range(nl))}
        self.tc_valid = zeros(n, dtype=torch.int32)

    def _logits(self) -> torch.Tensor:
        spec = self.spec
        x = _embed_rows(self.dec, spec, self.last, self.pos)
        if self.stacked is not None:
            st = self.state
            posf = torch.where(self.active, self.pos, -1)  # parked slots write nowhere
            lg, _, _ = fused_aed_step_multi(self.stacked, self._geom, x, st["k"], st["v"],
                                            st["ck"], st["cv"], posf, self.tc_valid)
            return lg[:, : spec.vocab_size]
        hidden, _ = aed_decoder_step_rowwise(self.dec, spec, x[:, None], self.state, self.pos,
                                             self.tc_valid, self.active)
        head = self.dec["out"] if "out" in self.dec else self.dec["embed"]
        return embedding_logits(head, hidden[:, -1])

    @torch.inference_mode()
    def try_submit(self, small_state: dict, p_len: int, logits0: torch.Tensor,
                   tc_valid: int, seed: int | None = None) -> int | None:
        """Insert one prefilled request into a free slot.

        Args:
          small_state: batch-1 state from the family's ``make_state`` + prompt
            prefill (solo layout: per-layer self/cross KV); its cross length
            is at most ``spec.tc_max``.
          p_len: prompt length (the prompt occupies self-cache [0, p_len)).
          logits0: (1, V) prefill logits, already suppressed (and
            begin-suppressed for Whisper).
          tc_valid: number of real cross rows.
          seed: optional request seed for sampling; automatic seeds (a
            counter) never collide with explicit ones.

        Returns the slot id, or None when all slots are busy.
        """
        claim = self._claim(seed)
        if claim is None:
            return None
        slot, explicit, seed_i = claim
        if p_len + self.gen_cap > self.spec.t_max:
            self._unclaim(slot)
            raise ValueError(f"prompt {p_len} + budget {self.gen_cap} exceeds t_max "
                             f"{self.spec.t_max}")
        first = self._first_token(slot, explicit, seed_i, logits0)
        d = self.spec.d_model
        layers = small_state["layers"]
        tc = layers[0]["cross_k"].shape[1]
        if self.stacked is not None:
            st = self.state
            for l, ls in enumerate(layers):
                st["k"][l, slot] = ls["self_k"][0].reshape(-1, d)
                st["v"][l, slot] = ls["self_v"][0].reshape(-1, d)
                st["ck"][l, slot, :tc] = ls["cross_k"][0].reshape(tc, d)
                st["cv"][l, slot, :tc] = ls["cross_v"][0].reshape(tc, d)
        else:
            for big, sm in zip(self.state["layers"], layers):
                for key, t in sm.items():
                    big[key][slot, : t.shape[1]] = t[0]
        self.tc_valid[slot] = tc_valid
        self._start(slot, first, p_len)
        return slot
