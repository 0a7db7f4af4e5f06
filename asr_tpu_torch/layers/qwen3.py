"""Qwen3-style decoder stack: RMSNorm + GQA (per-head q/k RMSNorm) + RoPE +
gated-SiLU MLP, with fixed-shape KV caches.

Counterpart of ``asr_tpu/layers/qwen3.py`` for the LLM-decoder ASR
families. It works on input embeddings (the ASR families feed mixed
audio/text embeds) with additive f32 attention biases built from lengths
and shifts (0 keep, the finite ``NEG_INF`` drop). Where JAX returns updated
caches, the port writes the fresh rows into the given ``(B, T_max, Hkv,
D)`` caches in place at ``pos`` and returns the same tensors. Linear
weights are ``(in, out)`` and may be ``QuantizedLinear`` leaves (unpacked
through the int8 kernel, packed int4 and packed int2 through their own
kernels); the tied ``embed`` may be a ``QuantizedEmbedding``.

On a tensor-parallel rank (``parallel/mesh.py``) a layer runs on the rank's
q and kv heads and its share of the FFN, taken from the local widths; the
caches :func:`make_kv_state` makes hold the rank's kv heads, and the tied
head stays whole on every rank (an untied ``lm_head`` is gathered).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from asr_tpu_torch.layers.attention import NEG_INF
from asr_tpu_torch.layers.norms import rms_norm
from asr_tpu_torch.layers.rope import apply_rope, rope_tables
from asr_tpu_torch.layers.transformer import dense
from asr_tpu_torch.parallel import mesh
from asr_tpu_torch.quant.quantize import QuantizedEmbedding, QuantizedLinear, embedding_logits


@dataclasses.dataclass(frozen=True)
class Qwen3Config:
    vocab_size: int = 151936
    hidden: int = 1024
    num_layers: int = 28
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 128
    ffn_dim: int = 3072
    rms_eps: float = 1e-6
    rope_theta: float = 5_000_000.0
    max_seq_len: int = 2048
    attention_bias: bool = False
    qk_norm: bool = True
    tie_embeddings: bool = True


def init_params(cfg: Qwen3Config, generator: torch.Generator, device=None,
                dtype: torch.dtype = torch.float32) -> dict:
    """Random-init parameters with the JAX package's layout and scales, drawn
    from ``generator`` on its own device and placed on ``device``."""
    device = torch.device(device) if device is not None else generator.device
    h = cfg.hidden

    def normal(*shape, std):
        t = torch.randn(shape, generator=generator, device=generator.device) * std
        return t.to(device=device, dtype=dtype)

    def ones(n):
        return torch.ones((n,), device=device, dtype=dtype)

    def lin(i, o, bias=False):
        p = {"w": normal(i, o, std=i ** -0.5)}
        if bias:
            p["b"] = torch.zeros((o,), device=device, dtype=dtype)
        return p

    def layer():
        p = {
            "input_norm": {"scale": ones(h)},
            "attn": {
                "q": lin(h, cfg.num_heads * cfg.head_dim, cfg.attention_bias),
                "k": lin(h, cfg.num_kv_heads * cfg.head_dim, cfg.attention_bias),
                "v": lin(h, cfg.num_kv_heads * cfg.head_dim, cfg.attention_bias),
                "o": lin(cfg.num_heads * cfg.head_dim, h),
            },
            "post_norm": {"scale": ones(h)},
            "mlp": {"gate": lin(h, cfg.ffn_dim), "up": lin(h, cfg.ffn_dim),
                    "down": lin(cfg.ffn_dim, h)},
        }
        if cfg.qk_norm:
            p["attn"]["q_norm"] = {"scale": ones(cfg.head_dim)}
            p["attn"]["k_norm"] = {"scale": ones(cfg.head_dim)}
        return p

    return {
        "embed": normal(cfg.vocab_size, h, std=0.02),
        "layers": [layer() for _ in range(cfg.num_layers)],
        "final_norm": {"scale": ones(h)},
        **({} if cfg.tie_embeddings else {"lm_head": lin(h, cfg.vocab_size)}),
    }


def make_kv_state(cfg: Qwen3Config, batch: int, t_max: int, dtype=torch.float32,
                  device=None) -> dict:
    """Zeroed per-layer caches (B, T_max, Hkv, D); on a tensor-parallel rank
    Hkv is the rank's share of the kv heads."""
    shape = (batch, t_max, cfg.num_kv_heads // mesh.model_size(), cfg.head_dim)
    return {"layers": tuple(
        {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device)}
        for _ in range(cfg.num_layers))}


def _attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               bias: torch.Tensor, num_kv_groups: int) -> torch.Tensor:
    """GQA over the full cache with additive bias (B, 1, S, T_max)."""
    b, s, hq, d = q.shape
    hkv = k_cache.shape[2]
    qg = q.reshape(b, s, hkv, num_kv_groups, d)
    k, v = k_cache.to(q.dtype), v_cache.to(q.dtype)
    scores = torch.einsum("bshgd,bthd->bhgst", qg, k).to(torch.float32) * (d ** -0.5)
    scores = scores + (bias[:, :, None] if bias.ndim == 4 else bias)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v)
    return out.reshape(b, s, hq * d)


def _rope_rows(cfg: Qwen3Config, t_max: int, pos: int, s: int, pos_offset, device):
    cs = torch.from_numpy(rope_tables(t_max, cfg.head_dim, cfg.rope_theta)).to(device)
    if pos_offset is None:
        return cs[0, pos : pos + s], cs[1, pos : pos + s]
    offset = torch.as_tensor(pos_offset, device=device).to(torch.int64)
    logical = pos + torch.arange(s, device=device)[None, :] - offset[:, None]
    logical = logical.clamp(0, t_max - 1)  # (B, S)
    return cs[0][logical], cs[1][logical]


def _layer(p: dict, cfg: Qwen3Config, x: torch.Tensor, ls: dict, cos: torch.Tensor,
           sin: torch.Tensor, bias: torch.Tensor, write) -> torch.Tensor:
    """One decoder layer on x (B, S, H): ``write(cache, rows)`` puts the
    fresh k or v rows (B, S, Hkv, D) into the layer's cache before the
    attention reads it."""
    b, s, hd = x.shape[0], x.shape[1], cfg.head_dim
    y = rms_norm(x, p["input_norm"]["scale"], cfg.rms_eps)
    if "qkv" in p["attn"]:
        qkv = dense(y, p["attn"]["qkv"])
        # the local width is a 1/T share of q | k | v: T from the widths
        t = (cfg.num_heads + 2 * cfg.num_kv_heads) * hd // qkv.shape[-1]
        qd, kd = cfg.num_heads // t * hd, cfg.num_kv_heads // t * hd
        q = qkv[..., :qd].reshape(b, s, qd // hd, hd)
        k = qkv[..., qd : qd + kd].reshape(b, s, kd // hd, hd)
        v = qkv[..., qd + kd :].reshape(b, s, kd // hd, hd)
    else:
        q = dense(y, p["attn"]["q"])
        k = dense(y, p["attn"]["k"])
        v = dense(y, p["attn"]["v"])
        q, k, v = (z.reshape(b, s, z.shape[-1] // hd, hd) for z in (q, k, v))
    if cfg.qk_norm:
        q = rms_norm(q, p["attn"]["q_norm"]["scale"], cfg.rms_eps)
        k = rms_norm(k, p["attn"]["k_norm"]["scale"], cfg.rms_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    write(ls["k"], k)
    write(ls["v"], v)
    attn = _attention(q, ls["k"], ls["v"], bias, cfg.num_heads // cfg.num_kv_heads)
    x = x + dense(attn, p["attn"]["o"])
    y = rms_norm(x, p["post_norm"]["scale"], cfg.rms_eps)
    if "gateup" in p["mlp"]:
        gu = dense(y, p["mlp"]["gateup"])
        f = gu.shape[-1] // 2
        h = F.silu(gu[..., :f]) * gu[..., f:]
    else:
        h = F.silu(dense(y, p["mlp"]["gate"])) * dense(y, p["mlp"]["up"])
    return x + dense(h, p["mlp"]["down"])


def decoder_pass(params: dict, cfg: Qwen3Config, x: torch.Tensor, state: dict, pos: int,
                 bias: torch.Tensor, pos_offset=None) -> tuple[torch.Tensor, dict]:
    """Run S embeddings through all layers, writing the KV caches at ``pos``.

    Args:
      x: (B, S, H) input embeddings.
      state: KV caches (B, T_max, Hkv, D) per layer, written in place.
      pos: slot of x[:, 0].
      bias: (B, 1, S, T_max) additive attention bias (causal + validity).
      pos_offset: optional (B,) per-row amount subtracted from the slot
        index to get the RoPE position (left-padded layout: the pad width;
        pad-slot phases clip to 0 and are masked by ``bias``).

    Returns (hidden (B, S, H), state).
    """
    t_max = state["layers"][0]["k"].shape[1]
    pos, s = int(pos), x.shape[1]
    cos, sin = _rope_rows(cfg, t_max, pos, s, pos_offset, x.device)

    def write(cache, rows):
        cache[:, pos : pos + s] = rows.to(cache.dtype)

    for p, ls in zip(params["layers"], state["layers"]):
        x = _layer(p, cfg, x, ls, cos, sin, bias, write)
    return x, state


def decoder_step_rowwise(params: dict, cfg: Qwen3Config, x: torch.Tensor, state: dict,
                         pos: torch.Tensor, active: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, dict]:
    """One decode token through all layers with a cache position per row
    (continuous batching: row b's prompt occupies its compact cache
    ``[0, L_b)`` and generation goes on at ``pos[b]``, so the cache slot is
    the logical position). Per row the math of :func:`decoder_pass` run
    alone; keys past ``pos[b]`` are masked (:func:`rowwise_step_bias`).

    Args:
      x: (B, 1, H) current-token embeddings.
      state: KV caches (B, T_max, Hkv, D) per layer; row ``pos[b]`` of an
        active row is written in place.
      pos: (B,) int cache slot each row writes.
      active: optional (B,) bool; inactive rows write nowhere (their hidden
        is garbage the caller discards).

    Returns (hidden (B, 1, H), state).
    """
    t_max = state["layers"][0]["k"].shape[1]
    dev = x.device
    cs = torch.from_numpy(rope_tables(t_max, cfg.head_dim, cfg.rope_theta)).to(dev)
    logical = pos.to(torch.int64).clamp(0, t_max - 1)
    cos, sin = cs[0][logical][:, None], cs[1][logical][:, None]  # (B, 1, D)
    bias = rowwise_step_bias(pos, t_max)
    bidx = torch.arange(x.shape[0], device=dev)

    def write(cache, rows):
        new = rows[:, 0].to(cache.dtype)
        if active is not None:
            new = torch.where(active[:, None, None], new, cache[bidx, logical])
        cache[bidx, logical] = new

    for p, ls in zip(params["layers"], state["layers"]):
        x = _layer(p, cfg, x, ls, cos, sin, bias, write)
    return x, state


def fuse_params(params: dict, cfg: Qwen3Config) -> dict:
    """Concatenate each layer's q/k/v -> ``qkv`` and gate/up -> ``gateup``
    along the output dimension (7 -> 4 matmuls a layer). Column
    concatenation keeps every weight, and every block-quantized value, bit
    for bit. Leaves that cannot fuse (mixed bits/block/packing, dynamic
    int8, biases on some but not all) stay split; a params tree without
    layers passes through."""
    if not isinstance(params, dict) or "layers" not in params:
        return params

    def cat(leaves):
        ws = [leaf["w"] for leaf in leaves]
        if any("b" in leaf for leaf in leaves):
            if not all("b" in leaf for leaf in leaves):
                return None
            b = torch.cat([leaf["b"] for leaf in leaves], dim=0)
        else:
            b = None
        if all(isinstance(w, torch.Tensor) for w in ws):
            out = {"w": torch.cat(ws, dim=1)}
        else:
            if not all(isinstance(w, QuantizedLinear) for w in ws):
                return None
            w0 = ws[0]
            key = (w0.bits, w0.block, w0.packed, w0.dynamic)
            if w0.dynamic or any((w.bits, w.block, w.packed, w.dynamic) != key for w in ws):
                return None
            out = {"w": QuantizedLinear(torch.cat([w.q for w in ws], dim=1),
                                        torch.cat([w.scale for w in ws], dim=1),
                                        torch.cat([w.zero for w in ws], dim=1),
                                        w0.bits, w0.block, packed=w0.packed)}
        if b is not None:
            out["b"] = b
        return out

    layers = []
    for p in params["layers"]:
        p = dict(p)
        attn = dict(p["attn"])
        if all(k in attn for k in ("q", "k", "v")):
            fused = cat([attn["q"], attn["k"], attn["v"]])
            if fused is not None:
                attn["qkv"] = fused
                del attn["q"], attn["k"], attn["v"]
        mlp = dict(p["mlp"])
        if "gate" in mlp and "up" in mlp:
            fused = cat([mlp["gate"], mlp["up"]])
            if fused is not None:
                mlp["gateup"] = fused
                del mlp["gate"], mlp["up"]
        p["attn"] = attn
        p["mlp"] = mlp
        layers.append(p)
    return {**params, "layers": layers}


def logits_from_normalized(params: dict, cfg: Qwen3Config, y: torch.Tensor) -> torch.Tensor:
    """LM-head logits for a hidden state that is already final-normalized
    (the fused decode step applies ``final_norm`` itself)."""
    if cfg.tie_embeddings:
        emb = params["embed"]
        if isinstance(emb, QuantizedEmbedding):
            return embedding_logits(emb, y)
        return y @ emb.T
    return dense(y, params["lm_head"])


def logits_from_hidden(params: dict, cfg: Qwen3Config, hidden: torch.Tensor) -> torch.Tensor:
    y = rms_norm(hidden, params["final_norm"]["scale"], cfg.rms_eps)
    return logits_from_normalized(params, cfg, y)


def _bias(keep: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=torch.float32, device=keep.device)
    return torch.where(keep, zero, NEG_INF)


def causal_prefill_bias(valid_len: torch.Tensor, s: int, t_max: int) -> torch.Tensor:
    """(B, 1, S, T_max) bias for prefill at pos 0: causal, and keys beyond
    each row's valid prompt length masked."""
    dev = valid_len.device
    qpos = torch.arange(s, device=dev)[:, None]
    kpos = torch.arange(t_max, device=dev)[None, :]
    keep = (kpos <= qpos)[None] & (kpos[None] < valid_len[:, None, None])
    return _bias(keep)[:, None]


def step_bias(valid_len: torch.Tensor, pos, t_max: int) -> torch.Tensor:
    """(B, 1, 1, T_max) bias for one token at slot ``pos``: the valid prompt
    prefix and every generated slot up to ``pos``."""
    kpos = torch.arange(t_max, device=valid_len.device)[None, :]
    vl = valid_len[:, None]
    keep = (kpos < vl) | ((kpos >= vl) & (kpos <= pos))
    return _bias(keep)[:, None, None]


def left_prefill_bias(shift: torch.Tensor, s: int, t_max: int) -> torch.Tensor:
    """(B, 1, S, T_max) prefill bias for a left-padded prompt in slots
    ``[shift_b, s)``: causal, pad keys masked, and pad query rows attend
    their own slot, so no softmax row is all masked (with a true -inf that
    row would be NaN and poison later layers' k/v)."""
    dev = shift.device
    qpos = torch.arange(s, device=dev)[:, None]
    kpos = torch.arange(t_max, device=dev)[None, :]
    keep = (kpos <= qpos)[None] & (kpos[None] >= shift[:, None, None])
    pad_self = (qpos < shift[:, None, None]) & (kpos[None] == qpos[None])
    return _bias(keep | pad_self)[:, None]


def left_step_bias(shift: torch.Tensor, pos, t_max: int) -> torch.Tensor:
    """(B, 1, 1, T_max) step bias for the left-padded layout: attends
    ``[shift_b, pos]``, masks the pad slots."""
    kpos = torch.arange(t_max, device=shift.device)[None, :]
    keep = (kpos >= shift[:, None]) & (kpos <= pos)
    return _bias(keep)[:, None, None]


def rowwise_step_bias(pos: torch.Tensor, t_max: int) -> torch.Tensor:
    """(B, 1, 1, T_max) step bias for compact per-row caches (every row's
    prompt starts at slot 0): key slot t is kept iff ``t <= pos[b]``."""
    kpos = torch.arange(t_max, device=pos.device)[None, :]
    return _bias(kpos <= pos[:, None])[:, None, None]
