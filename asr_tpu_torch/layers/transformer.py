"""Pre-LN transformer blocks (Whisper-style) with fixed-shape KV caches.

Counterpart of ``asr_tpu/layers/transformer.py``: ``dense``, the encoder
block (self-attention + exact-GELU MLP) and the decoder block (causal
self-attention over a preallocated KV cache + cross-attention over
precomputed encoder K/V + exact-GELU MLP). Caches are fixed
``(B, T_max, H, Dh)`` buffers; where JAX returns an updated copy, the port
writes the fresh rows into the given cache in place at ``pos`` and returns
the same tensors.

Under a tensor-parallel mesh (``parallel/mesh.py``) the same functions run
on each rank's local tree: ``dense`` honours a sharded weight's
``tp_role`` and the blocks take their head counts from the local widths
(whole heads per rank), so the caches hold the rank's heads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from asr_tpu_torch.layers.attention import NEG_INF, mha
from asr_tpu_torch.layers.norms import layer_norm
from asr_tpu_torch.ops.quant_matmul import quant_dense
from asr_tpu_torch.parallel import mesh
from asr_tpu_torch.quant.quantize import QuantizedLinear, dynamic_quant_dense


def dense(x: torch.Tensor, p: dict) -> torch.Tensor:
    """``x @ w (+ b)``; a QuantizedLinear ``w`` goes through :func:`quant_dense`
    (the int8 kernel on CUDA), a dynamic one through
    :func:`dynamic_quant_dense`. Weights are ``(in, out)``.

    On a tensor-parallel rank: a row shard (``tp_role`` "row") sums the
    ranks' partial products before its bias; a gathered head ("gather")
    concatenates the ranks' outputs after it; a whole weight given the
    local columns of its input gathers them first."""
    w = p["w"]
    role = getattr(w, "tp_role", None)
    if isinstance(w, QuantizedLinear):
        k = w.scale.shape[0] * w.block
    else:
        k = w.shape[0]
    if role is None and x.shape[-1] != k and mesh.current_group() is not None:
        x = mesh.all_gather(x)
    if not isinstance(w, QuantizedLinear):
        y = x @ w
    elif w.dynamic:
        y = dynamic_quant_dense(x, w)
    else:
        y = quant_dense(x, w)
    if role == "row":
        y = mesh.all_reduce(y)
    if p.get("b") is not None:
        y = y + p["b"]
    if role == "gather":
        y = mesh.all_gather(y)
    return y


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads)


def _heads(x: torch.Tensor, head_dim: int) -> torch.Tensor:
    """(B, T, H * head_dim) -> (B, T, H, head_dim), the head count taken
    from the width: a tensor-parallel rank's local columns give its heads."""
    return split_heads(x, x.shape[-1] // head_dim)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, t, h, d = x.shape
    return x.reshape(b, t, h * d)


def encoder_block(x: torch.Tensor, p: dict, num_heads: int, attn_bias=None) -> torch.Tensor:
    """Pre-LN self-attention block: x + attn(ln1(x)) then x + mlp(ln2(x))."""
    hd = x.shape[-1] // num_heads
    y = layer_norm(x, p["ln1"]["scale"], p["ln1"]["bias"])
    q = _heads(dense(y, p["attn"]["q"]), hd)
    k = _heads(dense(y, p["attn"]["k"]), hd)
    v = _heads(dense(y, p["attn"]["v"]), hd)
    x = x + dense(merge_heads(mha(q, k, v, bias=attn_bias)), p["attn"]["o"])
    y = layer_norm(x, p["ln2"]["scale"], p["ln2"]["bias"])
    h = F.gelu(dense(y, p["mlp"]["fc1"]), approximate="none")
    return x + dense(h, p["mlp"]["fc2"])


def cross_kv(enc: torch.Tensor, p: dict, num_heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-layer cross-attention K/V from the encoder output, once per utterance."""
    hd = enc.shape[-1] // num_heads
    k = _heads(dense(enc, p["cross"]["k"]), hd)
    v = _heads(dense(enc, p["cross"]["v"]), hd)
    return k, v


def decoder_block(
    x: torch.Tensor,
    p: dict,
    num_heads: int,
    self_k_cache: torch.Tensor,
    self_v_cache: torch.Tensor,
    pos: int,
    cross_k: torch.Tensor,
    cross_v: torch.Tensor,
    cross_bias=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decoder block over ``x`` (B, S, D) whose first row sits at ``pos``.

    The fresh k/v rows are written into ``self_k_cache``/``self_v_cache``
    (B, T_max, H, Dh) in place at ``[pos, pos + S)``; query i attends cache
    slots ``<= pos + i``. Returns (out, self_k_cache, self_v_cache)."""
    s = x.shape[1]
    t_max = self_k_cache.shape[1]
    hd = x.shape[-1] // num_heads
    y = layer_norm(x, p["ln1"]["scale"], p["ln1"]["bias"])
    q = _heads(dense(y, p["attn"]["q"]), hd)
    k = _heads(dense(y, p["attn"]["k"]), hd)
    v = _heads(dense(y, p["attn"]["v"]), hd)
    self_k_cache[:, pos : pos + s] = k.to(self_k_cache.dtype)
    self_v_cache[:, pos : pos + s] = v.to(self_v_cache.dtype)
    slot = torch.arange(t_max, device=x.device)[None, :]
    qpos = pos + torch.arange(s, device=x.device)[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    causal = torch.where(slot <= qpos, zero, NEG_INF)[None, None]
    attn = mha(q, self_k_cache, self_v_cache, bias=causal)
    x = x + dense(merge_heads(attn), p["attn"]["o"])

    y = layer_norm(x, p["ln_cross"]["scale"], p["ln_cross"]["bias"])
    qc = _heads(dense(y, p["cross"]["q"]), hd)
    xc = mha(qc, cross_k, cross_v, bias=cross_bias)
    x = x + dense(merge_heads(xc), p["cross"]["o"])

    y = layer_norm(x, p["ln2"]["scale"], p["ln2"]["bias"])
    h = F.gelu(dense(y, p["mlp"]["fc1"]), approximate="none")
    return x + dense(h, p["mlp"]["fc2"]), self_k_cache, self_v_cache
