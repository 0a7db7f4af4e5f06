"""Weight-only int8 quantization (block-wise affine) for serving.

Counterpart of ``asr_tpu/quant/quantize.py``: round-to-nearest range fit
plus the optional least-squares refinement of scale and zero point, and the
same storage. A ``(K, N)`` weight is cut into blocks of ``block`` rows along
K; each (block, column) pair has one f32 scale and zero point, and
``w ~ (q - zero) * scale``. Unpacked storage is CENTERED: ``q - 128`` as
int8 and ``zero - 128`` as f32, exactly as the JAX package writes it, so
artifact folders move between the two packages unchanged. When
``K % block != 0`` the block becomes K (one block per column).

Packed 4-bit storage (``quantize_linear(bits=4, pack=True)``) keeps raw
unsigned nibbles in a ``(K/2, N)`` int8 array: the low nibble holds rows
``[0, K/2)`` and the high nibble rows ``[K/2, K)`` (two contiguous halves,
not interleaved), with an UNSIGNED zero point; it runs through the int4
kernel. Packed 2-bit storage (``quantize_linear(bits=2, pack=True)``) keeps
raw unsigned values in a ``(K/4, N)`` int8 array: bit pair ``2j:2j+2`` holds
rows ``[jK/4, (j+1)K/4)`` (four contiguous quarters), again with an UNSIGNED
zero point; it runs through the int2 kernel. Either packing applies only
where each half (quarter) stays a whole number of blocks; elsewhere the
weight stays unpacked, centered int8 at any bit width, as in the JAX
package.

``QuantizedEmbedding`` is the gather-dequant table; its ``(D, V_pad)``
tied-head copy runs the LM head through the quantized kernels
(:func:`embedding_logits`): centered int8 with V padded to a 512 multiple
(every width but 4, 2-bit tables included), or, for 4-bit tables,
nibble-packed to ``(D/2, V_pad)`` with V padded to a 2048 multiple.

Block fits (``objective``): ``rtn`` (the range fit), ``kquant`` (a grid
search of 16 scale factors around the range fit, scored by x^2-weighted
error, the first minimum winning) and ``hqq`` (half-quadratic Lp
optimization of the zero points, 20 steps; the least-squares refine is
skipped for it). ``dynamic`` is dynamic-activation int8: 8-bit per-column
weights (block = K) whose product runs as an exact int8 x int8 -> int32
matmul on activations quantized per row at call time
(:func:`dynamic_quant_dense`). :func:`cast_pytree` is the serving cast of
plain trees.
"""

from __future__ import annotations

from typing import Callable

import torch


# The kquant grid, ``jnp.linspace(0.6, 1.2, 16)`` in f32 (torch.linspace and
# numpy round some of these values apart).
KQUANT_FACTORS = (0.6, 0.64000005, 0.68000007, 0.72, 0.76000005, 0.8, 0.84000003, 0.88000005,
                  0.9200001, 0.96000004, 1.0, 1.0400001, 1.08, 1.12, 1.1600001, 1.2)


# The fits' multiply-adds, block sums and means go through these three, so
# that a test can run the fits in another rounding order.
def _mul_add(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """``a * b + c``, each step rounded to f32."""
    return a * b + c


def _block_sum(x: torch.Tensor, y: torch.Tensor | None = None) -> torch.Tensor:
    """Sum of ``x`` (or of ``x * y``) over B of (NB, B, N) -> (NB, 1, N)."""
    return (x if y is None else x * y).sum(dim=1, keepdim=True)


def _block_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean of ``x`` over B of (NB, B, N) -> (NB, 1, N)."""
    return x.mean(dim=1, keepdim=True)


def _fit_rtn(blocks: torch.Tensor, qmax: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Range fit per block. blocks (NB, B, N) -> scale, zero (NB, 1, N)."""
    wmin = blocks.amin(dim=1, keepdim=True)
    wmax = blocks.amax(dim=1, keepdim=True)
    # XLA folds the division by the constant qmax into a multiply by its f32
    # reciprocal; doing the same keeps q bit-identical to the JAX package.
    scale = (wmax - wmin) * torch.tensor(1.0 / qmax, dtype=torch.float32, device=blocks.device)
    scale = torch.where(scale <= 1e-12, torch.ones_like(scale), scale)
    return scale, torch.round(-wmin / scale)


def _fit_kquant(blocks: torch.Tensor, qmax: int) -> tuple[torch.Tensor, torch.Tensor]:
    """k-quant fit: each of :data:`KQUANT_FACTORS` scales the range-fit
    scale, the zero point anchors at the block minimum, and the candidate
    with the least x^2-weighted squared error wins (the first on a tie, as
    an argmin over the 16 picks)."""
    weights = _mul_add(blocks, blocks, 1e-12)
    scale0, _ = _fit_rtn(blocks, qmax)
    wmin = blocks.amin(dim=1, keepdim=True)
    best = None
    for factor in KQUANT_FACTORS:
        scale = scale0 * factor
        zero = torch.clamp(torch.round(-wmin / scale), 0, qmax)
        q = torch.clamp(torch.round(blocks / scale + zero), 0, qmax)
        d = _mul_add(zero - q, scale, blocks)
        err = _block_sum(weights, d * d)
        if best is None:
            best = [err, scale, zero]
            continue
        better = err < best[0]  # strict: an equal error keeps the earlier factor
        best = [torch.where(better, new, old) for new, old in zip((err, scale, zero), best)]
    return best[1], best[2]


def _fit_hqq(blocks: torch.Tensor, qmax: int, iters: int = 20, lp_norm: float = 0.7,
             beta0: float = 10.0, kappa: float = 1.01) -> tuple[torch.Tensor, torch.Tensor]:
    """Half-quadratic zero-point fit: with the range-fit scale fixed, each
    step shrinks the residual by the generalized soft threshold of the
    Lp (p < 1) norm and re-fits the zero points in closed form. ``beta``
    grows by ``kappa`` a step as an f32 value, as the JAX package carries it."""
    scale, zero = _fit_rtn(blocks, qmax)
    beta = torch.tensor(beta0, dtype=torch.float32, device=blocks.device)
    for _ in range(iters):
        q = torch.clamp(torch.round(blocks / scale + zero), 0, qmax)
        err = _mul_add(zero - q, scale, blocks)
        mag = err.abs()
        e = torch.sign(err) * torch.relu(mag - (mag + 1e-8) ** (lp_norm - 1.0) / beta)
        zero = _block_mean(q - (blocks - e) / scale)
        beta = beta * kappa
    return scale, torch.clamp(torch.round(zero), 0, qmax)


def quantize_weight(w: torch.Tensor, bits: int = 8, block: int = 128, refine_iters: int = 0,
                    objective: str = "rtn"):
    """Quantize a (K, N) weight block-wise along K with the ``objective``
    fit (``rtn``, ``kquant`` or ``hqq``; any other name is the range fit,
    as in the JAX package).

    Returns (q int8 (K, N) centered, scale (NB, N), zero (NB, N) centered)."""
    k, n = w.shape
    if k % block:
        raise ValueError(f"K={k} is not a multiple of block={block}")
    qmax = (1 << bits) - 1
    blocks = w.reshape(k // block, block, n).to(torch.float32)
    fit = {"kquant": _fit_kquant, "hqq": _fit_hqq}.get(objective, _fit_rtn)
    scale, zero = fit(blocks, qmax)
    if objective == "hqq":
        refine_iters = 0  # the least-squares refine would discard the Lp-fitted zero points

    def quant(scale, zero):
        return torch.clamp(torch.round(blocks / scale + zero), 0, qmax)

    for _ in range(refine_iters):
        # Least-squares re-fit of the scale on (q - zero) vs w, then of the zero.
        centered = quant(scale, zero) - zero
        num = _block_sum(centered, blocks)
        den = _block_sum(centered, centered)
        scale = torch.where(den > 1e-12, num / torch.clamp(den, min=1e-12), scale)
        scale = torch.where(scale.abs() <= 1e-12, torch.ones_like(scale), scale)
        zero_f = _block_mean(quant(scale, zero) - blocks / scale)
        zero = torch.clamp(torch.round(zero_f), 0, qmax)
    q = (quant(scale, zero) - 128.0).to(torch.int8).reshape(k, n)
    return q, scale[:, 0, :], zero[:, 0, :] - 128.0


class QuantizedLinear:
    """Block-quantized linear weight with the JAX package's fields.

    Dict-style access (``leaf["q"]``) mirrors the JAX class. The port
    computes with unpacked static leaves of any width, packed 4-bit and
    2-bit leaves, and ``dynamic`` leaves (8-bit, block = K), whose product
    is :func:`dynamic_quant_dense`."""

    FIELDS = ("q", "scale", "zero", "bits", "block", "packed", "dynamic")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                 bits: int, block: int, packed: bool = False, dynamic: bool = False):
        self.q = q
        self.scale = scale
        self.zero = zero
        self.bits = int(bits)
        self.block = int(block)
        self.packed = bool(packed)
        self.dynamic = bool(dynamic)

    def __getitem__(self, key):
        return getattr(self, key)

    def int_mm_operand(self) -> torch.Tensor:
        """A dynamic leaf's weight as the card's int8 product takes it: q
        padded with zeros to multiples of 8 in K and N and laid out
        column-major, (K_pad, N_pad). Made on the first product and kept
        with the leaf while ``q`` stays the same tensor."""
        cached = getattr(self, "_int_mm", None)
        if cached is None or cached[0] is not self.q:
            k, n = self.q.shape
            b = torch.zeros((-(-n // 8) * 8, -(-k // 8) * 8), dtype=torch.int8, device=self.q.device)
            b[:n, :k] = self.q.t()
            self._int_mm = cached = (self.q, b.t())
        return cached[1]

    def __contains__(self, key):
        return key in self.FIELDS


def pack4_halves(q_unsigned: torch.Tensor) -> torch.Tensor:
    """(K, N) values in [0, 16) -> (K/2, N) int8: low nibble = rows [0, K/2),
    high nibble = rows [K/2, K)."""
    k = q_unsigned.shape[0]
    lo = q_unsigned[: k // 2].to(torch.uint8)
    hi = q_unsigned[k // 2 :].to(torch.uint8)
    return (lo | (hi << 4)).view(torch.int8)


def unpack4_halves(packed: torch.Tensor) -> torch.Tensor:
    """(K/2, N) int8 -> (K, N) float32 unsigned nibble values."""
    u = packed.contiguous().view(torch.uint8)
    return torch.cat([(u & 0xF), (u >> 4) & 0xF], dim=0).to(torch.float32)


def pack2_quarters(q_unsigned: torch.Tensor) -> torch.Tensor:
    """(K, N) values in [0, 4) -> (K/4, N) int8: bit pair ``2j:2j+2`` holds
    rows ``[jK/4, (j+1)K/4)``."""
    k4 = q_unsigned.shape[0] // 4
    out = q_unsigned[:k4].to(torch.uint8)
    for j in (1, 2, 3):
        out = out | (q_unsigned[j * k4 : (j + 1) * k4].to(torch.uint8) << (2 * j))
    return out.view(torch.int8)


def unpack2_quarters(packed: torch.Tensor) -> torch.Tensor:
    """(K/4, N) int8 -> (K, N) float32 unsigned 2-bit values."""
    u = packed.contiguous().view(torch.uint8)
    return torch.cat([(u >> (2 * j)) & 0x3 for j in range(4)], dim=0).to(torch.float32)


def dequantize_weight(qleaf) -> torch.Tensor:
    """Quantized leaf (or equivalent dict) -> dense f32 (K, N) weight.

    Unpacked storage is centered (q - 128, zero - 128); packed 4-bit and
    2-bit storage keeps raw unsigned values with an unsigned zero. All give
    ``w = (q - zero) * scale`` per block."""
    if "packed" in qleaf and bool(qleaf["packed"]):
        q = unpack2_quarters(qleaf["q"]) if int(qleaf["bits"]) == 2 else unpack4_halves(qleaf["q"])
    else:
        q = qleaf["q"].to(torch.float32)
    k, n = q.shape
    block = int(qleaf["block"])
    blocks = q.reshape(k // block, block, n)
    w = (blocks - qleaf["zero"][:, None, :]) * qleaf["scale"][:, None, :]
    return w.reshape(k, n)


def quantize_linear(w: torch.Tensor, bits: int = 8, block: int = 128,
                    refine_iters: int = 0, pack: bool = False,
                    objective: str = "rtn") -> QuantizedLinear:
    """(K, N) weight -> QuantizedLinear; the block becomes K when it does not
    divide K. ``pack`` packs 4-bit weights whose halves, and 2-bit weights
    whose quarters, stay block-aligned (raw unsigned values, unsigned zero);
    any other weight stays unpacked. ``objective="dynamic"`` ignores
    ``bits``, ``block`` and ``pack``: an rtn fit at 8 bits with one block
    per column, marked ``dynamic``."""
    k = w.shape[0]
    if objective == "dynamic":
        q, scale, zero = quantize_weight(w, 8, k, refine_iters, objective="rtn")
        return QuantizedLinear(q, scale, zero, 8, k, dynamic=True)
    if k % block:
        block = k
    q, scale, zero = quantize_weight(w, bits, block, refine_iters, objective=objective)
    for width, parts, packer in ((4, 2, pack4_halves), (2, 4, pack2_quarters)):
        if pack and bits == width and k % parts == 0 and (k // parts) % block == 0:
            q_unsigned = (q.to(torch.int32) + 128).to(torch.uint8)
            return QuantizedLinear(packer(q_unsigned), scale, zero + 128.0, bits, block,
                                   packed=True)
    return QuantizedLinear(q, scale, zero, bits, block)


def _int8_matmul(xq: torch.Tensor, qleaf) -> torch.Tensor:
    """Exact (M, K) int8 rows times a dynamic leaf's (K, N) int8 weight, as
    int32. On the CPU an f64 matmul, exact for any K below 2^53 / 127^2; on
    the card ``torch._int_mm`` on the leaf's padded column-major operand
    (:meth:`QuantizedLinear.int_mm_operand`), with the rows padded to 17
    and K by zeros (its limits), which add nothing to the sums."""
    if xq.device.type == "cpu":
        return (xq.to(torch.float64) @ qleaf["q"].to(torch.float64)).to(torch.int32)
    b = qleaf.int_mm_operand()
    m, k = xq.shape
    mp, kp = max(m, 17), b.shape[0]
    a = torch.nn.functional.pad(xq, (0, kp - k, 0, mp - m)) if (mp, kp) != (m, k) else xq
    return torch._int_mm(a.contiguous(), b)[:m, : qleaf["q"].shape[1]]


def dynamic_quant_dense(x: torch.Tensor, qleaf) -> torch.Tensor:
    """Dynamic-activation int8 matmul: each row of ``x`` quantizes
    symmetrically to int8 by its absmax at call time, the product runs
    int8 x int8 -> int32 exactly (:func:`_int8_matmul`), and the result
    rescales by row scale x column scale: ``(acc - rowsum(xq) * zero) * sx
    * scale`` in f32, in the JAX package's order. (..., K) -> (..., N)."""
    orig = x.shape
    x2 = x.reshape(-1, orig[-1]).to(torch.float32)
    absmax = x2.abs().amax(dim=1, keepdim=True)
    # / 127 as a multiply by the f32 reciprocal, as XLA folds a constant divisor
    sx = torch.where(absmax > 0, absmax * (1.0 / 127.0), torch.ones_like(absmax))
    xq = torch.clamp(torch.round(x2 / sx), -127, 127).to(torch.int8)
    acc = _int8_matmul(xq, qleaf).to(torch.float32)
    row_sum = xq.to(torch.int32).sum(dim=1, keepdim=True).to(torch.float32)
    y = (acc - row_sum * qleaf["zero"]) * sx * qleaf["scale"]
    return y.reshape(*orig[:-1], qleaf["q"].shape[1]).to(x.dtype)


class QuantizedEmbedding:
    """Row-gatherable block-quantized embedding table with the JAX package's
    fields: ``q`` (V, D) int8 centered, ``scale``/``zero`` (V, D // block),
    quantized along D in ``block``-wide groups per row. ``emb[ids]`` gathers
    and dequantizes only the touched rows. ``q_t``/``scale_t``/``zero_t`` are
    the optional tied-head copy in QuantizedLinear orientation, ``(D, V_pad)``
    with V zero-padded to a multiple of 512 (zero scale: pad logits are 0)."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                 bits: int, block: int, q_t: torch.Tensor | None = None,
                 scale_t: torch.Tensor | None = None, zero_t: torch.Tensor | None = None,
                 q_t_packed: bool = False):
        self.q = q
        self.scale = scale
        self.zero = zero
        self.bits = int(bits)
        self.block = int(block)
        self.q_t = q_t
        self.scale_t = scale_t
        self.zero_t = zero_t
        self.q_t_packed = bool(q_t_packed)

    def __getitem__(self, ids) -> torch.Tensor:
        ids = torch.as_tensor(ids, device=self.q.device)
        rows = self.q[ids].to(torch.float32)
        s, z = self.scale[ids], self.zero[ids]
        nb = self.scale.shape[1]
        rows = rows.reshape(*rows.shape[:-1], nb, self.q.shape[1] // nb)
        return ((rows - z[..., None]) * s[..., None]).reshape(*ids.shape, self.q.shape[1])

    def dequant(self) -> torch.Tensor:
        v, d = self.q.shape
        nb = self.scale.shape[1]
        rows = self.q.to(torch.float32).reshape(v, nb, d // nb)
        return ((rows - self.zero[..., None]) * self.scale[..., None]).reshape(v, d)

    @property
    def dtype(self) -> torch.dtype:
        return self.scale.dtype

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.q.shape)


def embedding_logits(embed, y: torch.Tensor) -> torch.Tensor:
    """Tied-head logits ``y @ embed.T`` for plain or quantized tables. A
    quantized table with its tied copy goes through ``quant_dense`` (the
    int8 kernel for a centered copy of any width, or the int4 kernel for a
    nibble-packed copy, on CUDA), reading the quantized bytes only."""
    if isinstance(embed, QuantizedEmbedding):
        if embed.q_t is not None:
            from asr_tpu_torch.ops.quant_matmul import quant_dense

            leaf = {"q": embed.q_t, "scale": embed.scale_t, "zero": embed.zero_t,
                    "bits": embed.bits, "block": embed.block, "packed": embed.q_t_packed}
            return quant_dense(y, leaf)[..., : embed.q.shape[0]]
        # logits_v = sum_b s[v,b] (y_b . q[v,b]) - sum_b s[v,b] z[v,b] sum(y_b)
        v, d = embed.q.shape
        nb = embed.scale.shape[1]
        yb = y.to(torch.float32).reshape(*y.shape[:-1], nb, d // nb)
        qb = embed.q.to(torch.float32).reshape(v, nb, d // nb)
        part = torch.einsum("...nk,vnk->...nv", yb, qb)
        logits = torch.einsum("...nv,vn->...v", part, embed.scale)
        logits = logits - torch.einsum("...n,vn->...v", yb.sum(-1), embed.scale * embed.zero)
        return logits.to(y.dtype)
    return y @ embed.T


def tied_head_arrays(q_t: torch.Tensor, scale_t: torch.Tensor, zero_t: torch.Tensor,
                     bits: int = 8, block: int | None = None):
    """Pad the (D, V) tied-head copy's V axis with zero scale and zero point,
    so pad logits are exactly 0 (callers slice [:V]).

    4-bit tables whose halves stay block-aligned are nibble-packed to
    ``(D/2, V_pad)`` with an unsigned zero and V padded to a multiple of
    2048; every other table stays centered int8 with V padded to a multiple
    of 512 (the JAX package's layout, so pad widths match).

    Returns (q_t, scale_t, zero_t, packed)."""
    d, v = q_t.shape
    pack = bits == 4 and block is not None and d % 2 == 0 and (d // 2) % block == 0
    pad = (-v) % (2048 if pack else 512)
    if pad:
        q_t = torch.nn.functional.pad(q_t, (0, pad))
        scale_t = torch.nn.functional.pad(scale_t, (0, pad))
        zero_t = torch.nn.functional.pad(zero_t, (0, pad))
    if pack:
        q_t = pack4_halves((q_t.to(torch.int32) + 128).to(torch.uint8))
        zero_t = zero_t + 128.0
    return q_t.contiguous(), scale_t.contiguous(), zero_t.contiguous(), pack


def quantize_embedding(w: torch.Tensor, bits: int = 8, block: int = 128, objective: str = "rtn",
                       tie_head: bool = True) -> QuantizedEmbedding:
    """(V, D) table -> per-row block quantization along D with the
    ``objective`` fit, plus the (D, V_pad) tied-head copy when ``tie_head``."""
    v, d = w.shape
    if d % block:
        block = d
    q, scale, zero = quantize_weight(w.T, bits, block, 0, objective=objective)  # blocks along D
    q_t = scale_t = zero_t = None
    packed = False
    if tie_head:
        q_t, scale_t, zero_t, packed = tied_head_arrays(q, scale, zero, bits=bits, block=block)
    return QuantizedEmbedding(q.T.contiguous(), scale.T.contiguous(), zero.T.contiguous(),
                              bits, block, q_t=q_t, scale_t=scale_t, zero_t=zero_t,
                              q_t_packed=packed)


def is_quantized(leaf) -> bool:
    if isinstance(leaf, QuantizedLinear):
        return True
    return isinstance(leaf, dict) and "q" in leaf and "scale" in leaf and "bits" in leaf


def quantize_pytree(
    params,
    bits: int = 8,
    block: int = 128,
    refine_iters: int = 2,
    min_size: int = 1 << 16,
    predicate: Callable[[str, torch.Tensor], bool] | None = None,
    pack: bool = False,
    objective: str = "rtn",
    quantize_embeddings: bool = False,
):
    """Quantize every 2-D ``w``/``w1``/``w2`` linear weight of at least
    ``min_size`` elements, with the JAX package's defaults and walk;
    ``pack`` packs 4-bit and 2-bit linears and ``objective`` picks the fit
    (:func:`quantize_linear`); ``quantize_embeddings`` also turns ``embed``
    tables of that size into :class:`QuantizedEmbedding` leaves (4-bit
    tables carry the nibble-packed tied head, every other width a centered
    one; under ``dynamic`` the tables take an rtn fit at ``max(bits, 8)``
    bits, as gathers have no activation to quantize)."""
    # 2-D kernels under these parents are consumed elementwise, not by dense().
    non_matmul_parents = ("dw", "dw1", "dw2", "conv", "fusion")

    def walk(node, path):
        parent = path.rsplit("/", 1)[-1]
        if isinstance(node, dict):
            out = {}
            for key, value in node.items():
                p = f"{path}/{key}"
                if (
                    key in ("w", "w1", "w2")
                    and parent not in non_matmul_parents
                    and isinstance(value, torch.Tensor)
                    and value.ndim == 2
                    and value.numel() >= min_size
                    and (predicate is None or predicate(p, value))
                ):
                    out[key] = quantize_linear(value, bits, block, refine_iters, pack=pack,
                                               objective=objective)
                elif (
                    quantize_embeddings
                    and key == "embed"
                    and isinstance(value, torch.Tensor)
                    and value.ndim == 2
                    and value.numel() >= min_size
                ):
                    dyn = objective == "dynamic"
                    out[key] = quantize_embedding(value, max(bits, 8) if dyn else bits, block,
                                                  objective="rtn" if dyn else objective)
                else:
                    out[key] = walk(value, p)
            return out
        if isinstance(node, (list, tuple)):
            walked = [walk(v, f"{path}/{i}") for i, v in enumerate(node)]
            return type(node)(walked) if isinstance(node, tuple) else walked
        return node

    return walk(params, "")


def quantization_error(w: torch.Tensor, qleaf) -> float:
    """Relative Frobenius error of the quantized representation."""
    w = w.to(torch.float32)
    deq = dequantize_weight(qleaf).to(w.device)
    return float(torch.linalg.norm(w - deq) / torch.clamp(torch.linalg.norm(w), min=1e-9))


def dequantize_pytree(params):
    """Every QuantizedLinear / QuantizedEmbedding leaf -> its dense f32
    weight (the plain-matmul twin)."""
    if isinstance(params, QuantizedLinear):
        return dequantize_weight(params)
    if isinstance(params, QuantizedEmbedding):
        return params.dequant()
    if isinstance(params, dict):
        return {k: dequantize_pytree(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(dequantize_pytree(v) for v in params)
    return params


def cast_pytree(params, dtype):
    """Serving cast (``--dtype``): every floating tensor of a plain parameter
    tree to ``dtype`` (a ``torch.dtype`` or its name, e.g. ``"bfloat16"``).
    Quantized leaves stay as they are: the kernels take their f32 scales and
    zero points (the JAX package casts those too)."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if isinstance(params, torch.Tensor):
        return params.to(dtype) if params.is_floating_point() else params
    if isinstance(params, dict):
        return {k: cast_pytree(v, dtype) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(cast_pytree(v, dtype) for v in params)
    return params
