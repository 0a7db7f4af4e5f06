"""One batch-1 AED decode step (all decoder layers + the q8 tied head).

Counterpart of ``asr_tpu/ops/fused_aed_step.py``. The pre-LN AED decoder
block shared by Whisper, FireRed and Dolphin (``layers/transformer
.decoder_block``): per layer LN + self q|k|v, self-attention over the cache
plus the fresh row (which is written into the cache at ``pos`` in place),
o-proj, LN + cross-q, cross-attention over the first ``tc_valid`` cross
rows, cross-o, LN + exact-GELU MLP; then the final LN and the q8 tied head.

:class:`FusedAedDecoder` is the batch-1 decode loop over it, one per
session, shared by Whisper (``models/whisper.fused_decoder``), FireRed and
Dolphin (:func:`scaled_embed_decoder`, :func:`fused_ar_decode`), which
differ only in their input row. Greedy decode keeps the loop's state in
static device buffers and replays a CUDA graph of one token (the step
through :func:`fused_aed_step_dev_cuda`, which reads the position from
the device), one stop-flag read-back a token; penalty and sampling run
``decode/ar.ar_decode`` over :func:`fused_aed_step`. ``GRAPH_REPLAYS`` and
``GRAPH_CAPTURES`` count the replayed steps and the captured graphs;
``LAUNCHES`` counts every step, a replayed one included.

:func:`fused_aed_step` runs it on a CUDA tensor through the hand-written
Hopper kernel ``asr_tpu_torch/csrc/fused_aed_step.cu`` (nvcc, ``sm_90a``,
bound with ``ctypes``) or raises; on a CPU tensor it runs the plain PyTorch
version :func:`fused_aed_step_reference`. Both round where the TPU kernel
rounds:

- every matvec input is rounded to bf16; int8 weights are exact; each
  128-row block accumulates in f32 and applies its affine as
  ``(x.q)*s - sum(x)*(z*s)``;
- attention scores are ``bf16(q * d_h**-0.5) . bf16(k)`` for cached rows;
  the fresh self row's score and its ``p * v`` are f32 from the unrounded
  q, k and v; probabilities are rounded to bf16 for ``P.V``;
- LayerNorm (eps 1e-5), softmax, biases, GELU and residuals are f32.

Stacked weights (:func:`stack_aed_step_params`) keep the JAX keys and
layout: ``wa_all`` = q|k|v|o|cq|co|fc1 column-concatenated ``(NL, D, 6D+F)``
int8, ``wb_all`` = fc2 ``(NL, F, D)``, per-128-row f32 scales ``a_s``/``b_s``
and ``a_zs``/``b_zs`` = zero*scale, absent biases as zeros, and the tied
head ``wh`` ``(D, V_pad)`` with ``h_s``/``h_zs`` ``(1, D/128, V_pad)``. The
TPU strip-width re-pad of the head is dropped: V_pad is the embedding's
512 multiple, and its pad columns (zero scale) give logits of exactly 0.
The TPU strip plan and its VMEM fit test are not needed here;
:func:`aed_plan` takes their place: each matvec's column tile and split of
K, and the attentions' row chunks, all fixed by the shapes, so a slot of
the multi-slot step (``ops/fused_aed_multi.py``, the same plan) is bitwise
the batch-1 step.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import threading
from pathlib import Path
from typing import Callable, NamedTuple

import torch

from asr_tpu_torch.decode import ar
from asr_tpu_torch.decode.strategies import NEG_INF
from asr_tpu_torch.ops import nvcc_build
from asr_tpu_torch.quant.quantize import QuantizedEmbedding, QuantizedLinear
from asr_tpu_torch.runtime.profiling import annotate

# Kernel launches since import (or since a caller reset it to 0): one per
# step, a replayed step included.
LAUNCHES = 0
GRAPH_REPLAYS = 0    # steps run by replaying FusedAedDecoder's graph of one token
GRAPH_CAPTURES = 0   # graphs FusedAedDecoder captured
MATVEC_LAUNCHES = 0  # the step's matvec launched alone (aed_matvec_cuda)

SOURCE = nvcc_build.CSRC / "fused_aed_step.cu"
NVCC_FLAGS = nvcc_build.NVCC_FLAGS
BLOCK = 128          # quantization block the kernel takes
HEAD_DIM = 64        # head width the kernel takes
EPS = 1e-5
SMS = 132            # streaming multiprocessors of an H100 SXM, which every matvec's blocks should cover
MV_WIDTHS = (128, 64, 32)  # column tiles of the matvec (32 a warp slab), widest first
MAX_ROWS = 32        # slots the matvec takes: two m16 tiles
CHUNK = 32           # values a staged chunk sum covers
ATTN_MIN_ROWS = 32   # cached rows an attention chunk takes at least
ATTN_STAGE_BYTES = 49152  # k (then v) rows, f32, an attention chunk stages in shared memory at most
# The kernel's own limits (aed_plan_limits in csrc/fused_aed_step.cu, which
# _load checks against these): parts of a matvec tile at most (one cluster
# of portable size), the padding of a staged weight row, the dynamic shared
# memory an H100 block may take, the attention's chunks at most (one
# cluster of portable size), its threads a block and the plan's ints.
MAX_PARTS = 8
MV_PAD = 16
MAX_SMEM = 232448
ATTN_MAX_CHUNKS = 8
ROW_THREADS = 256
PLAN_INTS = 21

_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


@dataclasses.dataclass(frozen=True)
class AedGeom:
    """Decoder geometry."""

    d_model: int
    ffn_dim: int
    num_heads: int

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


_SEGMENTS = ("q", "k", "v", "o", "cq", "co", "fc1")


def stack_aed_step_params(dec: dict, geom: AedGeom) -> dict | None:
    """q8 AED decoder params -> stacked arrays for the step kernel.

    Needs every decoder linear to be an unpacked static 8-bit
    QuantizedLinear with block 128, and the tied head (``dec["out"]`` when
    untied, else ``dec["embed"]``) to be an 8-bit block-128
    :class:`QuantizedEmbedding` with its ``(D, V_pad)`` copy. Returns None
    otherwise (callers keep the per-weight path)."""
    if not isinstance(dec, dict):
        return None
    d, ffn = geom.d_model, geom.ffn_dim

    def leaf(p):
        w = p.get("w")
        if isinstance(w, QuantizedLinear) and not w.packed and w.bits == 8 and not w.dynamic:
            return w
        return None

    def bias(p, n, like):
        b = p.get("b")
        return torch.zeros((n,), device=like.device) if b is None else b.to(torch.float32)

    cols: dict[str, list] = {k: [] for k in ("wa_all", "a_s", "a_zs", "ba", "wb_all", "b_s",
                                              "b_zs", "bb", "ln1_s", "ln1_b", "lnc_s",
                                              "lnc_b", "ln2_s", "ln2_b")}
    for p in dec.get("blocks", []):
        ws = {"q": leaf(p["attn"]["q"]), "k": leaf(p["attn"]["k"]), "v": leaf(p["attn"]["v"]),
              "o": leaf(p["attn"]["o"]), "cq": leaf(p["cross"]["q"]), "co": leaf(p["cross"]["o"]),
              "fc1": leaf(p["mlp"]["fc1"]), "fc2": leaf(p["mlp"]["fc2"])}
        if any(w is None or w.block != BLOCK for w in ws.values()):
            return None
        qa = torch.cat([ws[k].q for k in _SEGMENTS], dim=1)
        if qa.shape != (d, 6 * d + ffn):
            return None
        cols["wa_all"].append(qa)
        cols["a_s"].append(torch.cat([ws[k].scale for k in _SEGMENTS], dim=1).to(torch.float32))
        cols["a_zs"].append(torch.cat([ws[k].zero * ws[k].scale for k in _SEGMENTS],
                                      dim=1).to(torch.float32))
        like = ws["q"].scale
        cols["ba"].append(torch.cat([
            bias(p["attn"]["q"], d, like), bias(p["attn"]["k"], d, like),
            bias(p["attn"]["v"], d, like), bias(p["attn"]["o"], d, like),
            bias(p["cross"]["q"], d, like), bias(p["cross"]["o"], d, like),
            bias(p["mlp"]["fc1"], ffn, like)])[None])
        cols["wb_all"].append(ws["fc2"].q)
        cols["b_s"].append(ws["fc2"].scale.to(torch.float32))
        cols["b_zs"].append((ws["fc2"].zero * ws["fc2"].scale).to(torch.float32))
        cols["bb"].append(bias(p["mlp"]["fc2"], d, like)[None])
        for key, src in (("ln1", "ln1"), ("lnc", "ln_cross"), ("ln2", "ln2")):
            cols[key + "_s"].append(p[src]["scale"].to(torch.float32)[None])
            cols[key + "_b"].append(p[src]["bias"].to(torch.float32)[None])
    if not cols["wa_all"]:
        return None
    emb = dec.get("out", dec.get("embed"))
    if not (isinstance(emb, QuantizedEmbedding) and emb.q_t is not None
            and not emb.q_t_packed and emb.bits == 8 and emb.block == BLOCK):
        return None
    out = {k: torch.stack(v).contiguous() for k, v in cols.items()}
    out["lnf_s"] = dec["ln"]["scale"].to(torch.float32)[None].contiguous()
    out["lnf_b"] = dec["ln"]["bias"].to(torch.float32)[None].contiguous()
    out["wh"] = emb.q_t.contiguous()
    out["h_s"] = emb.scale_t.to(torch.float32)[None].contiguous()
    out["h_zs"] = (emb.zero_t * emb.scale_t).to(torch.float32)[None].contiguous()
    return out


def stack_whisper_step_params(params: dict, cfg) -> dict | None:
    """Whisper adapter: ``params["decoder"]`` through the generic stacker."""
    if not isinstance(params, dict) or "decoder" not in params:
        return None
    return stack_aed_step_params(params["decoder"],
                                 AedGeom(cfg.d_model, cfg.ffn_dim, cfg.num_heads))


# ── plain PyTorch version ───────────────────────────────────────────────


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def _matvec(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, zs: torch.Tensor) -> torch.Tensor:
    """(1, K) f32 @ q8 (K, N) -> (1, N): per 128-row block (bf16(x).q)*s - sum(bf16(x))*zs."""
    k, n = q.shape
    xb = _bf16(x).reshape(k // BLOCK, BLOCK)
    part = torch.einsum("bk,bkn->bn", xb, q.to(torch.float32).reshape(k // BLOCK, BLOCK, n))
    return (part * s - xb.sum(dim=1, keepdim=True) * zs).sum(dim=0, keepdim=True)


def _layer_norm(x: torch.Tensor, s: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    c = x - mu
    var = (c * c).mean(dim=-1, keepdim=True)
    return c * torch.rsqrt(var + EPS) * s + b


def _softmax(sc: torch.Tensor) -> torch.Tensor:
    e = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def fused_aed_step_reference(stacked: dict, geom: AedGeom, x: torch.Tensor,
                             k_self: torch.Tensor, v_self: torch.Tensor,
                             cross_k: torch.Tensor, cross_v: torch.Tensor,
                             pos: int, tc_valid: int | None = None):
    """Plain PyTorch version of the kernel, same arguments and results as
    :func:`fused_aed_step` (the caches take row ``pos`` in place)."""
    d, f, h = geom.d_model, geom.ffn_dim, geom.num_heads
    hd = d // h
    scale = hd ** -0.5
    tc_valid = cross_k.shape[1] if tc_valid is None else int(tc_valid)
    st = stacked
    x = x.to(torch.float32).reshape(1, d)
    for l in range(k_self.shape[0]):
        wa, a_s, a_zs, ba = st["wa_all"][l], st["a_s"][l], st["a_zs"][l], st["ba"][l]

        def seg(y, c0, n):
            return _matvec(y, wa[:, c0 : c0 + n], a_s[:, c0 : c0 + n], a_zs[:, c0 : c0 + n])

        # self attention over cache rows < pos plus the fresh row
        y = _layer_norm(x, st["ln1_s"][l], st["ln1_b"][l])
        qkv = seg(y, 0, 3 * d) + ba[:, : 3 * d]
        q, k, v = qkv[:, :d].reshape(h, hd), qkv[:, d : 2 * d], qkv[:, 2 * d : 3 * d]
        kc, vc = _bf16(k_self[l, :pos]).reshape(pos, h, hd), _bf16(v_self[l, :pos]).reshape(pos, h, hd)
        k_self[l, pos] = k[0].to(k_self.dtype)
        v_self[l, pos] = v[0].to(v_self.dtype)
        sc = torch.einsum("hd,thd->ht", _bf16(q * scale), kc)
        snew = (q * k.reshape(h, hd) * scale).sum(dim=-1, keepdim=True)
        pr = _softmax(torch.cat([sc, snew], dim=1))
        ctx = torch.einsum("ht,thd->hd", _bf16(pr[:, :pos]), vc) + pr[:, pos:] * v.reshape(h, hd)
        x = x + seg(ctx.reshape(1, d), 3 * d, d) + ba[:, 3 * d : 4 * d]
        # cross attention over the first tc_valid rows
        y = _layer_norm(x, st["lnc_s"][l], st["lnc_b"][l])
        qc = (seg(y, 4 * d, d) + ba[:, 4 * d : 5 * d]).reshape(h, hd)
        ck = _bf16(cross_k[l, :tc_valid]).reshape(tc_valid, h, hd)
        cv = _bf16(cross_v[l, :tc_valid]).reshape(tc_valid, h, hd)
        pr = _softmax(torch.einsum("hd,thd->ht", _bf16(qc * scale), ck))
        ctx = torch.einsum("ht,thd->hd", _bf16(pr), cv)
        x = x + seg(ctx.reshape(1, d), 5 * d, d) + ba[:, 5 * d : 6 * d]
        # exact-GELU MLP
        y = _layer_norm(x, st["ln2_s"][l], st["ln2_b"][l])
        h1 = seg(y, 6 * d, f) + ba[:, 6 * d :]
        h1 = 0.5 * h1 * (1.0 + torch.erf(h1 * 0.7071067811865476))
        x = x + _matvec(h1, st["wb_all"][l], st["b_s"][l], st["b_zs"][l]) + st["bb"][l]
    xn = _layer_norm(x, st["lnf_s"], st["lnf_b"])
    logits = _matvec(xn, st["wh"], st["h_s"][0], st["h_zs"][0])
    return logits, k_self, v_self


# ── the plan ────────────────────────────────────────────────────────────


def matvec_smem(bn: int, parts: int, k: int, rows: int = MAX_ROWS) -> int:
    """Shared memory of a matvec block (``mv_smem`` in
    ``csrc/aed_step.cuh``, which the card tests hold it to through
    ``aed_matvec_smem``): each 128-row block of the part (weight rows, x
    fragments, chunk sums), their scales and zero*scales, and the inbox of
    the cells it owns (``rows`` x BN cells shared by the parts, 64 at a
    time), one partial sum per part."""
    mt = 2 if rows > 16 else 1
    blk = BLOCK * (bn + MV_PAD) + (BLOCK // CHUNK) * mt * 1024 + (BLOCK // CHUNK) * 16 * mt * 4
    jper = k // BLOCK // parts
    share = -(-(-(-rows * bn // parts)) // 64) * 64
    return jper * blk + jper * 2 * bn * 4 + parts * share * 4


@functools.lru_cache(maxsize=256)
def matvec_plan(k: int, n: int) -> tuple[int, int]:
    """(BN, parts) of the step's matvec for an int8 (K, N) weight: column
    tiles BN wide, K/128 128-row blocks split into ``parts`` equal runs (a
    thread block cluster). ``parts`` is the largest divisor of the block
    count up to :data:`MAX_PARTS` whose part fits in shared memory at
    :data:`MAX_ROWS` rows (fewest blocks a part: the least latency a
    block), BN the widest of :data:`MV_WIDTHS` whose tiles, times the
    parts, reach :data:`SMS` blocks; where none does, the narrowest.
    Depends on (K, N) alone: the sum behind an output never depends on the
    slot count."""
    nb = k // BLOCK
    widths = [bn for bn in MV_WIDTHS if n % bn == 0]
    if nb < 1 or k % BLOCK or not widths:
        raise ValueError(f"no matvec tile for K={k}, N={n}")
    divs = [d for d in range(1, min(nb, MAX_PARTS) + 1) if nb % d == 0]
    fits = {bn: [d for d in divs if matvec_smem(bn, d, k) <= MAX_SMEM] for bn in widths}
    for bn in widths:
        if fits[bn] and n // bn * fits[bn][-1] >= SMS:
            return bn, fits[bn][-1]
    bn = widths[-1]
    if not fits[bn]:
        raise ValueError(f"no matvec split of K={k} fits in shared memory")
    return bn, fits[bn][-1]


def attn_smem(cap: int, srows: int, itemsize: int = 4) -> int:
    """Dynamic shared memory of an attention block (``attn_smem`` in
    ``csrc/aed_step.cuh``): ``cap`` scores, then ``srows`` rows of k, later
    of v, in one buffer. The kernel takes at most half of :data:`MAX_SMEM`
    (its static arrays take part of the rest)."""
    return -(-cap * 4 // 16) * 16 + srows * HEAD_DIM * itemsize


def attn_cap(t_rows: int) -> tuple[int, int]:
    """(score rows a chunk holds, k / v rows it stages) for an attention over
    at most ``t_rows`` cached rows: the longest chunk is ceil(t_rows / 8)
    rows, or fewer than :data:`ATTN_MIN_ROWS`, and a chunk stages as many of
    its rows as :data:`ATTN_STAGE_BYTES` hold in f32."""
    cap = max(ATTN_MIN_ROWS, -(-t_rows // ATTN_MAX_CHUNKS))
    return cap, min(cap, ATTN_STAGE_BYTES // (HEAD_DIM * 4))


class AedPlan(NamedTuple):
    """What both step kernels take beside their tensors: (BN, parts) of the
    q|k|v, self-o, cross-q, cross-o, fc1, fc2 and head matvecs, the
    attentions' chunk rule and cluster size, the score rows a chunk holds
    and the k / v rows it stages (self, then cross), and whether the
    launches are chained (programmatic dependent launch). ``pdl`` is off
    only to profile the step's kernels one at a time (with chained launches
    they overlap): ``chip_smoke.step_profile``."""
    qkv: tuple[int, int]
    so: tuple[int, int]
    cq: tuple[int, int]
    co: tuple[int, int]
    fc1: tuple[int, int]
    fc2: tuple[int, int]
    head: tuple[int, int]
    attn_min_rows: int
    attn_max_chunks: int
    self_cap: int
    self_srows: int
    cross_cap: int
    cross_srows: int
    pdl: bool = True

    def c_array(self):
        """The kernel's ``aedstep::Plan`` as a ctypes int array."""
        vals = (*self.qkv, *self.so, *self.cq, *self.co, *self.fc1, *self.fc2, *self.head,
                self.attn_min_rows, self.attn_max_chunks, self.self_cap, self.self_srows,
                self.cross_cap, self.cross_srows, int(self.pdl))
        return (ctypes.c_int * len(vals))(*vals)


def matvec_shapes(d: int, f: int, vp: int) -> dict:
    """(K, N) of the step's seven matvecs, in the plan's order."""
    return {"qkv": (d, 3 * d), "so": (d, d), "cq": (d, d), "co": (d, d), "fc1": (d, f),
            "fc2": (f, d), "head": (d, vp)}


def aed_plan(d: int, f: int, vp: int, t_self: int, t_cross: int, pdl: bool = True) -> AedPlan:
    """The plan of a step of width ``d``, FFN ``f`` and a tied head of ``vp``
    padded columns over self caches of ``t_self`` rows (at most t_self - 1
    cached rows attended) and cross caches of ``t_cross``: one for every
    slot count."""
    mv = {name: matvec_plan(k, n) for name, (k, n) in matvec_shapes(d, f, vp).items()}
    return AedPlan(**mv, attn_min_rows=ATTN_MIN_ROWS, attn_max_chunks=ATTN_MAX_CHUNKS,
                   self_cap=attn_cap(t_self - 1)[0], self_srows=attn_cap(t_self - 1)[1],
                   cross_cap=attn_cap(t_cross)[0], cross_srows=attn_cap(t_cross)[1], pdl=pdl)


# ── the CUDA kernel ─────────────────────────────────────────────────────


def build() -> tuple[Path, str]:
    """Compile the kernel (once per source and flags); return (library, nvcc log)."""
    return nvcc_build.build(SOURCE, NVCC_FLAGS)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            # x, 19 stacked arrays, 4 caches, logits, scratch; 10 ints, eps, plan, stream
            lib.fused_aed_step.argtypes = ([ctypes.c_void_p] * 26 + [ctypes.c_int] * 10
                                           + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
            lib.fused_aed_step.restype = ctypes.c_int
            # x, 19 stacked arrays, 4 caches, pos, tc_valid, logits, scratch; 8 ints, eps, plan, stream
            lib.fused_aed_step_dev.argtypes = ([ctypes.c_void_p] * 28 + [ctypes.c_int] * 8
                                               + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
            lib.fused_aed_step_dev.restype = ctypes.c_int
            lib.fused_aed_step_scratch_floats.argtypes = [ctypes.c_int] * 2
            lib.fused_aed_step_scratch_floats.restype = ctypes.c_longlong
            # x, w, s, zs, out, scratch; rows, k, n, bn, parts; stream
            lib.aed_matvec.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            lib.aed_matvec.restype = ctypes.c_int
            lib.aed_matvec_scratch_floats.argtypes = [ctypes.c_int] * 2
            lib.aed_matvec_scratch_floats.restype = ctypes.c_longlong
            lib.aed_matvec_smem.argtypes = [ctypes.c_int] * 4
            lib.aed_matvec_smem.restype = ctypes.c_longlong
            lib.aed_attn_smem.argtypes = [ctypes.c_int] * 3
            lib.aed_attn_smem.restype = ctypes.c_longlong
            lib.aed_plan_limits.argtypes = [ctypes.c_void_p]
            lib.aed_plan_limits.restype = None
            limits = (ctypes.c_int * 6)()
            lib.aed_plan_limits(limits)
            ours = (MAX_PARTS, MV_PAD, MAX_SMEM, ATTN_MAX_CHUNKS, ROW_THREADS, PLAN_INTS)
            if tuple(limits) != ours:
                raise RuntimeError(f"{SOURCE.name} was built with the plan limits {tuple(limits)}, "
                                   f"the plan assumes {ours}")
            _lib = lib
    return _lib


def _stacked_shapes(nl: int, d: int, f: int, vp: int) -> dict:
    """Each stacked array's shape, in the order the C entry point takes them."""
    na, kd, kf, ln = 6 * d + f, d // BLOCK, f // BLOCK, (nl, 1, d)
    return {"ln1_s": ln, "ln1_b": ln, "lnc_s": ln, "lnc_b": ln, "ln2_s": ln, "ln2_b": ln,
            "lnf_s": (1, d), "lnf_b": (1, d), "ba": (nl, 1, na), "bb": ln,
            "wa_all": (nl, d, na), "a_s": (nl, kd, na), "a_zs": (nl, kd, na),
            "wb_all": (nl, f, d), "b_s": (nl, kf, d), "b_zs": (nl, kf, d),
            "wh": (d, vp), "h_s": (1, kd, vp), "h_zs": (1, kd, vp)}


def _check(name: str, t: torch.Tensor, shape: tuple, dtypes, dev: torch.device) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_step(stacked: dict, geom: AedGeom, x, k_self, v_self, cross_k, cross_v) -> tuple:
    """The checks both batch-1 launchers make; returns (NL, T, Tc, V_pad,
    the stacked arrays' shapes in the C order, the caches' dtype)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the fused AED step needs CUDA tensors, got {dev}")
    d, f, h = geom.d_model, geom.ffn_dim, geom.num_heads
    if h * HEAD_DIM != d or d % BLOCK or f % BLOCK:
        raise ValueError(f"the kernel takes head_dim {HEAD_DIM} and D, F multiples of {BLOCK}; "
                         f"got D={d}, heads={h}, F={f}")
    nl, t_self = k_self.shape[0], k_self.shape[1]
    t_cross = cross_k.shape[1]
    vp = stacked["wh"].shape[-1]
    if vp % BLOCK:
        raise ValueError(f"wh must be (D, V_pad) with V_pad a multiple of {BLOCK}, got {vp}")
    shapes = _stacked_shapes(nl, d, f, vp)
    for key, shape in shapes.items():
        dtypes = (torch.int8,) if key in ("wa_all", "wb_all", "wh") else (torch.float32,)
        _check(key, stacked[key], shape, dtypes, dev)
    _check("x", x, (1, d), (torch.float32,), dev)
    cdt = k_self.dtype
    if cdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"caches must be float32 or bfloat16, got {cdt}")
    for name, t, rows in (("k_self", k_self, t_self), ("v_self", v_self, t_self),
                          ("cross_k", cross_k, t_cross), ("cross_v", cross_v, t_cross)):
        _check(name, t, (nl, rows, d), (cdt,), dev)
    return nl, t_self, t_cross, vp, shapes, cdt


def fused_aed_step_cuda(stacked: dict, geom: AedGeom, x: torch.Tensor,
                        k_self: torch.Tensor, v_self: torch.Tensor,
                        cross_k: torch.Tensor, cross_v: torch.Tensor,
                        pos: int, tc_valid: int | None = None, plan: AedPlan | None = None):
    """Launch the CUDA kernel; checks every argument and raises on what the
    kernel does not take (it takes head_dim 64, D and F multiples of 128,
    block-128 q8 weights, and f32 or bf16 caches of one dtype). ``plan``
    defaults to :func:`aed_plan`'s."""
    global LAUNCHES
    nl, t_self, t_cross, vp, shapes, cdt = _check_step(stacked, geom, x, k_self, v_self,
                                                       cross_k, cross_v)
    dev, d, f, h = x.device, geom.d_model, geom.ffn_dim, geom.num_heads
    tc_valid = t_cross if tc_valid is None else int(tc_valid)
    pos = int(pos)
    if not 0 <= pos < t_self:
        raise ValueError(f"pos {pos} outside the self cache of {t_self} rows")
    if not 1 <= tc_valid <= t_cross:
        raise ValueError(f"tc_valid {tc_valid} outside [1, {t_cross}]")
    plan = plan or aed_plan(d, f, vp, t_self, t_cross)
    lib = _load()
    scratch = torch.empty((lib.fused_aed_step_scratch_floats(d, f),), device=dev, dtype=torch.float32)
    logits = torch.empty((1, vp), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_aed_step(
            x.data_ptr(), *(stacked[k].data_ptr() for k in shapes),
            k_self.data_ptr(), v_self.data_ptr(), cross_k.data_ptr(), cross_v.data_ptr(),
            logits.data_ptr(), scratch.data_ptr(),
            nl, d, h, f, t_self, t_cross, vp, pos, tc_valid, int(cdt == torch.bfloat16),
            EPS, plan.c_array(), stream)
    if err != 0:
        raise RuntimeError(f"fused_aed_step launch failed: CUDA error {err}")
    with _count_lock:
        LAUNCHES += 1
    return logits, k_self, v_self


def step_scratch_floats(geom: AedGeom) -> int:
    """Floats of the scratch buffer :func:`fused_aed_step_dev_cuda` takes."""
    return int(_load().fused_aed_step_scratch_floats(geom.d_model, geom.ffn_dim))


def fused_aed_step_dev_cuda(stacked: dict, geom: AedGeom, x: torch.Tensor,
                            k_self: torch.Tensor, v_self: torch.Tensor,
                            cross_k: torch.Tensor, cross_v: torch.Tensor,
                            pos: torch.Tensor, tc_valid: torch.Tensor, logits: torch.Tensor,
                            scratch: torch.Tensor, plan: AedPlan | None = None):
    """:func:`fused_aed_step_cuda` with ``pos`` and ``tc_valid`` as (1,)
    int32 device tensors, read by the kernels, and the (1, V_pad) f32
    ``logits`` and the scratch (:func:`step_scratch_floats`) given by the
    caller: nothing is allocated, so the launches can be captured in a CUDA
    graph and replayed while the device advances ``pos``. Makes
    :func:`fused_aed_step_cuda`'s checks except the range of ``pos``, which
    the caller makes once for its whole loop (the kernel clamps
    ``tc_valid`` into [1, Tc]); the logits are bitwise those of the
    host-``pos`` launch. Counts a launch unless a graph is being captured
    (the replays count theirs)."""
    global LAUNCHES
    nl, t_self, t_cross, vp, shapes, cdt = _check_step(stacked, geom, x, k_self, v_self,
                                                       cross_k, cross_v)
    dev, d, f, h = x.device, geom.d_model, geom.ffn_dim, geom.num_heads
    lib = _load()
    _check("pos", pos, (1,), (torch.int32,), dev)
    _check("tc_valid", tc_valid, (1,), (torch.int32,), dev)
    _check("logits", logits, (1, vp), (torch.float32,), dev)
    _check("scratch", scratch, (lib.fused_aed_step_scratch_floats(d, f),), (torch.float32,), dev)
    plan = plan or aed_plan(d, f, vp, t_self, t_cross)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_aed_step_dev(
            x.data_ptr(), *(stacked[k].data_ptr() for k in shapes),
            k_self.data_ptr(), v_self.data_ptr(), cross_k.data_ptr(), cross_v.data_ptr(),
            pos.data_ptr(), tc_valid.data_ptr(), logits.data_ptr(), scratch.data_ptr(),
            nl, d, h, f, t_self, t_cross, vp, int(cdt == torch.bfloat16), EPS, plan.c_array(), stream)
    if err != 0:
        raise RuntimeError(f"fused_aed_step_dev launch failed: CUDA error {err}")
    if not torch.cuda.is_current_stream_capturing():
        with _count_lock:
            LAUNCHES += 1
    return logits, k_self, v_self


def aed_matvec_cuda(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                    zs: torch.Tensor) -> torch.Tensor:
    """The step's matvec alone, on the card: x (B, K) f32, B <= 32, through an
    int8 (K, N) weight with scales and zero*scales (K/128, N) -> (B, N) f32,
    with :func:`matvec_plan`'s tile. Its plain version is :func:`_matvec`,
    row by row."""
    global MATVEC_LAUNCHES
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"aed_matvec_cuda needs CUDA tensors, got {dev}")
    rows, k = x.shape
    n = q.shape[1]
    if not 1 <= rows <= MAX_ROWS or k % BLOCK or n % 32:
        raise ValueError(f"the matvec takes 1..{MAX_ROWS} rows, K a multiple of {BLOCK} and N of 32; "
                         f"got x {tuple(x.shape)}, q {tuple(q.shape)}")
    _check("x", x, (rows, k), (torch.float32,), dev)
    _check("q", q, (k, n), (torch.int8,), dev)
    for name, a in (("s", s), ("zs", zs)):
        _check(name, a, (k // BLOCK, n), (torch.float32,), dev)
    bn, parts = matvec_plan(k, n)
    lib = _load()
    scratch = torch.empty((lib.aed_matvec_scratch_floats(rows, k),), device=dev, dtype=torch.float32)
    out = torch.empty((rows, n), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        err = lib.aed_matvec(x.data_ptr(), q.data_ptr(), s.data_ptr(), zs.data_ptr(), out.data_ptr(),
                             scratch.data_ptr(), rows, k, n, bn, parts,
                             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"aed_matvec launch failed: CUDA error {err}")
    with _count_lock:
        MATVEC_LAUNCHES += 1
    return out


def fused_aed_step(stacked: dict, geom: AedGeom, x: torch.Tensor,
                   k_self: torch.Tensor, v_self: torch.Tensor,
                   cross_k: torch.Tensor, cross_v: torch.Tensor,
                   pos: int, tc_valid: int | None = None):
    """One batch-1 AED decode step.

    Args:
      stacked: from :func:`stack_aed_step_params`.
      x: (1, D) f32 input row (token embedding + positional embedding).
      k_self/v_self: (NL, T, D) self caches (f32 or bf16); row ``pos`` is
        written in place, every other row is left as it was.
      cross_k/cross_v: (NL, Tc, D) cross K/V in the caches' dtype.
      pos: this token's cache slot.
      tc_valid: number of real cross rows (default Tc); later rows are masked.

    Returns ``(logits (1, V_pad) f32, k_self, v_self)``; pad logits are 0.
    On a CPU tensor this is the plain version; on a CUDA tensor the kernel.
    """
    if x.device.type == "cpu":
        return fused_aed_step_reference(stacked, geom, x, k_self, v_self, cross_k, cross_v,
                                        pos, tc_valid)
    return fused_aed_step_cuda(stacked, geom, x, k_self, v_self, cross_k, cross_v, pos, tc_valid)


def fused_whisper_step(stacked: dict, cfg, x, k_self, v_self, cross_k, cross_v, pos,
                       tc_valid=None):
    """Whisper adapter for :func:`fused_aed_step` (geometry from cfg)."""
    return fused_aed_step(stacked, AedGeom(cfg.d_model, cfg.ffn_dim, cfg.num_heads), x,
                          k_self, v_self, cross_k, cross_v, pos, tc_valid=tc_valid)


# ── the batch-1 decode loop ─────────────────────────────────────────────


def position_rows(table: torch.Tensor, pos) -> torch.Tensor:
    """Row ``pos`` of a position table as (1, D): a host int slices it, a
    (1,) device int gathers it (the same values)."""
    return table[pos : pos + 1] if isinstance(pos, int) else table.index_select(0, pos)


class _Static:
    """The device buffers of one loop shape and the CUDA graph of one token
    over them (None until captured; never on the CPU)."""

    def __init__(self, nl: int, t: int, tc: int, d: int, vp: int, cdt: torch.dtype,
                 suppress: tuple, scratch_floats: int, dev: torch.device):
        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.kc, self.vc = zeros((nl, t, d), cdt), zeros((nl, t, d), cdt)
        self.ck, self.cv = zeros((nl, tc, d), cdt), zeros((nl, tc, d), cdt)
        self.logits = zeros((1, vp), torch.float32)
        self.scratch = zeros((scratch_floats,), torch.float32) if scratch_floats else None
        self.pos = zeros((1,), torch.int32)
        self.tcv = zeros((1,), torch.int32)
        self.buf = zeros((1, t + 1), torch.int64)  # every write lands at pos + 1 <= t
        self.counts = zeros((1,), torch.int32)
        self.finished = zeros((1,), torch.bool)
        self.suppress = torch.as_tensor(suppress, dtype=torch.int64, device=dev) if suppress else None
        self.graph = None


class FusedAedDecoder:
    """The batch-1 AR decode of one AED decoder (Whisper, FireRed, Dolphin)
    over :func:`fused_aed_step`, owned by a session and shared by its calls.

    ``input_row(token (1,) int64, pos)`` gives the family's decoder input
    (1, D) (``pos`` a host int or a (1,) int32 device tensor: see
    :func:`position_rows`). :meth:`decode` has ``decode/ar.ar_decode``'s
    arguments, results and stop rule. Greedy decode whose budget fits the
    self cache runs on static device buffers: on a card each token is one
    replay of a CUDA graph of one token (the family's input row, the step
    through :func:`fused_aed_step_dev_cuda` with the position on the
    device, suppression, argmax, the token written at ``pos + 1``, counts,
    stop flags, ``pos + 1``), followed by the one read-back of the stop
    flag a token that ``ar_decode`` makes; on the CPU the same body runs
    eagerly. The graph of a shape (cache dtype, T, Tc, EOT, suppress ids) is
    captured after the first eagerly run step of the first request that
    needs it, and reused. Penalty and sampling run :meth:`host_loop`:
    ``ar_decode`` over :func:`fused_aed_step` with the position on the host.
    A lock keeps one call at a time on the buffers."""

    def __init__(self, stacked: dict, geom: AedGeom, vocab_size: int,
                 input_row: Callable[[torch.Tensor, object], torch.Tensor],
                 span: str | None = None):
        self.stacked, self.geom, self.vocab_size, self.input_row = stacked, geom, vocab_size, input_row
        self.span = span  # around the caches' stacking or copy
        self._statics: dict[tuple, _Static] = {}
        self._lock = threading.Lock()

    def _stack_span(self):
        return annotate(self.span) if self.span else contextlib.nullcontext()

    def decode(self, layers, prompt_len: int, first: torch.Tensor, buf: torch.Tensor, decode_cfg,
               generator: torch.Generator | None = None,
               tc_valid: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """Decode from the prefilled per-layer caches ``layers`` (each a
        dict of ``self_k`` / ``self_v`` (1, T, ...) and ``cross_k`` /
        ``cross_v`` (1, Tc, ...)), attending to the first ``tc_valid`` cross
        rows (default Tc, clamped into [1, Tc]). Returns ``ar_decode``'s
        (tokens (1, T_total) int64, counts (1,) int32). Greedy decode whose
        last step's position lies in the self cache runs on the static
        buffers; everything else is :meth:`host_loop`."""
        t = layers[0]["self_k"].shape[1]
        if (decode_cfg.strategy != "greedy" or prompt_len + decode_cfg.max_new_tokens > t
                or buf.shape[1] > t + 1):
            return self.host_loop(layers, prompt_len, first, buf, decode_cfg, generator, tc_valid)
        with self._lock:
            with torch.inference_mode():
                tokens, counts = self._greedy(layers, prompt_len, first, buf, decode_cfg,
                                              *self._cross_and_dtype(layers, tc_valid))
            return tokens[:, : buf.shape[1]].clone(), counts.clone()

    @staticmethod
    def _cross_and_dtype(layers, tc_valid):
        """(cross rows attended, the caches' dtype as the kernel takes them)."""
        tc = layers[0]["cross_k"].shape[1]
        tc_valid = tc if tc_valid is None else min(max(int(tc_valid), 1), tc)
        # The kernel reads f32 or bf16 caches: f16 caches (an artifact built
        # from an f16 checkpoint) widen exactly to f32.
        cdt = layers[0]["self_k"].dtype
        return tc_valid, torch.float32 if cdt == torch.float16 else cdt

    def host_loop(self, layers, prompt_len: int, first: torch.Tensor, buf: torch.Tensor, decode_cfg,
                  generator: torch.Generator | None = None,
                  tc_valid: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """:meth:`decode` as ``ar_decode`` over :func:`fused_aed_step`, the
        position on the host: the route of penalty and sampling, and the
        reference the greedy route is held to."""
        d = self.geom.d_model
        t, tc = layers[0]["self_k"].shape[1], layers[0]["cross_k"].shape[1]
        tc_valid, cdt = self._cross_and_dtype(layers, tc_valid)
        # (NL, T, D) stacks, made once before the loop; the step writes the
        # fresh self rows into kc / vc in place.
        with self._stack_span():
            kc = torch.stack([ls["self_k"][0].reshape(t, d) for ls in layers]).to(cdt)
            vc = torch.stack([ls["self_v"][0].reshape(t, d) for ls in layers]).to(cdt)
            ck = torch.stack([ls["cross_k"][0].reshape(tc, d) for ls in layers]).to(cdt)
            cv = torch.stack([ls["cross_v"][0].reshape(tc, d) for ls in layers]).to(cdt)

        def step(st, token, pos):
            x = self.input_row(token[:, 0], pos).to(torch.float32)
            lg, _, _ = fused_aed_step(self.stacked, self.geom, x, kc, vc, ck, cv, pos,
                                      tc_valid=tc_valid)
            return lg[:, : self.vocab_size], st

        return ar.ar_decode(step, None, prompt_len, first, buf, decode_cfg, generator)

    def _greedy(self, layers, prompt_len, first, buf, cfg, tc_valid, cdt):
        global LAUNCHES, GRAPH_REPLAYS
        d = self.geom.d_model
        nl, t, tc = len(layers), layers[0]["self_k"].shape[1], layers[0]["cross_k"].shape[1]
        dev = first.device
        suppress = tuple(cfg.suppress_ids)
        key = (cdt, t, tc, cfg.eot_id, suppress)
        st = self._statics.get(key)
        if st is None:
            floats = step_scratch_floats(self.geom) if dev.type == "cuda" else 0
            st = _Static(nl, t, tc, d, self.stacked["wh"].shape[-1], cdt, suppress, floats, dev)
            self._statics[key] = st
        with self._stack_span():  # the request's caches into the static ones: the same bytes
            for l, ls in enumerate(layers):
                st.kc[l].copy_(ls["self_k"][0].reshape(t, d))
                st.vc[l].copy_(ls["self_v"][0].reshape(t, d))
                st.ck[l].copy_(ls["cross_k"][0].reshape(tc, d))
                st.cv[l].copy_(ls["cross_v"][0].reshape(tc, d))
        st.buf.zero_()
        st.buf[:, : buf.shape[1]].copy_(buf)
        st.buf[:, prompt_len] = first
        st.finished.copy_(first == cfg.eot_id)
        st.counts.fill_(1)
        st.pos.fill_(prompt_len)
        st.tcv.fill_(tc_valid)
        i = 0
        more = i < cfg.max_new_tokens and not bool(st.finished.all())  # the host sync
        while more:
            with annotate("asr.decode.token"):  # a token's replay and the sync that reads it back
                if st.graph is not None:
                    st.graph.replay()
                    with _count_lock:
                        LAUNCHES += 1
                        GRAPH_REPLAYS += 1
                else:
                    self._body(st, cfg)
                i += 1
                more = i < cfg.max_new_tokens and not bool(st.finished.all())
            if more and st.graph is None and dev.type == "cuda":
                self._capture(st, cfg)
        return st.buf, st.counts

    def _capture(self, st: _Static, cfg) -> None:
        """Record one token of ``st``'s body (it runs nothing: the buffers
        keep the state the last eager step left)."""
        global GRAPH_CAPTURES
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self._body(st, cfg)
        st.graph = graph
        with _count_lock:
            GRAPH_CAPTURES += 1

    def _body(self, st: _Static, cfg) -> None:
        """One token on the static buffers, every value on the device:
        ``ar_decode``'s greedy iteration."""
        token = st.buf.index_select(1, st.pos)[:, 0]
        x = self.input_row(token, st.pos).to(torch.float32)
        if x.device.type == "cpu":
            lg, _, _ = fused_aed_step_reference(self.stacked, self.geom, x, st.kc, st.vc, st.ck,
                                                st.cv, int(st.pos), int(st.tcv))
        else:
            lg, _, _ = fused_aed_step_dev_cuda(self.stacked, self.geom, x, st.kc, st.vc, st.ck,
                                               st.cv, st.pos, st.tcv, st.logits, st.scratch)
        lg = lg[:, : self.vocab_size]
        if st.suppress is not None:
            lg = lg.index_fill(1, st.suppress, NEG_INF)
        nxt = torch.where(st.finished, cfg.eot_id, torch.argmax(lg, dim=-1))
        st.buf.index_copy_(1, (st.pos + 1).to(torch.int64), nxt[:, None])
        st.counts += (~st.finished).to(torch.int32)
        st.finished |= nxt == cfg.eot_id
        st.pos += 1


def scaled_embed_decoder(params: dict, cfg, stacked: dict) -> FusedAedDecoder:
    """The :class:`FusedAedDecoder` of the sqrt(d)-scaled-embedding AED
    families (FireRed, Dolphin: their ``_decoder_pass`` input math
    ``embed[token] * sqrt(d) + positions[pos]``, tied head)."""
    from asr_tpu_torch.layers.conformer import absolute_positions

    d = cfg.d_model
    embed = params["decoder"]["embed"]
    pos_table = absolute_positions(cfg.max_target_positions, d, stacked["wh"].device)

    def input_row(token, pos):
        return embed[token] * (d ** 0.5) + position_rows(pos_table, pos)

    return FusedAedDecoder(stacked, AedGeom(d, cfg.dec_ffn, cfg.dec_heads), cfg.vocab_size, input_row)


def fused_ar_decode(params: dict, cfg, state: dict, enc: torch.Tensor, enc_valid: torch.Tensor,
                    first: torch.Tensor, buf: torch.Tensor, decode_cfg,
                    generator: torch.Generator | None = None,
                    stacked: dict | FusedAedDecoder | None = None, start_pos: int = 1):
    """The batch-1 AR decode of FireRed and Dolphin over the fused step
    (:meth:`FusedAedDecoder.decode`), over the utterance's ``enc_valid[0]``
    cross rows (at least one, as the multi-slot step clamps them).
    ``stacked``: the session's :class:`FusedAedDecoder`, or stacked weights
    (a decoder is made for this call).

    The route applies to stacked weights at batch 1 in the bf16 mode;
    otherwise this returns None and the caller runs the per-weight step
    (batch > 1, the f32 mode). Else returns ``ar_decode``'s (tokens,
    counts)."""
    from asr_tpu_torch.ops.quant_matmul import _resolve_mm

    if stacked is None or enc.shape[0] != 1 or _resolve_mm(None) != "bf16":
        return None
    decoder = (stacked if isinstance(stacked, FusedAedDecoder)
               else scaled_embed_decoder(params, cfg, stacked))
    layers = state["layers"]
    tc_valid = min(max(int(enc_valid[0]), 1), layers[0]["cross_k"].shape[1])
    return decoder.decode(layers, start_pos, first, buf, decode_cfg, generator, tc_valid=tc_valid)
