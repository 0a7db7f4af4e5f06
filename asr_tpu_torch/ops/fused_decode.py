"""One batch-1 Qwen3 decode step: all layers, the final RMSNorm and the
optional packed-int4 tied head.

Counterpart of ``asr_tpu/ops/fused_decode.py``. Per layer: RMSNorm, the
packed-int4 q|k|v matvec, per-head q/k RMSNorm and NeoX RoPE, the fresh k/v
row written into the caches at ``pos`` in place, GQA attention over the
cached rows ``[shift, pos)`` plus the fresh row, the o-projection and
residual, RMSNorm, gate|up, SiLU(gate) * up, down and residual. Then the
final RMSNorm (the returned hidden is final-normalized) and, when the
stacked weights carry it, the nibble-packed tied head.

:func:`fused_decode_step` runs it on a CUDA tensor through the hand-written
Hopper kernel ``asr_tpu_torch/csrc/fused_decode.cu`` (nvcc, ``sm_90a``,
bound with ``ctypes``) or raises; on a CPU tensor it runs the plain PyTorch
version :func:`fused_decode_step_reference`. Both round where the TPU
kernel rounds:

- every matvec input is rounded to bf16; the nibbles are exact; each
  128-row quantization block accumulates in f32 and applies its affine as
  ``(x.q)*s - sum(x)*(z*s)``;
- cached rows ``[shift, pos)`` score as ``bf16(q * 128**-0.5) . bf16(k)``;
  the fresh row scores in f32 from the unrounded q and k and adds
  ``p_new * v_new`` in f32; the other probabilities are rounded to bf16 for
  ``P.V``;
- the RMSNorms (q/k per 128-wide head), softmax, SiLU gate and residuals
  are f32.

Stacked weights (:func:`stack_decode_params`) keep the JAX keys: packed
``wq`` (NL, H/2, (nh + 2 nkv) 128), ``wo``, ``wgu``, ``wd``, their scales and
zero*scale in the nibble-plane-major layout ``(NL, 2, NB/2, N)`` (plane 0 =
the low nibble = unpacked rows ``[0, K/2)``), the norm scales, and the head
``wh`` (H/2, V_pad) with ``h_s`` / ``h_zs`` (1, 2, NB/2, V_pad). The TPU
strip plan and its VMEM fit test are not needed here; :func:`decode_plan`
takes their place: each matvec's column tile and split of K, and the
attention's row chunks, all fixed by the shapes, so a slot of the
multi-slot step (``ops/fused_decode_multi.py``, the same plan) is bitwise
the batch-1 step.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path
from typing import NamedTuple

import torch

from asr_tpu_torch.ops import nvcc_build
from asr_tpu_torch.quant.quantize import QuantizedEmbedding, QuantizedLinear

# Kernel launches since import (or since a caller reset it to 0): one per step.
LAUNCHES = 0
MATVEC_LAUNCHES = 0  # the step's matvec launched alone (nibble_matvec_cuda)

SOURCE = nvcc_build.CSRC / "fused_decode.cu"
NVCC_FLAGS = nvcc_build.NVCC_FLAGS
BLOCK = 128      # quantization block the kernel takes
HEAD_DIM = 128   # head width the kernel takes
GROUPS = 2      # q heads per kv head the kernel takes (Qwen3-ASR's 16 / 8)
SMS = 132        # streaming multiprocessors of an H100 SXM, which every matvec's blocks should cover
MV_WIDTHS = (64, 32)  # column tiles of the matvec (32 a warp slab), widest first
MAX_ROWS = 32    # slots the matvec takes: two m16 tiles
ATTN_MIN_ROWS = 32   # cached rows an attention chunk takes at least
# The kernel's own limits (qwen_plan_limits in csrc/fused_decode.cu, which
# _load checks against these): parts of a matvec tile at most (one cluster
# of portable size), the 128-row blocks a part holds at once, the packed
# rows of a stage (a warp's share of a block) and their padding, the
# dynamic shared memory an H100 block may take, the attention's chunks at
# most (one cluster of portable size) and the plan's ints.
MAX_PARTS = 8
MV_BLOCKS_PER_PART = 2
MV_STAGE, MV_PAD = 32, 16
MAX_SMEM = 232448
ATTN_MAX_CHUNKS = 8
PLAN_INTS = 14
MV_STAGES_PER_BLOCK = BLOCK // MV_STAGE

_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def stack_decode_params(params: dict, cfg) -> dict | None:
    """Fused q4-packed Qwen3 params -> stacked arrays for the step kernel.

    Needs every layer to carry packed 4-bit ``qkv``/``o``/``gateup``/``down``
    QuantizedLinear leaves of block 128 without biases, q/k RMSNorm, head
    width 128 and a final norm. Returns None otherwise (callers keep the
    per-weight path). The head arrays are included when ``params["embed"]``
    is a 4-bit QuantizedEmbedding with its nibble-packed tied copy."""
    if not isinstance(params, dict):
        return None
    if cfg.head_dim != HEAD_DIM or not cfg.qk_norm or cfg.attention_bias:
        return None
    if cfg.num_heads != GROUPS * cfg.num_kv_heads:
        return None
    layers = params.get("layers")
    final = params.get("final_norm")
    if not layers or not (isinstance(final, dict) and "scale" in final):
        return None

    def leaf(p, *keys):
        for k in keys:
            if not isinstance(p, dict) or k not in p:
                return None
            p = p[k]
        if not isinstance(p, dict) or "b" in p:
            return None
        w = p.get("w")
        if (isinstance(w, QuantizedLinear) and w.packed and w.bits == 4 and not w.dynamic
                and w.block == BLOCK):
            return w
        return None

    h, f = cfg.hidden, cfg.ffn_dim
    qn = (cfg.num_heads + 2 * cfg.num_kv_heads) * HEAD_DIM
    shapes = {"qkv": (h // 2, qn), "o": (cfg.num_heads * HEAD_DIM // 2, h),
              "gu": (h // 2, 2 * f), "dn": (f // 2, h)}
    if h % (2 * BLOCK) or f % (2 * BLOCK):
        return None
    rows: dict[str, list] = {k: [] for k in shapes}
    norms: dict[str, list] = {"in_s": [], "post_s": [], "qn_s": [], "kn_s": []}
    for p in layers:
        ws = {"qkv": leaf(p, "attn", "qkv"), "o": leaf(p, "attn", "o"),
              "gu": leaf(p, "mlp", "gateup"), "dn": leaf(p, "mlp", "down")}
        if any(w is None or tuple(w.q.shape) != shapes[k] for k, w in ws.items()):
            return None
        for k, w in ws.items():
            rows[k].append(w)
        norms["in_s"].append(p["input_norm"]["scale"])
        norms["post_s"].append(p["post_norm"]["scale"])
        norms["qn_s"].append(p["attn"]["q_norm"]["scale"])
        norms["kn_s"].append(p["attn"]["k_norm"]["scale"])

    def sz(ws):
        s = torch.stack([w.scale.to(torch.float32) for w in ws])
        z = torch.stack([(w.zero * w.scale).to(torch.float32) for w in ws])
        nl, nb, n = s.shape
        return (s.reshape(nl, 2, nb // 2, n).contiguous(),
                z.reshape(nl, 2, nb // 2, n).contiguous())

    out = {}
    for key, src in (("wq", "qkv"), ("wo", "o"), ("wgu", "gu"), ("wd", "dn")):
        out[key] = torch.stack([w.q for w in rows[src]]).contiguous()
    out["qkv_s"], out["qkv_zs"] = sz(rows["qkv"])
    out["o_s"], out["o_zs"] = sz(rows["o"])
    out["gu_s"], out["gu_zs"] = sz(rows["gu"])
    out["dn_s"], out["dn_zs"] = sz(rows["dn"])
    for key, vals in norms.items():
        out[key] = torch.stack([v.to(torch.float32) for v in vals]).contiguous()
    out["fn_s"] = final["scale"].to(torch.float32)[None].contiguous()

    emb = params.get("embed")
    if (isinstance(emb, QuantizedEmbedding) and emb.q_t is not None and emb.q_t_packed
            and emb.bits == 4 and emb.block == BLOCK and emb.q_t.shape[0] == h // 2
            and emb.q_t.shape[1] % BLOCK == 0):
        nbh, vpad = emb.scale_t.shape
        out["wh"] = emb.q_t.contiguous()
        out["h_s"] = emb.scale_t.to(torch.float32).reshape(1, 2, nbh // 2, vpad).contiguous()
        out["h_zs"] = (emb.zero_t * emb.scale_t).to(torch.float32).reshape(
            1, 2, nbh // 2, vpad).contiguous()
    return out


# ── plain PyTorch version ───────────────────────────────────────────────


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def _nibbles(q: torch.Tensor) -> torch.Tensor:
    """Packed int4 (K/2, N) -> its (K, N) nibble values as f32 (low nibble =
    rows [0, K/2))."""
    u = q.view(torch.uint8)
    return torch.cat([u & 0xF, u >> 4], dim=0).to(torch.float32)


def _dot(x: torch.Tensor, vals: torch.Tensor, s: torch.Tensor, zs: torch.Tensor) -> torch.Tensor:
    """(1, K) f32 @ nibble values (K, N) -> (1, N): per 128-row block
    (bf16(x).u)*s - sum(bf16(x))*zs, scales in the (2, NB/2, N) layout."""
    k, n = vals.shape
    nb = k // BLOCK
    xb = _bf16(x).reshape(nb, BLOCK)
    part = torch.einsum("bk,bkn->bn", xb, vals.reshape(nb, BLOCK, n))
    s, zs = s.reshape(nb, n), zs.reshape(nb, n)
    return (part * s - xb.sum(dim=1, keepdim=True) * zs).sum(dim=0, keepdim=True)


def _matvec(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, zs: torch.Tensor) -> torch.Tensor:
    return _dot(x, _nibbles(q), s, zs)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def _rot_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


_MATVECS = (("wq", "qkv"), ("wo", "o"), ("wgu", "gu"), ("wd", "dn"))


def _layer_weights(st: dict, l: int) -> dict:
    """Layer l's four matvecs as (nibble values, scales, zero*scales)."""
    return {w: (_nibbles(st[w][l]), st[f"{k}_s"][l], st[f"{k}_zs"][l]) for w, k in _MATVECS}


def _layer(st: dict, l: int, mats: dict, cfg, x: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
           pos: int, shift: int, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Layer l of the step on x (1, H) over this layer's (T, kvw) caches,
    whose row ``pos`` it writes in place; ``mats`` from :func:`_layer_weights`."""
    nh, nkv, hd, f = cfg.num_heads, cfg.num_kv_heads, HEAD_DIM, cfg.ffn_dim
    g, eps = nh // nkv, cfg.rms_eps
    qd, kvw = nh * hd, nkv * hd
    y = _rms(x, st["in_s"][l], eps)
    qkv = _dot(y, *mats["wq"])
    q = _rms(qkv[0, :qd].reshape(nh, hd), st["qn_s"][l], eps)
    k = _rms(qkv[0, qd : qd + kvw].reshape(nkv, hd), st["kn_s"][l], eps)
    v = qkv[0, qd + kvw :].reshape(nkv, hd)
    q = q * cos + _rot_half(q) * sin
    k = k * cos + _rot_half(k) * sin
    kr = _bf16(kc[shift:pos]).reshape(pos - shift, nkv, hd)
    vr = _bf16(vc[shift:pos]).reshape(pos - shift, nkv, hd)
    kc[pos] = k.reshape(kvw).to(kc.dtype)
    vc[pos] = v.reshape(kvw).to(vc.dtype)
    qs32 = (q * hd ** -0.5).reshape(nkv, g, hd)
    sc = torch.einsum("hgd,thd->hgt", _bf16(qs32), kr)
    snew = (qs32 * k[:, None, :]).sum(dim=-1, keepdim=True)
    allsc = torch.cat([sc, snew], dim=-1)
    e = torch.exp(allsc - allsc.amax(dim=-1, keepdim=True))
    pr = e / e.sum(dim=-1, keepdim=True)
    ctx = torch.einsum("hgt,thd->hgd", _bf16(pr[..., :-1]), vr) + pr[..., -1:] * v[:, None, :]
    x = x + _dot(ctx.reshape(1, qd), *mats["wo"])
    y = _rms(x, st["post_s"][l], eps)
    gu = _dot(y, *mats["wgu"])
    hact = torch.nn.functional.silu(gu[:, :f]) * gu[:, f:]
    return x + _dot(hact, *mats["wd"])


def fused_decode_step_reference(stacked: dict, cfg, x: torch.Tensor, k_cache: torch.Tensor,
                                v_cache: torch.Tensor, pos: int, shift: int,
                                cos: torch.Tensor, sin: torch.Tensor):
    """Plain PyTorch version of the kernel, same arguments and results as
    :func:`fused_decode_step` (the caches take row ``pos`` in place)."""
    st = stacked
    pos, shift = int(pos), int(shift)
    cos, sin = cos.reshape(1, HEAD_DIM).to(torch.float32), sin.reshape(1, HEAD_DIM).to(torch.float32)
    x = x.to(torch.float32).reshape(1, cfg.hidden)
    for l in range(k_cache.shape[0]):
        x = _layer(st, l, _layer_weights(st, l), cfg, x, k_cache[l], v_cache[l], pos, shift, cos,
                   sin)
    hidden = _rms(x, st["fn_s"], cfg.rms_eps)
    logits = None
    if "wh" in st:
        logits = _matvec(hidden, st["wh"], st["h_s"][0], st["h_zs"][0])
    return hidden, logits, k_cache, v_cache


# ── the plan ────────────────────────────────────────────────────────────


def matvec_smem(bn: int, parts: int, k: int, rows: int = MAX_ROWS) -> int:
    """Shared memory of a matvec block (``mv_smem`` in
    ``csrc/qwen_common.cuh``, which the card tests hold it to through
    ``qwen_matvec_smem``): every stage of the part's 128-row blocks
    (weight rows, x fragments, chunk sums), their scales, the exchange of
    the stages' partial sums, and the inbox of the cells it sums (``rows`` x
    BN cells shared by the parts, 64 at a time), one term per 128-row block
    of K."""
    mt = 2 if rows > 16 else 1
    slot = MV_STAGE * (bn + MV_PAD) + mt * 2048 + 2 * 16 * mt * 4
    nbj = k // 2 // BLOCK
    jper = nbj // parts
    share = -(-(-(-rows * bn // parts)) // 64) * 64
    exchange = MV_STAGES_PER_BLOCK * bn // 32 * 2 * mt * 16 * 32 * 4
    return jper * MV_STAGES_PER_BLOCK * slot + jper * 4 * bn * 4 + exchange + 2 * nbj * share * 4


@functools.lru_cache(maxsize=256)
def matvec_plan(k: int, n: int, paired: bool = False) -> tuple[int, int]:
    """(BN, parts) of the step's matvec for a packed (K/2, N) weight: column
    tiles BN wide, K/256 128-row blocks split into ``parts`` equal runs of at
    most :data:`MV_BLOCKS_PER_PART` blocks (a thread block cluster). BN is
    the widest of :data:`MV_WIDTHS` (64 and up for the paired gate|up) whose
    tiles, times the least such divisor of the block count up to
    :data:`MAX_PARTS` whose part fits in shared memory at :data:`MAX_ROWS`
    rows, reach :data:`SMS` blocks; where none does, the narrowest with the
    most parts. Depends on (K, N) alone: the sum behind an output never
    depends on the slot count."""
    nbj = k // 2 // BLOCK
    widths = [bn for bn in MV_WIDTHS if n % bn == 0 and (bn >= 64 or not paired)]
    if nbj < 1 or k % (2 * BLOCK) or not widths:
        raise ValueError(f"no matvec tile for K={k}, N={n}")
    divs = [d for d in range(1, min(nbj, MAX_PARTS) + 1)
            if nbj % d == 0 and nbj // d <= MV_BLOCKS_PER_PART]
    for bn in widths:
        s = next((d for d in divs if n // bn * d >= SMS and matvec_smem(bn, d, k) <= MAX_SMEM), None)
        if s is not None:
            return bn, s
    bn = widths[-1]
    return bn, max(d for d in divs if matvec_smem(bn, d, k) <= MAX_SMEM)


def attn_chunks(rows: int, min_rows: int = ATTN_MIN_ROWS, max_chunks: int = ATTN_MAX_CHUNKS) -> int:
    """Row chunks of an attention over ``rows`` cached rows (``attn_chunks``
    in ``csrc/aed_common.cuh``, which the AED steps share): at least
    ``min_rows`` a chunk, at most ``max_chunks``; it depends on the row
    count alone."""
    return max(1, min(max_chunks, -(-rows // min_rows)))


def chunk_rows(rows: int, chunks: int, c: int) -> tuple[int, int]:
    """[r0, r1) of chunk c: chunks of ceil(rows / chunks) rows (``chunk_rows``
    in ``csrc/aed_common.cuh``)."""
    n = -(-rows // chunks)
    r0 = min(rows, c * n)
    return r0, min(rows, r0 + n)


class DecodePlan(NamedTuple):
    """What both step kernels take beside their tensors: (BN, parts) of the
    q|k|v, o, gate|up, down and head matvecs ((0, 0) without a head), the
    attention's chunk rule and cluster size, the score rows a chunk holds,
    and whether the launches are chained (programmatic dependent launch).
    ``pdl`` is off only to profile the step's kernels one at a time (with
    chained launches they overlap): ``chip_smoke.step_profile``."""
    qkv: tuple[int, int]
    o: tuple[int, int]
    gu: tuple[int, int]
    down: tuple[int, int]
    head: tuple[int, int]
    attn_min_rows: int
    attn_max_chunks: int
    attn_cap: int
    pdl: bool = True

    def c_array(self):
        """The kernel's ``qwen::Plan`` as a ctypes int array."""
        vals = (*self.qkv, *self.o, *self.gu, *self.down, *self.head, self.attn_min_rows,
                self.attn_max_chunks, self.attn_cap, int(self.pdl))
        return (ctypes.c_int * len(vals))(*vals)


def decode_plan(cfg, t: int, vp: int = 0, pdl: bool = True) -> DecodePlan:
    """The plan of a step of ``cfg`` over caches of ``t`` rows (and a tied
    head of ``vp`` padded columns): one for every slot count. A chunk holds
    at most ``max(ATTN_MIN_ROWS, ceil(t / ATTN_MAX_CHUNKS))`` score rows
    (the kernel refuses less)."""
    h, f = cfg.hidden, cfg.ffn_dim
    qd = cfg.num_heads * HEAD_DIM
    qn = qd + 2 * cfg.num_kv_heads * HEAD_DIM
    return DecodePlan(matvec_plan(h, qn), matvec_plan(qd, h), matvec_plan(h, 2 * f, paired=True),
                      matvec_plan(f, h), matvec_plan(h, vp) if vp else (0, 0), ATTN_MIN_ROWS,
                      ATTN_MAX_CHUNKS, max(ATTN_MIN_ROWS, -(-t // ATTN_MAX_CHUNKS)), pdl)


# ── the CUDA kernel ─────────────────────────────────────────────────────


def build() -> tuple[Path, str]:
    """Compile the kernel (once per source and flags); return (library, nvcc log)."""
    return nvcc_build.build(SOURCE, NVCC_FLAGS)


_ORDER = ("in_s", "post_s", "qn_s", "kn_s", "fn_s", "wq", "qkv_s", "qkv_zs", "wo", "o_s", "o_zs",
          "wgu", "gu_s", "gu_zs", "wd", "dn_s", "dn_zs")


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            # x, cos, sin, 17 stacked arrays, wh, h_s, h_zs, k, v, hidden, logits, scratch;
            # 10 ints, eps, plan, stream
            lib.fused_decode.argtypes = ([ctypes.c_void_p] * 28 + [ctypes.c_int] * 10
                                         + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
            lib.fused_decode.restype = ctypes.c_int
            lib.fused_decode_scratch_floats.argtypes = [ctypes.c_int] * 4
            lib.fused_decode_scratch_floats.restype = ctypes.c_longlong
            # x, w, s, zs, out, scratch; rows, k, n, bn, parts; stream
            lib.qwen_matvec.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            lib.qwen_matvec.restype = ctypes.c_int
            lib.qwen_matvec_scratch_floats.argtypes = [ctypes.c_int] * 2
            lib.qwen_matvec_scratch_floats.restype = ctypes.c_longlong
            lib.qwen_matvec_smem.argtypes = [ctypes.c_int] * 4
            lib.qwen_matvec_smem.restype = ctypes.c_longlong
            lib.qwen_plan_limits.argtypes = [ctypes.c_void_p]
            lib.qwen_plan_limits.restype = None
            limits = (ctypes.c_int * 7)()
            lib.qwen_plan_limits(limits)
            ours = (MAX_PARTS, MV_BLOCKS_PER_PART, MV_STAGE, MV_PAD, MAX_SMEM, ATTN_MAX_CHUNKS,
                    PLAN_INTS)
            if tuple(limits) != ours:
                raise RuntimeError(f"{SOURCE.name} was built with the plan limits {tuple(limits)}, "
                                   f"the plan assumes {ours}")
            _lib = lib
    return _lib


def _stacked_shapes(nl: int, h: int, nh: int, nkv: int, f: int) -> dict:
    qn, qd = (nh + 2 * nkv) * HEAD_DIM, nh * HEAD_DIM
    return {"in_s": (nl, h), "post_s": (nl, h), "qn_s": (nl, HEAD_DIM), "kn_s": (nl, HEAD_DIM),
            "fn_s": (1, h),
            "wq": (nl, h // 2, qn), "qkv_s": (nl, 2, h // 256, qn), "qkv_zs": (nl, 2, h // 256, qn),
            "wo": (nl, qd // 2, h), "o_s": (nl, 2, qd // 256, h), "o_zs": (nl, 2, qd // 256, h),
            "wgu": (nl, h // 2, 2 * f), "gu_s": (nl, 2, h // 256, 2 * f),
            "gu_zs": (nl, 2, h // 256, 2 * f),
            "wd": (nl, f // 2, h), "dn_s": (nl, 2, f // 256, h), "dn_zs": (nl, 2, f // 256, h)}


def _check(name: str, t: torch.Tensor, shape: tuple, dtypes, dev: torch.device) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def fused_decode_step_cuda(stacked: dict, cfg, x: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos: int, shift: int,
                           cos: torch.Tensor, sin: torch.Tensor, plan: DecodePlan | None = None):
    """Launch the CUDA kernel; checks every argument and raises on what the
    kernel does not take (head width 128, 2 q heads a kv head, H and F
    multiples of 256, block-128 packed weights, f32 or bf16 caches of
    one dtype, ``0 <= shift <= pos < T``). ``plan`` defaults to
    :func:`decode_plan`'s."""
    global LAUNCHES
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"fused_decode_step_cuda needs CUDA tensors, got {dev}")
    h, nh, nkv, f = cfg.hidden, cfg.num_heads, cfg.num_kv_heads, cfg.ffn_dim
    if cfg.head_dim != HEAD_DIM or nh != GROUPS * nkv or h % 256 or f % 256:
        raise ValueError(f"the kernel takes head_dim {HEAD_DIM}, {GROUPS} q heads a kv head and "
                         f"H, F multiples of 256; got {cfg}")
    nl, t = k_cache.shape[0], k_cache.shape[1]
    for key, shape in _stacked_shapes(nl, h, nh, nkv, f).items():
        dtypes = (torch.int8,) if key.startswith("w") else (torch.float32,)
        _check(key, stacked[key], shape, dtypes, dev)
    head = "wh" in stacked
    vp = stacked["wh"].shape[1] if head else 0
    if head:
        if vp % BLOCK:
            raise ValueError(f"wh must be (H/2, V_pad) with V_pad a multiple of {BLOCK}, got {vp}")
        _check("wh", stacked["wh"], (h // 2, vp), (torch.int8,), dev)
        for key in ("h_s", "h_zs"):
            _check(key, stacked[key], (1, 2, h // 256, vp), (torch.float32,), dev)
    _check("x", x, (1, h), (torch.float32,), dev)
    for name, a in (("cos", cos), ("sin", sin)):
        _check(name, a, (1, HEAD_DIM), (torch.float32,), dev)
    cdt = k_cache.dtype
    if cdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"caches must be float32 or bfloat16, got {cdt}")
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        _check(name, c, (nl, t, nkv * HEAD_DIM), (cdt,), dev)
    pos, shift = int(pos), int(shift)
    if not 0 <= shift <= pos < t:
        raise ValueError(f"need 0 <= shift <= pos < {t}, got shift {shift}, pos {pos}")
    plan = plan or decode_plan(cfg, t, vp)
    lib = _load()
    scratch = torch.empty((lib.fused_decode_scratch_floats(h, nh, nkv, f),),
                          device=dev, dtype=torch.float32)
    hidden = torch.empty((1, h), device=dev, dtype=torch.float32)
    logits = torch.empty((1, vp), device=dev, dtype=torch.float32) if head else None
    null = ctypes.c_void_p(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_decode(
            x.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            *(stacked[k].data_ptr() for k in _ORDER),
            *((stacked[k].data_ptr() for k in ("wh", "h_s", "h_zs")) if head else (null,) * 3),
            k_cache.data_ptr(), v_cache.data_ptr(), hidden.data_ptr(),
            logits.data_ptr() if head else null, scratch.data_ptr(),
            nl, h, nh, nkv, f, t, vp, pos, shift, int(cdt == torch.bfloat16),
            cfg.rms_eps, plan.c_array(), stream)
    if err != 0:
        raise RuntimeError(f"fused_decode launch failed: CUDA error {err}")
    with _count_lock:
        LAUNCHES += 1
    return hidden, logits, k_cache, v_cache


def nibble_matvec_cuda(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                       zs: torch.Tensor) -> torch.Tensor:
    """The step's matvec alone, on the card: x (B, K) f32, B <= 32, through a
    packed (K/2, N) weight with scales and zero*scales (2, K/256, N) as the
    stacked weights hold them -> (B, N) f32, with :func:`matvec_plan`'s tile.
    Its plain version is :func:`_dot`, row by row."""
    global MATVEC_LAUNCHES
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"nibble_matvec_cuda needs CUDA tensors, got {dev}")
    rows, k = x.shape
    n = q.shape[1]
    if not 1 <= rows <= MAX_ROWS or k % (2 * BLOCK) or n % 32:
        raise ValueError(f"the matvec takes 1..{MAX_ROWS} rows, K a multiple of {2 * BLOCK} and N of "
                         f"32; got x {tuple(x.shape)}, q {tuple(q.shape)}")
    _check("x", x, (rows, k), (torch.float32,), dev)
    _check("q", q, (k // 2, n), (torch.int8,), dev)
    for name, a in (("s", s), ("zs", zs)):
        _check(name, a, (2, k // 2 // BLOCK, n), (torch.float32,), dev)
    bn, parts = matvec_plan(k, n)
    lib = _load()
    scratch = torch.empty((lib.qwen_matvec_scratch_floats(rows, k),), device=dev, dtype=torch.float32)
    out = torch.empty((rows, n), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        err = lib.qwen_matvec(x.data_ptr(), q.data_ptr(), s.data_ptr(), zs.data_ptr(), out.data_ptr(),
                              scratch.data_ptr(), rows, k, n, bn, parts,
                              torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"qwen_matvec launch failed: CUDA error {err}")
    with _count_lock:
        MATVEC_LAUNCHES += 1
    return out


def fused_decode_step(stacked: dict, cfg, x: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, pos: int, shift: int,
                      cos: torch.Tensor, sin: torch.Tensor):
    """One batch-1 Qwen3 decode step.

    Args:
      stacked: from :func:`stack_decode_params`.
      x: (1, H) f32 input embedding row.
      k_cache/v_cache: (NL, T, n_kv * 128) head-major rows, f32 or bf16; row
        ``pos`` is written in place, every other row is left as it was.
      pos: this token's cache slot; shift: the left-pad width (cached rows
        below it are masked).
      cos/sin: (1, 128) f32 RoPE rows of the logical position.

    Returns ``(hidden, logits, k_cache, v_cache)``: ``hidden`` (1, H) f32 is
    final-normalized; ``logits`` (1, V_pad) f32 when the stacked weights
    carry the head (pad columns exactly 0), else None. On a CPU tensor this
    is the plain version; on a CUDA tensor the kernel.
    """
    if x.device.type == "cpu":
        return fused_decode_step_reference(stacked, cfg, x, k_cache, v_cache, pos, shift, cos, sin)
    return fused_decode_step_cuda(stacked, cfg, x, k_cache, v_cache, pos, shift, cos, sin)
