"""One batch-1 AED decode step (all decoder layers + the q8 tied head).

Counterpart of ``asr_tpu/ops/fused_aed_step.py``. The pre-LN AED decoder
block shared by Whisper, FireRed and Dolphin (``layers/transformer
.decoder_block``): per layer LN + self q|k|v, self-attention over the cache
plus the fresh row (which is written into the cache at ``pos`` in place),
o-proj, LN + cross-q, cross-attention over the first ``tc_valid`` cross
rows, cross-o, LN + exact-GELU MLP; then the final LN and the q8 tied head.

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
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from pathlib import Path

import torch

from asr_tpu_torch.ops import nvcc_build
from asr_tpu_torch.quant.quantize import QuantizedEmbedding, QuantizedLinear

# Kernel launches since import (or since a caller reset it to 0): one per step.
LAUNCHES = 0

SOURCE = nvcc_build.CSRC / "fused_aed_step.cu"
NVCC_FLAGS = nvcc_build.NVCC_FLAGS
BLOCK = 128          # quantization block the kernel takes
HEAD_DIM = 64        # head width the kernel takes
EPS = 1e-5

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
            lib.fused_aed_step.argtypes = ([ctypes.c_void_p] * 26 + [ctypes.c_int] * 10
                                           + [ctypes.c_float, ctypes.c_void_p])
            lib.fused_aed_step.restype = ctypes.c_int
            lib.fused_aed_step_scratch_floats.argtypes = [ctypes.c_int] * 6
            lib.fused_aed_step_scratch_floats.restype = ctypes.c_longlong
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


def fused_aed_step_cuda(stacked: dict, geom: AedGeom, x: torch.Tensor,
                        k_self: torch.Tensor, v_self: torch.Tensor,
                        cross_k: torch.Tensor, cross_v: torch.Tensor,
                        pos: int, tc_valid: int | None = None):
    """Launch the CUDA kernel; checks every argument and raises on what the
    kernel does not take (it takes head_dim 64, D and F multiples of 128,
    block-128 q8 weights, and f32 or bf16 caches of one dtype)."""
    global LAUNCHES
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"fused_aed_step_cuda needs CUDA tensors, got {dev}")
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
    tc_valid = t_cross if tc_valid is None else int(tc_valid)
    pos = int(pos)
    if not 0 <= pos < t_self:
        raise ValueError(f"pos {pos} outside the self cache of {t_self} rows")
    if not 1 <= tc_valid <= t_cross:
        raise ValueError(f"tc_valid {tc_valid} outside [1, {t_cross}]")
    lib = _load()
    scratch = torch.empty((lib.fused_aed_step_scratch_floats(d, f, h, t_self, t_cross, vp),),
                          device=dev, dtype=torch.float32)
    logits = torch.empty((1, vp), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_aed_step(
            x.data_ptr(), *(stacked[k].data_ptr() for k in shapes),
            k_self.data_ptr(), v_self.data_ptr(), cross_k.data_ptr(), cross_v.data_ptr(),
            logits.data_ptr(), scratch.data_ptr(),
            nl, d, h, f, t_self, t_cross, vp, pos, tc_valid, int(cdt == torch.bfloat16),
            EPS, stream)
    if err != 0:
        raise RuntimeError(f"fused_aed_step launch failed: CUDA error {err}")
    with _count_lock:
        LAUNCHES += 1
    return logits, k_self, v_self


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
