"""Dequant-fused int8, packed-int4 and packed-int2 matmuls for
weight-only-quantized linears.

Counterpart of ``asr_tpu/ops/quant_matmul.py``. ``quant_dense`` computes
``x @ ((q - zero) * scale)`` for a :class:`~asr_tpu_torch.quant.quantize.QuantizedLinear`
leaf. On a CUDA tensor it launches a hand-written Hopper kernel (built with
``nvcc`` for ``sm_90a`` at first use, bound with ``ctypes``) or raises:
``asr_tpu_torch/csrc/quant_matmul_int8.cu`` for unpacked static leaves of
any bit width (centered int8 storage, as the JAX package routes them),
``asr_tpu_torch/csrc/quant_matmul_int4.cu`` for packed 4-bit leaves (low
nibble = rows ``[0, K/2)``, high nibble = rows ``[K/2, K)``) and
``asr_tpu_torch/csrc/quant_matmul_int2.cu`` for packed 2-bit leaves (bit
pair ``2j:2j+2`` = rows ``[jK/4, (j+1)K/4)``). On a CPU tensor it runs the
plain PyTorch versions, :func:`quant_dense_reference`,
:func:`quant_dense_p4_reference` and :func:`quant_dense_p2_reference`.
Dynamic-activation int8 leaves do not come here: ``layers/transformer.dense``
routes them to ``quant/quantize.dynamic_quant_dense``, and ``quant_dense``
raises on one given to it directly.

Matmul mode, as in the JAX package:
  ``"f32"``:  the exact f32 product of x and the dequantized weight;
  ``"bf16"``: x is rounded to bf16 (nearest even) first; the kernels take
              the raw integers on tensor cores with f32 accumulation and
              apply each scale block's affine to the f32 partial, as the
              TPU kernels' bf16 branch does (the plain versions dequantize
              in f32: the same function up to f32 rounding). The split
              of K behind each output is fixed by the weight
              (:func:`packed_plan`, :func:`int8_split`), so a row of a
              batched call is bitwise the row alone.
Precedence: an explicit ``mm=`` argument, then ``set_quant_config(mm=...)``,
then ``"bf16"``.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path

import torch

from asr_tpu_torch.ops import nvcc_build
from asr_tpu_torch.quant.quantize import dequantize_weight

# Kernel launches since import (or since a caller reset them to 0).
LAUNCHES = 0       # the int8 kernel
LAUNCHES_INT4 = 0  # the packed-int4 kernel
LAUNCHES_INT2 = 0  # the packed-int2 kernel

_CONFIG: dict = {"mm": None}

SOURCE = nvcc_build.CSRC / "quant_matmul_int8.cu"
SOURCE_INT4 = nvcc_build.CSRC / "quant_matmul_int4.cu"
SOURCE_INT2 = nvcc_build.CSRC / "quant_matmul_int2.cu"
NVCC_FLAGS = nvcc_build.NVCC_FLAGS
PACKED_STAGE = 32  # packed rows a stage of the packed kernels holds; the block must be a multiple
SMS = 132          # streaming multiprocessors of an H100 SXM, which a decode call's blocks should cover
PACKED_MAX_SPLIT = 8  # split parts of a tile: one thread block cluster, at most the portable size
INT8_STAGE = 64    # padded rows of K a stage of the int8 kernel holds; each scale block pads to a multiple
INT8_TILE_N = (128, 64, 32)  # column tile widths of the int8 kernel's cluster schedule at M <= 16, widest first
INT8_CLUSTER_TILES = ((16, 32), (16, 64), (16, 128), (64, 128))  # (BM, BN) of its cluster schedule
INT8_WALK_TILES = ((64, 128), (64, 64))  # (BM, BN) of its walking schedule
INT8_WALK_MAX_K = 2048  # the narrow walking tile only where K is short: longer K splits better

_lib = None
_packed_libs: dict = {}  # kernel name -> the loaded packed-int4 / packed-int2 library
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def set_quant_config(mm: str | None = None) -> None:
    """Process-wide matmul mode for quantized linears."""
    if mm is not None:
        _check_mm(mm)
        _CONFIG["mm"] = mm


def _check_mm(mm: str) -> str:
    if mm not in ("bf16", "f32"):
        raise ValueError(f"mm must be 'bf16' or 'f32', got {mm!r}")
    return mm


def _resolve_mm(mm: str | None) -> str:
    if mm is None:
        mm = _CONFIG["mm"] or "bf16"
    return _check_mm(mm)


def quant_dense_reference(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                          zero: torch.Tensor, block: int, mm: str) -> torch.Tensor:
    """Plain PyTorch version of the kernel: dequantize in f32, then ``x' @ w``."""
    w = dequantize_weight({"q": q, "scale": scale, "zero": zero, "block": block})
    if _check_mm(mm) == "bf16":
        x = x.to(torch.bfloat16).to(torch.float32)
    return x @ w


def quant_dense_p4_reference(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                             zero: torch.Tensor, block: int, mm: str) -> torch.Tensor:
    """Plain PyTorch version of the int4 kernel: unpack the nibble halves,
    dequantize in f32 (unsigned zero), then ``x' @ w``."""
    w = dequantize_weight({"q": q, "scale": scale, "zero": zero, "block": block,
                           "bits": 4, "packed": True})
    if _check_mm(mm) == "bf16":
        x = x.to(torch.bfloat16).to(torch.float32)
    return x @ w


def quant_dense_p2_reference(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                             zero: torch.Tensor, block: int, mm: str) -> torch.Tensor:
    """Plain PyTorch version of the int2 kernel: unpack the four 2-bit
    quarters, dequantize in f32 (unsigned zero), then ``x' @ w``."""
    w = dequantize_weight({"q": q, "scale": scale, "zero": zero, "block": block,
                           "bits": 2, "packed": True})
    if _check_mm(mm) == "bf16":
        x = x.to(torch.bfloat16).to(torch.float32)
    return x @ w


# x, q, scale, zero, out, workspace; M, K, N, block, bf16, splits, BN, BM; stream
PACKED_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
# the same, then walk (the int8 kernel's large-M schedule); stream
INT8_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def load_library(source: Path, salt: str = ""):
    """Build (once) and load the int8, int4 or int2 kernel's library, its C
    entry typed. The wrappers use the unsalted build; a ``salt`` loads a
    second library of the same source beside it (the linkage check:
    chip_smoke.py phase 25 and the card tests)."""
    path, _ = nvcc_build.build(source, NVCC_FLAGS, salt=salt)
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, source.stem)
    fn.argtypes = INT8_ARGTYPES if source == SOURCE else PACKED_ARGTYPES
    fn.restype = ctypes.c_int
    return lib


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = load_library(SOURCE)
    return _lib


def _load_packed(source: Path, name: str):
    with _lib_lock:
        if name not in _packed_libs:
            _packed_libs[name] = load_library(source)
    return _packed_libs[name]


def _check_operands(name: str, x, q, scale, zero) -> None:
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    for arg, t, dtype in (("x", x, torch.float32), ("q", q, torch.int8),
                          ("scale", scale, torch.float32), ("zero", zero, torch.float32)):
        if t.device != dev:
            raise ValueError(f"{arg} is on {t.device}, x on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{arg} must be {dtype}, got {t.dtype}")
        if t.ndim != 2 or not t.is_contiguous():
            raise ValueError(f"{arg} must be a contiguous 2-D tensor, got shape {tuple(t.shape)}")


@functools.lru_cache(maxsize=1024)
def packed_plan(m: int, k: int, n: int, parts: int, block: int) -> tuple[int, int, int]:
    """(S, BN, BM) of a bf16-mode packed call: K/``parts`` packed rows split
    into S parts of whole scale blocks, output tiles BN columns wide and BM
    rows high. BN is the widest of 128, 64, 32, 16 whose column tiles, times
    some S that divides the scale blocks (so every part is as long) and is
    at most :data:`PACKED_MAX_SPLIT`, give :data:`SMS` blocks, and S the
    least such divisor; both depend on (K, N, block, parts) only, so the sum
    behind each output never depends on M. M picks BM alone."""
    nbk = k // parts // block
    for bn in (128, 64, 32, 16):
        tiles = -(-n // bn)
        s = next((d for d in range(-(-SMS // tiles), min(nbk, PACKED_MAX_SPLIT) + 1) if nbk % d == 0),
                 max(d for d in range(1, min(nbk, PACKED_MAX_SPLIT) + 1) if nbk % d == 0))
        if tiles * s >= SMS:
            break
    bm = 16 if m <= 16 else (32 if bn == 128 else 64)
    return s, bn, bm


def packed_workspace(m: int, k: int) -> int:
    """f32 words of a bf16-mode call's workspace (``Layout`` in
    ``csrc/packed_common.cuh``): x in bf16 fragment order for M rounded up
    to 16, then the row sums of each stage's x."""
    mpad = -(-m // 16) * 16
    return mpad * k // 2 + k // PACKED_STAGE * mpad


def _divisors(n: int, most: int) -> list[int]:
    return [d for d in range(1, min(n, most) + 1) if n % d == 0]


@functools.lru_cache(maxsize=1024)
def int8_split(k: int, n: int, block: int) -> tuple[int, int]:
    """(V, BN) of the int8 kernel's bf16 mode for a (K, N) weight: V splits
    the K/``block`` scale blocks into V contiguous equal parts, so each
    output is ``((part_0 + part_1) + ...) + part_{V-1}``, each part folded
    block by block; BN is the cluster schedule's tile width. BN is the
    widest of :data:`INT8_TILE_N` whose column tiles, times the least
    divisor V of the block count (at most :data:`PACKED_MAX_SPLIT`, a thread
    block cluster) that reaches :data:`SMS` blocks, fill the card at M <= 16;
    where none does, BN is the narrowest and V the largest such divisor.
    Both depend on (K, N, block) only: the sum order never depends on M."""
    divs = _divisors(k // block, PACKED_MAX_SPLIT)
    for bn in INT8_TILE_N:
        tiles = -(-n // bn)
        v = next((d for d in divs if tiles * d >= SMS), None)
        if v is not None:
            return v, bn
    return divs[-1], INT8_TILE_N[-1]


@functools.lru_cache(maxsize=4096)
def int8_plan(m: int, k: int, n: int, block: int) -> tuple[int, int, int, bool]:
    """(V, BN, BM, walk) of a bf16-mode int8 call. V is :func:`int8_split`'s;
    the schedule follows M. Up to 16 rows, the V parts of a 16 x BN tile
    (BN from :func:`int8_split`) are one thread block cluster. Above, one
    block walks its tile's V parts in order where the 64 x 128 walking tiles
    number at least :data:`SMS` (or the 64 x 64 ones do and K is at most
    :data:`INT8_WALK_MAX_K`); otherwise the parts of a 64 x 128 tile form a
    cluster. Every schedule adds the same parts in the same order, so a row
    is bitwise the same under each. (The choices follow device times of
    every tile at the main paths' shapes on an H100: PERF.md.)"""
    v, bn = int8_split(k, n, block)
    if m <= 16:
        return v, bn, 16, False
    rows = -(-m // 64)
    if rows * -(-n // 128) >= SMS:
        return v, 128, 64, True
    if k <= INT8_WALK_MAX_K and rows * -(-n // 64) >= SMS:
        return v, 64, 64, True
    return v, 128, 64, False


def int8_workspace(m: int, k: int, block: int) -> int:
    """f32 words of a bf16-mode int8 call's workspace (``i8::Layout`` in
    ``csrc/quant_matmul_int8.cu``): x in bf16 fragment order for M rounded
    up to 16 over K with each scale block padded to a multiple of
    :data:`INT8_STAGE` rows, then the row sums of each stage's x."""
    mpad = -(-m // 16) * 16
    kp = k // block * (-(-block // INT8_STAGE) * INT8_STAGE)
    return mpad * kp // 2 + kp // INT8_STAGE * mpad


def check_packed_shapes(parts: int, x_shape, q_shape, scale_shape, zero_shape, block: int) -> None:
    """Raise ValueError for what the packed kernels do not take."""
    m, k = x_shape
    kp, n = q_shape
    if (k != parts * kp or kp == 0 or block <= 0 or block % PACKED_STAGE or kp % block):
        raise ValueError(f"bad shapes: x {tuple(x_shape)}, packed q {tuple(q_shape)}, block {block} "
                         f"(K/{parts} must be a positive multiple of the block, and the block of "
                         f"{PACKED_STAGE})")
    if tuple(scale_shape) != (k // block, n) or tuple(zero_shape) != (k // block, n):
        raise ValueError(f"scale/zero must be {(k // block, n)}, got "
                         f"{tuple(scale_shape)} / {tuple(zero_shape)}")
    if max(k, n) >= 2**31 or m > 32 * 65535:  # int sizes; grid.y counts row tiles of 32 or more
        raise ValueError(f"shape too large for the kernel: {(m, k, n)}")


def _packed_launch(name: str, parts: int, x: torch.Tensor, q: torch.Tensor,
                   scale: torch.Tensor, zero: torch.Tensor, block: int, mm: str,
                   lib=None) -> torch.Tensor:
    """Checks and launch shared by the int4 (``parts`` = 2) and int2
    (``parts`` = 4) kernels; returns the (M, N) f32 output. bf16 mode runs
    :func:`packed_plan`'s split with a :func:`packed_workspace`; f32 mode
    takes the CUDA-core kernel, which needs neither. ``lib``: another
    library of the same source (:func:`load_library`) instead of the
    wrapper's."""
    mm = _check_mm(mm)
    _check_operands(name, x, q, scale, zero)
    check_packed_shapes(parts, x.shape, q.shape, scale.shape, zero.shape, block)
    if mm == "bf16" and any(t.data_ptr() % 16 for t in (x, q, scale, zero)):
        raise ValueError(f"{name} in bf16 mode needs 16-byte aligned operands (cp.async)")
    m, k = x.shape
    n = q.shape[1]
    if m == 0 or n == 0:
        return torch.empty((m, n), device=x.device, dtype=torch.float32)
    lib = lib or _load_packed(SOURCE_INT4 if parts == 2 else SOURCE_INT2, name)
    s, bn, bm = packed_plan(m, k, n, parts, block) if mm == "bf16" else (1, 0, 0)
    # one allocation: the output, then (bf16) the workspace at a 16-byte boundary
    out_words = -(-m * n // 4) * 4
    buf = torch.empty(out_words + (packed_workspace(m, k) if mm == "bf16" else 0), device=x.device,
                      dtype=torch.float32)
    out = buf[: m * n].view(m, n)
    ws = buf[out_words:].data_ptr() if mm == "bf16" else None
    if x.device.index == torch.cuda.current_device():
        err = _call_packed(lib, name, x, q, scale, zero, out, ws, block, mm, s, bn, bm)
    else:
        with torch.cuda.device(x.device):
            err = _call_packed(lib, name, x, q, scale, zero, out, ws, block, mm, s, bn, bm)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out


def _call_packed(lib, name, x, q, scale, zero, out, ws, block, mm, s, bn, bm) -> int:
    """The C call on the current device's current stream; returns its error code."""
    (m, k), n = x.shape, q.shape[1]
    return getattr(lib, name)(x.data_ptr(), q.data_ptr(), scale.data_ptr(), zero.data_ptr(),
                              out.data_ptr(), ws, m, k, n, int(block), int(mm == "bf16"), s, bn, bm,
                              torch.cuda.current_stream().cuda_stream)


def quant_matmul_int4(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                      zero: torch.Tensor, block: int, mm: str) -> torch.Tensor:
    """Launch the CUDA kernel: x (M, K) f32 @ dequant(q (K/2, N) packed int4,
    scale / unsigned zero (K / block, N)) -> (M, N) f32."""
    global LAUNCHES_INT4
    out = _packed_launch("quant_matmul_int4", 2, x, q, scale, zero, block, mm)
    if out.numel():
        with _count_lock:
            LAUNCHES_INT4 += 1
    return out


def quant_matmul_int2(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                      zero: torch.Tensor, block: int, mm: str) -> torch.Tensor:
    """Launch the CUDA kernel: x (M, K) f32 @ dequant(q (K/4, N) packed int2,
    scale / unsigned zero (K / block, N)) -> (M, N) f32."""
    global LAUNCHES_INT2
    out = _packed_launch("quant_matmul_int2", 4, x, q, scale, zero, block, mm)
    if out.numel():
        with _count_lock:
            LAUNCHES_INT2 += 1
    return out


def quant_matmul_int8(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                      zero: torch.Tensor, block: int, mm: str,
                      plan: tuple[int, int, int, bool] | None = None) -> torch.Tensor:
    """Launch the CUDA kernel: x (M, K) f32 @ dequant(q (K, N) int8) -> (M, N)
    f32. bf16 mode runs ``plan`` ((V, BN, BM, walk); :func:`int8_plan` by
    default) with an :func:`int8_workspace`; f32 mode takes the CUDA-core
    kernel, which needs neither."""
    global LAUNCHES
    out = _int8_launch(x, q, scale, zero, block, mm, plan)
    if out.numel():
        with _count_lock:
            LAUNCHES += 1
    return out


def _int8_launch(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                 block: int, mm: str, plan: tuple[int, int, int, bool] | None = None,
                 lib=None) -> torch.Tensor:
    """Checks and launch of the int8 kernel; returns the (M, N) f32 output.
    ``lib``: another library of the same source (:func:`load_library`)
    instead of the wrapper's."""
    mm = _check_mm(mm)
    _check_operands("quant_matmul_int8", x, q, scale, zero)
    m, k = x.shape
    n = q.shape[1]
    if q.shape[0] != k or block <= 0 or k % block:
        raise ValueError(f"bad shapes: x {tuple(x.shape)}, q {tuple(q.shape)}, block {block}")
    if scale.shape != (k // block, n) or zero.shape != (k // block, n):
        raise ValueError(f"scale/zero must be {(k // block, n)}, got "
                         f"{tuple(scale.shape)} / {tuple(zero.shape)}")
    if max(k, n) >= 2**31 or -(-m // 64) > 65535:  # int sizes; grid.y counts 64-row tiles (16 up to M = 16)
        raise ValueError(f"shape too large for the kernel: {(m, k, n)}")
    if mm == "bf16" and any(t.data_ptr() % 16 for t in (q, scale, zero)):
        raise ValueError("quant_matmul_int8 in bf16 mode needs 16-byte aligned q, scale and zero (cp.async)")
    if m == 0 or n == 0:
        return torch.empty((m, n), device=x.device, dtype=torch.float32)
    lib = lib or _load()
    v, bn, bm, walk = (plan or int8_plan(m, k, n, block)) if mm == "bf16" else (1, 0, 0, False)
    # one allocation: the output, then (bf16) the workspace at a 16-byte boundary
    out_words = -(-m * n // 4) * 4
    buf = torch.empty(out_words + (int8_workspace(m, k, block) if mm == "bf16" else 0),
                      device=x.device, dtype=torch.float32)
    out = buf[: m * n].view(m, n)
    ws = buf[out_words:].data_ptr() if mm == "bf16" else None
    args = (x.data_ptr(), q.data_ptr(), scale.data_ptr(), zero.data_ptr(), out.data_ptr(), ws,
            m, k, n, int(block), int(mm == "bf16"), v, bn, bm, int(walk))
    if x.device.index == torch.cuda.current_device():
        err = lib.quant_matmul_int8(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(x.device):
            err = lib.quant_matmul_int8(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"quant_matmul_int8 launch failed: CUDA error {err}")
    return out


def quant_dense(x: torch.Tensor, qleaf, mm: str | None = None) -> torch.Tensor:
    """Batched dense through a static quantized weight: (..., K) -> (..., N).
    Packed 4-bit and 2-bit leaves take their own kernels; every unpacked
    leaf, whatever its bit width, is centered int8 and takes the int8
    kernel."""
    packed = "packed" in qleaf and bool(qleaf["packed"])
    if "dynamic" in qleaf and bool(qleaf["dynamic"]):
        raise NotImplementedError("a dynamic-activation int8 leaf takes "
                                  "quant.quantize.dynamic_quant_dense (layers/transformer.dense "
                                  "routes it there), not quant_dense")
    bits = int(qleaf["bits"])
    if packed and bits not in (2, 4):
        raise ValueError(f"packed storage exists for 2 and 4 bits only, got bits={bits}")
    mode = _resolve_mm(mm)
    q, scale, zero, block = qleaf["q"], qleaf["scale"], qleaf["zero"], int(qleaf["block"])
    k = x.shape[-1]
    n = q.shape[1]
    # the kernels take f32 rows: f16 / bf16 activations (an artifact built
    # from a half-precision checkpoint) widen exactly, and the output
    # returns in their dtype, as the JAX package's product does
    x2 = x.reshape(-1, k).to(torch.float32).contiguous()
    if x2.device.type == "cpu":
        ref = (quant_dense_reference if not packed else
               quant_dense_p4_reference if bits == 4 else quant_dense_p2_reference)
        out = ref(x2, q, scale, zero, block, mode)
    else:
        launch = (quant_matmul_int8 if not packed else
                  quant_matmul_int4 if bits == 4 else quant_matmul_int2)
        out = launch(x2, q, scale, zero, block, mode)
    return out.reshape(*x.shape[:-1], n).to(x.dtype)
