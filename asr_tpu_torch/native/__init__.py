"""ctypes bindings for the native audio DSP library.

The port's own copy of ``asr_tpu/native`` (the C++ source ``audio_dsp.cc``
is the same below its header comment). Builds the library from
``audio_dsp.cc`` with g++ at first use into the gitignored
``asr_tpu_torch/_build/``, named by a hash of the source so a stale build
is never loaded, and exposes numpy-friendly wrappers. Every entry point has
a pure-Python fallback in ``asr_tpu_torch.runtime``; a missing toolchain
or a failed build disables the native path.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import math
import os
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "audio_dsp.cc"
_BUILD_DIR = _DIR.parent / "_build"
_lib = None
_failed = False


def _library() -> Path | None:
    """Build the library once per source content; None if g++ fails."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = _BUILD_DIR / f"libasr_audio_dsp-{digest}.so"
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(_BUILD_DIR / "audio_dsp.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not so.exists():
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-pthread", "-std=c++17",
                                str(_SRC), "-o", str(tmp)], check=True, capture_output=True)
                os.replace(tmp, so)
    except Exception:
        return None
    return so


def get_lib():
    """Load the native library (building it at first use), or None."""
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    so = _library()
    try:
        lib = ctypes.CDLL(str(so)) if so is not None else None
    except OSError:
        lib = None
    if lib is None:
        _failed = True
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    i16p = ctypes.POINTER(ctypes.c_int16)
    lib.design_lowpass.argtypes = [ctypes.c_double, ctypes.c_double, ctypes.c_double,
                                   ctypes.c_long, f32p]
    lib.resample_poly.argtypes = [f32p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
                                  f32p, ctypes.c_long, f32p, ctypes.c_long]
    lib.downmix_interleaved.argtypes = [f32p, ctypes.c_long, ctypes.c_int, f32p]
    lib.pcm16_to_float.argtypes = [i16p, ctypes.c_long, f32p]
    lib.rms.argtypes = [f32p, ctypes.c_long]
    lib.rms.restype = ctypes.c_double
    lib.scale_inplace.argtypes = [f32p, ctypes.c_long, ctypes.c_float]
    lib.load_wav_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_long, f32p, ctypes.POINTER(ctypes.c_long), ctypes.c_int,
    ]
    lib.load_wav_batch.restype = ctypes.c_int
    lib.flac_decode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.flac_decode.restype = ctypes.c_long
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def resample(x: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Polyphase resample (Kaiser windowed-sinc, scipy-compatible length)."""
    lib = get_lib()
    assert lib is not None
    g = math.gcd(src_rate, dst_rate)
    up, down = dst_rate // g, src_rate // g
    if up == down:
        return np.ascontiguousarray(x, np.float32)
    x = np.ascontiguousarray(x, np.float32)
    max_ud = max(up, down)
    half_len = 10 * max_ud                       # scipy resample_poly default
    taps = 2 * half_len + 1
    filt = np.empty(taps, np.float32)
    # scipy uses kaiser beta 5.0 with cutoff 1/max(up,down), gain up.
    lib.design_lowpass(1.0 / max_ud, 5.0, float(up), taps, _fptr(filt))
    n_out = -(-len(x) * up // down)
    out = np.empty(n_out, np.float32)
    lib.resample_poly(_fptr(x), len(x), up, down, _fptr(filt), taps, _fptr(out), n_out)
    return out


def downmix(x: np.ndarray) -> np.ndarray:
    """(channels, n) -> (n,) via the native kernel."""
    lib = get_lib()
    assert lib is not None
    channels, frames = x.shape
    inter = np.ascontiguousarray(x.T, np.float32)  # interleaved
    out = np.empty(frames, np.float32)
    lib.downmix_interleaved(_fptr(inter), frames, channels, _fptr(out))
    return out


def rms(x: np.ndarray) -> float:
    lib = get_lib()
    assert lib is not None
    x = np.ascontiguousarray(x, np.float32)
    return float(lib.rms(_fptr(x), len(x)))


def flac_decode(data: bytes):
    """Native FLAC stream decode -> (samples int32 (N,) or (N, C), rate,
    depth). Raises ValueError on malformed streams (same subset as the
    pure-Python ``runtime.flac`` decoder, which remains the fallback)."""
    lib = get_lib()
    if lib is None:
        raise ValueError("native FLAC decoder unavailable")
    buf = np.frombuffer(data, np.uint8)
    # capacity guess: a FLAC frame cannot code a sample in < 1 bit, so
    # 8 * n_bytes samples TOTAL is a safe upper bound; retry bigger if the
    # stream is pathological (constant frames compress below 1 bit/sample).
    cap = max(1 << 16, 8 * len(buf))
    for _ in range(3):
        out = np.empty(cap, np.int32)
        ch = ctypes.c_int(0)
        rate = ctypes.c_int(0)
        depth = ctypes.c_int(0)
        n = lib.flac_decode(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cap, ctypes.byref(ch), ctypes.byref(rate), ctypes.byref(depth))
        if n == -4:
            cap *= 8
            continue
        if n < 0:
            raise ValueError(f"native FLAC decode failed (code {n})")
        c = ch.value
        samples = out[: n * c]
        if c > 1:
            samples = samples.reshape(-1, c)
        return samples, rate.value, depth.value
    raise ValueError("native FLAC decode: capacity retry exhausted")


def load_wav_batch(paths, target_rate: int, window_samples: int,
                   n_threads: int = 0):
    """Decode + downmix + resample WAV files in parallel C++ threads into a
    fixed-shape (N, window) batch (int16 numeric range). Returns
    (batch float32 (N, window), valid int64 (N,)); valid[i] = -1 marks a
    file the native parser could not handle (caller falls back to the
    Python ingest for those rows)."""
    lib = get_lib()
    assert lib is not None
    n = len(paths)
    out = np.zeros((n, window_samples), np.float32)
    valid = np.zeros((n,), np.int64)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    lib.load_wav_batch(arr, n, target_rate, window_samples, _fptr(out),
                       valid.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                       n_threads)
    return out, valid
