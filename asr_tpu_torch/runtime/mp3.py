"""MP3 ingest via ctypes bindings to the system ``libmpg123``.

The port's own copy of ``asr_tpu/runtime/mp3.py``.

Fallback order: libmpg123 -> ffmpeg subprocess -> clear error.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import glob
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_ENC_SIGNED_16 = 0x10 | 0x80  # MPG123_ENC_16 | MPG123_ENC_SIGNED

_lib = None


def _find_libmpg123():
    candidates = [ctypes.util.find_library("mpg123")]
    candidates += [
        "/usr/lib/x86_64-linux-gnu/libmpg123.so.0",
        "/usr/lib/x86_64-linux-gnu/libmpg123.so.0.47.0",
    ]
    # pygame's wheel bundles a libmpg123 in the environment's site-packages.
    candidates += glob.glob(str(Path(sys.prefix) / "lib" / "python3*" / "site-packages"
                                / "pygame.libs" / "libmpg123*.so*"))
    for c in candidates:
        if not c:
            continue
        try:
            return ctypes.CDLL(c)
        except OSError:
            continue
    return None


def _get_lib():
    global _lib
    if _lib is not None:
        return _lib
    lib = _find_libmpg123()
    if lib is None:
        return None
    lib.mpg123_init.restype = ctypes.c_int
    lib.mpg123_new.restype = ctypes.c_void_p
    lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_open.restype = ctypes.c_int
    lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.mpg123_getformat.restype = ctypes.c_int
    lib.mpg123_getformat.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
    lib.mpg123_format.restype = ctypes.c_int
    lib.mpg123_format.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int]
    lib.mpg123_read.restype = ctypes.c_int
    lib.mpg123_read.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.mpg123_close.argtypes = [ctypes.c_void_p]
    lib.mpg123_delete.argtypes = [ctypes.c_void_p]
    lib.mpg123_init()
    _lib = lib
    return _lib


def mpg123_available() -> bool:
    return _get_lib() is not None


def _read_mp3_mpg123(path: str | Path) -> tuple[np.ndarray, int]:
    lib = _get_lib()
    err = ctypes.c_int(0)
    handle = lib.mpg123_new(None, ctypes.byref(err))
    if not handle:
        raise RuntimeError(f"mpg123_new failed: {err.value}")
    try:
        if lib.mpg123_open(handle, str(path).encode()) != _MPG123_OK:
            raise RuntimeError(f"mpg123_open failed for {path}")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        encoding = ctypes.c_int(0)
        lib.mpg123_getformat(handle, ctypes.byref(rate), ctypes.byref(channels), ctypes.byref(encoding))
        # Lock output to signed 16-bit at the stream's native rate/channels.
        lib.mpg123_format_none(handle)
        lib.mpg123_format(handle, rate.value, channels.value, _MPG123_ENC_SIGNED_16)
        chunks = []
        bufsize = 1 << 16
        buf = (ctypes.c_char * bufsize)()
        done = ctypes.c_size_t(0)
        while True:
            ret = lib.mpg123_read(handle, buf, bufsize, ctypes.byref(done))
            if done.value:
                chunks.append(bytes(buf[: done.value]))
            if ret == _MPG123_DONE:
                break
            if ret not in (_MPG123_OK, _MPG123_NEW_FORMAT):
                if not chunks:
                    raise RuntimeError(f"mpg123_read failed: {ret}")
                break
        raw = b"".join(chunks)
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32)
        ch = max(1, channels.value)
        data = data[: (len(data) // ch) * ch]
        return data.reshape(-1, ch).T, int(rate.value)
    finally:
        lib.mpg123_close(handle)
        lib.mpg123_delete(handle)


def _read_mp3_ffmpeg(path: str | Path) -> tuple[np.ndarray, int]:
    ffmpeg = shutil.which("ffmpeg")
    probe = subprocess.run(
        [ffmpeg, "-i", str(path), "-f", "s16le", "-acodec", "pcm_s16le", "-"],
        capture_output=True, check=True,
    )
    import re

    m = re.search(rb"(\d+) Hz, (stereo|mono)", probe.stderr)
    rate = int(m.group(1)) if m else 44100
    ch = 2 if (m and m.group(2) == b"stereo") else 1
    data = np.frombuffer(probe.stdout, dtype="<i2").astype(np.float32)
    return data.reshape(-1, ch).T, rate


def read_mp3(path: str | Path) -> tuple[np.ndarray, int]:
    """Decode an MP3 -> (float32 (channels, n) int16-range samples, rate)."""
    if mpg123_available():
        return _read_mp3_mpg123(path)
    if shutil.which("ffmpeg"):
        return _read_mp3_ffmpeg(path)
    raise NotImplementedError(
        "MP3 decoding needs libmpg123 or ffmpeg; neither is available"
    )
