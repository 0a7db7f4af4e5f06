"""OGG/Vorbis ingest via the system libvorbisfile (ctypes, no pip deps).

The port's own copy of ``asr_tpu/runtime/ogg.py``, with one repair, for
chained streams (several logical bitstreams, one after another). The
original reads the format once, from the first link, and assembles a later
link's frames with the first link's channel count; and it starts reading
where ``ov_fopen`` left the stream, which for a chained file is the start
of the last link, so the earlier links are lost. The port seeks a chained
file back to its first sample, re-reads the format whenever the link
changes, and raises a ``RuntimeError`` naming both formats when a link
changes the channel count or the sample rate.

Closes the last ingest-format gap vs the reference, whose pydub/ffmpeg
path reads any container (``SenseVoice/Inference_SenseVoice_ONNX.py:8``).
OGG rides the distro's ``libvorbisfile.so.3`` — universally present on
Linux images — through hand-declared ctypes bindings (no headers needed).

Validation: ``tests/test_ogg.py`` round-trips a known signal through the
system *encoder* (libvorbisenc) and this decoder, so correctness is
checked against an independent implementation, not against ourselves.

Decode output follows the repo convention: float32 in the int16 numeric
range, shaped (channels, n), plus the native sample rate — identical to
``read_wav`` / ``read_mp3`` / ``read_flac``.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from pathlib import Path

import numpy as np

# OggVorbis_File is ~944 bytes on LP64; allocate with margin so a future
# libvorbisfile that grows the struct still fits (the library only ever
# touches sizeof(OggVorbis_File) bytes of what we hand it).
_OVF_BYTES = 4096


class _VorbisInfo(ctypes.Structure):
    # vorbis/codec.h struct vorbis_info — stable ABI since libvorbis 1.0.
    _fields_ = [
        ("version", ctypes.c_int),
        ("channels", ctypes.c_int),
        ("rate", ctypes.c_long),
        ("bitrate_upper", ctypes.c_long),
        ("bitrate_nominal", ctypes.c_long),
        ("bitrate_lower", ctypes.c_long),
        ("bitrate_window", ctypes.c_long),
        ("codec_setup", ctypes.c_void_p),
    ]


_lib = None
_lib_err: str | None = None


def _load() -> ctypes.CDLL | None:
    global _lib, _lib_err
    if _lib is not None or _lib_err is not None:
        return _lib
    candidates = []
    found = ctypes.util.find_library("vorbisfile")
    if found:
        candidates.append(found)
    candidates += ["libvorbisfile.so.3", "libvorbisfile.so"]
    for name in candidates:
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.ov_fopen.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        lib.ov_fopen.restype = ctypes.c_int
        lib.ov_info.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ov_info.restype = ctypes.POINTER(_VorbisInfo)
        lib.ov_pcm_total.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ov_pcm_total.restype = ctypes.c_int64
        lib.ov_read_float.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.POINTER(ctypes.c_float))),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.ov_read_float.restype = ctypes.c_long
        lib.ov_clear.argtypes = [ctypes.c_void_p]
        lib.ov_clear.restype = ctypes.c_int
        lib.ov_streams.argtypes = [ctypes.c_void_p]
        lib.ov_streams.restype = ctypes.c_long
        lib.ov_pcm_seek.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.ov_pcm_seek.restype = ctypes.c_int
        _lib = lib
        return _lib
    _lib_err = "libvorbisfile not found (tried: %s)" % ", ".join(candidates)
    return None


def available() -> bool:
    """True when the system Vorbis decoder is loadable."""
    return _load() is not None


def _check_link_format(lib, vf, link: int, channels: int, rate: int, path) -> None:
    """Raise unless chained link ``link`` has the first link's format."""
    info = lib.ov_info(vf, link)
    if not info:
        raise RuntimeError(f"ov_info({path}, link {link}) returned NULL")
    ch, r = info.contents.channels, int(info.contents.rate)
    if (ch, r) != (channels, rate):
        raise RuntimeError(f"{path}: chained Ogg link {link} changes the format from "
                           f"{channels} channel(s) at {rate} Hz to {ch} at {r} Hz")


def read_ogg(path: str | Path) -> tuple[np.ndarray, int]:
    """Decode an OGG/Vorbis file -> (float32 (channels, n) in int16 numeric
    range, sample_rate). Raises ``RuntimeError`` when libvorbisfile is
    absent, the file is not valid Vorbis, or a chained link changes the
    channel count or the sample rate."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"OGG ingest unavailable: {_lib_err}")
    vf = ctypes.create_string_buffer(_OVF_BYTES)
    rc = lib.ov_fopen(str(path).encode(), vf)
    if rc != 0:
        raise RuntimeError(f"ov_fopen({path}) failed: rc={rc} (not Ogg/Vorbis?)")
    try:
        info = lib.ov_info(vf, -1)
        if not info:
            raise RuntimeError(f"ov_info({path}) returned NULL")
        channels = info.contents.channels
        rate = int(info.contents.rate)
        if channels <= 0 or rate <= 0:
            raise RuntimeError(f"bad Vorbis stream: channels={channels} rate={rate}")
        total = int(lib.ov_pcm_total(vf, -1))  # -1 on unseekable; grow then
        if lib.ov_streams(vf) > 1 and total > 0:
            rc = lib.ov_pcm_seek(vf, 0)  # a chained file: back to the first link
            if rc != 0:
                raise RuntimeError(f"ov_pcm_seek({path}, 0) failed: rc={rc}")
        chunks: list[np.ndarray] = []
        pcm = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))()
        section = ctypes.c_int(0)
        link = None  # the link whose format was last checked
        got = 0
        while True:
            n = lib.ov_read_float(vf, ctypes.byref(pcm), 4096, ctypes.byref(section))
            if n == 0:
                break  # EOF
            if n < 0:
                # OV_HOLE (-3): corrupt page, vorbisfile resyncs — skip.
                if n == -3:
                    continue
                raise RuntimeError(f"ov_read_float failed: rc={n}")
            if section.value != link:
                link = section.value
                _check_link_format(lib, vf, link, channels, rate, path)
            frame = np.empty((channels, n), np.float32)
            for c in range(channels):
                frame[c] = np.ctypeslib.as_array(pcm[c], shape=(n,))
            chunks.append(frame)
            got += n
            if total > 0 and got >= total:
                # Trust the index; some encoders pad the final packet.
                break
        if not chunks:
            return np.zeros((channels, 0), np.float32), rate
        out = np.concatenate(chunks, axis=1)
        if total > 0 and out.shape[1] > total:
            out = out[:, :total]
        return out * np.float32(32768.0), rate
    finally:
        lib.ov_clear(vf)
