"""Audio ingest: file -> mono PCM at the model rate.

The port's own copy of ``asr_tpu/runtime/audio.py``: stdlib ``wave`` for
WAV, polyphase resampling (scipy) for rate conversion, channel downmix,
optional RMS normalization, and dtype conventions driven by model metadata
(``audio_pcm_scale``: int16 numeric range vs [-1, 1] float PCM).

Only the pure-Python paths are kept: resampling is always scipy's
``resample_poly`` (the JAX package tries its native C++ resampler first),
and the native parallel batch loader ``load_audio_batch`` is left out; it
comes with ``SenseVoiceSession.transcribe_batch``.

Host-side only — device work starts at the front end.
"""

from __future__ import annotations

import math
import wave
from pathlib import Path

import numpy as np


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Read a PCM WAV file -> (float32 samples in int16 numeric range
    shaped (channels, n), sample_rate)."""
    with wave.open(str(path), "rb") as w:
        rate = w.getframerate()
        channels = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32)
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 65536.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) * 256.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        val = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        val = np.where(val >= 1 << 23, val - (1 << 24), val)
        data = val.astype(np.float32) / 256.0
    else:
        raise ValueError(f"unsupported WAV sample width: {width}")
    return data.reshape(-1, channels).T, rate


def downmix(samples: np.ndarray) -> np.ndarray:
    """(channels, n) -> (n,) by averaging channels."""
    if samples.ndim == 1:
        return samples
    return samples.mean(axis=0)


def resample(samples: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Polyphase resample 1-D samples from src_rate to dst_rate (scipy)."""
    if src_rate == dst_rate:
        return samples
    from scipy.signal import resample_poly

    g = math.gcd(src_rate, dst_rate)
    return resample_poly(samples, dst_rate // g, src_rate // g).astype(np.float32)


def rms_normalize(samples: np.ndarray, target_rms: float = 2048.0) -> np.ndarray:
    """Scale to a target RMS (int16 numeric range convention)."""
    rms = float(np.sqrt(np.mean(np.square(samples)))) if samples.size else 0.0
    if rms <= 1e-6:
        return samples
    return samples * (target_rms / rms)


def iter_windows(n: int, window: int, stride: int):
    """Start offsets of the sliding windows covering ``n`` samples — the
    ONE definition of the windowing geometry, shared by the sessions and
    the HTTP server (divergence would silently split requests differently
    than `session.transcribe`)."""
    num = max(1, -(-max(n - window, 0) // stride) + 1) if n > window else 1
    return [i * stride for i in range(num)]


def load_audio(
    path: str | Path,
    sample_rate: int,
    pcm_scale: float = 32768.0,
    normalize_rms: float | None = None,
) -> np.ndarray:
    """Load any supported file as mono float32 at ``sample_rate``.

    ``pcm_scale`` follows the reference's ``audio_pcm_scale`` metadata:
    32768.0 means "int16 numeric range" (Kaldi-convention families);
    1.0 means [-1, 1] PCM (Whisper-convention families).
    """
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".wav":
        samples, rate = read_wav(path)
    elif suffix == ".mp3":
        from asr_tpu_torch.runtime.mp3 import read_mp3

        samples, rate = read_mp3(path)
    elif suffix == ".flac":
        from asr_tpu_torch.runtime.flac import read_flac

        samples, rate = read_flac(path)
    elif suffix in (".ogg", ".oga"):
        from asr_tpu_torch.runtime.ogg import read_ogg

        samples, rate = read_ogg(path)
    else:
        raise ValueError(f"unsupported audio format: {suffix}")
    mono = downmix(samples)
    mono = resample(mono, rate, sample_rate)
    if normalize_rms is not None:
        mono = rms_normalize(mono, normalize_rms)
    if pcm_scale != 32768.0:
        mono = mono * (pcm_scale / 32768.0)
    return np.ascontiguousarray(mono, dtype=np.float32)
