"""Audio ingest: file -> mono PCM at the model rate.

The port's own copy of ``asr_tpu/runtime/audio.py``: stdlib ``wave`` for
WAV, polyphase resampling (scipy) for rate conversion, channel downmix,
optional RMS normalization, and dtype conventions driven by model metadata
(``audio_pcm_scale``: int16 numeric range vs [-1, 1] float PCM).

Resampling and the parallel WAV batch loader prefer the port's native C++
layer (``asr_tpu_torch.native``, built with g++ at first use), as the JAX
package prefers its own, so both packages feed their front ends the same
samples; scipy and the per-file Python path are the fallbacks.

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
    """Polyphase resample 1-D samples from src_rate to dst_rate.

    Uses the native C++ resampler (``asr_tpu_torch.native``) when available, else
    scipy."""
    if src_rate == dst_rate:
        return samples
    try:
        from asr_tpu_torch import native

        if native.available():
            return native.resample(samples, src_rate, dst_rate)
    except Exception:
        pass
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


def load_audio_batch(
    paths,
    sample_rate: int,
    window_samples: int,
    pcm_scale: float = 32768.0,
    n_threads: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Parallel batch ingest: decode/downmix/resample N files into a fixed
    (N, window) float32 batch + TRUE per-file sample counts (a count larger
    than ``window_samples`` means the row was truncated — callers route
    such files through their sliding-window path).

    Uses the multithreaded C++ loader (``asr_tpu_torch.native.load_wav_batch``)
    for WAV files; rows it cannot handle (MP3, exotic encodings, decode
    errors) fall back to the per-file Python path. Output follows the
    ``pcm_scale`` convention of :func:`load_audio`."""
    paths = [str(p) for p in paths]
    n = len(paths)
    out = np.zeros((n, window_samples), np.float32)
    valid = np.full((n,), -1, np.int64)
    try:
        from asr_tpu_torch import native

        if native.available():
            out, valid = native.load_wav_batch(paths, sample_rate, window_samples, n_threads)
    except Exception:
        pass
    for i in range(n):
        if valid[i] < 0:  # native miss -> python ingest
            try:
                mono = load_audio(paths[i], sample_rate)  # int16 range
            except Exception as exc:
                # Undecodable file (malformed header, unknown codec): keep
                # the batch alive with a zero-length row, but SAY so — a
                # silent empty transcript is indistinguishable from silence.
                import warnings

                warnings.warn(
                    f"load_audio_batch: could not decode {paths[i]!r} "
                    f"({type(exc).__name__}: {exc}); emitting an empty row",
                    stacklevel=2,
                )
                out[i] = 0.0
                valid[i] = 0
                continue
            keep = min(len(mono), window_samples)
            out[i, :keep] = mono[:keep]
            out[i, keep:] = 0.0
            valid[i] = len(mono)  # TRUE length (callers detect overflow)
    if pcm_scale != 32768.0:
        out *= np.float32(pcm_scale / 32768.0)
    return out, valid
