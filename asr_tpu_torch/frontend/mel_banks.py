"""Mel filterbank construction (numpy, build-time constants).

The port's own copy of ``asr_tpu/frontend/mel_banks.py``.

Two conventions are needed across the 12 families (SURVEY.md §2.2):

- **Kaldi triangular banks** (FunASR-style families: SenseVoice, Paraformer,
  FireRedASR, X-ASR, Dolphin-streaming). Matches
  ``torchaudio.compliance.kaldi.get_mel_banks(n_mels, nfft, sr, 20.0, 0.0,
  100.0, -500.0, 1.0)`` as baked by reference
  ``SenseVoice/Export_SenseVoice.py:157-160`` — including the zero Nyquist
  column pad so the bank spans all ``nfft//2 + 1`` rfft bins.
- **Slaney-normalized banks** (librosa default) used by Whisper-style
  families (Whisper, Qwen3-ASR, Dolphin, FireRed STFT variants, Parakeet,
  Nemotron); matches ``librosa.filters.mel(htk=False, norm="slaney")`` /
  ``transformers.audio_utils.mel_filter_bank(norm="slaney",
  mel_scale="slaney")``.

These are computed once at model-build time on host in float64 and cast,
exactly like the reference bakes them as ONNX initializers.
"""

from __future__ import annotations

import numpy as np


def mel_scale_kaldi(freq):
    return 1127.0 * np.log1p(np.asarray(freq, dtype=np.float64) / 700.0)


def kaldi_mel_banks(
    n_mels: int,
    n_fft: int,
    sample_rate: float,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
) -> np.ndarray:
    """Kaldi triangular mel bank, shape ``(n_fft // 2 + 1, n_mels)``.

    Kaldi computes weights over the ``n_fft // 2`` non-Nyquist bins; the
    Nyquist row is zero (the pad the reference applies explicitly).
    """
    nyquist = 0.5 * sample_rate
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    num_fft_bins = n_fft // 2
    fft_bin_width = sample_rate / n_fft
    mel_low = mel_scale_kaldi(low_freq)
    mel_high = mel_scale_kaldi(high_freq)
    mel_delta = (mel_high - mel_low) / (n_mels + 1)

    mel = mel_scale_kaldi(fft_bin_width * np.arange(num_fft_bins, dtype=np.float64))
    left = mel_low + np.arange(n_mels, dtype=np.float64)[:, None] * mel_delta
    center = left + mel_delta
    right = center + mel_delta

    up = (mel[None, :] - left) / (center - left)
    down = (right - mel[None, :]) / (right - center)
    weights = np.where(
        (mel[None, :] > left) & (mel[None, :] <= center),
        up,
        np.where((mel[None, :] > center) & (mel[None, :] < right), down, 0.0),
    )
    banks = np.zeros((n_fft // 2 + 1, n_mels), dtype=np.float64)
    banks[:num_fft_bins, :] = weights.T
    return banks.astype(np.float32)


def _hz_to_mel_slaney(freq):
    freq = np.asarray(freq, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3.0
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        freq >= min_log_hz, min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep, mels
    )


def _mel_to_hz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3.0
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


def slaney_mel_banks(
    n_mels: int,
    n_fft: int,
    sample_rate: float,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    """Slaney-scale, slaney-normalized mel bank, shape ``(n_fft // 2 + 1, n_mels)``."""
    if fmax is None:
        fmax = sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.arange(n_freqs, dtype=np.float64) * sample_rate / n_fft
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[None, :] - fft_freqs[:, None]  # (n_freqs, n_mels + 2)
    lower = -ramps[:, :-2] / fdiff[None, :-1]
    upper = ramps[:, 2:] / fdiff[None, 1:]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney-style area normalization.
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[None, :]
    return weights.astype(np.float32)


def htk_mel_banks(
    n_mels: int,
    n_fft: int,
    sample_rate: float,
    fmin: float = 20.0,
    fmax: float | None = None,
) -> np.ndarray:
    """HTK-scale triangular mel bank without normalization, shape
    ``(n_fft // 2 + 1, n_mels)`` — matches ``torchaudio.functional.
    melscale_fbanks(..., mel_scale='htk', norm=None)`` as used by
    FireRedASR (reference ``FireRedASR/Export_FireRedASR_AED.py:779``)."""
    if fmax is None:
        fmax = sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.arange(n_freqs, dtype=np.float64) * sample_rate / n_fft

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)

    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[None, :] - fft_freqs[:, None]
    lower = -ramps[:, :-2] / fdiff[None, :-1]
    upper = ramps[:, 2:] / fdiff[None, 1:]
    return np.maximum(0.0, np.minimum(lower, upper)).astype(np.float32)
