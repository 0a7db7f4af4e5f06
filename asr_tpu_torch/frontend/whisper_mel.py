"""Whisper/librosa log-mel spectrogram as two matmuls.

Counterpart of ``asr_tpu/frontend/whisper_mel.py``: center-reflect padded
STFT with a periodic Hann window, power spectrum, slaney-normalized mel
bank, ``log10`` with a 1e-10 floor, the per-sample dynamic-range clamp
``max(x, max - 8)`` and the ``(x + 4) / 4`` affine. The framed signal meets
one ``(T, K*hop) @ (K*hop, 2*n_bins)`` DFT matmul, then the mel matmul; both
are plain f32 ``torch.matmul`` (TF32 off on a card, as for the Kaldi front
end). Whisper drops the final STFT frame: ``num_samples // hop`` frames.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from asr_tpu_torch.frontend import framing
from asr_tpu_torch.frontend.mel_banks import slaney_mel_banks


@dataclasses.dataclass(frozen=True)
class WhisperMelConfig:
    sample_rate: int = 16000
    n_mels: int = 128          # 128 for large-v3/turbo, 80 for v2 and earlier
    n_fft: int = 400
    hop_length: int = 160
    input_scale: float = 1.0   # 1/32768 if feeding int16-range samples

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1

    def num_frames(self, num_samples: int) -> int:
        # center=True STFT gives 1 + n//hop frames; Whisper drops the last.
        return num_samples // self.hop_length


def hann_window_periodic(win: int) -> np.ndarray:
    n = np.arange(win, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win)).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _whisper_constants(cfg: WhisperMelConfig) -> tuple[np.ndarray, np.ndarray]:
    """The DFT basis ``(K * hop, 2 * n_bins)`` and mel bank ``(n_bins, n_mels)``."""
    window = hann_window_periodic(cfg.n_fft)
    freqs = np.arange(cfg.n_bins, dtype=np.float32)[:, None]
    samples = np.arange(cfg.n_fft, dtype=np.float32)[None, :]
    omega = (2.0 * np.pi / cfg.n_fft) * freqs * samples
    cos_basis = np.cos(omega, dtype=np.float32) * window
    sin_basis = -np.sin(omega, dtype=np.float32) * window
    kernel = np.concatenate([cos_basis, sin_basis], axis=0)  # (2*n_bins, n_fft)
    if cfg.input_scale != 1.0:
        kernel = kernel * np.float32(cfg.input_scale)
    k = -(-cfg.n_fft // cfg.hop_length)
    basis = np.zeros((k * cfg.hop_length, 2 * cfg.n_bins), dtype=np.float32)
    basis[: cfg.n_fft] = kernel.T
    mel = slaney_mel_banks(cfg.n_mels, cfg.n_fft, cfg.sample_rate)
    return basis, np.asarray(mel, np.float32)


@functools.lru_cache(maxsize=16)
def _device_constants(cfg: WhisperMelConfig, device: torch.device):
    basis, mel = _whisper_constants(cfg)
    return torch.from_numpy(basis).to(device), torch.from_numpy(mel).to(device)


def log_mel_spectrogram(audio: torch.Tensor, cfg: WhisperMelConfig) -> torch.Tensor:
    """``(..., num_samples)`` waveform in [-1, 1] (or via ``input_scale``) ->
    ``(..., num_samples // hop, n_mels)`` f32 Whisper log-mel features."""
    basis, mel = _device_constants(cfg, audio.device)
    pad = cfg.n_fft // 2
    x = audio.to(torch.float32)
    lead = x.shape[:-1]
    x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect").reshape(*lead, -1)
    n_frames = cfg.num_frames(audio.shape[-1])
    frames = framing.frame_signal(x, cfg.n_fft, cfg.hop_length, n_frames)
    spectrum = frames @ basis
    re, im = torch.chunk(spectrum * spectrum, 2, dim=-1)
    mel_feat = (re + im) @ mel
    log_spec = torch.log10(torch.clamp(mel_feat, min=1e-10))
    max_val = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, max_val - 8.0)
    return (log_spec + 4.0) / 4.0
