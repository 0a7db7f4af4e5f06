"""Espnet DefaultFrontend log-mel (the Dolphin / OWSM convention) as two matmuls.

Counterpart of ``asr_tpu/frontend/espnet_mel.py``: optional pre-emphasis,
a center reflect pad, a periodic Hann window zero-padded from
``win_length`` to ``n_fft``, the one-sided DFT as one matmul over the framed
signal, the power spectrum, a Slaney mel bank with ``fmin = 0`` and
``log(max(., 1e-10))`` (natural log); the model applies the global CMVN.
The trailing STFT frame is kept: ``1 + num_samples // hop`` frames, unlike
Whisper. Both matmuls are plain f32 (TF32 off on a card, as for the other
front ends).
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
class EspnetMelConfig:
    sample_rate: int = 16000
    n_mels: int = 80
    n_fft: int = 512
    win_length: int = 400
    hop_length: int = 160
    preemphasis: float = 0.0
    input_scale: float = 1.0  # 1/32768 for int16-range input

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1

    def num_frames(self, num_samples: int) -> int:
        return num_samples // self.hop_length + 1

    def valid_frames(self, valid_samples: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(valid_samples).to(torch.int64) // self.hop_length + 1


def hann_window_periodic(win: int) -> np.ndarray:
    n = np.arange(win, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win)).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _espnet_constants(cfg: EspnetMelConfig) -> tuple[np.ndarray, np.ndarray]:
    """The DFT basis ``(K * hop, 2 * n_bins)`` and mel bank ``(n_bins, n_mels)``."""
    pad_l = (cfg.n_fft - cfg.win_length) // 2
    win = np.zeros(cfg.n_fft, np.float32)
    win[pad_l : pad_l + cfg.win_length] = hann_window_periodic(cfg.win_length)
    freqs = np.arange(cfg.n_bins, dtype=np.float32)[:, None]
    samples = np.arange(cfg.n_fft, dtype=np.float32)[None, :]
    omega = (2.0 * np.pi / cfg.n_fft) * freqs * samples
    kernel = np.concatenate(
        [np.cos(omega, dtype=np.float32) * win, -np.sin(omega, dtype=np.float32) * win], axis=0)
    k = -(-cfg.n_fft // cfg.hop_length)
    basis = np.zeros((k * cfg.hop_length, 2 * cfg.n_bins), np.float32)
    basis[: cfg.n_fft] = kernel.T
    mel = slaney_mel_banks(cfg.n_mels, cfg.n_fft, cfg.sample_rate, fmin=0.0)
    return basis, np.asarray(mel, np.float32)


@functools.lru_cache(maxsize=16)
def _device_constants(cfg: EspnetMelConfig, device: torch.device):
    basis, mel = _espnet_constants(cfg)
    return torch.from_numpy(basis).to(device), torch.from_numpy(mel).to(device)


def log_mel(audio: torch.Tensor, cfg: EspnetMelConfig) -> torch.Tensor:
    """``(..., S)`` waveform -> ``(..., 1 + S // hop, n_mels)`` f32 natural-log mel."""
    basis, mel = _device_constants(cfg, audio.device)
    x = audio.to(torch.float32) * cfg.input_scale
    if cfg.preemphasis > 0:
        prev = F.pad(x, (1, 0))[..., :-1]
        x = torch.cat([x[..., :1], (x - cfg.preemphasis * prev)[..., 1:]], dim=-1)
    pad = cfg.n_fft // 2
    lead = x.shape[:-1]
    x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect").reshape(*lead, -1)
    frames = framing.frame_signal(x, cfg.n_fft, cfg.hop_length, cfg.num_frames(audio.shape[-1]))
    spec = frames @ basis
    re, im = torch.chunk(spec * spec, 2, dim=-1)
    return torch.log(torch.clamp((re + im) @ mel, min=1e-10))
