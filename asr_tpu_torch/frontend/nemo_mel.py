"""NeMo-convention log-mel front end (Parakeet / Nemotron FastConformer).

Counterpart of ``asr_tpu/frontend/nemo_mel.py``: pre-emphasis
``x[t] - c*x[t-1]`` (zero boundary), a **symmetric** Hann window
zero-padded from ``win_length`` to ``n_fft``, **constant** (zero) centre
padding of ``n_fft // 2``, the one-sided DFT as one matmul over the framed
signal, the power spectrum, a Slaney mel bank (fmin 0, fmax sr/2),
``log(max(mel, 2^-24))`` and the trailing frame dropped; then, for
Parakeet, **per-feature normalization** over the valid frames (mean, the
(N-1) variance with N clamped at 2, ``std + eps``).

The JAX package runs both products at ``Precision.HIGHEST``; here they run
with TF32 turned off for their duration (:func:`_exact_f32`), so a card
computes them in exact f32 whatever the process-wide setting is.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from asr_tpu_torch.frontend import framing
from asr_tpu_torch.frontend.mel_banks import slaney_mel_banks


@dataclasses.dataclass(frozen=True)
class NemoMelConfig:
    sample_rate: int = 16000
    n_mels: int = 128
    n_fft: int = 512
    win_length: int = 400
    hop_length: int = 160
    preemphasis: float = 0.97
    log_guard: float = 2.0 ** -24
    norm_eps: float = 1e-5
    input_scale: float = 1.0  # 1/32768 for int16-range input

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1

    def num_frames(self, num_samples: int) -> int:
        # center=True gives 1 + n // hop; NeMo drops the trailing frame.
        return num_samples // self.hop_length

    def valid_frames(self, valid_samples: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(valid_samples).to(torch.int64) // self.hop_length


def hann_window_symmetric(win: int) -> np.ndarray:
    n = np.arange(win, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / (win - 1))).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _nemo_constants(cfg: NemoMelConfig) -> tuple[np.ndarray, np.ndarray]:
    """The DFT basis ``(K * hop, 2 * n_bins)`` and mel bank ``(n_bins, n_mels)``."""
    pad_l = (cfg.n_fft - cfg.win_length) // 2
    win = np.zeros(cfg.n_fft, np.float32)
    win[pad_l : pad_l + cfg.win_length] = hann_window_symmetric(cfg.win_length)
    freqs = np.arange(cfg.n_bins, dtype=np.float32)[:, None]
    samples = np.arange(cfg.n_fft, dtype=np.float32)[None, :]
    omega = (2.0 * np.pi / cfg.n_fft) * freqs * samples
    kernel = np.concatenate(
        [np.cos(omega, dtype=np.float32) * win, -np.sin(omega, dtype=np.float32) * win], axis=0)
    k = -(-cfg.n_fft // cfg.hop_length)
    basis = np.zeros((k * cfg.hop_length, 2 * cfg.n_bins), np.float32)
    basis[: cfg.n_fft] = kernel.T
    mel = slaney_mel_banks(cfg.n_mels, cfg.n_fft, cfg.sample_rate)
    return basis, np.asarray(mel, np.float32)


@functools.lru_cache(maxsize=16)
def _device_constants(cfg: NemoMelConfig, device: torch.device):
    basis, mel = _nemo_constants(cfg)
    return torch.from_numpy(basis).to(device), torch.from_numpy(mel).to(device)


@contextlib.contextmanager
def _exact_f32():
    """TF32 off for the matmuls inside (JAX's ``Precision.HIGHEST``); the
    process-wide setting is restored after."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def log_mel(audio: torch.Tensor, cfg: NemoMelConfig) -> torch.Tensor:
    """``(..., S)`` waveform -> ``(..., S // hop, n_mels)`` un-normalized log-mel."""
    basis, mel = _device_constants(cfg, audio.device)
    x = audio.to(torch.float32) * cfg.input_scale
    prev = F.pad(x, (1, 0))[..., :-1]
    x = x - cfg.preemphasis * prev
    pad = cfg.n_fft // 2
    x = F.pad(x, (pad, pad))  # constant zeros
    frames = framing.frame_signal(x, cfg.n_fft, cfg.hop_length, cfg.num_frames(audio.shape[-1]))
    with _exact_f32():
        spec = frames @ basis
        re, im = torch.chunk(spec * spec, 2, dim=-1)
        melspec = (re + im) @ mel
    return torch.log(torch.clamp(melspec, min=cfg.log_guard))


def per_feature_norm(feats: torch.Tensor, valid: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """NeMo per-feature normalization over the valid time range.

    feats (B, T, M); valid (B,). Mean over the valid frames, variance with
    (N - 1), N clamped at 2; ``(x - mean) / (std + eps)``. Padded frames
    add nothing to the statistics and are zero in the output."""
    t = feats.shape[1]
    keep = (torch.arange(t, device=feats.device)[None, :] < valid[:, None])[..., None]
    n = torch.clamp(valid, min=2).to(torch.float32)[:, None, None]
    zero = torch.zeros((), dtype=torch.float32, device=feats.device)
    x = torch.where(keep, feats.to(torch.float32), zero)
    mean = x.sum(dim=1, keepdim=True) / n
    centered = torch.where(keep, x - mean, zero)
    var = (centered * centered).sum(dim=1, keepdim=True) / (n - 1.0)
    normed = centered / (torch.sqrt(var) + eps)
    return torch.where(keep, normed, zero)
