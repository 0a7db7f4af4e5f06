"""Kaldi-faithful log-mel filterbank as two matmuls.

Counterpart of ``asr_tpu/frontend/kaldi_fbank.py``: per-frame DC removal,
pre-emphasis with replicate boundary, the symmetric window and the one-sided
``n_fft``-point DFT are linear in the frame, so they fold into one
``(K * hop, 2 * n_bins)`` analysis basis applied to the framed signal; then
power, the mel matmul and the log floored at FLT_EPSILON.

Both matmuls are f32. The JAX package runs them at HIGHEST precision; on a
CUDA card that means TF32 off (``torch.backends.cuda.matmul.allow_tf32 =
False``, PyTorch's default), which callers that compare against it keep.

Kaldi convention: the int16 numeric range (no division by 32768); callers
with [-1, 1] PCM set ``input_scale=32768.0``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from asr_tpu_torch.frontend import framing, mel_banks

_F32_EPS = float(np.finfo(np.float32).eps)


def hamming_window(win: int) -> np.ndarray:
    """Symmetric (periodic=False) Hamming window, Kaldi's default for fbank."""
    n = np.arange(win, dtype=np.float64)
    return (0.54 - 0.46 * np.cos(2.0 * np.pi * n / (win - 1))).astype(np.float32)


def povey_window(win: int) -> np.ndarray:
    """Kaldi's 'povey' window (hann ** 0.85)."""
    n = np.arange(win, dtype=np.float64)
    return ((0.5 - 0.5 * np.cos(2.0 * np.pi * n / (win - 1))) ** 0.85).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class KaldiFbankConfig:
    sample_rate: int = 16000
    n_mels: int = 80
    n_fft: int = 512           # Kaldi zero-pads the 400-sample frame to next pow2
    win_length: int = 400      # 25 ms
    hop_length: int = 160      # 10 ms
    pre_emphasis: float = 0.97
    window: str = "hamming"    # "hamming" | "povey"
    remove_dc: bool = True
    low_freq: float = 20.0
    mel_style: str = "kaldi"   # "kaldi" | "htk"
    input_scale: float = 1.0   # multiply waveform before analysis (32768.0 for [-1,1] PCM)

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1

    def num_frames(self, num_samples: int) -> int:
        return framing.num_frames_snip(num_samples, self.win_length, self.hop_length)


def _fold_frontend(basis: np.ndarray, pre_emphasis: float, remove_dc: bool) -> np.ndarray:
    """Fold pre-emphasis (replicate boundary) and DC removal into a windowed
    ``(n_bins, win)`` basis, so that ``kernel @ frame`` is the analysis of
    the pre-processed frame."""
    shifted = np.concatenate([basis[:, 1:], np.zeros_like(basis[:, :1])], axis=1)
    folded = basis - pre_emphasis * shifted      # pf[n] = s[n] - c * s[n-1]
    folded[:, 0] -= pre_emphasis * basis[:, 0]   # replicate boundary pf[0] = (1-c) s[0]
    if remove_dc:
        folded = folded - folded.mean(axis=1, keepdims=True)
    return folded


@functools.lru_cache(maxsize=16)
def _kaldi_constants(cfg: KaldiFbankConfig) -> tuple[np.ndarray, np.ndarray]:
    """The folded DFT basis ``(K * hop, 2 * n_bins)`` and mel bank ``(n_bins, n_mels)``."""
    win, n_fft, n_bins = cfg.win_length, cfg.n_fft, cfg.n_bins
    window = {"hamming": hamming_window, "povey": povey_window}[cfg.window](win)
    freqs = np.arange(n_bins, dtype=np.float32)[:, None]
    samples = np.arange(win, dtype=np.float32)[None, :]
    omega = (2.0 * np.pi / n_fft) * freqs * samples
    cos_basis = np.cos(omega, dtype=np.float32) * window
    sin_basis = -np.sin(omega, dtype=np.float32) * window
    kernel = np.concatenate(
        [
            _fold_frontend(cos_basis, cfg.pre_emphasis, cfg.remove_dc),
            _fold_frontend(sin_basis, cfg.pre_emphasis, cfg.remove_dc),
        ],
        axis=0,
    )  # (2 * n_bins, win)
    if cfg.input_scale != 1.0:
        kernel = kernel * np.float32(cfg.input_scale)
    k = -(-win // cfg.hop_length)
    basis = np.zeros((k * cfg.hop_length, 2 * n_bins), dtype=np.float32)
    basis[:win] = kernel.T  # zero rows past win make the matmul ignore frame scratch
    banks = mel_banks.htk_mel_banks if cfg.mel_style == "htk" else mel_banks.kaldi_mel_banks
    mel = banks(cfg.n_mels, n_fft, cfg.sample_rate, cfg.low_freq)
    return basis, np.asarray(mel, np.float32)


@functools.lru_cache(maxsize=16)
def _device_constants(cfg: KaldiFbankConfig, device: torch.device):
    basis, mel = _kaldi_constants(cfg)
    return torch.from_numpy(basis).to(device), torch.from_numpy(mel).to(device)


def log_mel_fbank(audio: torch.Tensor, cfg: KaldiFbankConfig, n_frames: int) -> torch.Tensor:
    """``(..., num_samples)`` waveform -> ``(..., n_frames, n_mels)`` f32
    log-mel features, floored at log(FLT_EPSILON) like Kaldi."""
    basis, mel = _device_constants(cfg, audio.device)
    frames = framing.frame_signal(audio.to(torch.float32), cfg.win_length, cfg.hop_length, n_frames)
    spectrum = frames @ basis
    re, im = torch.chunk(spectrum * spectrum, 2, dim=-1)
    mel_feat = (re + im) @ mel
    return torch.log(torch.clamp(mel_feat, min=_F32_EPS))
