"""Plain front ends: the Kaldi log-mel filterbank (SenseVoice) and Whisper's
log-mel spectrogram, written out in float32 torch from their published
definitions (Kaldi ``compute-fbank-feats`` with ``snip_edges``, librosa /
OpenAI Whisper ``log_mel_spectrogram``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

F32_EPS = float(np.finfo(np.float32).eps)


def frames(x: torch.Tensor, win: int, hop: int, n_frames: int) -> torch.Tensor:
    """(B, S) -> (B, n_frames, win): frame m is ``x[m * hop : m * hop + win]``,
    zero past the end of ``x``."""
    need = (n_frames - 1) * hop + win
    if x.shape[-1] < need:
        x = F.pad(x, (0, need - x.shape[-1]))
    return x.unfold(-1, win, hop)[..., :n_frames, :]


def kaldi_mel_banks(n_mels: int, n_fft: int, sample_rate: float, low_freq: float) -> np.ndarray:
    """Kaldi's triangular banks over the n_fft/2 bins below Nyquist; the
    Nyquist row is zero. (n_fft/2 + 1, n_mels)."""
    def mel(f):
        return 1127.0 * np.log1p(np.asarray(f, np.float64) / 700.0)

    nbins = n_fft // 2
    lo, hi = mel(low_freq), mel(0.5 * sample_rate)
    delta = (hi - lo) / (n_mels + 1)
    m = mel(sample_rate / n_fft * np.arange(nbins, dtype=np.float64))
    left = lo + np.arange(n_mels, dtype=np.float64)[:, None] * delta
    center, right = left + delta, left + 2 * delta
    up = (m[None] - left) / (center - left)
    down = (right - m[None]) / (right - center)
    w = np.where((m[None] > left) & (m[None] <= center), up,
                 np.where((m[None] > center) & (m[None] < right), down, 0.0))
    out = np.zeros((nbins + 1, n_mels))
    out[:nbins] = w.T
    return out.astype(np.float32)


def kaldi_fbank(audio: torch.Tensor, n_mels: int = 80, sample_rate: int = 16000,
                win: int = 400, hop: int = 160, n_fft: int = 512, preemph: float = 0.97,
                low_freq: float = 20.0) -> torch.Tensor:
    """(B, S) int16-range waveform -> (B, T, n_mels) Kaldi log-mel features:
    per frame DC removal, pre-emphasis (replicate boundary), a symmetric
    Hamming window, the power of an n_fft-point DFT, the mel bank and a log
    floored at FLT_EPSILON."""
    n_frames = (audio.shape[-1] - win) // hop + 1
    fr = frames(audio.to(torch.float32), win, hop, n_frames)
    fr = fr - fr.mean(dim=-1, keepdim=True)
    prev = torch.cat([fr[..., :1], fr[..., :-1]], dim=-1)
    fr = fr - preemph * prev
    n = torch.arange(win, dtype=torch.float64, device=audio.device)
    window = (0.54 - 0.46 * torch.cos(2 * np.pi * n / (win - 1))).to(torch.float32)
    spec = torch.fft.rfft(fr * window, n=n_fft)
    power = spec.real ** 2 + spec.imag ** 2
    bank = torch.from_numpy(kaldi_mel_banks(n_mels, n_fft, sample_rate, low_freq)).to(audio.device)
    return torch.log(torch.clamp(power @ bank, min=F32_EPS))


def slaney_mel_banks(n_mels: int, n_fft: int, sample_rate: float) -> np.ndarray:
    """librosa ``filters.mel(htk=False, norm="slaney")``: (n_fft/2 + 1, n_mels)."""
    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        lin = f / (200.0 / 3)
        return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27),
                        lin)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27 * (m - 15.0)), m * 200.0 / 3)

    fft_f = np.arange(n_fft // 2 + 1, dtype=np.float64) * sample_rate / n_fft
    hz = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sample_rate / 2), n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[None, :] - fft_f[:, None]
    w = np.maximum(0.0, np.minimum(-ramps[:, :-2] / fdiff[None, :-1], ramps[:, 2:] / fdiff[None, 1:]))
    w *= (2.0 / (hz[2:] - hz[:-2]))[None, :]
    return w.astype(np.float32)


def whisper_log_mel(audio: torch.Tensor, n_mels: int = 128, sample_rate: int = 16000,
                    n_fft: int = 400, hop: int = 160) -> torch.Tensor:
    """(B, S) waveform in [-1, 1] -> (B, S // hop, n_mels): centre-reflect
    STFT with a periodic Hann window (the last frame dropped), power, the
    Slaney mel bank, log10 floored at 1e-10, the clamp to 8 below the
    maximum and ``(x + 4) / 4``."""
    x = F.pad(audio.to(torch.float32)[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    n_frames = audio.shape[-1] // hop
    fr = frames(x, n_fft, hop, n_frames)
    n = torch.arange(n_fft, dtype=torch.float64, device=audio.device)
    window = (0.5 - 0.5 * torch.cos(2 * np.pi * n / n_fft)).to(torch.float32)
    spec = torch.fft.rfft(fr * window, n=n_fft)
    power = spec.real ** 2 + spec.imag ** 2
    bank = torch.from_numpy(slaney_mel_banks(n_mels, n_fft, sample_rate)).to(audio.device)
    log_spec = torch.log10(torch.clamp(power @ bank, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0)
    return (log_spec + 4.0) / 4.0
