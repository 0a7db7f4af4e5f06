"""General STFT / ISTFT utilities.

Counterpart of ``asr_tpu/frontend/stft.py``: the STFT is the framed matmul
of every front end (``frontend/framing.py`` then one DFT-basis product),
the ISTFT an overlap-add with window-sum (COLA) normalisation. Both products
are plain f32 ``torch.matmul``; the overlap-add is ``index_add_``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from asr_tpu_torch.frontend import framing

# jnp.pad's mode names -> F.pad's
_PAD_MODES = {"reflect": "reflect", "constant": "constant", "zeros": "constant"}


def _window(kind: str, win: int, periodic: bool = True) -> np.ndarray:
    n = np.arange(win, dtype=np.float64)
    denom = win if periodic else win - 1
    if kind == "hann":
        return (0.5 - 0.5 * np.cos(2 * np.pi * n / denom)).astype(np.float32)
    if kind == "hamming":
        return (0.54 - 0.46 * np.cos(2 * np.pi * n / denom)).astype(np.float32)
    if kind == "povey":
        return ((0.5 - 0.5 * np.cos(2 * np.pi * n / denom)) ** 0.85).astype(np.float32)
    if kind in ("rect", "ones"):
        return np.ones(win, np.float32)
    raise ValueError(f"unknown window {kind!r}")


@functools.lru_cache(maxsize=16)
def _stft_consts(n_fft: int, win_length: int, window: str, periodic: bool):
    pad_l = (n_fft - win_length) // 2
    w = np.zeros(n_fft, np.float32)
    w[pad_l : pad_l + win_length] = _window(window, win_length, periodic)
    n_bins = n_fft // 2 + 1
    freqs = np.arange(n_bins, dtype=np.float32)[:, None]
    samples = np.arange(n_fft, dtype=np.float32)[None, :]
    omega = (2.0 * np.pi / n_fft) * freqs * samples
    basis = np.concatenate(
        [np.cos(omega, dtype=np.float32) * w, -np.sin(omega, dtype=np.float32) * w], axis=0
    ).T  # (n_fft, 2*n_bins)
    return basis, w


def stft(
    audio: torch.Tensor,
    n_fft: int = 400,
    hop_length: int = 160,
    win_length: int | None = None,
    window: str = "hann",
    center: bool = True,
    pad_mode: str = "reflect",
    periodic: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """STFT -> (real (..., T, n_bins), imag (..., T, n_bins))."""
    win_length = win_length or n_fft
    basis_np, _ = _stft_consts(n_fft, win_length, window, periodic)
    k = math.ceil(n_fft / hop_length)
    basis = torch.from_numpy(np.pad(basis_np, ((0, k * hop_length - n_fft), (0, 0)))).to(audio.device)
    x = audio.to(torch.float32)
    if center:
        pad = n_fft // 2
        lead = x.shape[:-1]
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad),
                  mode=_PAD_MODES[pad_mode]).reshape(*lead, -1)
        n_frames = audio.shape[-1] // hop_length + 1
    else:
        n_frames = framing.num_frames_snip(audio.shape[-1], n_fft, hop_length)
    frames = framing.frame_signal(x, n_fft, hop_length, n_frames)
    spec = frames @ basis
    re, im = torch.chunk(spec, 2, dim=-1)
    return re, im


def istft(
    real: torch.Tensor,
    imag: torch.Tensor,
    n_fft: int = 400,
    hop_length: int = 160,
    win_length: int | None = None,
    window: str = "hann",
    center: bool = True,
    length: int | None = None,
    periodic: bool = True,
) -> torch.Tensor:
    """Inverse STFT via overlap-add with COLA (window-sum) normalization.

    real/imag: (..., T, n_bins). Returns (..., samples)."""
    win_length = win_length or n_fft
    _, w_np = _stft_consts(n_fft, win_length, window, periodic)
    n_bins = n_fft // 2 + 1
    dev = real.device
    # Inverse real-DFT basis: x[n] = (1/N) * sum_k c_k (re_k cos + im_k(-sin))
    n = np.arange(n_fft, dtype=np.float32)[None, :]
    k = np.arange(n_bins, dtype=np.float32)[:, None]
    omega = (2.0 * np.pi / n_fft) * k * n
    coef = np.full((n_bins, 1), 2.0, np.float32)
    coef[0] = 1.0
    if n_fft % 2 == 0:
        coef[-1] = 1.0
    inv_basis = np.concatenate(
        [np.cos(omega) * coef, -np.sin(omega) * coef], axis=0
    ).astype(np.float32) / n_fft  # (2*n_bins, n_fft)
    spec = torch.cat([real, imag], dim=-1).to(torch.float32)
    frames = spec @ torch.from_numpy(inv_basis).to(dev)
    w = torch.from_numpy(w_np).to(dev)
    frames = frames * w  # synthesis window

    t = frames.shape[-2]
    out_len = n_fft + (t - 1) * hop_length
    batch_shape = frames.shape[:-2]
    flat = frames.reshape(-1, t, n_fft)

    # Overlap-add on frame start offsets.
    idx = (torch.arange(t, device=dev)[:, None] * hop_length
           + torch.arange(n_fft, device=dev)[None, :]).reshape(-1)
    sig = torch.zeros((flat.shape[0], out_len), dtype=torch.float32, device=dev)
    sig.index_add_(1, idx, flat.reshape(flat.shape[0], -1))
    wsum = torch.zeros((out_len,), dtype=torch.float32, device=dev)
    wsum.index_add_(0, idx, torch.square(w).expand(t, n_fft).reshape(-1))
    sig = sig / torch.clamp(wsum, min=1e-8)[None, :]
    if center:
        pad = n_fft // 2
        sig = sig[:, pad : out_len - pad]
    if length is not None:
        sig = sig[:, :length]
    return sig.reshape(*batch_shape, sig.shape[-1])


def power_spectrum(real: torch.Tensor, imag: torch.Tensor) -> torch.Tensor:
    """``stft_B_power`` equivalent."""
    return torch.square(real) + torch.square(imag)
