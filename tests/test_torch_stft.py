"""``asr_tpu_torch/frontend/stft.py`` against ``asr_tpu/frontend/stft.py`` on
the same seeded audio: ``stft``, ``istft`` and ``power_spectrum`` for each
window kind, ``center`` on and off, reflect and constant padding, a window
shorter than the FFT and a symmetric window. Outputs agree within 1e-5 of
the largest magnitude (f32 products of up to 512 terms, summed in another
order). Without ``center`` the inverse divides the edge samples by window
sums near 0 in both packages, which turns last-bit differences into any
size: there the inverses are compared where the window sum is at least 0.1.
``istft(stft(x))`` gives ``x`` back within 5e-5 of its largest magnitude
(two f32 DFT products in a row, each within about 2e-5 of the exact one).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.frontend import stft as jst
from asr_tpu_torch.frontend import stft as tst

TOL = 1e-5
ROUND_TRIP_TOL = 5e-5


def _close(got: torch.Tensor, want, tol: float = TOL, keep=slice(None)):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy()[..., keep], want[..., keep], rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1.0))


def _window_sum(n_fft=400, hop_length=160, win_length=None, window="hann", periodic=True, frames=1,
                **_):
    _, w = tst._stft_consts(n_fft, win_length or n_fft, window, periodic)
    out = np.zeros(n_fft + (frames - 1) * hop_length)
    for m in range(frames):
        out[m * hop_length : m * hop_length + n_fft] += w.astype(np.float64) ** 2
    return out


def _audio(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1.0, 1.0, shape).astype(np.float32)


CASES = [
    dict(window="hann"), dict(window="hamming"), dict(window="povey"), dict(window="rect"),
    dict(window="hann", center=False), dict(window="hamming", center=False),
    dict(window="hann", pad_mode="constant"), dict(window="povey", pad_mode="zeros"),
    dict(window="hann", n_fft=512, win_length=400, hop_length=128),
    dict(window="hann", periodic=False, n_fft=256, hop_length=64),
]


@pytest.mark.parametrize("kw", CASES, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_stft_power_and_istft_match_jax(kw):
    x = _audio(sum(map(ord, str(kw))), (2, 4000))
    re, im = tst.stft(torch.from_numpy(x), **kw)
    jre, jim = jst.stft(jnp.asarray(x), **kw)
    _close(re, jre)
    _close(im, jim)
    _close(tst.power_spectrum(re, im), jst.power_spectrum(jre, jim))
    inv = {k: v for k, v in kw.items() if k != "pad_mode"}
    got = tst.istft(re, im, length=x.shape[-1], **inv)
    want = jst.istft(jre, jim, length=x.shape[-1], **inv)
    keep = slice(None)
    if not kw.get("center", True):
        keep = _window_sum(frames=re.shape[-2], **kw)[: got.shape[-1]] >= 0.1
        assert keep.mean() > 0.9
    _close(got, want, keep=keep)


@pytest.mark.parametrize("window", ["hann", "hamming", "rect"])
def test_istft_inverts_stft(window):
    x = _audio(7, (3, 3200))
    re, im = tst.stft(torch.from_numpy(x), window=window)
    _close(tst.istft(re, im, window=window, length=x.shape[-1]), x, ROUND_TRIP_TOL)
    back = tst.istft(re, im, window=window)  # no length: the centre-trimmed overlap-add
    assert back.shape == (3, (re.shape[-2] - 1) * 160)
    _close(back, x[:, : back.shape[-1]], ROUND_TRIP_TOL)


def test_stft_keeps_leading_axes_and_one_dim_audio():
    x = _audio(3, (2, 3, 1600))
    re, _ = tst.stft(torch.from_numpy(x))
    assert re.shape == (2, 3, 11, 201)
    one, _ = tst.stft(torch.from_numpy(x[0, 0]))
    assert torch.equal(one, re[0, 0])
    with pytest.raises(ValueError, match="unknown window"):
        tst.stft(torch.from_numpy(x), window="blackman")
