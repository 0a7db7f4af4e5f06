"""The one traffic generator: a mix's data file in, requests out.

A mix (``traffic/<mix>.json``) gives the audio lengths (``audio_seconds``:
``uniform`` or ``loguniform`` between ``low`` and ``high``), for an open
loop the mean arrival rate (``rate_per_s``), and ``cycle``: sizes and gaps
are ``cycle`` stratified quantiles of their distributions (the gaps'
exponential: a Poisson stream), shuffled once into an order of the mix's
own, and repeated. The seed picks where in that order a run starts. So
every seed offers the same work and the same bursts, at another phase, and
a run's load does not swing with its seed.

The audio is cut from one noise recording made from the seed: Gaussian
noise under an envelope that changes every quarter second, so frames differ
in energy as speech does. With ``"spectrum": "shaped"`` each quarter second
also passes through a spectral envelope of its own, so frames differ in
spectral shape too, not only in level: a model's frame outputs then vary
as they do on speech, where on level alone a deep random model gives
nearly the same output at every frame. A request takes a slice at an
offset drawn from the seed.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

ENVELOPE_SECONDS = 0.25
ORDER_SEED = 20260521  # the mixes' own order of their sizes and gaps
BANDS = 24             # shaped spectra: log-gains at log-spaced bands, 60 Hz to Nyquist
LOG_GAIN = 3.0         # each band's log-gain drawn uniform in [-LOG_GAIN, LOG_GAIN]


@dataclasses.dataclass
class Request:
    index: int
    samples: np.ndarray
    audio_seconds: float
    gap_seconds: float = 0.0  # open loop: time after the previous arrival


def _quantiles(dist: dict, n: int) -> np.ndarray:
    u = (np.arange(n) + 0.5) / n
    lo, hi = float(dist["low"]), float(dist["high"])
    if dist["dist"] == "uniform":
        return lo + u * (hi - lo)
    if dist["dist"] == "loguniform":
        return np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
    raise ValueError(f"unknown distribution {dist['dist']!r}")


def _shaped(noise: np.ndarray, seg: int, sample_rate: int, rng) -> np.ndarray:
    """Each ``seg`` samples of ``noise`` through a spectral envelope of
    their own (random log-gains at ``BANDS`` log-spaced bands, interpolated
    on log frequency), at unit power."""
    n, k = len(noise), -(-len(noise) // seg)
    x = np.zeros(k * seg, np.float32)
    x[:n] = noise
    f = np.fft.rfftfreq(seg, 1.0 / sample_rate)
    edges = np.geomspace(60.0, sample_rate / 2, BANDS)
    pos = np.interp(np.log(f + 1.0), np.log(edges), np.arange(BANDS))
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, BANDS - 1)
    w = (pos - lo).astype(np.float32)
    gains = rng.uniform(-LOG_GAIN, LOG_GAIN, size=(k, BANDS)).astype(np.float32)
    g = np.exp(gains[:, lo] * (1.0 - w) + gains[:, hi] * w)
    y = np.fft.irfft(np.fft.rfft(x.reshape(k, seg), axis=1) * g, seg, axis=1)
    y /= y.std(axis=1, keepdims=True) + 1e-12
    return y.reshape(-1)[:n].astype(np.float32)


class Traffic:
    """Requests of one mix for one seed, in order, without end."""

    def __init__(self, mix: dict, seed: int, sample_rate: int, scale: float):
        self.mix = mix
        self.sample_rate = sample_rate
        self.rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 7])
        self.cycle = int(mix.get("cycle", 64))
        self.sizes = _quantiles(mix["audio_seconds"], self.cycle)
        rate = mix.get("rate_per_s")
        # no cell offers open-loop arrivals yet; the generator keeps them so
        # that a later cell adds one as data and a driver, without an edit
        # here. Exponential gaps at stratified quantiles: a Poisson stream whose
        # cycle holds exactly cycle / rate seconds of arrivals
        self.gaps = (-np.log(1.0 - (np.arange(self.cycle) + 0.5) / self.cycle) / float(rate)
                     if rate else np.zeros(self.cycle))
        longest = float(mix["audio_seconds"]["high"])
        n = int(math.ceil((longest + 60.0) * sample_rate))
        noise = self.rng.standard_normal(n, dtype=np.float32)
        seg = int(ENVELOPE_SECONDS * sample_rate)
        env = self.rng.uniform(0.05, 1.0, size=-(-n // seg)).astype(np.float32)
        spectrum = mix.get("spectrum", "white")
        if spectrum == "shaped":
            noise = _shaped(noise, seg, sample_rate, self.rng)
        elif spectrum != "white":
            raise ValueError(f"unknown spectrum {spectrum!r}")
        self.audio = noise * np.repeat(env, seg)[:n] * np.float32(scale)
        fixed = np.random.default_rng(ORDER_SEED)
        self.sizes = self.sizes[fixed.permutation(self.cycle)]
        self.gaps = self.gaps[fixed.permutation(self.cycle)]
        self.count = 0
        self._phase = int(self.rng.integers(0, self.cycle))

    def next(self) -> Request:
        i = (self._phase + self.count) % self.cycle
        seconds = float(self.sizes[i])
        gap = float(self.gaps[i])
        n = int(seconds * self.sample_rate)
        off = int(self.rng.integers(0, len(self.audio) - n))
        req = Request(self.count, self.audio[off : off + n], n / self.sample_rate, gap)
        self.count += 1
        return req
