"""The generator: the same seed gives the same requests, another seed
another order of the same sizes."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import core
from benchmark.tests.tiny import SERVED_MIX
from benchmark.traffic import Traffic

MIXES = [w["traffic"] for w in core.load_spec()["workloads"]]
BIG = 2**31 + 12345


def mix_of(name):
    return SERVED_MIX if name == "served" else core.read_json("traffic", name)


def take(mix, seed, n):
    t = Traffic(mix_of(mix), seed, 16000, 0.1)
    return [t.next() for _ in range(n)]


@pytest.mark.parametrize("mix", MIXES + ["served"])
def test_same_seed_same_requests(mix):
    a, b = take(mix, BIG, 40), take(mix, BIG, 40)
    assert [r.audio_seconds for r in a] == [r.audio_seconds for r in b]
    assert [r.gap_seconds for r in a] == [r.gap_seconds for r in b]
    assert all(np.array_equal(x.samples, y.samples) for x, y in zip(a, b))


@pytest.mark.parametrize("mix", MIXES + ["served"])
def test_seeds_differ_in_order_not_in_work(mix):
    spec = mix_of(mix)
    n = spec["cycle"]
    a, b = take(mix, BIG, n), take(mix, BIG + 1, n)
    assert [r.audio_seconds for r in a] != [r.audio_seconds for r in b]
    assert sorted(r.audio_seconds for r in a) == sorted(r.audio_seconds for r in b)
    assert sum(r.gap_seconds for r in a) == pytest.approx(sum(r.gap_seconds for r in b))
    lo, hi = spec["audio_seconds"]["low"], spec["audio_seconds"]["high"]
    assert all(lo <= r.audio_seconds <= hi for r in a)


def test_open_loop_rate():
    """A mix with ``rate_per_s`` (for an open-loop driver) gets Poisson gaps
    at that mean rate."""
    mix = {"audio_seconds": {"dist": "uniform", "low": 20, "high": 30}, "rate_per_s": 4.8,
           "cycle": 200}
    t = Traffic(mix, 5, 16000, 0.1)
    gaps = [t.next().gap_seconds for _ in range(mix["cycle"])]
    assert len(gaps) / sum(gaps) == pytest.approx(mix["rate_per_s"], rel=0.02)


def test_shaped_spectrum_varies_the_shape_of_each_quarter_second():
    """Shaped noise: quarter seconds differ in spectral shape (the spread of
    their log-spectra's tilt), white noise only in level."""
    def tilts(spectrum):
        mix = {"audio_seconds": {"dist": "uniform", "low": 1, "high": 2}, "spectrum": spectrum}
        audio = Traffic(mix, BIG, 16000, 1.0).audio
        seg = audio[: 4000 * 200].reshape(200, 4000)
        power = np.abs(np.fft.rfft(seg, axis=1)) ** 2
        low, high = power[:, 10:200].mean(1), power[:, 1000:2000].mean(1)
        return np.log(low / high)
    assert tilts("shaped").std() > 5 * tilts("white").std()


def test_unknown_spectrum_is_refused():
    mix = {"audio_seconds": {"dist": "uniform", "low": 1, "high": 2}, "spectrum": "pink"}
    with pytest.raises(ValueError):
        Traffic(mix, 1, 16000, 1.0)
