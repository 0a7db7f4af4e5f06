"""PyTorch port: the audio readers against the JAX package's, where the
port's copies had drifted from them.

- Native layer: the port keeps its own copy of the C++ audio DSP library
  (``asr_tpu_torch/native``) and routes resampling, FLAC decoding and the
  parallel WAV batch loader through it as the JAX package does, so both
  packages feed their front ends the same samples (bitwise, at 44.1, 48
  and 8 kHz to 16 kHz). These tests skip only where g++ is absent.
- MP3: the port's libmpg123 lookup tries the same candidates, in the same
  order, as the JAX package's, pygame's bundled copy included.
- Ogg: a deliberate divergence from the JAX package, a repair of its
  chained-stream fault. The port decodes every link of a chained Ogg file
  (the JAX reader starts where ``ov_fopen`` leaves a chained file, at the
  last link, and loses the others), and raises where a later link changes
  the channel count or the sample rate (the JAX reader reads the format
  once, from the first link).
"""

import ctypes
import ctypes.util
import glob
import shutil
import struct
import sys
import wave

import numpy as np
import pytest

from asr_tpu import native as jnative
from asr_tpu.runtime import audio as jaudio
from asr_tpu.runtime import flac as jflac
from asr_tpu.runtime import mp3 as jmp3
from asr_tpu_torch import native as tnative
from asr_tpu_torch.runtime import audio as taudio
from asr_tpu_torch.runtime import flac as tflac
from asr_tpu_torch.runtime import mp3 as tmp3
from asr_tpu_torch.runtime import ogg as togg


def _need_native():
    if shutil.which("g++") is None:
        pytest.skip("g++ is absent: neither package builds its native layer")
    assert jnative.available() and tnative.available()


def _wav(path, samples: np.ndarray, rate: int):
    """(channels, n) int16 -> a PCM WAV file."""
    with wave.open(str(path), "wb") as w:
        w.setnchannels(samples.shape[0])
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.ascontiguousarray(samples.T).astype("<i2").tobytes())


@pytest.mark.parametrize("src", [44100, 48000, 8000])
def test_native_resample_is_the_reference_native_resample(src):
    _need_native()
    x = (np.random.default_rng(src).standard_normal(src // 3) * 3000).astype(np.float32)
    got = taudio.resample(x, src, 16000)
    want = jaudio.resample(x, src, 16000)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jnative.resample(x, src, 16000))


@pytest.mark.parametrize("src,channels", [(44100, 2), (48000, 1), (8000, 1)])
def test_load_audio_and_batch_loader_match_the_reference(tmp_path, src, channels):
    _need_native()
    rng = np.random.default_rng(src + channels)
    paths = []
    for i, seconds in enumerate((0.4, 1.3)):
        p = tmp_path / f"{i}.wav"
        _wav(p, rng.integers(-9000, 9000, (channels, int(src * seconds))), src)
        paths.append(p)
    for p in paths:
        np.testing.assert_array_equal(taudio.load_audio(p, 16000), jaudio.load_audio(p, 16000))
    for scale in (32768.0, 1.0):
        got, gv = taudio.load_audio_batch(paths, 16000, 16000, pcm_scale=scale)
        want, wv = jaudio.load_audio_batch(paths, 16000, 16000, pcm_scale=scale)
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(got, want)
    assert gv[1] > 16000  # the long row reports its true length


def test_native_flac_decode_matches_the_reference():
    _need_native()
    from test_flac import _encode  # the JAX package's in-test FLAC encoder

    rng = np.random.default_rng(3)
    a = rng.integers(-3000, 3000, 64).astype(np.int64)
    b = np.cumsum(rng.integers(-40, 40, 64)).astype(np.int64) + 100
    blob = _encode([[("verbatim", a, 16)], [("fixed2", b, 16)]])
    for got, want in zip(tnative.flac_decode(blob), jnative.flac_decode(blob)):
        np.testing.assert_array_equal(got, want)
    got, rate = tflac.read_flac_bytes(blob)
    want, jrate = jflac.read_flac_bytes(blob)
    assert rate == jrate == 16000
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.concatenate([a, b]).astype(np.float32))


def test_mp3_library_candidates_match_the_reference(monkeypatch):
    """Every candidate the JAX reader tries, in its order, pygame's bundled
    libmpg123 included (the port's copy once dropped that one)."""
    tried, patterns = [], []

    def fake_cdll(name, *args, **kwargs):
        tried.append(name)
        raise OSError(name)

    def fake_glob(pattern, *args, **kwargs):
        patterns.append(pattern)
        return [f"/bundled/pygame.libs/libmpg123-{len(patterns)}.so.0"] if "pygame.libs" in pattern else []

    monkeypatch.setattr(ctypes.util, "find_library", lambda name: f"lib{name}-found.so")
    monkeypatch.setattr(ctypes, "CDLL", fake_cdll)
    monkeypatch.setattr(glob, "glob", fake_glob)
    assert tmp3._find_libmpg123() is None
    port_tried, port_pattern = tried[:], patterns[-1]
    tried.clear()
    assert jmp3._find_libmpg123() is None
    ref_pattern = patterns[-1]
    assert [t.replace("-1.so", "-2.so") for t in port_tried] == tried
    assert any("pygame.libs" in t for t in tried)
    # the same glob below the environment's prefix
    tail = ref_pattern[ref_pattern.index("/lib/python3*"):]
    assert port_pattern == sys.prefix + tail


# ── chained Ogg streams ────────────────────────────────────────────────────


def _ogg_crc(page: bytes) -> int:
    crc = 0
    for byte in page:
        crc ^= byte << 24
        for _ in range(8):
            crc = ((crc << 1) ^ 0x04C11DB7) if crc & 0x80000000 else crc << 1
            crc &= 0xFFFFFFFF
    return crc


def _reserial(data: bytes, serial: int) -> bytes:
    """Give every page of one Ogg stream another serial number (and a new
    CRC), so two encodings can be chained into one file."""
    out, pos = bytearray(), 0
    while pos < len(data):
        assert data[pos:pos + 4] == b"OggS"
        nseg = data[pos + 26]
        size = 27 + nseg + sum(data[pos + 27 : pos + 27 + nseg])
        page = bytearray(data[pos : pos + size])
        page[14:18] = struct.pack("<I", serial)
        page[22:26] = b"\0\0\0\0"
        page[22:26] = struct.pack("<I", _ogg_crc(bytes(page)))
        out += page
        pos += size
    return bytes(out)


def _chain(tmp_path, links):
    from test_ogg import _encode_ogg, _sine  # the JAX package's system-encoder helpers

    if not togg.available():
        pytest.skip("system Vorbis decoder not present")
    blobs = []
    for i, (channels, rate) in enumerate(links):
        p = tmp_path / f"link{i}.ogg"
        _encode_ogg(p, np.stack([_sine(rate, 0.5, 300 + 100 * c) for c in range(channels)]), rate)
        blobs.append(_reserial(p.read_bytes(), 1000 + i))
    path = tmp_path / "chained.ogg"
    path.write_bytes(b"".join(blobs))
    return path


def test_chained_ogg_of_one_format_decodes_every_link(tmp_path):
    from asr_tpu.runtime import ogg as jogg

    path = _chain(tmp_path, [(1, 16000), (1, 16000)])
    got, rate = togg.read_ogg(path)
    links = [jogg.read_ogg(tmp_path / f"link{i}.ogg") for i in range(2)]
    assert rate == 16000 and all(r == 16000 for _, r in links)
    np.testing.assert_array_equal(got, np.concatenate([a for a, _ in links], axis=1))
    assert got.shape == (1, 16000)  # both 0.5 s links
    # the JAX reader keeps the last link only
    np.testing.assert_array_equal(jogg.read_ogg(path)[0], links[1][0])


@pytest.mark.parametrize("second", [(2, 16000), (1, 22050)])
def test_chained_ogg_that_changes_format_raises(tmp_path, second):
    """The divergence from the JAX reader, which assembles the later link
    with the first link's format."""
    path = _chain(tmp_path, [(1, 16000), second])
    with pytest.raises(RuntimeError, match="chained Ogg link 1 changes the format"):
        togg.read_ogg(path)
