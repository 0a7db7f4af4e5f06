"""Self-contained pure-Python FLAC decoder (no external deps).

The port's own copy of ``asr_tpu/runtime/flac.py``. Like the original, it
prefers the native C++ decoder (``asr_tpu_torch.native``) and falls back to
this pure-Python decoder.

FLAC, the most common lossless fixture format, needs neither ffmpeg nor
libFLAC here: this is a direct implementation of the format spec (https://xiph.org/flac/):
STREAMINFO, frame headers with UTF-8 coded numbers, CONSTANT / VERBATIM /
FIXED(0-4) / LPC subframes, 4/5-bit Rice-coded residual partitions,
wasted bits, and left/right/mid stereo decorrelation.

Decoding is exact (FLAC is lossless): the output int16/24/8 samples are
bit-identical to the encoder's input. Pure Python is fast enough for
ingest of test fixtures and utterance-length files (~1 s of CPU per
minute of 16 kHz mono); batch pipelines should prefer WAV.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


class _Bits:
    """MSB-first bit reader over bytes."""

    def __init__(self, data: bytes, pos_bits: int = 0):
        self.data = data
        self.pos = pos_bits

    def read(self, n: int) -> int:
        out = 0
        pos = self.pos
        data = self.data
        for _ in range(n):
            byte = data[pos >> 3]
            out = (out << 1) | ((byte >> (7 - (pos & 7))) & 1)
            pos += 1
        self.pos = pos
        return out

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v >> (n - 1) else v

    def unary(self) -> int:
        count = 0
        pos = self.pos
        data = self.data
        while True:
            byte = data[pos >> 3]
            bit = (byte >> (7 - (pos & 7))) & 1
            pos += 1
            if bit:
                self.pos = pos
                return count
            count += 1

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7


def _utf8_number(bits: _Bits) -> int:
    """FLAC 'UTF-8 style' coded frame/sample number (up to 56 bits)."""
    b0 = bits.read(8)
    if b0 < 0x80:
        return b0
    n = 0
    while (b0 << n) & 0x80:
        n += 1
    val = b0 & (0x7F >> n)
    for _ in range(n - 1):
        val = (val << 6) | (bits.read(8) & 0x3F)
    return val


_BLOCKSIZE = [0, 192, 576, 1152, 2304, 4608, -1, -2,
              256, 512, 1024, 2048, 4096, 8192, 16384, 32768]
_RATES = [0, 88200, 176400, 192000, 8000, 16000, 22050, 24000,
          32000, 44100, 48000, 96000, -1, -2, -3, 0]


def _residuals(bits: _Bits, block_size: int, order: int) -> list[int]:
    method = bits.read(2)
    if method > 1:
        raise ValueError(f"reserved residual method {method}")
    plen = 4 if method == 0 else 5
    escape = 0xF if method == 0 else 0x1F
    part_order = bits.read(4)
    nparts = 1 << part_order
    out: list[int] = []
    for p in range(nparts):
        nsamples = (block_size >> part_order) - (order if p == 0 else 0)
        rice = bits.read(plen)
        if rice == escape:
            nbits = bits.read(5)
            for _ in range(nsamples):
                out.append(bits.read_signed(nbits) if nbits else 0)
        else:
            for _ in range(nsamples):
                q = bits.unary()
                r = bits.read(rice) if rice else 0
                v = (q << rice) | r
                out.append((v >> 1) ^ -(v & 1))  # zigzag
    return out


def _subframe(bits: _Bits, block_size: int, depth: int) -> list[int]:
    if bits.read(1):
        raise ValueError("invalid subframe padding bit")
    stype = bits.read(6)
    wasted = 0
    if bits.read(1):
        wasted = 1 + bits.unary()
        depth -= wasted
    if stype == 0:  # CONSTANT
        v = bits.read_signed(depth)
        samples = [v] * block_size
    elif stype == 1:  # VERBATIM
        samples = [bits.read_signed(depth) for _ in range(block_size)]
    elif 8 <= stype <= 12:  # FIXED order 0-4
        order = stype - 8
        warm = [bits.read_signed(depth) for _ in range(order)]
        res = _residuals(bits, block_size, order)
        samples = list(warm)
        coeffs = FIXED_COEFFS[order]
        for i, e in enumerate(res):
            pred = sum(c * samples[order + i - 1 - j] for j, c in enumerate(coeffs))
            samples.append(e + pred)
    elif stype >= 32:  # LPC order 1-32
        order = stype - 31
        warm = [bits.read_signed(depth) for _ in range(order)]
        prec = bits.read(4) + 1
        if prec == 16:
            raise ValueError("invalid LPC precision escape")
        shift = bits.read_signed(5)
        coeffs = [bits.read_signed(prec) for _ in range(order)]
        res = _residuals(bits, block_size, order)
        samples = list(warm)
        for e in res:
            acc = 0
            base = len(samples)
            for j, c in enumerate(coeffs):
                acc += c * samples[base - 1 - j]
            samples.append(e + (acc >> shift))
    else:
        raise ValueError(f"reserved subframe type {stype}")
    if wasted:
        samples = [s << wasted for s in samples]
    return samples


def read_flac(path: str | Path) -> tuple[np.ndarray, int]:
    """Decode a FLAC file -> (float32 samples in the int16 numeric range,
    sample_rate). Multi-channel returns (N, C)."""
    return read_flac_bytes(Path(path).read_bytes())


def read_flac_bytes(data: bytes) -> tuple[np.ndarray, int]:
    """Decode an in-memory FLAC stream (HTTP bodies skip the filesystem).

    Prefers the native C++ decoder (``asr_tpu_torch.native.flac_decode``,
    the same subset); this pure-Python implementation is the
    always-available fallback and the reference for its tests."""
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC file (missing fLaC marker)")
    try:
        from asr_tpu_torch import native

        if native.available():
            samples, rate, depth = native.flac_decode(data)
            scale = 2.0 ** (15 - (depth - 1))
            return samples.astype(np.float32) * np.float32(scale), rate
    except Exception:
        pass  # native layer unavailable or the stream malformed: pure-Python path
    pos = 4
    info = None
    while True:
        hdr = data[pos:pos + 4]
        last = hdr[0] >> 7
        btype = hdr[0] & 0x7F
        size = int.from_bytes(hdr[1:4], "big")
        body = data[pos + 4: pos + 4 + size]
        if btype == 0:  # STREAMINFO
            b = _Bits(body)
            b.read(16); b.read(16)  # min/max block size
            b.read(24); b.read(24)  # min/max frame size
            rate = b.read(20)
            channels = b.read(3) + 1
            depth = b.read(5) + 1
            total = b.read(36)
            info = (rate, channels, depth, total)
        pos += 4 + size
        if last:
            break
    if info is None:
        raise ValueError("FLAC stream has no STREAMINFO block")
    rate, channels, depth, total = info

    chans: list[list[int]] = [[] for _ in range(channels)]
    while pos < len(data) - 2:
        bits = _Bits(data, pos * 8)
        sync = bits.read(14)
        if sync != 0x3FFE:
            raise ValueError(f"lost frame sync at byte {pos}")
        bits.read(1)  # reserved
        bits.read(1)  # blocking strategy
        bs_code = bits.read(4)
        sr_code = bits.read(4)
        chan_code = bits.read(4)
        depth_code = bits.read(3)
        bits.read(1)
        _utf8_number(bits)
        if bs_code == 6:
            block_size = bits.read(8) + 1
        elif bs_code == 7:
            block_size = bits.read(16) + 1
        else:
            block_size = _BLOCKSIZE[bs_code]
        if sr_code == 12:
            bits.read(8)
        elif sr_code in (13, 14):
            bits.read(16)
        bits.read(8)  # header CRC-8 (not verified)
        if depth_code:
            depth_f = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}[depth_code]
        else:
            depth_f = depth

        if chan_code < 8:
            nch = chan_code + 1
            subs = [_subframe(bits, block_size, depth_f) for _ in range(nch)]
        elif chan_code == 8:  # left/side
            left = _subframe(bits, block_size, depth_f)
            side = _subframe(bits, block_size, depth_f + 1)
            subs = [left, [l - s for l, s in zip(left, side)]]
        elif chan_code == 9:  # right/side
            side = _subframe(bits, block_size, depth_f + 1)
            right = _subframe(bits, block_size, depth_f)
            subs = [[r + s for r, s in zip(right, side)], right]
        elif chan_code == 10:  # mid/side
            mid = _subframe(bits, block_size, depth_f)
            side = _subframe(bits, block_size, depth_f + 1)
            subs = [[], []]
            for m, s in zip(mid, side):
                m = (m << 1) | (s & 1)
                subs[0].append((m + s) >> 1)
                subs[1].append((m - s) >> 1)
        else:
            raise ValueError(f"reserved channel assignment {chan_code}")
        bits.align()
        bits.read(16)  # frame CRC-16 (not verified)
        for c, s in enumerate(subs):
            chans[c].extend(s)
        pos = bits.pos >> 3
        if total and len(chans[0]) >= total:
            break

    arr = np.array(chans, dtype=np.int64).T  # (N, C)
    if total:
        arr = arr[:int(total)]
    # normalize any depth to the int16 numeric range
    scale = 2.0 ** (15 - (depth - 1))
    out = arr.astype(np.float32) * np.float32(scale)
    if out.shape[1] == 1:
        out = out[:, 0]
    return out, rate
