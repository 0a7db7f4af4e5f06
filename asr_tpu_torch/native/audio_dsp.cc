// Native audio ingest DSP (C++17, no external deps): the PyTorch port's copy
// of asr_tpu/native/audio_dsp.cc, identical below this header.
//
// The reference delegates audio ingest to pydub/ffmpeg + numpy on the host
// (SenseVoice/Inference_SenseVoice_ONNX.py:62-86). For production serving the
// hot host-side path is sample-rate conversion of many concurrent streams;
// this library provides a windowed-sinc polyphase resampler, channel
// downmix, PCM conversion and RMS utilities callable via ctypes
// (asr_tpu_torch/native/__init__.py). Python/scipy remains the fallback.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Modified Bessel function of the first kind, order 0 (for Kaiser window).
double bessel_i0(double x) {
  double sum = 1.0, term = 1.0;
  const double half_x = x / 2.0;
  for (int k = 1; k < 64; ++k) {
    term *= (half_x / k) * (half_x / k);
    sum += term;
    if (term < 1e-16 * sum) break;
  }
  return sum;
}

}  // namespace

extern "C" {

// Design a Kaiser-windowed sinc low-pass FIR: cutoff in (0, 1] relative to
// Nyquist, `taps` odd length, `beta` Kaiser parameter. Gain `scale` applied.
void design_lowpass(double cutoff, double beta, double scale, long taps,
                    float* out) {
  const long half = (taps - 1) / 2;
  const double denom = bessel_i0(beta);
  for (long n = 0; n < taps; ++n) {
    const double m = static_cast<double>(n - half);
    const double sinc =
        (m == 0.0) ? cutoff : std::sin(M_PI * cutoff * m) / (M_PI * m);
    const double r = 2.0 * m / (taps - 1);
    const double w = bessel_i0(beta * std::sqrt(std::max(0.0, 1.0 - r * r))) / denom;
    out[n] = static_cast<float>(scale * sinc * w);
  }
}

// Polyphase rational resampling by up/down with the given FIR (odd length,
// centered). Matches scipy.signal.resample_poly's output length
// ceil(n_in * up / down) and group-delay compensation.
void resample_poly(const float* in, long n_in, int up, int down,
                   const float* filt, long n_filt, float* out, long n_out) {
  const long half = (n_filt - 1) / 2;
  for (long m = 0; m < n_out; ++m) {
    // Output sample m sits at upsampled index m * down; the filter is
    // centered there (group delay `half` in upsampled domain).
    const long center = m * static_cast<long>(down);
    double acc = 0.0;
    // Upsampled index u = center - half + j has a nonzero input only when
    // u % up == 0 -> input index u / up.
    const long u0 = center - half;
    // First j with (u0 + j) % up == 0:
    long rem = ((u0 % up) + up) % up;
    long j = (rem == 0) ? 0 : (up - rem);
    for (; j < n_filt; j += up) {
      const long u = u0 + j;
      const long i = u / up;
      if (i >= 0 && i < n_in) {
        acc += static_cast<double>(filt[j]) * in[i];
      }
    }
    out[m] = static_cast<float>(acc);
  }
}

// Average `channels`-interleaved frames into mono.
void downmix_interleaved(const float* in, long frames, int channels,
                         float* out) {
  for (long t = 0; t < frames; ++t) {
    double acc = 0.0;
    for (int c = 0; c < channels; ++c) acc += in[t * channels + c];
    out[t] = static_cast<float>(acc / channels);
  }
}

// int16 PCM -> float32 (keeps int16 numeric range, the Kaldi convention).
void pcm16_to_float(const int16_t* in, long n, float* out) {
  for (long i = 0; i < n; ++i) out[i] = static_cast<float>(in[i]);
}

double rms(const float* x, long n) {
  double acc = 0.0;
  for (long i = 0; i < n; ++i) acc += static_cast<double>(x[i]) * x[i];
  return n > 0 ? std::sqrt(acc / n) : 0.0;
}

void scale_inplace(float* x, long n, float s) {
  for (long i = 0; i < n; ++i) x[i] *= s;
}

}  // extern "C"

// ── Multithreaded WAV batch loader ─────────────────────────────────────────
// Production data-loader: decode + downmix + resample a batch of WAV files
// in parallel worker threads and write fixed-size zero-padded windows —
// the host-side feeder for fixed-shape device batches (MicroBatcher /
// DataParallelRunner). RIFF-PCM16 and RIFF-float32 supported; everything
// else routes through the Python ingest path.

#include <atomic>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct WavData {
  std::vector<float> mono;  // downmixed, int16 numeric range
  int rate = 0;
  bool ok = false;
};

WavData read_wav_mono(const char* path) {
  WavData out;
  FILE* f = std::fopen(path, "rb");
  if (!f) return out;
  unsigned char hdr[12];
  if (std::fread(hdr, 1, 12, f) != 12 || std::memcmp(hdr, "RIFF", 4) != 0 ||
      std::memcmp(hdr + 8, "WAVE", 4) != 0) {
    std::fclose(f);
    return out;
  }
  int fmt = 0, channels = 0, rate = 0, bits = 0;
  std::vector<unsigned char> data;
  unsigned char chdr[8];
  while (std::fread(chdr, 1, 8, f) == 8) {
    const unsigned long size = chdr[4] | (chdr[5] << 8) | (chdr[6] << 16) |
                               (static_cast<unsigned long>(chdr[7]) << 24);
    if (std::memcmp(chdr, "fmt ", 4) == 0) {
      // Untrusted header: a PCM fmt chunk is >= 16 bytes; anything smaller
      // would make the b[14]/b[15] reads below out-of-bounds. Bound the
      // declared size by the bytes remaining in the file too — a hostile
      // 32-bit size field would otherwise zero-initialize up to 4 GiB
      // (and bad_alloc across the ctypes boundary aborts the process).
      if (size < 16) break;
      const long fpos = std::ftell(f);
      if (fpos < 0 || std::fseek(f, 0, SEEK_END) != 0) break;
      const long fend = std::ftell(f);
      if (fend < fpos || std::fseek(f, fpos, SEEK_SET) != 0) break;
      if (size > static_cast<unsigned long>(fend - fpos)) break;
      std::vector<unsigned char> b(size);
      if (std::fread(b.data(), 1, size, f) != size) break;
      fmt = b[0] | (b[1] << 8);
      channels = b[2] | (b[3] << 8);
      rate = b[4] | (b[5] << 8) | (b[6] << 16) | (b[7] << 24);
      bits = b[14] | (b[15] << 8);
    } else if (std::memcmp(chdr, "data", 4) == 0) {
      // Bound the declared size by the bytes actually remaining in the file
      // before allocating (a hostile 32-bit size field can claim 4 GiB).
      const long pos = std::ftell(f);
      if (pos < 0 || std::fseek(f, 0, SEEK_END) != 0) break;
      const long end = std::ftell(f);
      if (end < pos || std::fseek(f, pos, SEEK_SET) != 0) break;
      const unsigned long avail = static_cast<unsigned long>(end - pos);
      const unsigned long want = size < avail ? size : avail;
      data.resize(want);
      if (std::fread(data.data(), 1, want, f) != want) data.clear();
      break;
    } else {
      std::fseek(f, static_cast<long>(size + (size & 1)), SEEK_CUR);
    }
  }
  std::fclose(f);
  if (data.empty() || channels <= 0 || rate <= 0) return out;

  long frames = 0;
  std::vector<float> inter;
  if (fmt == 1 && bits == 16) {  // PCM16 -> int16 numeric range
    frames = static_cast<long>(data.size()) / (2 * channels);
    inter.resize(static_cast<size_t>(frames) * channels);
    const int16_t* s = reinterpret_cast<const int16_t*>(data.data());
    for (long i = 0; i < frames * channels; ++i) inter[i] = static_cast<float>(s[i]);
  } else if (fmt == 3 && bits == 32) {  // IEEE float [-1,1] -> int16 range
    frames = static_cast<long>(data.size()) / (4 * channels);
    inter.resize(static_cast<size_t>(frames) * channels);
    const float* s = reinterpret_cast<const float*>(data.data());
    for (long i = 0; i < frames * channels; ++i) inter[i] = s[i] * 32768.0f;
  } else {
    return out;
  }
  out.mono.resize(frames);
  for (long t = 0; t < frames; ++t) {
    double acc = 0.0;
    for (int c = 0; c < channels; ++c) acc += inter[static_cast<size_t>(t) * channels + c];
    out.mono[t] = static_cast<float>(acc / channels);
  }
  out.rate = rate;
  out.ok = true;
  return out;
}

long gcd_long(long a, long b) { return b == 0 ? a : gcd_long(b, a % b); }

}  // namespace

extern "C" {

// paths: n C strings. out: (n, window) float32 (zero-padded, truncated at
// window). valid[i]: TRUE resampled sample count (may exceed window — the
// caller decides how to handle overflow) or -1 on decode failure.
// Returns #succeeded.
int load_wav_batch(const char** paths, int n, int target_rate, long window,
                   float* out, long* valid, int n_threads) {
  std::atomic<int> next(0), succeeded(0);
  if (n_threads <= 0) n_threads = static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads <= 0) n_threads = 4;
  if (n_threads > n) n_threads = n;

  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      float* row = out + static_cast<size_t>(i) * window;
      std::memset(row, 0, sizeof(float) * window);
      WavData w = read_wav_mono(paths[i]);
      if (!w.ok) {
        valid[i] = -1;
        continue;
      }
      std::vector<float> res;
      const float* src = w.mono.data();
      long n_src = static_cast<long>(w.mono.size());
      if (w.rate != target_rate) {
        const long g = gcd_long(w.rate, target_rate);
        const int up = static_cast<int>(target_rate / g);
        const int down = static_cast<int>(w.rate / g);
        const long max_ud = up > down ? up : down;
        const long taps = 2 * 10 * max_ud + 1;  // scipy resample_poly default
        std::vector<float> filt(taps);
        design_lowpass(1.0 / max_ud, 5.0, static_cast<double>(up), taps, filt.data());
        const long n_out = (n_src * up + down - 1) / down;
        res.resize(n_out);
        resample_poly(src, n_src, up, down, filt.data(), taps, res.data(), n_out);
        src = res.data();
        n_src = n_out;
      }
      const long keep = n_src < window ? n_src : window;
      std::memcpy(row, src, sizeof(float) * keep);
      valid[i] = n_src;  // TRUE length: callers detect window overflow
      succeeded.fetch_add(1);
    }
  };

  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return succeeded.load();
}

}  // extern "C"

// ── FLAC decode ─────────────────────────────────────────────────────────────
// Native counterpart of asr_tpu/runtime/flac.py (same subset: STREAMINFO,
// CONSTANT/VERBATIM/FIXED/LPC subframes, 4/5-bit Rice partitions, wasted
// bits, left/right/mid stereo decorrelation; CRCs unverified). The pure-
// Python decoder is bit-exact but ~1 s of CPU per minute of audio; the hot
// loops here are the bit reader and Rice/LPC reconstruction.

namespace flac {

struct Bits {
  const uint8_t* data;
  long nbits;
  long pos = 0;
  bool fail = false;

  uint64_t read(int n) {
    if (pos + n > nbits) { fail = true; return 0; }
    uint64_t out = 0;
    for (int i = 0; i < n; ++i) {
      out = (out << 1) | ((data[pos >> 3] >> (7 - (pos & 7))) & 1);
      ++pos;
    }
    return out;
  }
  int64_t read_signed(int n) {
    uint64_t v = read(n);
    if (n > 0 && (v >> (n - 1))) return static_cast<int64_t>(v) - (1LL << n);
    return static_cast<int64_t>(v);
  }
  long unary() {
    long count = 0;
    while (pos < nbits) {
      const int bit = (data[pos >> 3] >> (7 - (pos & 7))) & 1;
      ++pos;
      if (bit) return count;
      ++count;
    }
    fail = true;
    return 0;
  }
  void align() { pos = (pos + 7) & ~7L; }
};

uint64_t utf8_number(Bits& b) {
  uint64_t b0 = b.read(8);
  if (b0 < 0x80) return b0;
  int n = 0;
  while ((b0 << n) & 0x80) ++n;
  uint64_t val = b0 & (0x7FULL >> n);
  for (int i = 0; i < n - 1; ++i) val = (val << 6) | (b.read(8) & 0x3F);
  return val;
}

const int kBlockSize[] = {0, 192, 576, 1152, 2304, 4608, -1, -2,
                          256, 512, 1024, 2048, 4096, 8192, 16384, 32768};
const int kFixedOrders[5][4] = {{}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};

bool residuals(Bits& b, long block_size, int order, std::vector<int64_t>& out) {
  const int method = static_cast<int>(b.read(2));
  if (method > 1) return false;
  const int plen = method == 0 ? 4 : 5;
  const uint64_t escape = method == 0 ? 0xF : 0x1F;
  const int part_order = static_cast<int>(b.read(4));
  const long nparts = 1L << part_order;
  out.clear();
  for (long p = 0; p < nparts; ++p) {
    long nsamples = (block_size >> part_order) - (p == 0 ? order : 0);
    const uint64_t rice = b.read(plen);
    if (rice == escape) {
      const int nbits = static_cast<int>(b.read(5));
      for (long i = 0; i < nsamples; ++i)
        out.push_back(nbits ? b.read_signed(nbits) : 0);
    } else {
      const int k = static_cast<int>(rice);
      for (long i = 0; i < nsamples; ++i) {
        const uint64_t q = static_cast<uint64_t>(b.unary());
        const uint64_t r = k ? b.read(k) : 0;
        const uint64_t v = (q << k) | r;
        out.push_back(static_cast<int64_t>(v >> 1) ^ -static_cast<int64_t>(v & 1));
      }
    }
    if (b.fail) return false;
  }
  return true;
}

bool subframe(Bits& b, long block_size, int depth, std::vector<int64_t>& s) {
  if (b.read(1)) return false;
  const int stype = static_cast<int>(b.read(6));
  int wasted = 0;
  if (b.read(1)) { wasted = 1 + static_cast<int>(b.unary()); depth -= wasted; }
  s.clear();
  s.reserve(block_size);
  std::vector<int64_t> res;
  if (stype == 0) {
    const int64_t v = b.read_signed(depth);
    s.assign(block_size, v);
  } else if (stype == 1) {
    for (long i = 0; i < block_size; ++i) s.push_back(b.read_signed(depth));
  } else if (stype >= 8 && stype <= 12) {
    const int order = stype - 8;
    for (int i = 0; i < order; ++i) s.push_back(b.read_signed(depth));
    if (!residuals(b, block_size, order, res)) return false;
    for (size_t i = 0; i < res.size(); ++i) {
      int64_t pred = 0;
      const size_t base = s.size();
      for (int j = 0; j < order; ++j) pred += kFixedOrders[order][j] * s[base - 1 - j];
      s.push_back(res[i] + pred);
    }
  } else if (stype >= 32) {
    const int order = stype - 31;
    for (int i = 0; i < order; ++i) s.push_back(b.read_signed(depth));
    const int prec = static_cast<int>(b.read(4)) + 1;
    if (prec == 16) return false;
    const int shift = static_cast<int>(b.read_signed(5));
    if (shift < 0) return false;  // negative shift is UB; Python ref raises
    std::vector<int64_t> coeffs(order);
    for (int i = 0; i < order; ++i) coeffs[i] = b.read_signed(prec);
    if (!residuals(b, block_size, order, res)) return false;
    for (size_t i = 0; i < res.size(); ++i) {
      int64_t acc = 0;
      const size_t base = s.size();
      for (int j = 0; j < order; ++j) acc += coeffs[j] * s[base - 1 - j];
      s.push_back(res[i] + (acc >> shift));
    }
  } else {
    return false;
  }
  if (b.fail) return false;
  if (wasted) for (auto& v : s) v <<= wasted;
  return true;
}

}  // namespace flac

extern "C" {

// Decode a whole FLAC stream. out: interleaved int32, capacity `max_ints`
// TOTAL elements (all channels). Returns samples PER CHANNEL (>= 0) or a
// negative error: -1 bad magic, -2 no STREAMINFO, -3 frame decode error,
// -4 capacity exceeded.
long flac_decode(const uint8_t* data, long n_bytes, int32_t* out,
                 long max_ints, int* out_channels, int* out_rate,
                 int* out_depth) {
  if (n_bytes < 8 || std::memcmp(data, "fLaC", 4) != 0) return -1;
  long pos = 4;
  int rate = 0, channels = 0, depth = 0;
  long total = -1;
  bool have_info = false;
  while (pos + 4 <= n_bytes) {
    const int last = data[pos] >> 7;
    const int btype = data[pos] & 0x7F;
    const long size = (static_cast<long>(data[pos + 1]) << 16) |
                      (static_cast<long>(data[pos + 2]) << 8) | data[pos + 3];
    if (btype == 0 && pos + 4 + size <= n_bytes) {
      flac::Bits b{data + pos + 4, size * 8};
      b.read(16); b.read(16); b.read(24); b.read(24);
      rate = static_cast<int>(b.read(20));
      channels = static_cast<int>(b.read(3)) + 1;
      depth = static_cast<int>(b.read(5)) + 1;
      total = static_cast<long>(b.read(36));
      if (total == 0) total = -1;  // 0 = unknown length in STREAMINFO
      have_info = true;
    }
    pos += 4 + size;
    if (last) break;
  }
  if (!have_info) return -2;
  *out_channels = channels;
  *out_rate = rate;
  *out_depth = depth;

  long written = 0;  // samples per channel
  std::vector<std::vector<int64_t>> subs(channels);
  while (pos < n_bytes - 2) {
    flac::Bits b{data, n_bytes * 8};
    b.pos = pos * 8;
    if (b.read(14) != 0x3FFE) return -3;
    b.read(1); b.read(1);
    const int bs_code = static_cast<int>(b.read(4));
    const int sr_code = static_cast<int>(b.read(4));
    const int chan_code = static_cast<int>(b.read(4));
    const int depth_code = static_cast<int>(b.read(3));
    b.read(1);
    flac::utf8_number(b);
    long block_size;
    if (bs_code == 6) block_size = static_cast<long>(b.read(8)) + 1;
    else if (bs_code == 7) block_size = static_cast<long>(b.read(16)) + 1;
    else block_size = flac::kBlockSize[bs_code];
    if (block_size <= 0) return -3;
    if (sr_code == 12) b.read(8);
    else if (sr_code == 13 || sr_code == 14) b.read(16);
    b.read(8);  // header CRC-8
    int depth_f = depth;
    if (depth_code) {
      const int map[] = {0, 8, 12, 0, 16, 20, 24, 32};
      depth_f = map[depth_code];
      if (!depth_f) return -3;
    }

    if (chan_code < 8) {
      if (chan_code + 1 != channels) return -3;
      for (int c = 0; c < channels; ++c)
        if (!flac::subframe(b, block_size, depth_f, subs[c])) return -3;
    } else if (chan_code == 8) {  // left/side
      if (channels != 2) return -3;
      if (!flac::subframe(b, block_size, depth_f, subs[0])) return -3;
      if (!flac::subframe(b, block_size, depth_f + 1, subs[1])) return -3;
      for (long i = 0; i < block_size; ++i) subs[1][i] = subs[0][i] - subs[1][i];
    } else if (chan_code == 9) {  // right/side
      if (channels != 2) return -3;
      std::vector<int64_t> side, right;
      if (!flac::subframe(b, block_size, depth_f + 1, side)) return -3;
      if (!flac::subframe(b, block_size, depth_f, right)) return -3;
      subs[0].resize(block_size);
      subs[1] = right;
      for (long i = 0; i < block_size; ++i) subs[0][i] = right[i] + side[i];
    } else if (chan_code == 10) {  // mid/side
      if (channels != 2) return -3;
      std::vector<int64_t> mid, side;
      if (!flac::subframe(b, block_size, depth_f, mid)) return -3;
      if (!flac::subframe(b, block_size, depth_f + 1, side)) return -3;
      subs[0].resize(block_size);
      subs[1].resize(block_size);
      for (long i = 0; i < block_size; ++i) {
        const int64_t m = (mid[i] << 1) | (side[i] & 1);
        subs[0][i] = (m + side[i]) >> 1;
        subs[1][i] = (m - side[i]) >> 1;
      }
    } else {
      return -3;
    }
    b.align();
    b.read(16);  // frame CRC-16
    if (b.fail) return -3;
    const long keep = (total >= 0 && written + block_size > total)
                          ? total - written : block_size;
    if ((written + keep) * channels > max_ints) return -4;
    for (long i = 0; i < keep; ++i)
      for (int c = 0; c < channels; ++c)
        out[(written + i) * channels + c] = static_cast<int32_t>(subs[c][i]);
    written += keep;
    pos = b.pos >> 3;
    if (total >= 0 && written >= total) break;
  }
  return written;
}

}  // extern "C"
