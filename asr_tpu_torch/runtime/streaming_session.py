"""Streaming sessions: chunked transcription with device-resident state.

Counterpart of ``asr_tpu/runtime/streaming_session.py``: fixed-size audio
chunks, the state carried across steps on the parameters' device, the
Paraformer decoder run only when the predictor fired (the one host read of
a chunk), RMS-matched white-noise final padding, and per-chunk timing. Each
session calls its family's batched step at N = 1, the same step the
multi-stream runner (``streaming/multistream.py``) calls at N = its slots.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from asr_tpu_torch.runtime import audio as audio_io
from asr_tpu_torch.runtime.session import TranscribeResult
from asr_tpu_torch.runtime.transducer_session import _params_device
from asr_tpu_torch.streaming import paraformer_online as po


def _on(device, samples: np.ndarray) -> torch.Tensor:
    """One chunk as a (1, S) f32 tensor on ``device``."""
    return torch.from_numpy(np.asarray(samples, np.float32)[None]).to(device)


class ParaformerStreamingSession:
    def __init__(self, params, cfg: po.ParaformerStreamConfig, tokenizer=None):
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = _params_device(params)
        self.reset()

    def reset(self) -> None:
        self.state = po.init_state(self.cfg, self.params, 1, self.device)
        self.token_ids: list[int] = []
        self.elapsed = 0.0
        self.audio_samples = 0

    @torch.inference_mode()
    def push_chunk(self, chunk: np.ndarray) -> list[int]:
        """Feed one fixed-size chunk; returns the newly decoded token ids."""
        assert len(chunk) == self.cfg.chunk_samples, "fixed-size chunks required"
        t0 = time.perf_counter()
        self.state, fired, count, enc_out = po.encoder_step(self.params, self.cfg, self.state,
                                                            _on(self.device, chunk))
        n_fired = int(count[0])  # the reference's single scalar host read per chunk
        new_ids: list[int] = []
        if n_fired > 0:
            self.state, ids, _ = po.decoder_step(self.params, self.cfg, self.state, enc_out, fired, count)
            new_ids = [int(t) for t in ids[0, :n_fired].tolist()]
            self.token_ids.extend(new_ids)
        self.elapsed += time.perf_counter() - t0
        self.audio_samples += len(chunk)
        return new_ids

    def transcribe(self, audio: np.ndarray | str | Path) -> TranscribeResult:
        if isinstance(audio, (str, Path)):
            audio = audio_io.load_audio(audio, self.cfg.base.sample_rate)
        audio = np.asarray(audio, np.float32)
        self.reset()
        w = self.cfg.chunk_samples
        n = len(audio)
        rng = np.random.default_rng(0)
        for i in range(-(-n // w)):
            chunk = audio[i * w : (i + 1) * w]
            if len(chunk) < w:
                # RMS-matched white-noise pad (zero padding biases the CIF
                # tail; matched noise keeps the fbank energy profile).
                rms = float(np.sqrt(np.mean(np.square(chunk)))) if len(chunk) else 1.0
                pad = (rng.standard_normal(w - len(chunk)) * max(rms, 1e-3)).astype(np.float32)
                chunk = np.concatenate([chunk, pad])
            self.push_chunk(chunk)
        text = self.tokenizer.decode(self.token_ids) if self.tokenizer else ""
        return TranscribeResult(text=text, token_ids=list(self.token_ids),
                                audio_seconds=n / self.cfg.base.sample_rate, elapsed_seconds=self.elapsed)


def snip_edges_false_pad(waveform: np.ndarray, win_length: int, hop_length: int) -> np.ndarray:
    """Reflection-pad so snip_edges=True framing of the padded signal equals
    Kaldi ``snip_edges=False`` fbank of the original."""
    pad = win_length // 2 - hop_length // 2
    rev = waveform[::-1]
    if pad > 0:
        return np.concatenate([rev[-pad:], waveform, rev])
    return np.concatenate([waveform[-pad:], rev])


class XasrStreamingSession:
    """X-ASR Zipformer2 chunked transcription: snip_edges=False padding, a
    0.3 s zero tail, fixed windows, per-chunk greedy transducer."""

    def __init__(self, params, cfg, tokenizer=None):
        from asr_tpu_torch.models import zipformer as zf

        self.zf = zf
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = _params_device(params)
        self.reset()

    def reset(self) -> None:
        self.state = self.zf.init_state(self.cfg, 1, self.device)
        self.token_ids: list[int] = []
        self.elapsed = 0.0

    @torch.inference_mode()
    def push_window(self, window: np.ndarray) -> list[int]:
        """One window -> the newly emitted ids (one host read of the count)."""
        t0 = time.perf_counter()
        self.state, ids, count = self.zf.transcribe_chunk(self.params, self.cfg, self.state,
                                                          _on(self.device, window))
        new = ids[0, : int(count[0])].tolist()
        self.elapsed += time.perf_counter() - t0
        self.token_ids.extend(new)
        return new

    def transcribe(self, audio: np.ndarray | str | Path) -> TranscribeResult:
        cfg = self.cfg
        fb = cfg.fbank
        if isinstance(audio, (str, Path)):
            audio = audio_io.load_audio(audio, fb.sample_rate)
        audio = np.asarray(audio, np.float32)
        n_orig = len(audio)
        padded = snip_edges_false_pad(audio, fb.win_length, fb.hop_length)
        padded = np.concatenate([padded, np.zeros(int(0.3 * fb.sample_rate), np.float32)])
        self.reset()
        w, adv = cfg.window_samples, cfg.advance_samples
        pos = 0
        while pos + w <= len(padded) or pos == 0:
            window = np.zeros(w, np.float32)
            chunk = padded[pos : pos + w]
            window[: len(chunk)] = chunk
            self.push_window(window)
            pos += adv
        text = self.tokenizer.decode(self.token_ids) if self.tokenizer else ""
        return TranscribeResult(text=text, token_ids=list(self.token_ids),
                                audio_seconds=n_orig / fb.sample_rate, elapsed_seconds=self.elapsed)


class NemotronStreamingSession:
    """Nemotron cache-aware streaming RNN-T: fixed audio windows, carried
    mel / attention / conv caches and predictor LSTM state, language tags
    stripped from the final text; the position keys projected once."""

    def __init__(self, params, cfg, tokenizer=None, prompt_id: int = 0, max_new_per_chunk: int = 32):
        from asr_tpu_torch.streaming import nemotron_stream as ns

        self.ns = ns
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.prompt_id = prompt_id
        self.max_new = max_new_per_chunk
        self.device = _params_device(params)
        with torch.inference_mode():
            self.rel_k_cache = ns.precompute_rel_k(params, cfg)
        self.reset()

    def reset(self) -> None:
        self.state = self.ns.init_state(self.cfg, 1, self.device)
        self.state["token"] = torch.full_like(self.state["token"], self.cfg.base.blank_id)
        self.token_ids: list[int] = []
        self.elapsed = 0.0
        self.audio_samples = 0

    @torch.inference_mode()
    def push_chunk(self, chunk: np.ndarray) -> list[int]:
        assert len(chunk) == self.cfg.window_samples, "fixed-size windows required"
        t0 = time.perf_counter()
        pid = torch.full((1,), self.prompt_id, dtype=torch.int64, device=self.device)
        self.state, enc_proj = self.ns.encoder_step(self.params, self.cfg, self.state,
                                                    _on(self.device, chunk), pid, self.rel_k_cache)
        self.state, ids, count = self.ns.rnnt_stream_step(self.params, self.cfg, self.state, enc_proj,
                                                          max_new=self.max_new)
        new_ids = ids[0, : int(count[0])].tolist()
        self.token_ids.extend(new_ids)
        self.elapsed += time.perf_counter() - t0
        self.audio_samples += len(chunk)
        return new_ids

    def transcribe(self, audio: np.ndarray | str | Path) -> TranscribeResult:
        from asr_tpu_torch.runtime.transducer_session import strip_language_tags

        if isinstance(audio, (str, Path)):
            audio = audio_io.load_audio(audio, self.cfg.base.sample_rate, pcm_scale=1.0)
        audio = np.asarray(audio, np.float32)
        self.reset()
        w = self.cfg.window_samples
        n = len(audio)
        for i in range(-(-n // w)):
            chunk = np.zeros(w, np.float32)
            part = audio[i * w : (i + 1) * w]
            chunk[: len(part)] = part
            self.push_chunk(chunk)
        text = strip_language_tags(self.tokenizer.decode(self.token_ids)) if self.tokenizer else ""
        return TranscribeResult(text=text, token_ids=list(self.token_ids),
                                audio_seconds=n / self.cfg.base.sample_rate, elapsed_seconds=self.elapsed)


class DolphinStreamingSession:
    """Dolphin CN-dialect streaming: overlapped windows (3 mel frames of
    lookahead), per-chunk CTC partials, and a final AR rescoring pass over
    the accumulated cross-K/V with the language / region prompt."""

    def __init__(self, params, cfg, tokenizer=None, decode_cfg=None, language_id: int = -1,
                 region_id: int = -2, blank_id: int = 0, language_catalog: dict | None = None,
                 language: str | None = None):
        from asr_tpu_torch.decode.ar import DecodeConfig
        from asr_tpu_torch.streaming import dolphin_stream as ds

        self.ds = ds
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = _params_device(params)
        self.decode_cfg = decode_cfg or DecodeConfig(
            max_new_tokens=min(64, cfg.base.max_target_positions - 4), eot_id=cfg.base.eos_id,
            strategy="greedy")
        if language:
            # the same named two-level resolution as the offline DolphinSession
            from asr_tpu_torch.runtime.transducer_session import DolphinSession

            resolver = DolphinSession.__new__(DolphinSession)
            resolver.language_catalog = language_catalog or {}
            language_id, region_id = resolver.resolve_language(language)
        self.language_id = language_id
        self.region_id = region_id
        self.blank_id = blank_id
        with torch.inference_mode():
            self.rel_k_cache = ds.precompute_rel_k(params, cfg)
        self.reset()

    def reset(self) -> None:
        self.state = self.ds.init_state(self.cfg, 1, self.device)
        self.partial_ids: list[int] = []
        self._last_ctc = self.blank_id
        self.elapsed = 0.0

    @torch.inference_mode()
    def push_window(self, window: np.ndarray) -> list[int]:
        """One overlapped window -> the newly collapsed CTC partial ids."""
        assert len(window) == self.cfg.window_samples, "fixed-size windows required"
        t0 = time.perf_counter()
        self.state, ctc_ids, _ = self.ds.encoder_step(self.params, self.cfg, self.state,
                                                      _on(self.device, window), self.rel_k_cache)
        new: list[int] = []
        for t in ctc_ids[0].tolist():
            if t != self.blank_id and t != self._last_ctc:
                new.append(t)
            self._last_ctc = t
        self.partial_ids.extend(new)
        self.elapsed += time.perf_counter() - t0
        return new

    @torch.inference_mode()
    def finalize(self, generator: torch.Generator | None = None) -> list[int]:
        """AR rescoring over everything streamed so far."""
        t0 = time.perf_counter()
        prompt = torch.tensor([[self.cfg.base.sos_id, self.language_id, self.region_id]],
                              dtype=torch.int64, device=self.device)
        tokens, counts = self.ds.rescore_decode(self.params, self.cfg, self.state, prompt,
                                                self.decode_cfg, generator)
        row = tokens[0, 3 : 3 + int(counts[0])].tolist()
        self.elapsed += time.perf_counter() - t0
        return [t for t in row if t != self.cfg.base.eos_id]

    def transcribe(self, audio: np.ndarray | str | Path) -> TranscribeResult:
        if isinstance(audio, (str, Path)):
            audio = audio_io.load_audio(audio, self.cfg.base.sample_rate)
        audio = np.asarray(audio, np.float32)
        self.reset()
        n = len(audio)
        w, adv = self.cfg.window_samples, self.cfg.advance_samples
        pos = 0
        while pos + adv <= n or pos == 0:
            window = np.zeros(w, np.float32)
            part = audio[pos : pos + w]
            window[: len(part)] = part
            self.push_window(window)
            pos += adv
        ids = self.finalize()
        text = self.tokenizer.decode(ids) if self.tokenizer else ""
        return TranscribeResult(text=text, token_ids=ids, audio_seconds=n / self.cfg.base.sample_rate,
                                elapsed_seconds=self.elapsed)
