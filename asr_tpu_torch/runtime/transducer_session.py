"""Offline windowed sessions: fixed windows, one batched forward, tokenizer
decode, RTF.

Counterpart of ``asr_tpu/runtime/transducer_session.py`` for the families
the port runs so far: the shared windowed machinery (``_WindowedSession``,
without the ``mesh=`` data-parallel runner) and Fun-ASR-Nano's fast CTC
head (``FunAsrNanoCtcSession``). Each session wraps a model module's
forward with the family's PCM convention; the parameters' device is the
session's.
"""

from __future__ import annotations

import re
import time
from pathlib import Path

import numpy as np
import torch

from asr_tpu_torch.runtime import audio as audio_io
from asr_tpu_torch.runtime.session import TranscribeResult, bucket_windows


def strip_language_tags(text: str) -> str:
    """Drop emitted ``<en>`` / ``<zh-CN>``-style language tags."""
    return re.sub(r"<[a-z]{2}(-[A-Za-z]{2,4})?>", "", text).strip()


def _params_device(tree) -> torch.device:
    """The device of a tensor in a parameter tree (the CPU for an empty one)."""
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, torch.Tensor):
            return node.device
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif hasattr(node, "q"):  # a quantized leaf
            stack.append(node.q)
    return torch.device("cpu")


class _WindowedSession:
    """Shared machinery: pad and window the audio, run the forward on one
    padded batch of windows."""

    pcm_scale = 1.0         # 32768.0 = the int16 numeric range convention
    window_seconds = 30.0
    sample_rate = 16000

    def __init__(self, params, cfg, tokenizer=None, window_seconds=None):
        self.cfg = cfg
        self.tokenizer = tokenizer
        if window_seconds is not None:
            self.window_seconds = window_seconds
        self.window_samples = int(self.window_seconds * self.sample_rate)
        self.params = params
        self.device = _params_device(params)

    def _forward(self, params, audio: torch.Tensor, valid: torch.Tensor):
        raise NotImplementedError

    def _postprocess(self, text: str) -> str:
        return text

    def _run(self, buf: np.ndarray, valid: np.ndarray, **kw):
        """One forward over (N, window) windows -> (tokens, counts) on the
        host, and its wall time (the device's work included)."""
        t0 = time.perf_counter()
        with torch.inference_mode():
            toks, counts = self._forward(self.params, torch.from_numpy(buf).to(self.device),
                                         torch.from_numpy(valid).to(self.device), **kw)
            toks = toks.cpu().numpy()  # waits for the device
            counts = counts.cpu().numpy()
        return toks, counts, time.perf_counter() - t0

    def transcribe(self, audio: np.ndarray | str | Path, **kw) -> TranscribeResult:
        if isinstance(audio, (str, Path)):
            audio = audio_io.load_audio(audio, self.sample_rate, pcm_scale=self.pcm_scale)
        audio = np.asarray(audio, np.float32)
        n = len(audio)
        w = self.window_samples
        starts = audio_io.iter_windows(n, w, w)
        num = len(starts)
        padded = bucket_windows(num)
        buf = np.zeros((padded, w), np.float32)
        valid = np.zeros((padded,), np.int64)
        for i, s in enumerate(starts):
            chunk = audio[s : s + w]
            buf[i, : len(chunk)] = chunk
            valid[i] = len(chunk)
        toks, counts, elapsed = self._run(buf, valid, **kw)
        ids = [int(t) for i in range(num) for t in toks[i, : counts[i]]]
        text = self._postprocess(self.tokenizer.decode(ids)) if self.tokenizer else ""
        return TranscribeResult(text=text, token_ids=ids, audio_seconds=n / self.sample_rate,
                                elapsed_seconds=elapsed)

    def transcribe_batch(self, paths, n_threads: int = 0, **kw) -> list[TranscribeResult]:
        """Many short files -> one forward: the parallel batch loader fills a
        fixed (N, window) buffer; files longer than one window fall back to
        the windowed :meth:`transcribe`."""
        buf, true_len = audio_io.load_audio_batch(paths, self.sample_rate, self.window_samples,
                                                  pcm_scale=self.pcm_scale, n_threads=n_threads)
        valid = np.minimum(true_len, self.window_samples).astype(np.int64)
        toks, counts, elapsed = self._run(buf, valid, **kw)
        results = []
        for i, path in enumerate(paths):
            if true_len[i] > self.window_samples:
                results.append(self.transcribe(path, **kw))
                continue
            ids = [int(t) for t in toks[i, : counts[i]]]
            text = self._postprocess(self.tokenizer.decode(ids)) if self.tokenizer else ""
            results.append(TranscribeResult(text=text, token_ids=ids,
                                            audio_seconds=float(valid[i]) / self.sample_rate,
                                            elapsed_seconds=elapsed, batch_size=len(paths)))
        return results


class FunAsrNanoCtcSession(_WindowedSession):
    """Fun-ASR-Nano's fast CTC head; Kaldi int16 PCM convention, 30 s windows."""

    pcm_scale = 32768.0
    window_seconds = 30.0

    def _forward(self, params, audio, valid):
        from asr_tpu_torch.models import fun_asr_nano as fn

        return fn.forward_ctc(params, self.cfg, audio, valid)
