"""Inference sessions: file/array in -> tokens and text out, with RTF reporting.

Counterpart of ``asr_tpu/runtime/session.py`` (``SenseVoiceSession``):
long audio is cut into fixed windows, the windows run as one padded batch
in a single forward, and the per-window token ids are concatenated in order;
``transcribe_batch`` runs many short files as one padded forward.
``transcribe`` opens its stage spans (``asr.session.*``,
``runtime/profiling.annotate``) while a profile records. With
``mesh=`` the forward runs through ``parallel/serve.DataParallelRunner``
(batch data parallel over the mesh's data axis; with ``param_specs``, e.g.
``parallel/mesh.sensevoice_param_specs``, tensor parallel over its model
axis).
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from asr_tpu_torch.models import sensevoice as sv
from asr_tpu_torch.runtime import audio as audio_io
from asr_tpu_torch.runtime.artifact import load_model, load_tokenizer
from asr_tpu_torch.runtime.metadata import ModelMetadata, config_from_dict
from asr_tpu_torch.runtime.profiling import annotate


@dataclasses.dataclass
class TranscribeResult:
    text: str
    token_ids: list[int]
    audio_seconds: float
    elapsed_seconds: float   # wall-clock latency of the forward that produced this
    batch_size: int = 1      # items sharing that forward (batched calls: the whole batch's latency)

    @property
    def rtf(self) -> float:
        return self.elapsed_seconds / max(self.audio_seconds, 1e-9)


def bucket_windows(num: int) -> int:
    """Round a window count up to the next power of two, so a session sees
    few distinct batch shapes. Padded windows carry valid=0."""
    n = 1
    while n < num:
        n *= 2
    return n


def _params_device(params) -> torch.device:
    return params["ctc"]["b"].device


class SenseVoiceSession:
    """Batched sliding-window SenseVoice inference on the parameters' device."""

    # windowed-session protocol (used by parallel.http_server)
    pcm_scale = 32768.0
    sample_rate = 16000

    def __init__(self, params, cfg: sv.SenseVoiceConfig, tokenizer=None,
                 metadata: ModelMetadata | None = None, window_seconds: float = 8.0,
                 window_stride_seconds: float | None = None, mesh=None, param_specs=None):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.metadata = metadata
        self.window_samples = int(window_seconds * cfg.sample_rate)
        self.stride_samples = (
            int(window_stride_seconds * cfg.sample_rate)
            if window_stride_seconds else self.window_samples
        )
        if not 0 < self.stride_samples <= self.window_samples:
            raise ValueError("window stride must be in (0, window]")
        self.runner = None
        if mesh is not None:
            from asr_tpu_torch.parallel.serve import DataParallelRunner

            tp = mesh.shape["model"]
            if param_specs is not None and cfg.num_heads % tp:
                raise ValueError(f"tensor-parallel size {tp} must divide num_heads={cfg.num_heads}")
            self.runner = DataParallelRunner(mesh, param_specs=param_specs)
            params = self.runner.shard_params(params)
            self.device = self.runner.device
        else:
            self.device = _params_device(params)
        self.params = params

    def language_index(self, language: str) -> int:
        for i, (code, desc, aliases, _tok) in enumerate(sv.LANGUAGE_PROFILES):
            if language.lower() in (code, desc.lower(), *(a.lower() for a in aliases)):
                return i
        raise KeyError(f"unsupported language {language!r}")

    def transcribe(self, audio: np.ndarray | str | Path, language: str = "auto") -> TranscribeResult:
        with annotate("asr.session.transcribe"):
            if isinstance(audio, (str, Path)):
                audio = audio_io.load_audio(audio, self.cfg.sample_rate)
            with annotate("asr.session.pack"):
                audio = np.asarray(audio, dtype=np.float32)
                n = len(audio)
                w = self.window_samples
                starts = audio_io.iter_windows(n, w, self.stride_samples)
                num_windows = len(starts)
                padded = bucket_windows(num_windows)
                buf = np.zeros((padded, w), dtype=np.float32)
                valid = np.zeros((padded,), dtype=np.int32)
                for i, s in enumerate(starts):
                    chunk = audio[s : s + w]
                    buf[i, : len(chunk)] = chunk
                    valid[i] = len(chunk)

            t0 = time.perf_counter()
            toks, counts = self._run(buf, valid, language)
            elapsed = time.perf_counter() - t0

            with annotate("asr.session.collect"):
                ids: list[int] = []
                for i in range(num_windows):
                    ids.extend(int(t) for t in toks[i, : counts[i]])
                text = self.tokenizer.decode(ids) if self.tokenizer is not None else ""
            return TranscribeResult(text=text, token_ids=ids, audio_seconds=n / self.cfg.sample_rate,
                                    elapsed_seconds=elapsed)

    def transcribe_batch(self, paths, language: str = "auto", n_threads: int = 0) -> list[TranscribeResult]:
        """Many short files -> one padded forward: the parallel batch loader
        fills a fixed (N, window) buffer and every file rides the same
        forward; files longer than one window fall back to the windowed
        :meth:`transcribe`."""
        buf, valid = audio_io.load_audio_batch(paths, self.cfg.sample_rate, self.window_samples,
                                               n_threads=n_threads)
        valid_clip = np.minimum(valid, self.window_samples)
        t0 = time.perf_counter()
        toks, counts = self._run(buf, valid_clip, language)
        elapsed = time.perf_counter() - t0
        results = []
        for i, path in enumerate(paths):
            if valid[i] > self.window_samples:
                results.append(self.transcribe(path, language=language))
                continue
            ids = [int(t) for t in toks[i, : counts[i]]]
            results.append(TranscribeResult(
                text=self.tokenizer.decode(ids) if self.tokenizer is not None else "",
                token_ids=ids, audio_seconds=float(valid[i]) / self.cfg.sample_rate,
                elapsed_seconds=elapsed, batch_size=len(paths)))
        return results

    def warmup(self) -> None:
        self.transcribe(np.zeros(self.window_samples, dtype=np.float32))

    def _run(self, buf: np.ndarray, valid: np.ndarray, language: str) -> tuple[np.ndarray, np.ndarray]:
        """One forward over (N, window) windows, through the runner when
        there is one -> (tokens, counts) on the host."""
        if self.runner is not None:
            toks, counts = self.runner(lambda p, a, v: self._forward(p, a, v, language),
                                       self.params, buf, valid)
        else:
            with annotate("asr.session.upload"):
                audio = torch.from_numpy(buf).to(self.device)
                valid = torch.from_numpy(valid).to(self.device)
            toks, counts = self._forward(self.params, audio, valid, language)
        with annotate("asr.session.download"):
            return toks.cpu().numpy(), counts.cpu().numpy()  # waits for the device

    def _forward(self, params, audio: torch.Tensor, valid: torch.Tensor, language: str = "auto"):
        lang = torch.full((audio.shape[0],), self.language_index(language), dtype=torch.int64,
                          device=audio.device)
        with torch.inference_mode():
            return sv.forward(params, self.cfg, audio, valid, lang)

    def _postprocess(self, text: str) -> str:
        return text


def load_session(folder: str | Path, device="cuda", tokenizer=None, **session_kw) -> SenseVoiceSession:
    """Artifact folder (``metadata.json`` family ``sensevoice``, its config
    under ``extra["config"]``) -> a session on ``device``, decoding with
    ``tokenizer`` or else the artifact's tokenizer file (:func:`load_tokenizer`)."""
    params, meta = load_model(folder, device)
    if meta.family != "sensevoice":
        raise ValueError(f"expected a sensevoice artifact, got family {meta.family!r}")
    cfg = config_from_dict(sv.SenseVoiceConfig, meta.extra.get("config", {}))
    if tokenizer is None:
        tokenizer = load_tokenizer(folder, meta)
    return SenseVoiceSession(params, cfg, tokenizer=tokenizer, metadata=meta, **session_kw)
