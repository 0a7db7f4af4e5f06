"""Whisper inference session: file/array -> token ids and text, 30 s windows.

Counterpart of ``asr_tpu/runtime/whisper_session.py``: 30-second
zero-padded windows, a per-window [SOT] probe (language + no-speech),
the prompt [SOT, lang, task, notimestamps], suppress / begin-suppress
biasing, greedy / penalty / sampling decode, optional repeated-tail
removal, and RTF reporting; ``transcribe`` opens its stage spans
(``asr.session.*``, ``runtime/profiling.annotate``) while a profile
records. With ``mesh=`` the window batch runs through
``parallel/serve.DataParallelRunner`` (data parallel; with ``param_specs``,
e.g. ``parallel/mesh.whisper_param_specs``, tensor parallel with the caches
at each rank's heads), on the per-weight decode step.

When the parameters are on a CUDA card and quantized matmuls run in the
``bf16`` mode, the session stacks the q8 decoder for the fused step
kernel (``ops/fused_aed_step.py``) and keeps one ``FusedAedDecoder``
over it; a single-window transcription then runs every decode step as one
kernel call, greedy decode as one CUDA graph replay a token.

The continuous-serving surface (``aed_engine_spec``, ``continuous_prefill``)
feeds ``parallel/llm_server.ContinuousSessionServer``, whose batcher steps
every slot through the multi-slot kernel (``ops/fused_aed_multi.py``) with
the same stacked weights.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from asr_tpu_torch.decode.ar import DecodeConfig
from asr_tpu_torch.models import whisper as wh
from asr_tpu_torch.ops.fused_aed_step import stack_whisper_step_params
from asr_tpu_torch.ops.quant_matmul import _resolve_mm
from asr_tpu_torch.parallel.mesh import rank_generator
from asr_tpu_torch.runtime import audio as audio_io
from asr_tpu_torch.runtime.artifact import load_model, load_tokenizer
from asr_tpu_torch.runtime.metadata import config_from_dict
from asr_tpu_torch.runtime.profiling import annotate
from asr_tpu_torch.runtime.session import TranscribeResult, bucket_windows

WINDOW_SECONDS = 30.0


def remove_repeated_tail(ids: list[int], min_rep: int = 2, max_span: int = 20) -> list[int]:
    """Drop a trailing immediate repetition of a span of up to ``max_span`` ids."""
    n = len(ids)
    for span in range(1, min(max_span, n // 2) + 1):
        reps = 1
        while (reps + 1) * span <= n and ids[n - (reps + 1) * span : n - reps * span] == ids[n - span :]:
            reps += 1
        if reps >= min_rep + 1:
            return ids[: n - (reps - 1) * span]
    return ids


@dataclasses.dataclass
class WhisperSessionConfig:
    language: str | None = None          # None -> auto-detect per window
    task: str = "transcribe"
    max_new_tokens: int = 440
    strategy: str = "greedy"
    penalty: float = 1.0
    penalty_range: int = 64
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    no_speech_threshold: float | None = 0.6
    suppress_ids: tuple[int, ...] = ()
    begin_suppress_ids: tuple[int, ...] = ()
    remove_repeats: bool = False


class WhisperSession:
    pcm_scale = 1.0  # [-1, 1] PCM

    def __init__(self, params, cfg: wh.WhisperConfig, tokenizer=None,
                 session_cfg: WhisperSessionConfig | None = None,
                 language_id_map: dict[str, int] | None = None,
                 window_seconds: float = WINDOW_SECONDS, mesh=None, param_specs=None):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.scfg = session_cfg or WhisperSessionConfig()
        self.window_samples = int(window_seconds * cfg.sample_rate)
        self.language_id_map = language_id_map or {}
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
            self.device = params["decoder"]["pos"].device
        self.params = params
        # The stacked copy duplicates the q8 decoder and the (D, V_pad) head:
        # built only where the fused kernel runs (a CUDA card, bf16 mode,
        # no runner: the sharded route decodes on the per-weight step).
        self.stacked = self._decoder = None
        if self.runner is None and self.device.type == "cuda" and _resolve_mm(None) == "bf16":
            self.stacked = stack_whisper_step_params(params, cfg)

    @property
    def decoder(self):
        """The batch-1 decode over ``self.stacked``
        (``ops/fused_aed_step.FusedAedDecoder``: its graphs and static
        buffers), made at first use and again when ``stacked`` is replaced;
        None without stacked weights."""
        if self.stacked is None:
            return None
        if self._decoder is None or self._decoder.stacked is not self.stacked:
            self._decoder = wh.fused_decoder(self.params, self.cfg, self.stacked)
        return self._decoder

    @property
    def sample_rate(self) -> int:
        return self.cfg.sample_rate

    @property
    def decode_cfg(self) -> DecodeConfig:
        s = self.scfg
        return DecodeConfig(
            max_new_tokens=s.max_new_tokens, eot_id=self.cfg.eot_id, suppress_ids=s.suppress_ids,
            strategy=s.strategy, penalty=s.penalty, penalty_range=s.penalty_range,
            temperature=s.temperature, top_k=s.top_k, top_p=s.top_p)

    # ---- continuous-batching serving surface (parallel/llm_server.py) ----

    def aed_engine_spec(self):
        from asr_tpu_torch.parallel.aed_batcher import spec_for_whisper

        return spec_for_whisper(self.cfg)

    @torch.inference_mode()
    def continuous_prefill(self, samples: np.ndarray, language: str | None = None) -> dict:
        """One request's prefilled decode state for the continuous AED
        engine: encoder + [SOT] probe + prompt prefill of one window
        (``models/whisper.prefill_window``). ``skip=True`` marks a no-speech
        window: the server returns empty ids without admitting it (the solo
        path decodes, then discards; skipping gives the same output)."""
        s = np.asarray(samples, np.float32)[: self.window_samples]
        buf = np.zeros((1, self.window_samples), np.float32)
        buf[0, : len(s)] = s
        prompt = torch.from_numpy(self._prompt(1, language)).to(self.device)
        mel = wh.mel_for_audio(self.cfg, torch.from_numpy(buf).to(self.device))
        pre = wh.prefill_window(self.params, self.cfg, mel, prompt, self.decode_cfg,
                                begin_suppress_ids=self.scfg.begin_suppress_ids)
        thresh = self.scfg.no_speech_threshold
        skip = thresh is not None and float(pre["no_speech_prob"][0]) > thresh
        tc = pre["state"]["layers"][0]["cross_k"].shape[1]
        return {"state": pre["state"], "p_len": prompt.shape[1], "logits0": pre["logits0"],
                "tc_valid": tc, "skip": skip}

    def _prompt(self, batch: int, language: str | None = None) -> np.ndarray:
        cfg, s = self.cfg, self.scfg
        language = language if language is not None else s.language
        if language is None:
            lang = -1  # auto-detect per window
        elif language in self.language_id_map:
            lang = self.language_id_map[language]
        else:
            raise KeyError(
                f"language {language!r} not in this artifact's language_id_map "
                f"({sorted(self.language_id_map) or 'empty'}); omit it for auto-detection")
        task = cfg.transcribe_id if s.task == "transcribe" else cfg.translate_id
        row = [cfg.sot_id, lang, task, cfg.no_timestamps_id]
        return np.tile(np.asarray(row, np.int64), (batch, 1))

    def transcribe(self, audio: np.ndarray | str | Path, language: str | None = None,
                   generator: torch.Generator | None = None) -> TranscribeResult:
        with annotate("asr.session.transcribe"):
            if isinstance(audio, (str, Path)):
                audio = audio_io.load_audio(audio, self.cfg.sample_rate, pcm_scale=1.0)
            with annotate("asr.session.pack"):
                audio = np.asarray(audio, np.float32)
                n = len(audio)
                w = self.window_samples
                starts = audio_io.iter_windows(n, w, w)
                num_windows = len(starts)
                padded = bucket_windows(num_windows)
                buf = np.zeros((padded, w), np.float32)
                for i, s in enumerate(starts):
                    chunk = audio[s : s + w]
                    buf[i, : len(chunk)] = chunk
                prompt_np = self._prompt(padded, language)
                prompt = torch.from_numpy(prompt_np)

            t0 = time.perf_counter()
            with torch.inference_mode():
                if self.runner is not None:
                    def window(p, a, pr):
                        return wh.transcribe_window(
                            p, self.cfg, wh.mel_for_audio(self.cfg, a), pr, self.decode_cfg,
                            begin_suppress_ids=self.scfg.begin_suppress_ids,
                            generator=rank_generator(generator))

                    out = self.runner(window, self.params, buf, prompt_np)
                else:
                    with annotate("asr.session.upload"):
                        audio_dev = torch.from_numpy(buf).to(self.device)
                    mel = wh.mel_for_audio(self.cfg, audio_dev)
                    with annotate("asr.session.upload"):
                        prompt_dev = prompt.to(self.device)
                    out = wh.transcribe_window(
                        self.params, self.cfg, mel, prompt_dev, self.decode_cfg,
                        begin_suppress_ids=self.scfg.begin_suppress_ids, generator=generator,
                        stacked=self.decoder if padded == 1 else None)
                with annotate("asr.session.download"):
                    tokens = out["tokens"].cpu().numpy()  # waits for the device
                    counts = out["counts"].cpu().numpy()
                    nsp = out["no_speech_prob"].cpu().numpy()
            elapsed = time.perf_counter() - t0

            with annotate("asr.session.collect"):
                p_len = prompt.shape[1]
                ids: list[int] = []
                for i in range(num_windows):
                    if self.scfg.no_speech_threshold is not None and nsp[i] > self.scfg.no_speech_threshold:
                        continue
                    win_ids = [int(t) for t in tokens[i, p_len : p_len + counts[i]] if t != self.cfg.eot_id]
                    ids.extend(remove_repeated_tail(win_ids) if self.scfg.remove_repeats else win_ids)
                text = self.tokenizer.decode(ids) if self.tokenizer is not None else ""
            return TranscribeResult(text=text, token_ids=ids, audio_seconds=n / self.cfg.sample_rate,
                                    elapsed_seconds=elapsed)


def load_whisper_session(folder: str | Path, device="cuda", tokenizer=None,
                         **session_kw) -> WhisperSession:
    """Artifact folder (``metadata.json`` family ``whisper``, config under
    ``extra["config"]``) -> a session on ``device``, with the suppress lists
    and the language map read from the metadata and, unless ``tokenizer`` is
    given, the artifact's tokenizer file (``runtime/artifact.load_tokenizer``)."""
    params, meta = load_model(folder, device)
    if meta.family != "whisper":
        raise ValueError(f"expected a whisper artifact, got family {meta.family!r}")
    if tokenizer is None:
        tokenizer = load_tokenizer(folder, meta)
    cfg = config_from_dict(wh.WhisperConfig, meta.extra.get("config", {}))
    scfg = WhisperSessionConfig(
        suppress_ids=tuple(meta.extra.get("suppress_tokens", [])),
        begin_suppress_ids=tuple(meta.extra.get("begin_suppress_tokens", [])))
    lang_map = {p.code: p.prompt_token_id for p in meta.supported_languages
                if p.prompt_token_id is not None}
    return WhisperSession(params, cfg, tokenizer=tokenizer, session_cfg=scfg,
                          language_id_map=lang_map, **session_kw)
