"""Offline windowed sessions: fixed windows, one batched forward, tokenizer
decode, RTF.

Counterpart of ``asr_tpu/runtime/transducer_session.py`` for every offline
windowed family: the shared windowed machinery (``_WindowedSession``;
``mesh=`` runs its forward through ``parallel/serve.DataParallelRunner``,
batch data parallel), the transducers Parakeet-TDT
(``ParakeetSession``, 24 s windows) and Nemotron (``NemotronSession``, a
prompt id, language tags stripped from the text), the AED families
FireRed (``FireRedSession``) and Dolphin (``DolphinSession``, with its
language / region probes and catalog), Paraformer (``ParaformerSession``,
CIF + non-AR decoder) and Fun-ASR-Nano's fast CTC head
(``FunAsrNanoCtcSession``). Each session wraps a model module's forward
with the family's PCM convention; the parameters' device is the session's.

The AED sessions stack their q8 decoder for the fused step kernel
(``ops/fused_aed_step.py``) where it runs (a CUDA card, the bf16 mode) and
keep one ``FusedAedDecoder`` over it: a one-window transcription then runs
every decode step as one kernel call, greedy decode as one CUDA graph
replay a token.
Their continuous-serving surface (``aed_engine_spec``,
``continuous_prefill``) feeds ``parallel/llm_server.ContinuousSessionServer``,
whose batcher steps every slot through the multi-slot kernel with the same
stacked weights.
"""

from __future__ import annotations

import re
import time
from pathlib import Path

import numpy as np
import torch

from asr_tpu_torch.layers.conformer import subsampled_length
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


def _aed_stacked(sess, cfg):
    """Stacked q8 decoder weights for the fused AED step
    (``ops/fused_aed_step.stack_aed_step_params``), or None: built only where
    the kernel runs (parameters on a CUDA card, the bf16 mode), since the
    stacked copy duplicates the q8 decoder and the (D, V_pad) head."""
    if sess.runner is not None or sess.device.type != "cuda" or not isinstance(sess.params, dict) \
            or "decoder" not in sess.params:
        return None
    from asr_tpu_torch.ops.fused_aed_step import AedGeom, stack_aed_step_params
    from asr_tpu_torch.ops.quant_matmul import _resolve_mm

    if _resolve_mm(None) != "bf16":
        return None
    return stack_aed_step_params(sess.params["decoder"],
                                 AedGeom(cfg.d_model, cfg.dec_ffn, cfg.dec_heads))


def _aed_decoder(sess):
    """The session's batch-1 decode over ``sess.stacked``
    (``ops/fused_aed_step.FusedAedDecoder``: its graphs and static buffers),
    made at first use and again when ``stacked`` is replaced; None without
    stacked weights."""
    if sess.stacked is None:
        return None
    made = getattr(sess, "_decoder", None)
    if made is None or made.stacked is not sess.stacked:
        from asr_tpu_torch.ops.fused_aed_step import scaled_embed_decoder

        made = sess._decoder = scaled_embed_decoder(sess.params, sess.cfg, sess.stacked)
    return made


def _one_window(sess, samples) -> tuple[torch.Tensor, torch.Tensor]:
    """One zero-padded window of ``samples`` and its valid count, on the
    session's device (a continuous request's prefill input)."""
    s = np.asarray(samples, np.float32)[: sess.window_samples]
    buf = np.zeros((1, sess.window_samples), np.float32)
    buf[0, : len(s)] = s
    return (torch.from_numpy(buf).to(sess.device),
            torch.tensor([len(s)], dtype=torch.int64, device=sess.device))


class _WindowedSession:
    """Shared machinery: pad and window the audio, run the forward on one
    padded batch of windows."""

    pcm_scale = 1.0         # 32768.0 = the int16 numeric range convention
    window_seconds = 30.0
    sample_rate = 16000

    def __init__(self, params, cfg, tokenizer=None, window_seconds=None, mesh=None,
                 param_specs=None):
        self.cfg = cfg
        self.tokenizer = tokenizer
        if window_seconds is not None:
            self.window_seconds = window_seconds
        self.window_samples = int(self.window_seconds * self.sample_rate)
        self.runner = None
        if mesh is not None:
            from asr_tpu_torch.parallel.serve import DataParallelRunner

            self.runner = DataParallelRunner(mesh, param_specs=param_specs)
            params = self.runner.shard_params(params)
            self.device = self.runner.device
        else:
            self.device = _params_device(params)
        self.params = params

    def _forward(self, params, audio: torch.Tensor, valid: torch.Tensor):
        raise NotImplementedError

    def _postprocess(self, text: str) -> str:
        return text

    def _run(self, buf: np.ndarray, valid: np.ndarray, **kw):
        """One forward over (N, window) windows -> (tokens, counts) on the
        host, and its wall time (the device's work included)."""
        t0 = time.perf_counter()
        with torch.inference_mode():
            if self.runner is not None:
                toks, counts = self.runner(lambda p, a, v: self._forward(p, a, v, **kw),
                                           self.params, buf, valid)
            else:
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


class ParakeetSession(_WindowedSession):
    """Parakeet-TDT offline; NeMo's [-1, 1] PCM (``mel.input_scale`` in the
    config), 24 s windows."""

    window_seconds = 24.0

    def _forward(self, params, audio, valid):
        from asr_tpu_torch.models import parakeet as pk

        return pk.forward(params, self.cfg, audio, valid)


class NemotronSession(_WindowedSession):
    """Nemotron offline RNN-T with a multilingual prompt id; emitted
    ``<xx>`` language tags are stripped from the text."""

    def __init__(self, params, cfg, tokenizer=None, prompt_id: int = 0, **kw):
        super().__init__(params, cfg, tokenizer, **kw)
        self.prompt_id = prompt_id

    def _forward(self, params, audio, valid):
        from asr_tpu_torch.models import nemotron as nm

        pid = torch.full((audio.shape[0],), self.prompt_id, dtype=torch.int64, device=audio.device)
        return nm.forward(params, self.cfg, audio, valid, pid)

    def _postprocess(self, text: str) -> str:
        return strip_language_tags(text)


class ParaformerSession(_WindowedSession):
    """Paraformer non-streaming: Kaldi int16-range PCM, 30 s windows, at
    most ``max_tokens`` CIF tokens a window."""

    pcm_scale = 32768.0
    window_seconds = 30.0

    def __init__(self, params, cfg, tokenizer=None, max_tokens: int = 256, **kw):
        super().__init__(params, cfg, tokenizer, **kw)
        self.max_tokens = max_tokens

    def _forward(self, params, audio, valid):
        from asr_tpu_torch.models import paraformer as pf

        return pf.forward(params, self.cfg, audio, valid, max_tokens=self.max_tokens)


class FireRedSession(_WindowedSession):
    """FireRedASR-AED offline: Kaldi int16-range PCM, 30 s windows, greedy /
    penalty / sampling AR decode from [SOS] (the SOS slot is dropped from
    the ids)."""

    pcm_scale = 32768.0
    decoder = property(_aed_decoder)

    def __init__(self, params, cfg, tokenizer=None, decode_cfg=None, **kw):
        super().__init__(params, cfg, tokenizer, **kw)
        from asr_tpu_torch.decode.ar import DecodeConfig

        self.decode_cfg = decode_cfg or DecodeConfig(max_new_tokens=224, eot_id=cfg.eos_id,
                                                     strategy="greedy")
        self.stacked = _aed_stacked(self, cfg)

    def _forward(self, params, audio, valid):
        from asr_tpu_torch.models import firered as fr

        toks, counts = fr.transcribe(params, self.cfg, audio, valid, self.decode_cfg,
                                     stacked=self.decoder if audio.shape[0] == 1 else None)
        return toks[:, 1:], counts  # drop the SOS slot

    # ---- continuous-batching serving surface (parallel/llm_server.py) ----

    def aed_engine_spec(self):
        """The engine spec, its cross length computed on the host: the
        fixed window's fbank frames, the lookahead pad and the two stem
        convs (``models/firered.encode_from_mel``'s arithmetic)."""
        from asr_tpu_torch.parallel.aed_batcher import spec_for_aed

        t = self.cfg.fbank.num_frames(self.window_samples) + self.cfg.pad_lookahead
        return spec_for_aed(self.cfg, subsampled_length(t))

    @torch.inference_mode()
    def continuous_prefill(self, samples, language: str | None = None) -> dict:
        """One request's prefilled decode state for the continuous AED engine
        (``models/firered.prefill_window`` on one window); FireRed takes no
        language."""
        from asr_tpu_torch.models import firered as fr

        audio, valid = _one_window(self, samples)
        pre = fr.prefill_window(self.params, self.cfg, audio, valid, self.decode_cfg)
        return {"state": pre["state"], "p_len": 1, "logits0": pre["logits0"],
                "tc_valid": int(pre["enc_valid"][0]), "skip": False}


class DolphinSession(_WindowedSession):
    """Dolphin offline AED with language / region auto-probe: prompt [sos,
    lang, region] where -1 / -2 ask for the probed language / region token;
    the ids start after the prompt. ``last_language`` / ``last_region`` hold
    the probes of the last call."""

    pcm_scale = 32768.0
    decoder = property(_aed_decoder)
    window_seconds = 30.0

    def __init__(self, params, cfg, tokenizer=None, decode_cfg=None, language_id: int = -1,
                 region_id: int = -2, language_catalog: dict | None = None,
                 language: str | None = None, **kw):
        super().__init__(params, cfg, tokenizer, **kw)
        from asr_tpu_torch.decode.ar import DecodeConfig

        self.decode_cfg = decode_cfg or DecodeConfig(max_new_tokens=224, eot_id=cfg.eos_id,
                                                     strategy="greedy")
        self.stacked = _aed_stacked(self, cfg)
        # ``language_catalog``: the artifact's two-level token catalog
        # (``dolphin_language_catalog``). ``language`` takes "ja",
        # "Japanese", "zh-SICHUAN" or "Chinese-Sichuan"-style names and
        # resolves to forced prompt ids; -1 / -2 keep the probes.
        self.language_catalog = language_catalog or {}
        if language:
            language_id, region_id = self.resolve_language(language)
        self.language_id = language_id
        self.region_id = region_id
        self.last_language: int | None = None
        self.last_region: int | None = None

    def resolve_language(self, name: str) -> tuple[int, int]:
        """Name -> (language token id, region token id or -2).

        Takes a model code ("ja", "zh-SICHUAN"), an alias ("Japanese") or an
        Alias-Region compound ("Chinese-Sichuan"). Raises KeyError listing
        the catalog when it cannot resolve the name: forcing a language by
        name never falls back to auto-detection."""
        cat = self.language_catalog
        langs = cat.get("languages") or {}
        regions = cat.get("regions") or {}
        aliases = {k.lower(): v for k, v in (cat.get("aliases") or {}).items()}
        want = name.strip()
        if want.lower() in ("auto", "auto-auto"):
            return -1, -2
        lang_part, _, region_part = want.partition("-")
        code = aliases.get(lang_part.lower(), lang_part.lower())
        if code not in langs:
            raise KeyError(
                f"language {name!r} not in this artifact's catalog "
                f"(languages: {sorted(langs) or 'none — rebuild with --vocab'}; "
                f"aliases: {sorted(cat.get('aliases') or {})})")
        if not region_part or region_part.lower() == "auto":
            return langs[code], -2
        region = region_part.upper()
        if region not in regions:
            raise KeyError(f"region {region_part!r} not in this artifact's catalog "
                           f"(regions: {sorted(regions)})")
        return langs[code], regions[region]

    def _prompt(self, batch: int, language: str | None = None, device=None) -> torch.Tensor:
        lang_id, region_id = (self.resolve_language(language) if language
                              else (self.language_id, self.region_id))
        row = torch.tensor([[self.cfg.sos_id, lang_id, region_id]], dtype=torch.int64,
                           device=device or self.device)
        return row.expand(batch, -1).contiguous()

    def _note_probes(self, out: dict) -> None:
        if "language" in out:
            self.last_language = int(out["language"][0])
        if "region" in out:
            self.last_region = int(out["region"][0])

    def _forward(self, params, audio, valid):
        from asr_tpu_torch.models import dolphin as dp

        b = audio.shape[0]
        prompt = self._prompt(b, device=audio.device)
        out = dp.transcribe(params, self.cfg, audio, valid, prompt, self.decode_cfg,
                            stacked=self.decoder if b == 1 else None)
        self._note_probes(out)
        return out["tokens"][:, prompt.shape[1]:], out["counts"]

    # ---- continuous-batching serving surface (parallel/llm_server.py) ----

    def aed_engine_spec(self):
        """The engine spec, its cross length computed on the host: the
        fixed window's ``1 + S // hop`` mel frames through the two stem
        convs (``models/dolphin.encode_from_mel``'s arithmetic); no encoder
        runs, so no probe touches ``last_language`` / ``last_region``."""
        from asr_tpu_torch.parallel.aed_batcher import spec_for_aed

        return spec_for_aed(self.cfg, subsampled_length(self.cfg.mel.num_frames(self.window_samples)))

    @torch.inference_mode()
    def continuous_prefill(self, samples, language: str | None = None) -> dict:
        """One request's prefilled decode state for the continuous AED engine
        (``models/dolphin.prefill_window``: encoder, probes, the 3-id prompt);
        ``language`` forces this request's prompt."""
        from asr_tpu_torch.models import dolphin as dp

        audio, valid = _one_window(self, samples)
        pre = dp.prefill_window(self.params, self.cfg, audio, valid, self._prompt(1, language),
                                self.decode_cfg)
        self._note_probes(pre)
        return {"state": pre["state"], "p_len": 3, "logits0": pre["logits0"],
                "tc_valid": int(pre["enc_valid"][0]), "skip": False}


class FunAsrNanoCtcSession(_WindowedSession):
    """Fun-ASR-Nano's fast CTC head; Kaldi int16 PCM convention, 30 s windows."""

    pcm_scale = 32768.0
    window_seconds = 30.0

    def _forward(self, params, audio, valid):
        from asr_tpu_torch.models import fun_asr_nano as fn

        return fn.forward_ctc(params, self.cfg, audio, valid)
