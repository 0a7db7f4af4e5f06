"""Qwen3-ASR session: prompt assembly, context and language prompts.

Counterpart of ``asr_tpu/runtime/qwen_session.py`` (``QwenAsrSession``):
the chat-style prompt [head | user context
text | suffix | audio | tail] is tokenized on the host, each utterance is
cut to ``max_seconds`` and zero-padded, and one call runs the tower, the
prefill and the decode. Qwen has no language probe: a language comes from
the artifact's prompt catalog or from the model's own "language X<asr_text>"
prefix, which :func:`parse_asr_output` splits off.

When the parameters are on a CUDA card and quantized matmuls run in the
``bf16`` mode, the session stacks the q4-packed LLM for the fused decode
step (``ops/fused_decode.py``); a batch-1 transcription then runs every
decode step as one kernel call, with the tied head inside it, and the
continuous server (``parallel/llm_server.py``) every step of all its slots
as one call of the multi-slot kernel (``ops/fused_decode_multi.py``). An LLM
that does not stack (a q2 LLM: packed 2-bit linears and a centered 2-bit
tied head) takes the per-weight route everywhere, every linear one
``quant_dense`` call (the int2 kernel on a card).

With ``mesh=`` both sessions run through ``parallel/serve.DataParallelRunner``:
batch data parallel over the mesh's data axis, and the LLM sharded by
``parallel/mesh.qwen3_param_specs`` over its model axis (the audio tower
replicates); the batch-1 fused step is not used there.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from asr_tpu_torch.decode.ar import DecodeConfig
from asr_tpu_torch.layers.qwen3 import fuse_params
from asr_tpu_torch.models import fun_asr_nano as fn
from asr_tpu_torch.models import qwen_asr as qa
from asr_tpu_torch.ops.fused_decode import stack_decode_params
from asr_tpu_torch.ops.quant_matmul import _resolve_mm
from asr_tpu_torch.parallel.mesh import ShardedParams, rank_generator
from asr_tpu_torch.runtime import audio as audio_io
from asr_tpu_torch.runtime.artifact import load_model, load_tokenizer
from asr_tpu_torch.runtime.metadata import config_from_dict
from asr_tpu_torch.runtime.session import TranscribeResult


@dataclasses.dataclass
class QwenPromptTemplate:
    """Token-id templates around the audio (from the checkpoint's chat
    template and special tokens)."""

    head_ids: tuple[int, ...] = ()      # e.g. <|im_start|>system...<|im_start|>user
    suffix_ids: tuple[int, ...] = ()    # between context text and audio
    tail_ids: tuple[int, ...] = ()      # e.g. <|im_end|><|im_start|>assistant


ASR_TEXT_TAG = "<asr_text>"
LANG_PREFIX = "language "


def parse_asr_output(raw: str, user_language: str | None = None) -> tuple[str, str]:
    """Split a decoded "language English<asr_text>hello" string into
    (language, text)."""
    text = (raw or "").strip()
    if not text:
        return "", ""
    if user_language:
        return user_language, text
    if ASR_TEXT_TAG not in text:
        return "", text
    meta_part, text_part = text.split(ASR_TEXT_TAG, 1)
    language = ""
    index = meta_part.lower().find(LANG_PREFIX)
    if index >= 0:
        language = meta_part[index + len(LANG_PREFIX):].strip()
        if language:
            language = language[:1].upper() + language[1:].lower()
    return language, text_part.strip()


def _batched_llm_call(items, *, max_samples, sample_rate, pcm_scale, run, eot_id, device):
    """Shared body of the batched LLM transcribe path: load and cut each
    item to ``max_samples``, zero-pad into one (B, W) buffer, run ``run(audio,
    valid, b) -> (tokens, counts, starts)``, slice each row's generated
    region and drop the EOT. Returns (ids_per_row, valid, elapsed, b)."""
    arrs = []
    for a in items:
        if isinstance(a, (str, Path)):
            a = audio_io.load_audio(a, sample_rate, pcm_scale=pcm_scale)
        arrs.append(np.asarray(a, np.float32)[:max_samples])
    b = len(arrs)
    buf = np.zeros((b, max_samples), np.float32)
    valid = np.zeros((b,), np.int64)
    for i, a in enumerate(arrs):
        buf[i, : len(a)] = a
        valid[i] = len(a)
    t0 = time.perf_counter()
    with torch.inference_mode():
        tokens, counts, starts = run(torch.from_numpy(buf).to(device),
                                     torch.from_numpy(valid).to(device), b)
        tokens = tokens.cpu().numpy()  # waits for the device
        counts, starts = counts.cpu().numpy(), starts.cpu().numpy()
    elapsed = time.perf_counter() - t0
    ids_rows = []
    for i in range(b):
        v, c = int(starts[i]), int(counts[i])
        ids_rows.append([int(t) for t in tokens[i, v : v + c] if t != eot_id])
    return ids_rows, valid, elapsed, b


def _shard(sess, mesh, front, llm_params, lcfg):
    """Lay a session's front end (replicated) and LLM (``qwen3_param_specs``)
    out on ``mesh``: sets ``runner``, ``device`` and ``_sharded`` (the
    positions' (front, llm) tuples); returns the sharded (front, llm)."""
    from asr_tpu_torch.parallel.mesh import qwen3_param_specs, shard_params
    from asr_tpu_torch.parallel.serve import DataParallelRunner

    tp = mesh.shape["model"]
    if lcfg.num_heads % tp or lcfg.num_kv_heads % tp:
        raise ValueError(f"tensor-parallel size {tp} must divide num_heads={lcfg.num_heads} "
                         f"and num_kv_heads={lcfg.num_kv_heads}")
    sess.runner = DataParallelRunner(mesh, param_specs=qwen3_param_specs)
    sess.device = sess.runner.device
    front = shard_params(front, mesh)
    llm = sess.runner.shard_params(llm_params)
    sess._sharded = ShardedParams.zip(front, llm)
    return front, llm


def _params_device(llm_params) -> torch.device:
    if isinstance(llm_params, dict) and "final_norm" in llm_params:
        return llm_params["final_norm"]["scale"].device
    return torch.device("cpu")


class QwenAsrSession:
    pcm_scale = 1.0  # the tower consumes [-1, 1] PCM
    # Each window's decode carries its own "language X<asr_text>" prefix, so
    # the HTTP server decodes and strips per window.
    postprocess_per_window = True

    def __init__(self, tower_params, llm_params, cfg: qa.QwenAsrConfig, tokenizer=None,
                 template: QwenPromptTemplate | None = None, max_new_tokens: int = 256,
                 strategy: str = "greedy", penalty: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0, max_seconds: float = 30.0,
                 language_prompt_ids: dict[str, list[int]] | None = None, metadata=None,
                 fuse: bool = True, mesh=None):
        if fuse:
            # q|k|v and gate|up fusion: 7 -> 4 matmuls a layer, bit-exact.
            llm_params = fuse_params(llm_params, cfg.llm)
        self.runner = None
        if mesh is not None:
            tower_params, llm_params = _shard(self, mesh, tower_params, llm_params, cfg.llm)
        else:
            self.device = _params_device(llm_params)
        self.tower_params = tower_params
        self.llm_params = llm_params
        self.cfg = cfg
        # The stacked copy duplicates the q4 LLM and the packed head: built
        # only where the fused kernel runs (a CUDA card, bf16 mode, no
        # runner). Other LLMs (q2, q8, f32) do not stack and stay on the
        # per-weight route.
        self.stacked = None
        if self.runner is None and self.device.type == "cuda" and _resolve_mm(None) == "bf16":
            self.stacked = stack_decode_params(llm_params, cfg.llm)
        self.tokenizer = tokenizer
        self.template = template or QwenPromptTemplate()
        self.decode_cfg = DecodeConfig(max_new_tokens=max_new_tokens, eot_id=cfg.eot_id,
                                       strategy=strategy, penalty=penalty, top_k=top_k,
                                       top_p=top_p)
        self.max_samples = int(max_seconds * cfg.sample_rate)
        # code -> prompt ids ("English<asr_text>" etc.), appended to the tail
        # to force the output language.
        self.language_prompt_ids = language_prompt_ids or {}
        self.metadata = metadata
        self.last_language: str = ""
        self.last_languages: list[str] = []

    def _resolve_language_code(self, language: str) -> str:
        code = language.strip().lower()
        if code not in self.language_prompt_ids and self.metadata is not None:
            try:
                code = self.metadata.resolve_language(language).code.lower()
            except KeyError:
                pass  # the catalog KeyError below names the choices
        return code

    def _prompt_ids(self, context: str, language: str | None = None) -> dict:
        query = self.tokenizer.encode(context) if (context and self.tokenizer) else []
        tail = list(self.template.tail_ids)
        if language:
            lang_ids = self.language_prompt_ids.get(self._resolve_language_code(language))
            if lang_ids is None:
                raise KeyError(f"language {language!r} not in this artifact's prompt catalog "
                               f"({sorted(self.language_prompt_ids) or 'empty'})")
            tail = tail + list(lang_ids)

        def mk(ids):
            return torch.tensor([list(ids)], dtype=torch.int64).reshape(1, len(ids))

        return {"head": mk(self.template.head_ids), "query": mk(query),
                "suffix": mk(self.template.suffix_ids), "tail": mk(tail)}

    def _batch_ids(self, prompt: dict, b: int, device=None) -> dict:
        return {k: v.to(device or self.device).repeat(b, 1) for k, v in prompt.items()}

    def _local(self):
        """(tower, llm) of the first mesh position, or the unsharded pair."""
        if self.runner is not None:
            return self._sharded.local(0, 0)
        return self.tower_params, self.llm_params

    def transcribe(self, audio: np.ndarray | str | Path, context: str = "",
                   language: str | None = None,
                   generator: torch.Generator | None = None) -> TranscribeResult:
        """``context``: optional text prompt (hot words); ``language``: force
        the output language through the prompt catalog (None: the model's
        detected language lands in ``self.last_language``)."""
        res = self.transcribe_batch([audio], context=context, language=language,
                                    generator=generator)[0]
        self.last_language = self.last_languages[0]
        return res

    def transcribe_batch(self, items, context: str = "", language: str | None = None,
                         generator: torch.Generator | None = None) -> list[TranscribeResult]:
        """N audio files/arrays -> one batched tower, prefill and lockstep
        decode (rows of unequal length are exact: each is re-packed
        left-padded). Batch 1 takes the fused step when it is stacked."""
        prompt = self._prompt_ids(context, language)

        def run(audio, valid, b):
            if self.runner is not None:
                return self.runner(
                    lambda p, a, v: qa.forward(p[0], p[1], self.cfg, a, v,
                                               self._batch_ids(prompt, a.shape[0], a.device),
                                               self.decode_cfg, rank_generator(generator)),
                    self._sharded, audio, valid)
            return qa.forward(self.tower_params, self.llm_params, self.cfg, audio, valid,
                              self._batch_ids(prompt, b), self.decode_cfg, generator,
                              stacked=self.stacked if b == 1 else None)

        ids_rows, valid, elapsed, b = _batched_llm_call(
            items, max_samples=self.max_samples, sample_rate=self.cfg.sample_rate,
            pcm_scale=1.0, run=run, eot_id=self.cfg.eot_id, device=self.device)
        out, langs = [], []
        for i, ids in enumerate(ids_rows):
            raw = self.tokenizer.decode(ids) if self.tokenizer else ""
            lang, text = parse_asr_output(raw, user_language=language)
            langs.append(lang)
            out.append(TranscribeResult(text=text, token_ids=ids,
                                        audio_seconds=float(valid[i]) / self.cfg.sample_rate,
                                        elapsed_seconds=elapsed, batch_size=b))
        self.last_languages = langs
        return out

    @torch.inference_mode()
    def prompt_embeds(self, samples, context: str = "", language: str | None = None):
        """One request's prompt embeds: (L, H) (valid prefix + END padding)
        and the valid length. The audio pads to ``max_samples``."""
        s = np.asarray(samples, np.float32)[: self.max_samples]
        buf = np.zeros((1, self.max_samples), np.float32)
        buf[0, : len(s)] = s
        embeds, valid = qa.prompt_embeds(
            *self._local(), self.cfg, torch.from_numpy(buf).to(self.device),
            torch.tensor([len(s)], device=self.device),
            self._batch_ids(self._prompt_ids(context, language), 1))
        return embeds[0], int(valid[0])

    @property
    def llm_cfg(self):
        """The LLM decoder's config (the continuous server's engine needs it)."""
        return self.cfg.llm

    # ---- micro-batched HTTP serving surface (parallel/http_server.py) ----

    @property
    def params(self):
        return self._sharded if self.runner is not None else (self.tower_params, self.llm_params)

    @property
    def window_samples(self) -> int:
        return self.max_samples

    @property
    def sample_rate(self) -> int:
        return self.cfg.sample_rate

    def _forward(self, params, audio: torch.Tensor, valid: torch.Tensor, language=None):
        """(B, W) audio -> (generated tokens (B, max_new + 1), counts (B,)).
        The generated region starts at a fixed offset (left-padded lockstep
        decode), so a request's ids are ``row[:count]``; a final EOT is
        dropped from the count. ``language`` forces the output language."""
        tower, llm = params
        ids = self._batch_ids(self._prompt_ids("", language), audio.shape[0], audio.device)
        with torch.inference_mode():
            tokens, counts, _ = qa.forward(tower, llm, self.cfg, audio, valid, ids,
                                           self.decode_cfg, None,
                                           stacked=self.stacked if audio.shape[0] == 1 else None)
            lf = tokens.shape[1] - self.decode_cfg.max_new_tokens - 1
            gen = tokens[:, lf:]
            last = torch.gather(gen, 1, torch.clamp(counts.to(torch.int64) - 1, min=0)[:, None])[:, 0]
            counts = counts - (last == self.cfg.eot_id).to(counts.dtype)
        return gen, counts

    def _postprocess(self, raw: str) -> str:
        return parse_asr_output(raw)[1]


class FunAsrNanoLlmSession:
    """Fun-ASR-Nano's LLM decode path: the SANM encoder's audio tokens
    spliced into a Qwen3 chat prompt [head | context text + suffix | audio |
    tail], one call for the encoder, the prefill and the decode.

    Counterpart of ``asr_tpu/runtime/qwen_session.py``'s class (without the
    and its ``mesh=`` runner), with :class:`QwenAsrSession`'s prompt
    template, batch routes and continuous serving surface: on a CUDA card in the ``bf16``
    mode a q4-packed LLM stacks for the fused step, so batch 1 decodes one
    kernel call a step and the continuous server runs the multi-slot
    kernel."""

    pcm_scale = 32768.0  # the SANM front end consumes int16-range PCM

    def __init__(self, params, llm_params, cfg, tokenizer=None,
                 template: QwenPromptTemplate | None = None, max_new_tokens: int = 256,
                 strategy: str = "greedy", penalty: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0, max_seconds: float = 30.0, fuse: bool = True, mesh=None):
        if fuse:
            llm_params = fuse_params(llm_params, cfg.llm)
        self.runner = None
        if mesh is not None:
            params, llm_params = _shard(self, mesh, params, llm_params, cfg.llm)
        else:
            self.device = _params_device(llm_params)
        self.params = params
        self.llm_params = llm_params
        self.cfg = cfg
        self.stacked = None
        if self.runner is None and self.device.type == "cuda" and _resolve_mm(None) == "bf16":
            self.stacked = stack_decode_params(llm_params, cfg.llm)
        self.tokenizer = tokenizer
        self.template = template or QwenPromptTemplate()
        self.decode_cfg = DecodeConfig(max_new_tokens=max_new_tokens, eot_id=cfg.eot_id,
                                       strategy=strategy, penalty=penalty, top_k=top_k,
                                       top_p=top_p)
        self.max_samples = int(max_seconds * cfg.sample_rate)

    def _prompt_ids(self, context: str) -> dict:
        query = self.tokenizer.encode(context) if (context and self.tokenizer) else []

        def mk(ids):
            return torch.tensor([list(ids)], dtype=torch.int64).reshape(1, len(ids))

        # head and suffix make one segment before the audio in this family
        return {"head": mk(self.template.head_ids),
                "query": mk(tuple(query) + tuple(self.template.suffix_ids)),
                "tail": mk(self.template.tail_ids)}

    def _batch_ids(self, prompt: dict, b: int, device=None) -> dict:
        return {k: v.to(device or self.device).repeat(b, 1) for k, v in prompt.items()}

    def _local(self):
        """(encoder, llm) of the first mesh position, or the unsharded pair."""
        if self.runner is not None:
            return self._sharded.local(0, 0)
        return self.params, self.llm_params

    @property
    def window_samples(self) -> int:
        return self.max_samples

    @property
    def sample_rate(self) -> int:
        return self.cfg.sample_rate

    @property
    def llm_cfg(self):
        """The LLM decoder's config (the continuous server's engine needs it)."""
        return self.cfg.llm

    @torch.inference_mode()
    def prompt_embeds(self, samples, context: str = "", language: str | None = None):
        """One request's prompt embeds (L, H) and valid length, as
        :meth:`QwenAsrSession.prompt_embeds` (the audio pads to
        ``max_samples``); this family has no language prompt."""
        if language:
            raise KeyError("Fun-ASR-Nano has no language prompt catalog")
        s = np.asarray(samples, np.float32)[: self.max_samples]
        buf = np.zeros((1, self.max_samples), np.float32)
        buf[0, : len(s)] = s
        embeds, valid = fn.prompt_embeds_llm(
            *self._local(), self.cfg, torch.from_numpy(buf).to(self.device),
            torch.tensor([len(s)], device=self.device), self._batch_ids(self._prompt_ids(context), 1))
        return embeds[0], int(valid[0])

    def transcribe(self, audio, context: str = "",
                   generator: torch.Generator | None = None) -> TranscribeResult:
        return self.transcribe_batch([audio], context=context, generator=generator)[0]

    def transcribe_batch(self, items, context: str = "",
                         generator: torch.Generator | None = None) -> list[TranscribeResult]:
        """N audio files/arrays -> one batched encoder, prefill and lockstep
        decode; batch 1 takes the fused step when it is stacked."""
        prompt = self._prompt_ids(context)

        def run(audio, valid, b):
            if self.runner is not None:
                return self.runner(
                    lambda p, a, v: fn.forward_llm(p[0], p[1], self.cfg, a, v,
                                                   self._batch_ids(prompt, a.shape[0], a.device),
                                                   self.decode_cfg, rank_generator(generator)),
                    self._sharded, audio, valid)
            return fn.forward_llm(self.params, self.llm_params, self.cfg, audio, valid,
                                  self._batch_ids(prompt, b), self.decode_cfg, generator,
                                  stacked=self.stacked if b == 1 else None)

        ids_rows, valid, elapsed, b = _batched_llm_call(
            items, max_samples=self.max_samples, sample_rate=self.cfg.sample_rate,
            pcm_scale=self.pcm_scale, run=run, eot_id=self.cfg.eot_id, device=self.device)
        return [TranscribeResult(text=self.tokenizer.decode(ids) if self.tokenizer else "",
                                 token_ids=ids, audio_seconds=float(valid[i]) / self.cfg.sample_rate,
                                 elapsed_seconds=elapsed, batch_size=b)
                for i, ids in enumerate(ids_rows)]


def load_qwen_session(folder: str | Path, device="cuda", tokenizer=None,
                      **session_kw) -> QwenAsrSession:
    """Artifact folder (``metadata.json`` family ``qwen_asr``, config under
    ``extra["config"]``, weights under ``tower/`` and ``llm/``) -> a session
    on ``device``, with the prompt template and language catalog read from
    the metadata extras and, unless ``tokenizer`` is given, the artifact's
    tokenizer file (``runtime/artifact.load_tokenizer``)."""
    params, meta = load_model(folder, device)
    if meta.family != "qwen_asr":
        raise ValueError(f"expected a qwen_asr artifact, got family {meta.family!r}")
    cfg = config_from_dict(qa.QwenAsrConfig, meta.extra.get("config", {}))
    if tokenizer is None:
        tokenizer = load_tokenizer(folder, meta)
    return QwenAsrSession(params["tower"], params["llm"], cfg, tokenizer=tokenizer,
                          template=prompt_template(meta),
                          language_prompt_ids=meta.extra.get("language_prompt_ids") or {},
                          metadata=meta, **session_kw)


def prompt_template(meta) -> QwenPromptTemplate:
    """The prompt template an artifact's metadata extras carry."""
    return QwenPromptTemplate(head_ids=tuple(meta.extra.get("prompt_head_ids", [])),
                              suffix_ids=tuple(meta.extra.get("prompt_suffix_ids", [])),
                              tail_ids=tuple(meta.extra.get("prompt_tail_ids", [])))
