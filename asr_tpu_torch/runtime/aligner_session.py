"""Qwen ForcedAligner session: text -> word units -> timestamp alignment.

Counterpart of ``asr_tpu/runtime/aligner_session.py``: the prompt is
[audio_start | audio embeds | audio_end | per word: its token ids +
``<timestamp>`` x tokens_per_word], one non-autoregressive pass classifies
an 80 ms bucket at every ``<timestamp>`` position, and the bucket stream is
repaired to be monotone and grouped per word.

Word units: letters, digits and apostrophes are kept, CJK ideographs become
single-character units, everything else splits on whitespace. Japanese
uses a self-contained script-class segmenter (:func:`word_units_japanese`:
a kanji run with its trailing hiragana is one unit, each hiragana /
katakana / latin-digit run another); Korean eojeol are the whitespace
units. A custom ``split_fn`` overrides both.
"""

from __future__ import annotations

import time
import unicodedata
from pathlib import Path

import numpy as np
import torch

from asr_tpu_torch.models import forced_aligner as fa
from asr_tpu_torch.runtime import audio as audio_io


def _is_kept(ch: str) -> bool:
    if ch == "'":
        return True
    cat = unicodedata.category(ch)
    return cat.startswith(("L", "N"))


def _is_cjk(ch: str) -> bool:
    code = ord(ch)
    return (
        0x4E00 <= code <= 0x9FFF or 0x3400 <= code <= 0x4DBF
        or 0x20000 <= code <= 0x2CEAF or 0xF900 <= code <= 0xFAFF
    )


def word_units(text: str) -> list[str]:
    """Alignment units: whitespace-separated words, with CJK ideographs as
    single-character units and non-letter/digit characters dropped."""
    units: list[str] = []
    for seg in text.split():
        cleaned = "".join(ch for ch in seg if _is_kept(ch))
        if not cleaned:
            continue
        buf: list[str] = []
        for ch in cleaned:
            if _is_cjk(ch):
                if buf:
                    units.append("".join(buf))
                    buf = []
                units.append(ch)
            else:
                buf.append(ch)
        if buf:
            units.append("".join(buf))
    return units


def _jp_script(ch: str) -> str:
    code = ord(ch)
    if 0x3040 <= code <= 0x309F:
        return "hira"
    if 0x30A0 <= code <= 0x30FF or 0x31F0 <= code <= 0x31FF or ch == "ー":
        return "kata"
    if _is_cjk(ch):
        return "kanji"
    return "other"


def word_units_japanese(text: str) -> list[str]:
    """Self-contained Japanese unit splitter (nagisa stand-in): segments on
    script-class transitions, attaching a trailing hiragana run to a
    preceding kanji run (stem + okurigana form one unit)."""
    units: list[str] = []
    buf: list[str] = []
    buf_script = ""
    for ch in text:
        if not _is_kept(ch):
            if buf:
                units.append("".join(buf))
                buf, buf_script = [], ""
            continue
        s = _jp_script(ch)
        if buf and (s == buf_script or (buf_script == "kanji" and s == "hira")):
            buf.append(ch)
            if s == "hira":
                buf_script = "hira"  # okurigana attached; next kanji starts anew
        else:
            if buf:
                units.append("".join(buf))
            buf, buf_script = [ch], s
    if buf:
        units.append("".join(buf))
    return units


def word_units_for_language(text: str, language: str | None) -> list[str]:
    """Language dispatch mirroring the reference's
    ``AlignerTextProcessor.word_units(text, language)``: Japanese uses the
    script segmenter, Korean and everything else the space/CJK splitter
    (see module docstring for the untrained-LTokenizer equivalence)."""
    if language and language.lower() in ("japanese", "ja", "jp"):
        return word_units_japanese(text)
    return word_units(text)


class QwenAlignerSession:
    """Non-autoregressive forced alignment: (audio, transcript) -> word
    timestamps, on the parameters' device."""

    def __init__(self, tower_params, llm_params, head, cfg: fa.ForcedAlignerConfig, tokenizer,
                 special_ids: dict, tokens_per_word: int = 1, max_seconds: float = 30.0,
                 split_fn=None):
        self.tower_params = tower_params
        self.llm_params = llm_params
        self.head = head
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.timestamp_id = int(special_ids["timestamp"])
        self.audio_start_id = int(special_ids["audio_start"])
        self.audio_end_id = int(special_ids["audio_end"])
        self.tokens_per_word = tokens_per_word
        self.max_samples = int(max_seconds * cfg.asr.sample_rate)
        self.split_fn = split_fn or word_units
        self.device = llm_params["final_norm"]["scale"].device

    def _embed(self, token_id: int) -> torch.Tensor:
        """(1, 1, H) embedding of one token: a plain table's row, or a
        QuantizedEmbedding's gathered and dequantized row."""
        return self.llm_params["embed"][torch.tensor([[token_id]], device=self.device)]

    def align(self, audio: np.ndarray | str | Path, text: str,
              language: str | None = None) -> list[dict]:
        """Returns [{"text", "start_ms", "end_ms"}] per word unit.

        ``language`` selects the unit splitter (e.g. ``"japanese"``) when no
        custom ``split_fn`` was given."""
        if isinstance(audio, (str, Path)):
            audio = audio_io.load_audio(audio, self.cfg.asr.sample_rate, pcm_scale=1.0)
        audio = np.asarray(audio, np.float32)[: self.max_samples]
        n = len(audio)
        buf = np.zeros((1, self.max_samples), np.float32)
        buf[0, :n] = audio

        if self.tokenizer is None:
            raise ValueError("forced alignment needs a tokenizer with .encode() "
                             "(artifact tokenizer file missing?)")
        if language is not None and self.split_fn is word_units:
            words = word_units_for_language(text, language)
        else:
            words = self.split_fn(text)
        text_ids: list[int] = []
        ts_positions: list[int] = []
        for w in words:
            text_ids.extend(int(t) for t in self.tokenizer.encode(w))
            for _ in range(self.tokens_per_word):
                ts_positions.append(len(text_ids))
                text_ids.append(self.timestamp_id)
        if not text_ids:
            return []

        t0 = time.perf_counter()
        with torch.inference_mode():
            buckets, valid_len = fa.forward(
                self.tower_params, self.llm_params, self.head, self.cfg,
                torch.from_numpy(buf).to(self.device), torch.tensor([n], device=self.device),
                self._embed(self.audio_start_id), self._embed(self.audio_end_id),
                torch.tensor([text_ids], device=self.device))
            buckets = buckets[0].cpu().numpy()  # waits for the device
            valid = int(valid_len[0])
        self.last_elapsed = time.perf_counter() - t0
        # the text starts at valid_len - len(text_ids) in the compacted prompt
        offset = valid - len(text_ids)
        ts_buckets = [int(buckets[offset + p]) for p in ts_positions]
        return fa.word_timestamps(words, ts_buckets, self.tokens_per_word, self.cfg.segment_ms)
