"""Qwen3 ForcedAligner: non-autoregressive timestamp classification.

Counterpart of ``asr_tpu/models/forced_aligner.py``: the Qwen3-ASR audio
tower and Qwen3 decoder, with a ``classify_num``-bucket timestamp head in
place of the LM head, run as ONE pass over the prompt (no KV cache growth,
no decode loop): every ``<timestamp>`` position classifies an 80 ms time
bucket. Prompt layout: [<|audio_start|> | audio embeds | <|audio_end|> |
text / timestamp embeds], compacted by ``qwen_asr.assemble_prompt``.

The defaults are Qwen3-ForcedAligner-0.6B's: the Qwen3-ASR-0.6B tower and
LLM, 375 classes of 80 ms (30 s).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from asr_tpu_torch.frontend.whisper_mel import log_mel_spectrogram
from asr_tpu_torch.layers import qwen3
from asr_tpu_torch.layers.norms import rms_norm
from asr_tpu_torch.layers.transformer import dense
from asr_tpu_torch.models.qwen_asr import QwenAsrConfig, assemble_prompt, encode_audio


@dataclasses.dataclass(frozen=True)
class ForcedAlignerConfig:
    asr: QwenAsrConfig = QwenAsrConfig()
    classify_num: int = 375          # 30 s / 80 ms buckets
    segment_ms: int = 80


def align_logits(llm_params: dict, head: dict, cfg: ForcedAlignerConfig, embeds: torch.Tensor,
                 valid_len: torch.Tensor) -> torch.Tensor:
    """One causal pass over the prompt embeds (B, L, H) -> timestamp-head
    logits (B, L, classify_num)."""
    lcfg = cfg.asr.llm
    b, lf, _ = embeds.shape
    state = qwen3.make_kv_state(lcfg, b, lf, embeds.dtype, embeds.device)
    bias = qwen3.causal_prefill_bias(valid_len.to(embeds.device), lf, lf)
    hidden, _ = qwen3.decoder_pass(llm_params, lcfg, embeds, state, 0, bias)
    y = rms_norm(hidden, llm_params["final_norm"]["scale"], lcfg.rms_eps)
    return dense(y, head)


def align_embeds(llm_params: dict, head: dict, cfg: ForcedAlignerConfig, embeds: torch.Tensor,
                 valid_len: torch.Tensor) -> torch.Tensor:
    """One pass -> per-position bucket ids (B, L)."""
    return torch.argmax(align_logits(llm_params, head, cfg, embeds, valid_len), dim=-1)


def prompt_for(tower_params: dict, llm_params: dict, cfg: ForcedAlignerConfig, audio: torch.Tensor,
               valid_samples: torch.Tensor, audio_start_embed: torch.Tensor,
               audio_end_embed: torch.Tensor, text_ids: torch.Tensor):
    """Front half of :func:`forward`: raw audio (1, S) in [-1, 1] and the
    text / timestamp ids (1, T) -> (mel, compacted prompt embeds, valid_len).
    ``audio_start_embed`` / ``audio_end_embed`` are (1, 1, H)."""
    acfg = cfg.asr
    mel_cfg = acfg.mel_config()
    mel = log_mel_spectrogram(audio, mel_cfg)
    pad = (-mel.shape[1]) % (acfg.chunk_frames * acfg.chunks_per_window)
    if pad:
        mel = F.pad(mel, (0, 0, 0, pad))
    valid_frames = torch.div(valid_samples.to(torch.int64), mel_cfg.hop_length, rounding_mode="floor")
    audio_tokens, audio_valid = encode_audio(tower_params, acfg, mel, valid_frames.to(mel.device))

    text_embed = llm_params["embed"][text_ids.to(mel.device)].to(audio_tokens.dtype)
    h = text_embed.shape[-1]
    empty = torch.zeros((1, 0, h), dtype=text_embed.dtype, device=text_embed.device)
    embeds, valid_len = assemble_prompt(
        audio_start_embed.to(text_embed.dtype), empty, empty, audio_tokens, audio_valid,
        torch.cat([audio_end_embed.to(text_embed.dtype), text_embed], dim=1))
    return mel, embeds, valid_len


def forward(tower_params: dict, llm_params: dict, head: dict, cfg: ForcedAlignerConfig,
            audio: torch.Tensor, valid_samples: torch.Tensor, audio_start_embed: torch.Tensor,
            audio_end_embed: torch.Tensor, text_ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw audio + text / timestamp ids -> (buckets (1, L), valid_len (1,));
    the ``<timestamp>`` ids sit at ``1 + audio_valid + 1 + index_in_text``
    of the compacted prompt."""
    _mel, embeds, valid_len = prompt_for(tower_params, llm_params, cfg, audio, valid_samples,
                                         audio_start_embed, audio_end_embed, text_ids)
    return align_embeds(llm_params, head, cfg, embeds, valid_len), valid_len


def fix_timestamps(buckets: list[int]) -> list[int]:
    """Monotone repair by the longest non-decreasing subsequence: the LIS
    stays as anchors; short anomaly runs (<= 2) snap to the nearest anchor,
    longer runs are interpolated linearly between anchors."""
    data = [int(x) for x in buckets]
    n = len(data)
    if n == 0:
        return []
    dp = [1] * n
    parent = [-1] * n
    for i in range(1, n):
        for j in range(i):
            if data[j] <= data[i] and dp[j] + 1 > dp[i]:
                dp[i] = dp[j] + 1
                parent[i] = j
    idx = dp.index(max(dp))
    normal = [False] * n
    while idx != -1:
        normal[idx] = True
        idx = parent[idx]
    result = data.copy()
    i = 0
    while i < n:
        if normal[i]:
            i += 1
            continue
        j = i
        while j < n and not normal[j]:
            j += 1
        left = next((result[k] for k in range(i - 1, -1, -1) if normal[k]), None)
        right = next((result[k] for k in range(j, n) if normal[k]), None)
        count = j - i
        for k in range(i, j):
            if count <= 2:
                if left is None:
                    result[k] = right
                elif right is None:
                    result[k] = left
                else:
                    result[k] = left if (k - (i - 1)) <= (j - k) else right
            else:
                if left is not None and right is not None:
                    result[k] = int(left + (right - left) / (count + 1) * (k - i + 1))
                elif left is not None:
                    result[k] = left
                elif right is not None:
                    result[k] = right
        i = j
    return [int(x) for x in result]


def word_timestamps(words: list[str], buckets: list[int], tokens_per_word: int,
                    segment_ms: int = 80) -> list[dict]:
    """Group the repaired buckets into per-word start / end times (ms)."""
    fixed = fix_timestamps(buckets)
    out = []
    for i, w in enumerate(words):
        grp = fixed[i * tokens_per_word : (i + 1) * tokens_per_word]
        if not grp:
            break
        out.append({"text": w, "start_ms": grp[0] * segment_ms, "end_ms": grp[-1] * segment_ms})
    return out
