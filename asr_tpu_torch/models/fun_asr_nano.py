"""Fun-ASR-Nano: SANM encoder + two decode heads (fast CTC / Qwen3 LLM).

Counterpart of ``asr_tpu/models/fun_asr_nano.py``: Kaldi fbank scaled by
sqrt(hidden) (no CMVN), the truncating LFR length ``frames // 6 - 1``, the
SenseVoice-style SANM encoder (encoders0 / encoders / tp_encoders), then
either
  (a) the fast CTC head: linear1 -> relu -> linear2 -> MHA blocks -> the
      CTC projection, greedy collapse; or
  (b) the LLM path: the audio adaptor (linear1 / relu / linear2 + MHA
      blocks, its output cut to ``ceil(mel_frames / 48)`` speech tokens)
      feeding the Qwen3 decoder through the Qwen3-ASR prompt layout
      [head | query | audio | tail] and decode (``qwen_asr.transcribe_embeds``).

Parameters are the JAX package's pytree as nested dicts and lists of
tensors with the same keys (``runtime/artifact.py`` flattens both packages'
trees to the same names). Linears may be ``QuantizedLinear`` leaves (the
int8 kernel on a card); a packed-q4 LLM with stacked weights decodes batch
1 through the fused Qwen3 step.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from asr_tpu_torch.decode.ar import DecodeConfig
from asr_tpu_torch.decode.ctc import ctc_greedy_collapse
from asr_tpu_torch.frontend.kaldi_fbank import KaldiFbankConfig, log_mel_fbank
from asr_tpu_torch.frontend.lfr import lfr_stack
from asr_tpu_torch.layers import qwen3
from asr_tpu_torch.layers.attention import attention_bias_from_lengths, length_mask, mha
from asr_tpu_torch.layers.norms import layer_norm
from asr_tpu_torch.layers.sanm import sanm_block
from asr_tpu_torch.layers.transformer import dense, merge_heads, split_heads
from asr_tpu_torch.models.qwen_asr import QwenAsrConfig, assemble_prompt, transcribe_embeds
from asr_tpu_torch.models.sensevoice import sinusoid_position_encoding


@dataclasses.dataclass(frozen=True)
class FunAsrNanoConfig:
    # SANM audio encoder.
    hidden: int = 512
    num_heads: int = 4
    head_dim: int = 128
    ffn_dim: int = 2048
    num_encoders0: int = 1
    num_encoders: int = 49
    num_tp_encoders: int = 20
    fsmn_kernel: int = 11
    n_mels: int = 80
    lfr_m: int = 7
    lfr_n: int = 6
    # Adaptor / CTC decoder (transformer blocks on top of the encoder).
    adaptor_hidden: int = 1024       # llm hidden
    adaptor_blocks: int = 2
    adaptor_heads: int = 8
    adaptor_ffn: int = 4096
    ctc_hidden: int = 512
    ctc_blocks: int = 2
    ctc_heads: int = 4
    ctc_ffn: int = 2048
    ctc_vocab: int = 8404
    blank_id: int = 0
    llm: qwen3.Qwen3Config = qwen3.Qwen3Config()
    eot_id: int = 151645
    sample_rate: int = 16000
    fbank: KaldiFbankConfig = KaldiFbankConfig()

    @property
    def feature_size(self) -> int:
        return self.n_mels * self.lfr_m


def init_params(cfg: FunAsrNanoConfig, generator: torch.Generator, device=None,
                dtype: torch.dtype = torch.float32) -> dict:
    """Random-init encoder, adaptor and CTC-head parameters with the JAX
    package's layout and scales, drawn from ``generator`` on its own device
    and placed on ``device`` (the LLM is ``qwen3.init_params(cfg.llm, ...)``)."""
    device = torch.device(device) if device is not None else generator.device
    h, f = cfg.hidden, cfg.ffn_dim

    def normal(*shape, std):
        t = torch.randn(shape, generator=generator, device=generator.device) * std
        return t.to(device=device, dtype=dtype)

    def zeros(n):
        return torch.zeros((n,), device=device, dtype=dtype)

    def lin(i, o):
        return {"w": normal(i, o, std=i ** -0.5), "b": zeros(o)}

    def norm(d=h):
        return {"scale": torch.ones((d,), device=device, dtype=dtype), "bias": zeros(d)}

    def enc_block(in_size):
        return {
            "norm1": norm(in_size),
            "qkv": lin(in_size, 3 * h),
            "fsmn_w": normal(cfg.fsmn_kernel, h, std=0.1),
            "out": lin(h, h),
            "norm2": norm(),
            "ffn": {"w1": normal(h, f, std=h ** -0.5), "b1": zeros(f),
                    "w2": normal(f, h, std=f ** -0.5), "b2": zeros(h)},
        }

    def mha_block(d, ffn):
        return {"norm1": norm(d), "qkv": lin(d, 3 * d), "out": lin(d, d), "norm2": norm(d),
                "ffn": {"w1": lin(d, ffn), "w2": lin(ffn, d)}}

    ad, ch = cfg.adaptor_hidden, cfg.ctc_hidden
    return {
        "encoders0": [enc_block(cfg.feature_size) for _ in range(cfg.num_encoders0)],
        "encoders": [enc_block(h) for _ in range(cfg.num_encoders)],
        "tp_encoders": [enc_block(h) for _ in range(cfg.num_tp_encoders)],
        "after_norm": norm(),
        "tp_norm": norm(),
        "adaptor": {"linear1": lin(h, ad), "linear2": lin(ad, ad),
                    "blocks": [mha_block(ad, cfg.adaptor_ffn) for _ in range(cfg.adaptor_blocks)]},
        "ctc": {"linear1": lin(h, ch), "linear2": lin(ch, ch),
                "blocks": [mha_block(ch, cfg.ctc_ffn) for _ in range(cfg.ctc_blocks)],
                "lo": lin(ch, cfg.ctc_vocab)},
    }


def _adaptor_block(x: torch.Tensor, p: dict, heads: int, bias: torch.Tensor) -> torch.Tensor:
    """Pre-LN MHA block of the adaptor and the CTC decoder (exact GELU)."""
    y = layer_norm(x, p["norm1"]["scale"], p["norm1"]["bias"])
    q, k, v = torch.chunk(dense(y, p["qkv"]), 3, dim=-1)
    ctx = mha(split_heads(q, heads), split_heads(k, heads), split_heads(v, heads), bias=bias)
    x = x + dense(merge_heads(ctx), p["out"])
    y = layer_norm(x, p["norm2"]["scale"], p["norm2"]["bias"])
    return x + dense(F.gelu(dense(y, p["ffn"]["w1"]), approximate="none"), p["ffn"]["w2"])


def encode(params: dict, cfg: FunAsrNanoConfig, audio: torch.Tensor, valid_samples: torch.Tensor):
    """Raw audio (B, S) in the int16 range -> (encoder output (B, T_lfr,
    hidden), valid_lfr (B,), valid_frames (B,))."""
    fb = cfg.fbank
    mel = log_mel_fbank(audio, fb, fb.num_frames(audio.shape[-1])) * (cfg.hidden ** 0.5)
    valid_samples = valid_samples.to(torch.int64)
    valid_frames = torch.clamp((valid_samples - fb.win_length) // fb.hop_length + 1, min=0)
    feats = lfr_stack(mel, cfg.lfr_m, cfg.lfr_n, valid_frames)
    # Truncating LFR length: frames // lfr_n - 1.
    valid_lfr = torch.clamp(valid_frames // cfg.lfr_n - 1, min=0)
    t_lfr = feats.shape[1]
    pe = torch.from_numpy(sinusoid_position_encoding(t_lfr, cfg.feature_size)).to(feats.device)
    x = feats + pe[None]

    key_mask = length_mask(valid_lfr, t_lfr)
    bias = attention_bias_from_lengths(valid_lfr, t_lfr)
    x = torch.where(key_mask[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    for p in params["encoders0"]:
        x = sanm_block(x, p, cfg.num_heads, cfg.head_dim, bias, key_mask, residual=False)
    for p in params["encoders"]:
        x = sanm_block(x, p, cfg.num_heads, cfg.head_dim, bias, key_mask, residual=True)
    x = layer_norm(x, params["after_norm"]["scale"], params["after_norm"]["bias"])
    for p in params["tp_encoders"]:
        x = sanm_block(x, p, cfg.num_heads, cfg.head_dim, bias, key_mask, residual=True)
    enc = layer_norm(x, params["tp_norm"]["scale"], params["tp_norm"]["bias"])
    return enc, valid_lfr, valid_frames


def ctc_logits(params: dict, cfg: FunAsrNanoConfig, enc: torch.Tensor,
               valid_lfr: torch.Tensor) -> torch.Tensor:
    """CTC head over the encoder output -> logits (B, T_lfr, ctc_vocab)."""
    p = params["ctc"]
    c = dense(torch.relu(dense(enc, p["linear1"])), p["linear2"])
    bias = attention_bias_from_lengths(valid_lfr, c.shape[1])
    for bp in p["blocks"]:
        c = _adaptor_block(c, bp, cfg.ctc_heads, bias)
    return dense(c, p["lo"])


def forward_ctc(params: dict, cfg: FunAsrNanoConfig, audio: torch.Tensor,
                valid_samples: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fast CTC path: raw audio -> (left-compacted token ids (B, T_lfr)
    int32, counts (B,) int32)."""
    enc, valid_lfr, _ = encode(params, cfg, audio, valid_samples)
    ids = torch.argmax(ctc_logits(params, cfg, enc, valid_lfr), dim=-1)
    return ctc_greedy_collapse(ids, valid_lfr, cfg.blank_id)


def audio_embeds(params: dict, cfg: FunAsrNanoConfig, audio: torch.Tensor,
                 valid_samples: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """LLM-path audio tokens: the adaptor output (B, T_lfr, adaptor_hidden)
    and the speech-token count ceil(valid mel frames / 48) per row."""
    enc, valid_lfr, valid_frames = encode(params, cfg, audio, valid_samples)
    p = params["adaptor"]
    x = dense(torch.relu(dense(enc, p["linear1"])), p["linear2"])
    bias = attention_bias_from_lengths(valid_lfr, x.shape[1])
    for bp in p["blocks"]:
        x = _adaptor_block(x, bp, cfg.adaptor_heads, bias)
    per_token = cfg.lfr_n * 8
    return x, (valid_frames + per_token - 1) // per_token


def prompt_embeds_llm(params: dict, llm_params: dict, cfg: FunAsrNanoConfig, audio: torch.Tensor,
                      valid_samples: torch.Tensor, prompt_ids: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Front half of :func:`forward_llm`: audio + prompt id tensors {"head",
    "query", "tail"} -> compacted prompt embeds (B, L, H) + valid lengths
    (B,), as :func:`~asr_tpu_torch.models.qwen_asr.assemble_prompt` lays
    them out (the continuous server's prompt)."""
    tokens, speech_len = audio_embeds(params, cfg, audio, valid_samples)

    def emb(ids):
        return llm_params["embed"][ids.to(tokens.device)].to(tokens.dtype)

    empty = torch.zeros((tokens.shape[0], 0, tokens.shape[-1]), dtype=tokens.dtype,
                        device=tokens.device)
    return assemble_prompt(emb(prompt_ids["head"]), emb(prompt_ids["query"]), empty, tokens,
                           speech_len, emb(prompt_ids["tail"]))


def forward_llm(params: dict, llm_params: dict, cfg: FunAsrNanoConfig, audio: torch.Tensor,
                valid_samples: torch.Tensor, prompt_ids: dict, decode_cfg: DecodeConfig,
                generator: torch.Generator | None = None, stacked: dict | None = None):
    """LLM path: audio (B, S) + prompt ids -> (tokens, counts, prompt_start)
    as ``qwen_asr.transcribe_embeds`` returns them (batched, left-padded
    lockstep decode; at batch 1 with ``stacked`` weights, the fused step)."""
    embeds, valid_len = prompt_embeds_llm(params, llm_params, cfg, audio, valid_samples, prompt_ids)
    qcfg = QwenAsrConfig(llm=cfg.llm, eot_id=cfg.eot_id)
    return transcribe_embeds(llm_params, qcfg, embeds, valid_len, decode_cfg, generator,
                             stacked=stacked)
