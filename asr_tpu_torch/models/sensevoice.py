"""SenseVoiceSmall: Kaldi fbank -> LFR/CMVN -> SANM encoder -> CTC head.

Counterpart of ``asr_tpu/models/sensevoice.py``: language + system prompt
embeddings prepended to the LFR features, 70 SANM blocks (encoders0 1 +
encoders 49 + tp_encoders 20 for SenseVoiceSmall), CTC argmax and collapse.
A batched fixed-shape forward with per-sample valid lengths.

Parameters are the JAX package's pytree as nested dicts and lists of
tensors, with the same keys (``runtime/artifact.py`` flattens both packages'
trees to the same names); linear weights are ``(in, out)`` and may be
:class:`~asr_tpu_torch.quant.quantize.QuantizedLinear` leaves.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from asr_tpu_torch.decode.ctc import ctc_greedy_collapse
from asr_tpu_torch.frontend.kaldi_fbank import KaldiFbankConfig, log_mel_fbank
from asr_tpu_torch.frontend.lfr import apply_cmvn_addmul, lfr_stack
from asr_tpu_torch.layers.attention import attention_bias_from_lengths, length_mask
from asr_tpu_torch.layers.norms import layer_norm
from asr_tpu_torch.layers.sanm import sanm_block
from asr_tpu_torch.layers.transformer import dense
from asr_tpu_torch.runtime.profiling import annotate

# (code, description, aliases, prompt_token_id) — table row order is the
# language_embed row index.
LANGUAGE_PROFILES = (
    ("auto", "Automatic language detection", ("automatic", "detect"), 0),
    ("zh", "Chinese", ("Chinese", "Mandarin", "zh-CN", "中文"), 3),
    ("en", "English", ("English", "en-US"), 4),
    ("yue", "Cantonese", ("Cantonese", "zh-yue", "粤语", "粵語"), 7),
    ("ja", "Japanese", ("Japanese", "jp", "日本語"), 11),
    ("ko", "Korean", ("Korean", "kr", "한국어"), 12),
    ("nospeech", "No speech", ("no-speech", "silence"), 13),
)


@dataclasses.dataclass(frozen=True)
class SenseVoiceConfig:
    vocab_size: int = 25055
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
    blank_id: int = 0
    use_emotion: bool = True
    sample_rate: int = 16000
    fbank: KaldiFbankConfig = KaldiFbankConfig()

    @property
    def feature_size(self) -> int:
        return self.n_mels * self.lfr_m  # 560

    @property
    def prompt_len(self) -> int:
        return 4 if self.use_emotion else 3  # 1 language + system prompt

    @property
    def system_prompt_ids(self) -> tuple[int, ...]:
        return (1, 2, 14) if self.use_emotion else (5, 14)

    @property
    def num_blocks(self) -> int:
        return self.num_encoders0 + self.num_encoders + self.num_tp_encoders


def sinusoid_position_encoding(length: int, depth: int, start: int = 1) -> np.ndarray:
    """FunASR sinusoidal PE; positions start at 1."""
    positions = np.arange(start, start + length, dtype=np.float32)[:, None]
    log_inc = np.log(10000.0) / (depth / 2 - 1)
    inv = np.exp(np.arange(depth / 2, dtype=np.float32) * -log_inc)[None, :]
    scaled = positions * inv
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def init_params(cfg: SenseVoiceConfig, generator: torch.Generator, device=None,
                dtype: torch.dtype = torch.float32) -> dict:
    """Random-init parameters with the checkpoint's layout, drawn from
    ``generator`` on its own device and placed on ``device``."""
    device = torch.device(device) if device is not None else generator.device

    def normal(*shape, std):
        t = torch.randn(shape, generator=generator, device=generator.device) * std
        return t.to(device=device, dtype=dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dtype)

    def norm(size=cfg.hidden):
        return {"scale": ones(size), "bias": zeros(size)}

    def block(in_size):
        return {
            "norm1": norm(in_size),
            "qkv": {"w": normal(in_size, 3 * cfg.hidden, std=in_size ** -0.5), "b": zeros(3 * cfg.hidden)},
            "fsmn_w": normal(cfg.fsmn_kernel, cfg.hidden, std=0.1),
            "out": {"w": normal(cfg.hidden, cfg.hidden, std=cfg.hidden ** -0.5), "b": zeros(cfg.hidden)},
            "norm2": norm(),
            "ffn": {
                "w1": normal(cfg.hidden, cfg.ffn_dim, std=cfg.hidden ** -0.5),
                "b1": zeros(cfg.ffn_dim),
                "w2": normal(cfg.ffn_dim, cfg.hidden, std=cfg.ffn_dim ** -0.5),
                "b2": zeros(cfg.hidden),
            },
        }

    f = cfg.feature_size
    return {
        "cmvn_means": zeros(f),
        "cmvn_istd": ones(f),
        "language_embed": normal(len(LANGUAGE_PROFILES), f, std=0.02),
        "system_embed": normal(len(cfg.system_prompt_ids), f, std=0.02),
        "encoders0": [block(f) for _ in range(cfg.num_encoders0)],
        "encoders": [block(cfg.hidden) for _ in range(cfg.num_encoders)],
        "tp_encoders": [block(cfg.hidden) for _ in range(cfg.num_tp_encoders)],
        "after_norm": norm(),
        "tp_norm": norm(),
        "ctc": {"w": normal(cfg.hidden, cfg.vocab_size, std=cfg.hidden ** -0.5), "b": zeros(cfg.vocab_size)},
    }


def encode(params: dict, cfg: SenseVoiceConfig, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """SANM encoder over prompt+speech features. x: (B, T, feature_size)."""
    with annotate("asr.sv.encode"):
        key_mask = length_mask(valid, x.shape[1])
        bias = attention_bias_from_lengths(valid, x.shape[1])
        x = torch.where(key_mask[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))

        def block(x, p, residual=True):
            with annotate("asr.sv.block"):
                return sanm_block(x, p, cfg.num_heads, cfg.head_dim, bias, key_mask, residual=residual)

        for p in params["encoders0"]:
            x = block(x, p, residual=False)
        for p in params["encoders"]:
            x = block(x, p)
        x = layer_norm(x, params["after_norm"]["scale"], params["after_norm"]["bias"])
        for p in params["tp_encoders"]:
            x = block(x, p)
        return layer_norm(x, params["tp_norm"]["scale"], params["tp_norm"]["bias"])


def forward(params: dict, cfg: SenseVoiceConfig, audio: torch.Tensor, valid_samples: torch.Tensor,
            language_idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw audio ``(B, S)`` (int16 numeric range), valid sample counts
    ``(B,)`` and language rows ``(B,)`` -> (token ids ``(B, T_seq)`` int32
    left-compacted, counts ``(B,)`` int32)."""
    x, valid_seq = frontend(params, cfg, audio, valid_samples, language_idx)
    enc = encode(params, cfg, x, valid_seq)
    with annotate("asr.sv.ctc"):
        ids = torch.argmax(dense(enc, params["ctc"]), dim=-1)
        return ctc_greedy_collapse(ids, valid_seq, cfg.blank_id)


def encode_logits(params: dict, cfg: SenseVoiceConfig, audio: torch.Tensor,
                  valid_samples: torch.Tensor, language_idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Same as :func:`forward` but returns (logits, valid_seq)."""
    x, valid_seq = frontend(params, cfg, audio, valid_samples, language_idx)
    return dense(encode(params, cfg, x, valid_seq), params["ctc"]), valid_seq


def encode_logits_from_lfr(params: dict, cfg: SenseVoiceConfig, feats: torch.Tensor,
                           valid_lfr: torch.Tensor, language_idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """LFR features (B, T, n_mels*lfr_m) -> (ctc_logits, valid_seq): CMVN,
    sinusoid PE, language/system prompt prepend, SANM encoder, CTC head."""
    x, valid_seq = prompt_rows(params, cfg, feats, valid_lfr, language_idx)
    return dense(encode(params, cfg, x, valid_seq), params["ctc"]), valid_seq


def frontend(params: dict, cfg: SenseVoiceConfig, audio: torch.Tensor, valid_samples: torch.Tensor,
             language_idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw audio -> the encoder's input and valid_seq: Kaldi fbank, LFR,
    then :func:`prompt_rows`."""
    with annotate("asr.sv.frontend"):
        fb = cfg.fbank
        n_frames = fb.num_frames(audio.shape[-1])
        mel = log_mel_fbank(audio, fb, n_frames)
        valid_samples = valid_samples.to(torch.int64)
        valid_frames = torch.clamp((valid_samples - fb.win_length) // fb.hop_length + 1, min=0)
        feats = lfr_stack(mel, cfg.lfr_m, cfg.lfr_n, valid_frames)
        valid_lfr = (valid_frames + cfg.lfr_n - 1) // cfg.lfr_n
        return prompt_rows(params, cfg, feats, valid_lfr, language_idx)


def prompt_rows(params: dict, cfg: SenseVoiceConfig, feats: torch.Tensor, valid_lfr: torch.Tensor,
                language_idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """LFR features (B, T, n_mels*lfr_m) -> the encoder's input (B, prompt_len
    + T, n_mels*lfr_m) in the parameters' dtype and valid_seq: CMVN,
    sinusoid PE, language/system prompt prepend."""
    feats = apply_cmvn_addmul(feats, params["cmvn_means"], params["cmvn_istd"])
    b, t_lfr = feats.shape[0], feats.shape[1]
    prompt_len = cfg.prompt_len
    pe = torch.from_numpy(sinusoid_position_encoding(t_lfr + prompt_len, cfg.feature_size)).to(feats.device)
    feats = feats + pe[prompt_len:][None]
    lang = params["language_embed"][language_idx.to(torch.int64)] + pe[0]
    system = params["system_embed"] + pe[1:prompt_len]
    x = torch.cat([lang[:, None, :], system[None].expand(b, -1, -1), feats], dim=1)
    valid_seq = valid_lfr + prompt_len
    return x.to(params["ctc"]["b"].dtype), valid_seq
