"""Paraformer (non-streaming): SANM encoder + CIF predictor + non-AR decoder.

Counterpart of ``asr_tpu/models/paraformer.py``: Kaldi fbank + LFR + CMVN
(+ the FunASR sinusoid positions) front end, the SANM encoder (SenseVoice's
blocks), the CifPredictorV2 integrate-and-fire token extraction
(``decode/cif.py``) and the FunASR ParaformerSANMDecoder (FFN-first
blocks: positionwise FFN -> FSMN memory -> cross-attention, then trailing
FFN-only blocks), which emits every token in one non-autoregressive pass.

In the q8 form every linear runs on the int8 kernel through
``layers/transformer.dense``: the encoder's qkv / out / FFN (the first
block's qkv at K = 560 in one scale block), the decoder's FFNs, cross q /
kv / out and the output head (N = 8404). The predictor's Conv1d (HIO
weights under ``conv``) and its one-column output stay f32.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from asr_tpu_torch.decode.cif import cif_fire
from asr_tpu_torch.frontend.kaldi_fbank import KaldiFbankConfig, log_mel_fbank
from asr_tpu_torch.frontend.lfr import apply_cmvn_addmul, lfr_stack
from asr_tpu_torch.layers.attention import attention_bias_from_lengths, length_mask, mha
from asr_tpu_torch.layers.conformer import zero_past
from asr_tpu_torch.layers.norms import layer_norm
from asr_tpu_torch.layers.sanm import depthwise_conv1d_time, sanm_block
from asr_tpu_torch.layers.transformer import dense
from asr_tpu_torch.models.sensevoice import sinusoid_position_encoding


@dataclasses.dataclass(frozen=True)
class ParaformerConfig:
    vocab_size: int = 8404           # zh large
    hidden: int = 512
    num_heads: int = 4
    head_dim: int = 128
    ffn_dim: int = 2048
    num_encoders0: int = 1
    num_encoders: int = 49
    num_decoders: int = 16
    num_decoder_ffn: int = 1
    fsmn_kernel: int = 11
    predictor_kernel: int = 3
    tail_threshold: float = 0.45
    n_mels: int = 80
    lfr_m: int = 7
    lfr_n: int = 6
    sample_rate: int = 16000
    fbank: KaldiFbankConfig = KaldiFbankConfig()

    @property
    def feature_size(self) -> int:
        return self.n_mels * self.lfr_m


def init_params(cfg: ParaformerConfig, generator: torch.Generator, device=None,
                dtype: torch.dtype = torch.float32) -> dict:
    """Random-init parameters with the checkpoint's layout and the JAX
    package's scales, drawn from ``generator`` on its own device and placed
    on ``device``."""
    device = torch.device(device) if device is not None else generator.device
    h, f = cfg.hidden, cfg.ffn_dim

    def normal(*shape, std):
        t = torch.randn(shape, generator=generator, device=generator.device) * std
        return t.to(device=device, dtype=dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dtype)

    def lin(i, o):
        return {"w": normal(i, o, std=i ** -0.5), "b": zeros(o)}

    def norm(d=h):
        return {"scale": ones(d), "bias": zeros(d)}

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

    def ffn_inner():
        return {"w1": lin(h, f), "norm": norm(f), "w2": lin(f, h)}

    def dec_block():
        return {
            "norm1": norm(), "ffn": ffn_inner(), "norm2": norm(),
            "fsmn_w": normal(cfg.fsmn_kernel, h, std=0.1),
            "norm3": norm(),
            "cross": {"q": lin(h, h), "kv": lin(h, 2 * h), "out": lin(h, h)},
        }

    fs = cfg.feature_size
    return {
        "cmvn_means": zeros(fs),
        "cmvn_istd": ones(fs),
        "encoders0": [enc_block(fs) for _ in range(cfg.num_encoders0)],
        "encoders": [enc_block(h) for _ in range(cfg.num_encoders)],
        "after_norm": norm(),
        "predictor": {
            "conv": {"w": normal(cfg.predictor_kernel, h, h, std=0.02), "b": zeros(h)},
            "out": lin(h, 1),
        },
        "decoders": [dec_block() for _ in range(cfg.num_decoders)],
        "decoder_ffn": [{"norm1": norm(), "ffn": ffn_inner()} for _ in range(cfg.num_decoder_ffn)],
        "decoder_after_norm": norm(),
        "output": lin(h, cfg.vocab_size),
    }


def _ffn_sanm_decoder(x: torch.Tensor, p: dict) -> torch.Tensor:
    """FunASR PositionwiseFeedForwardDecoderSANM: w2(norm(relu(w1(x))))."""
    y = layer_norm(torch.relu(dense(x, p["w1"])), p["norm"]["scale"], p["norm"]["bias"])
    return dense(y, p["w2"])


def encode(params: dict, cfg: ParaformerConfig, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """SANM encoder over (B, T, feature_size) features -> (B, T, hidden)."""
    key_mask = length_mask(valid, x.shape[1])
    bias = attention_bias_from_lengths(valid, x.shape[1])
    x = zero_past(x, key_mask)
    for p in params["encoders0"]:
        x = sanm_block(x, p, cfg.num_heads, cfg.head_dim, bias, key_mask, residual=False)
    for p in params["encoders"]:
        x = sanm_block(x, p, cfg.num_heads, cfg.head_dim, bias, key_mask, residual=True)
    return layer_norm(x, params["after_norm"]["scale"], params["after_norm"]["bias"])


def predict_alphas(params: dict, cfg: ParaformerConfig, enc: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """CifPredictorV2 weights: sigmoid(linear(relu(conv(enc)))), zero past
    the valid frames. The conv is a Conv1d over time with HIO weights."""
    p = params["predictor"]
    pad = (cfg.predictor_kernel - 1) // 2
    key_mask = length_mask(valid, enc.shape[1])
    x = zero_past(enc, key_mask)
    y = F.conv1d(x.transpose(1, 2), p["conv"]["w"].permute(2, 1, 0), padding=pad).transpose(1, 2)
    y = torch.relu(y + p["conv"]["b"])
    alphas = torch.sigmoid(dense(y, p["out"]))[..., 0]
    return torch.where(key_mask, alphas, torch.zeros((), dtype=alphas.dtype, device=alphas.device))


def decode_tokens(params: dict, cfg: ParaformerConfig, embeds: torch.Tensor, counts: torch.Tensor,
                  memory: torch.Tensor, memory_valid: torch.Tensor) -> torch.Tensor:
    """Non-AR decoder over the fired CIF embeddings. Returns logits (B, N, V)."""
    b, n = embeds.shape[0], embeds.shape[1]
    tok_mask = length_mask(counts, n)
    mem_bias = attention_bias_from_lengths(memory_valid, memory.shape[1])
    x = zero_past(embeds, tok_mask)
    pad = (cfg.fsmn_kernel - 1) // 2
    heads, hd = cfg.num_heads, cfg.head_dim
    for p in params["decoders"]:
        y = _ffn_sanm_decoder(layer_norm(x, p["norm1"]["scale"], p["norm1"]["bias"]), p["ffn"])
        sa_in = zero_past(layer_norm(y, p["norm2"]["scale"], p["norm2"]["bias"]), tok_mask)
        x = x + (depthwise_conv1d_time(sa_in, p["fsmn_w"], pad, pad) + sa_in)
        c_in = layer_norm(x, p["norm3"]["scale"], p["norm3"]["bias"])
        q = dense(c_in, p["cross"]["q"]).reshape(b, n, heads, hd)
        k, v = torch.chunk(dense(memory, p["cross"]["kv"]), 2, dim=-1)
        ctx = mha(q, k.reshape(b, -1, heads, hd), v.reshape(b, -1, heads, hd), bias=mem_bias)
        x = x + dense(ctx.reshape(b, n, cfg.hidden), p["cross"]["out"])
    for p in params["decoder_ffn"]:
        x = _ffn_sanm_decoder(layer_norm(x, p["norm1"]["scale"], p["norm1"]["bias"]), p["ffn"])
    x = layer_norm(x, params["decoder_after_norm"]["scale"], params["decoder_after_norm"]["bias"])
    return dense(x, params["output"])


def frontend_features(params: dict, cfg: ParaformerConfig, audio: torch.Tensor,
                      valid_samples: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw audio -> (mel, encoder-ready features (fbank + LFR + CMVN + PE),
    valid LFR frames)."""
    fb = cfg.fbank
    mel = log_mel_fbank(audio, fb, fb.num_frames(audio.shape[-1]))
    valid_samples = torch.as_tensor(valid_samples, device=audio.device).to(torch.int64)
    valid_frames = torch.clamp((valid_samples - fb.win_length) // fb.hop_length + 1, min=0)
    feats = lfr_stack(mel, cfg.lfr_m, cfg.lfr_n, valid_frames)
    valid_lfr = (valid_frames + cfg.lfr_n - 1) // cfg.lfr_n
    feats = apply_cmvn_addmul(feats, params["cmvn_means"], params["cmvn_istd"])
    pe = torch.from_numpy(sinusoid_position_encoding(feats.shape[1], cfg.feature_size)).to(audio.device)
    return mel, feats + pe[None], valid_lfr


def forward(params: dict, cfg: ParaformerConfig, audio: torch.Tensor, valid_samples: torch.Tensor,
            max_tokens: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw audio (B, S), int16 range -> (token ids (B, max_tokens) int32,
    counts (B,) int32)."""
    _mel, feats, valid_lfr = frontend_features(params, cfg, audio, valid_samples)
    enc = encode(params, cfg, feats.to(params["output"]["b"].dtype), valid_lfr)
    alphas = predict_alphas(params, cfg, enc, valid_lfr)
    embeds, counts = cif_fire(alphas, enc, valid_lfr, max_tokens, cfg.tail_threshold)
    logits = decode_tokens(params, cfg, embeds.to(enc.dtype), counts, enc, valid_lfr)
    ids = torch.argmax(logits, dim=-1).to(torch.int32)
    return zero_past(ids[..., None], length_mask(counts, max_tokens))[..., 0], counts
