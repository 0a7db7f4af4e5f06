"""Parakeet-TDT: FastConformer encoder + LSTM predictor + TDT joint.

Counterpart of ``asr_tpu/models/parakeet.py``: the NeMo mel front end with
per-feature normalization, the depthwise-separable 8x conv subsampling, the
subsampled states scaled by ``sqrt(d_model)`` (NeMo's xscale), 24
relative-position FastConformer blocks, the encoder projection
(``enc_proj``), a stateless-start 2-layer LSTM predictor and a joint head
that emits vocabulary and duration logits in one linear (split at the
embedding's row count), decoded by the TDT greedy loop.

Parameters are the JAX package's pytree (nested dicts and lists of
tensors, linear weights ``(in, out)``, conv weights HWIO). In the q8 form
every linear (the subsampling's output, the blocks' 11 linears, the
encoder projection, the predictor projection and the joint head) runs on
the int8 kernel through ``layers/transformer.dense``; the LSTM's gate
weights and the embedding stay f32.
"""

from __future__ import annotations

import dataclasses

import torch

from asr_tpu_torch.decode.tdt import tdt_greedy
from asr_tpu_torch.frontend.nemo_mel import NemoMelConfig, log_mel, per_feature_norm
from asr_tpu_torch.layers.attention import attention_bias_from_lengths, length_mask
from asr_tpu_torch.layers.conformer import (
    conformer_block,
    relative_position_embedding,
    subsample_conv2d,
)
from asr_tpu_torch.layers.lstm import init_lstm_params, lstm_step_stack
from asr_tpu_torch.layers.transformer import dense


@dataclasses.dataclass(frozen=True)
class ParakeetConfig:
    vocab_size: int = 8193          # includes blank (last id)
    blank_id: int = 8192
    d_model: int = 1024
    num_layers: int = 24
    num_heads: int = 8
    ffn_dim: int = 4096
    conv_kernel: int = 9
    sub_channels: int = 256
    sub_kernel: int = 3
    sub_stride: int = 2
    dec_hidden: int = 640
    lstm_layers: int = 2
    durations: tuple[int, ...] = (0, 1, 2, 3, 4)
    scale_input: bool = True     # NeMo xscale: multiply subsampled states by sqrt(d_model)
    eos_id: int | None = None
    sample_rate: int = 16000
    mel: NemoMelConfig = NemoMelConfig()

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def num_durations(self) -> int:
        return len(self.durations)


def init_params(cfg: ParakeetConfig, generator: torch.Generator, device=None,
                dtype: torch.dtype = torch.float32) -> dict:
    """Random-init parameters with the checkpoint's layout and the JAX
    package's scales, drawn from ``generator`` on its own device and placed
    on ``device``."""
    device = torch.device(device) if device is not None else generator.device
    d, f, ch, k = cfg.d_model, cfg.ffn_dim, cfg.sub_channels, cfg.sub_kernel

    def normal(*shape, std):
        t = torch.randn(shape, generator=generator, device=generator.device) * std
        return t.to(device=device, dtype=dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    def lin(i, o):
        return {"w": normal(i, o, std=i ** -0.5), "b": zeros(o)}

    def norm(dd=d):
        return {"scale": torch.ones((dd,), device=device, dtype=dtype), "bias": zeros(dd)}

    def block():
        return {
            "norm_ff1": norm(), "ff1": {"w1": lin(d, f), "w2": lin(f, d)},
            "norm_att": norm(),
            "attn": {
                "q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "o": lin(d, d),
                "rel_k": {"w": normal(d, d, std=d ** -0.5)},
                "bias_u": zeros(cfg.num_heads, cfg.head_dim),
                "bias_v": zeros(cfg.num_heads, cfg.head_dim),
            },
            "norm_conv": norm(),
            "conv": {
                "pw1": lin(d, 2 * d),
                "dw": {"w": normal(cfg.conv_kernel, d, std=0.1), "b": zeros(d)},
                "bn": {"scale": torch.ones((d,), device=device, dtype=dtype), "shift": zeros(d)},
                "pw2": lin(d, d),
            },
            "norm_ff2": norm(), "ff2": {"w1": lin(d, f), "w2": lin(f, d)},
            "norm_out": norm(),
        }

    def conv(*shape):
        return {"w": normal(*shape, std=0.1), "b": zeros(ch)}

    freq = cfg.mel.n_mels
    for _ in range(3):
        freq = (freq + 2 * ((k - 1) // 2) - k) // cfg.sub_stride + 1
    h = cfg.dec_hidden
    return {
        "subsample": {"conv0": conv(k, k, 1, ch), "dw1": conv(k, k, 1, ch), "pw1": conv(1, 1, ch, ch),
                      "dw2": conv(k, k, 1, ch), "pw2": conv(1, 1, ch, ch), "out": lin(ch * freq, d)},
        "blocks": [block() for _ in range(cfg.num_layers)],
        "enc_proj": lin(d, h),
        "decoder": {
            "embed": normal(cfg.vocab_size, h, std=0.02),
            "lstm": init_lstm_params(normal, zeros, h, h, cfg.lstm_layers),
            "proj": lin(h, h),
            "head": lin(h, cfg.vocab_size + cfg.num_durations),
        },
    }


def encode_features(params: dict, cfg: ParakeetConfig, feats: torch.Tensor,
                    valid_frames: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalized mel features (B, T, M) -> (conformer states (B, T', D),
    subsampled valid counts); no encoder projection."""
    x, valid = subsample_conv2d(feats, params["subsample"], valid_frames, cfg.sub_kernel, cfg.sub_stride)
    if cfg.scale_input:
        x = x * (cfg.d_model ** 0.5)
    t = x.shape[1]
    pe = torch.from_numpy(relative_position_embedding(t, cfg.d_model)).to(device=x.device, dtype=x.dtype)
    key_mask = length_mask(valid, t)
    bias = attention_bias_from_lengths(valid, t)
    for p in params["blocks"]:
        x = conformer_block(x, p, cfg.num_heads, pe, bias, key_mask)
    return x, valid


def encode(params: dict, cfg: ParakeetConfig, audio: torch.Tensor,
           valid_samples: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw audio (B, S) -> (projected encoder frames (B, T', dec_hidden),
    valid frame counts)."""
    mel = log_mel(audio, cfg.mel)
    valid_frames = cfg.mel.valid_frames(valid_samples).to(audio.device)
    feats = per_feature_norm(mel, valid_frames, cfg.mel.norm_eps)
    x, valid = encode_features(params, cfg, feats.to(params["enc_proj"]["b"].dtype), valid_frames)
    return dense(x, params["enc_proj"]), valid


def joint_step(params: dict, token: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
               enc_frame: torch.Tensor):
    """(token (B,), h, c, enc_frame (B, H)) -> (token logits (B, V),
    duration logits (B, ND), h', c')."""
    dec = params["decoder"]
    y, h2, c2 = lstm_step_stack(dec["embed"][token], h, c, dec["lstm"])
    z = torch.relu(enc_frame + dense(y, dec["proj"]))
    logits = dense(z, dec["head"])
    v = dec["embed"].shape[0]
    return logits[:, :v], logits[:, v:], h2, c2


def forward(params: dict, cfg: ParakeetConfig, audio: torch.Tensor, valid_samples: torch.Tensor,
            max_tokens: int = 256, max_symbols: int = 10) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw audio -> (token ids (B, max_tokens) int32, counts (B,) int32) by
    TDT greedy."""
    enc, valid = encode(params, cfg, audio, valid_samples)
    shape = (cfg.lstm_layers, enc.shape[0], cfg.dec_hidden)
    h0 = torch.zeros(shape, dtype=enc.dtype, device=enc.device)

    def step(token, h, c, enc_frame):
        return joint_step(params, token, h, c, enc_frame)

    return tdt_greedy(step, enc, valid, h0, h0.clone(), start_token=cfg.blank_id, blank_id=cfg.blank_id,
                      durations=cfg.durations, max_tokens=max_tokens, max_symbols_per_step=max_symbols,
                      eos_id=cfg.eos_id)
