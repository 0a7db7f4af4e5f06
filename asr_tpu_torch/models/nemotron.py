"""Nemotron 3.5 ASR: cache-aware FastConformer + RNN-T, offline mode.

Counterpart of ``asr_tpu/models/nemotron.py``: the NeMo mel front end (no
per-feature normalization, padded frames zeroed), a **causal** pre-encode
conv chain (the first conv pads ``2 + pre_encode_cache`` frames on top and
1 below, every conv pads the mel axis (2, 1); then ``drop_extra`` frames
are dropped), relative-position conformer blocks under a chunked block
attention mask (chunk = right_context + 1 frames, bounded left context)
that reproduces cache-aware streaming, causal conv modules (a fully
left-padded depthwise conv, then a LayerNorm), the multilingual prompt
folded into the joint's encoder side, and an LSTM predictor with an RNN-T
joint decoded by ``max_symbols_per_frame`` greedy.

In the q8 form every linear runs on the int8 kernel through
``layers/transformer.dense``; the prompt's ``w0_enc`` (a bare matrix, kept
f32 by its key name), its ``bias_table``, the LSTM gates and the embedding
stay f32.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from asr_tpu_torch.decode.rnnt import rnnt_greedy
from asr_tpu_torch.frontend.nemo_mel import NemoMelConfig, log_mel
from asr_tpu_torch.layers.attention import NEG_INF, attention_bias_from_lengths, length_mask
from asr_tpu_torch.layers.conformer import (
    _ff,
    zero_past,
    conv2d,
    rel_pos_attention,
    relative_position_embedding,
)
from asr_tpu_torch.layers.lstm import init_lstm_params, lstm_step_stack
from asr_tpu_torch.layers.norms import layer_norm
from asr_tpu_torch.layers.sanm import depthwise_conv1d_time
from asr_tpu_torch.layers.transformer import dense


@dataclasses.dataclass(frozen=True)
class NemotronConfig:
    vocab_size: int = 8192           # without blank; blank id = vocab_size
    d_model: int = 1024
    num_layers: int = 24
    num_heads: int = 8
    ffn_dim: int = 4096
    conv_kernel: int = 9
    sub_channels: int = 256
    pred_hidden: int = 640
    joint_hidden: int = 640
    prompt_hidden: int = 640
    lstm_layers: int = 2
    num_prompts: int = 128
    left_context: int = 70
    right_context: int = 13          # chunk = right + 1 encoder frames
    drop_extra: int = 2
    pre_encode_cache: int = 9        # sub_factor + 1
    max_symbols_per_frame: int = 10
    sample_rate: int = 16000
    mel: NemoMelConfig = NemoMelConfig(n_mels=128)

    @property
    def blank_id(self) -> int:
        return self.vocab_size

    @property
    def chunk(self) -> int:
        return self.right_context + 1


def init_params(cfg: NemotronConfig, generator: torch.Generator, device=None,
                dtype: torch.dtype = torch.float32) -> dict:
    """Random-init parameters with the checkpoint's layout and the JAX
    package's scales, drawn from ``generator`` on its own device and placed
    on ``device``."""
    device = torch.device(device) if device is not None else generator.device
    d, f, ch = cfg.d_model, cfg.ffn_dim, cfg.sub_channels

    def normal(*shape, std):
        t = torch.randn(shape, generator=generator, device=generator.device) * std
        return t.to(device=device, dtype=dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    def lin(i, o, bias=True):
        p = {"w": normal(i, o, std=i ** -0.5)}
        if bias:
            p["b"] = zeros(o)
        return p

    def norm(dd=d):
        return {"scale": torch.ones((dd,), device=device, dtype=dtype), "bias": zeros(dd)}

    def block():
        return {
            "norm_ff1": norm(), "ff1": {"w1": lin(d, f, False), "w2": lin(f, d, False)},
            "norm_att": norm(),
            "attn": {
                "q": lin(d, d, False), "k": lin(d, d, False), "v": lin(d, d, False),
                "o": lin(d, d, False),
                "rel_k": {"w": normal(d, d, std=d ** -0.5)},
                "bias_u": zeros(cfg.num_heads, d // cfg.num_heads),
                "bias_v": zeros(cfg.num_heads, d // cfg.num_heads),
            },
            "norm_conv": norm(),
            "conv": {
                "pw1": lin(d, 2 * d, False),
                "dw": {"w": normal(cfg.conv_kernel, d, std=0.1)},
                "ln": norm(),
                "pw2": lin(d, d, False),
            },
            "norm_ff2": norm(), "ff2": {"w1": lin(d, f, False), "w2": lin(f, d, False)},
            "norm_out": norm(),
        }

    def conv(*shape):
        return {"w": normal(*shape, std=0.1), "b": zeros(ch)}

    freq = cfg.mel.n_mels
    for _ in range(3):
        freq = (freq + 2 + 1 - 3) // 2 + 1  # mel pads (2, 1), kernel 3, stride 2
    ph, jh = cfg.pred_hidden, cfg.joint_hidden
    return {
        "pre_encode": {"conv0": conv(3, 3, 1, ch), "dw1": conv(3, 3, 1, ch), "pw1": conv(1, 1, ch, ch),
                       "dw2": conv(3, 3, 1, ch), "pw2": conv(1, 1, ch, ch), "out": lin(ch * freq, d)},
        "blocks": [block() for _ in range(cfg.num_layers)],
        "prompt": {
            "w0_enc": normal(d, cfg.prompt_hidden, std=d ** -0.5),
            "bias_table": normal(cfg.num_prompts, cfg.prompt_hidden, std=0.02),
            "w2": lin(cfg.prompt_hidden, cfg.prompt_hidden),
            "joint_enc": lin(cfg.prompt_hidden, jh),
        },
        "decoder": {
            "embed": normal(cfg.vocab_size + 1, ph, std=0.02),
            "lstm": init_lstm_params(normal, zeros, ph, ph, cfg.lstm_layers),
            "pred": lin(ph, jh),
            "joint_net": lin(jh, cfg.vocab_size + 1),
        },
    }


def _causal_conv2d(x, w, b, groups: int = 1, pad_top: int = 2):
    """NHWC conv, kernel 3, stride 2, pads H (time) = (pad_top, 1) and
    W (mel) = (2, 1): the reference's asymmetric conv."""
    return conv2d(x, w, b, (2, 2), ((pad_top, 1), (2, 1)), groups)


def pre_encode(params: dict, cfg: NemotronConfig, feats: torch.Tensor,
               valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """feats (B, T, M) -> ((B, T', D), valid counts): the causal conv chain,
    the channel-major flatten and the linear, then ``drop_extra``."""
    p = params["pre_encode"]
    ch = p["conv0"]["w"].shape[-1]
    x = feats[..., None]
    pad0 = 2 + cfg.pre_encode_cache
    x = torch.relu(_causal_conv2d(x, p["conv0"]["w"], p["conv0"]["b"], 1, pad0))
    valid = (valid + pad0 + 1 - 3) // 2 + 1
    for i in (1, 2):
        x = _causal_conv2d(x, p[f"dw{i}"]["w"], p[f"dw{i}"]["b"], ch)
        valid = (valid + 2 + 1 - 3) // 2 + 1
        x = torch.relu(conv2d(x, p[f"pw{i}"]["w"], p[f"pw{i}"]["b"]))
    b, t = x.shape[0], x.shape[1]
    x = dense(x.transpose(2, 3).reshape(b, t, -1), p["out"])  # channel-major flatten
    return x[:, cfg.drop_extra :], torch.clamp(valid - cfg.drop_extra, min=0)


@functools.lru_cache(maxsize=8)
def _chunk_mask_np(t: int, chunk: int, left: int, right: int) -> np.ndarray:
    """Additive (t, t) block mask of cache-aware chunked attention."""
    idx = np.arange(t)
    chunk_start = (idx // chunk) * chunk
    lo = (chunk_start - left)[:, None]
    hi = (chunk_start + right)[:, None]
    keep = (idx[None, :] >= lo) & (idx[None, :] <= hi)
    return np.where(keep, 0.0, NEG_INF).astype(np.float32)


def conv_module_causal(x: torch.Tensor, p: dict, key_mask: torch.Tensor | None) -> torch.Tensor:
    """Causal conv module: pointwise, GLU, padded rows zeroed, a fully
    left-padded depthwise conv, LayerNorm, SiLU, pointwise."""
    a, g = torch.chunk(dense(x, p["pw1"]), 2, dim=-1)
    y = zero_past(a * torch.sigmoid(g), key_mask)
    y = depthwise_conv1d_time(y, p["dw"]["w"], p["dw"]["w"].shape[0] - 1, 0)
    if "b" in p["dw"]:
        y = y + p["dw"]["b"]
    y = F.silu(layer_norm(y, p["ln"]["scale"], p["ln"]["bias"]))
    return dense(y, p["pw2"])


def encode_features(params: dict, cfg: NemotronConfig, mel: torch.Tensor, valid_frames: torch.Tensor,
                    prompt_id: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero-masked mel (B, T, M) -> (joint-projected frames (B, T',
    joint_hidden), valid counts)."""
    pr = params["prompt"]
    x, valid = pre_encode(params, cfg, mel.to(pr["w0_enc"].dtype), valid_frames)
    t = x.shape[1]
    pe = torch.from_numpy(relative_position_embedding(t, cfg.d_model)).to(device=x.device, dtype=x.dtype)
    key_mask = length_mask(valid, t)
    chunk = torch.from_numpy(_chunk_mask_np(t, cfg.chunk, cfg.left_context, cfg.right_context))
    bias = chunk.to(x.device)[None, None] + attention_bias_from_lengths(valid, t)

    for p in params["blocks"]:
        def ln(y, name):
            return layer_norm(y, p[name]["scale"], p[name]["bias"])

        x = x + 0.5 * _ff(ln(x, "norm_ff1"), p["ff1"])
        x = x + rel_pos_attention(ln(x, "norm_att"), p["attn"], cfg.num_heads, pe, bias)
        x = x + conv_module_causal(ln(x, "norm_conv"), p["conv"], key_mask)
        x = x + 0.5 * _ff(ln(x, "norm_ff2"), p["ff2"])
        x = ln(x, "norm_out")

    h0 = torch.relu(x @ pr["w0_enc"] + pr["bias_table"][prompt_id][:, None, :])
    return dense(dense(h0, pr["w2"]), pr["joint_enc"]), valid


def encode(params: dict, cfg: NemotronConfig, audio: torch.Tensor, valid_samples: torch.Tensor,
           prompt_id: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw audio -> (joint-projected encoder frames (B, T', joint_hidden), valid)."""
    mel = log_mel(audio, cfg.mel)
    valid_frames = cfg.mel.valid_frames(valid_samples).to(audio.device)
    keep = length_mask(valid_frames, mel.shape[1])
    mel = torch.where(keep[..., None], mel, torch.zeros((), dtype=mel.dtype, device=mel.device))
    return encode_features(params, cfg, mel, valid_frames, prompt_id)


def joint_step(params: dict, token: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
               enc_frame: torch.Tensor):
    """(token (B,), h, c, enc_frame (B, joint_hidden)) -> (logits (B, V + 1), h', c')."""
    dec = params["decoder"]
    y, h2, c2 = lstm_step_stack(dec["embed"][token], h, c, dec["lstm"])
    z = torch.relu(enc_frame + dense(y, dec["pred"]))
    return dense(z, dec["joint_net"]), h2, c2


def forward(params: dict, cfg: NemotronConfig, audio: torch.Tensor, valid_samples: torch.Tensor,
            prompt_id: torch.Tensor, max_tokens: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw audio -> (token ids (B, max_tokens) int32, counts (B,) int32) by
    RNN-T greedy."""
    enc, valid = encode(params, cfg, audio, valid_samples, prompt_id)
    shape = (cfg.lstm_layers, enc.shape[0], cfg.pred_hidden)
    h0 = torch.zeros(shape, dtype=enc.dtype, device=enc.device)

    def step(token, h, c, enc_frame):
        return joint_step(params, token, h, c, enc_frame)

    return rnnt_greedy(step, enc, valid, h0, h0.clone(), start_token=cfg.blank_id, blank_id=cfg.blank_id,
                       max_tokens=max_tokens, max_symbols_per_frame=cfg.max_symbols_per_frame)
