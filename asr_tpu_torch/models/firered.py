"""FireRedASR-AED: conformer encoder (espnet-style rel-pos) + AR decoder.

Counterpart of ``asr_tpu/models/firered.py``: a Kaldi-framed fbank with a
povey (hann^0.85) window and HTK mel banks, CMVN ``(x - means) * inv_std``,
6 appended zero lookahead frames, two unpadded k3/s2 Conv2d + ReLU, a
channel-major flatten and a linear, then conformer blocks

    out = x + 0.5*ffn1; + rel-pos MHSA (LayerNorm'd q/k/v, per-layer pos
    projection, bias_u / bias_v, rel-shift); + conv module (GLU 4d -> 2d,
    depthwise k33, LayerNorm, SiLU); + 0.5*ffn2; block LayerNorm

and a pre-LN transformer decoder (self-KV caches, per-layer cross-KV over
the encoder output, exact-GELU MLP) whose input is the sqrt(d)-scaled
embedding plus sinusoid positions, with the tied head (or ``dec["out"]``
where a checkpoint carries it). Decode is the shared greedy / penalty /
sampling loop; at batch 1 with stacked q8 weights it runs each step as one
call of the fused step kernel (``ops.fused_aed_step.fused_ar_decode``;
greedy decode replays one CUDA graph a token on a card).

Parameters are the JAX package's pytree (nested dicts and lists of tensors,
linear weights ``(in, out)``, conv weights HWIO); positions are Python ints
and the caches are written in place.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from asr_tpu_torch.decode.ar import DecodeConfig, ar_decode, select_token
from asr_tpu_torch.decode.strategies import suppress_tokens
from asr_tpu_torch.frontend.kaldi_fbank import KaldiFbankConfig, log_mel_fbank
from asr_tpu_torch.layers.attention import attention_bias_from_lengths, length_mask
from asr_tpu_torch.layers.conformer import (
    absolute_positions,
    conv2d,
    rel_shift,
    relative_position_embedding,
    subsampled_length,
)
from asr_tpu_torch.layers.norms import layer_norm
from asr_tpu_torch.layers.sanm import depthwise_conv1d_time
from asr_tpu_torch.layers.transformer import cross_kv, decoder_block, dense
from asr_tpu_torch.quant.quantize import embedding_logits


@dataclasses.dataclass(frozen=True)
class FireRedConfig:
    vocab_size: int = 7832
    n_mels: int = 80
    d_model: int = 1280
    enc_layers: int = 16
    enc_heads: int = 20
    conv_kernel: int = 33
    dec_layers: int = 16
    dec_heads: int = 20
    dec_ffn: int = 5120
    sos_id: int = 3
    eos_id: int = 4
    pad_lookahead: int = 6          # zero frames appended before subsampling
    max_target_positions: int = 448
    sample_rate: int = 16000
    fbank: KaldiFbankConfig = KaldiFbankConfig(window="povey", mel_style="htk")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.enc_heads


def init_params(cfg: FireRedConfig, generator: torch.Generator, device=None,
                dtype: torch.dtype = torch.float32) -> dict:
    """Random-init parameters with the checkpoint's layout and the JAX
    package's scales, drawn from ``generator`` on its own device and placed
    on ``device``."""
    device = torch.device(device) if device is not None else generator.device
    d = cfg.d_model

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

    def enc_block():
        return {
            "ffn1": {"norm": norm(), "w1": lin(d, 4 * d), "w2": lin(4 * d, d)},
            "attn": {
                "norm_q": norm(), "norm_k": norm(), "norm_v": norm(),
                "q": lin(d, d, False), "k": lin(d, d, False), "v": lin(d, d, False),
                "pos": {"w": normal(d, d, std=d ** -0.5)},
                "bias_u": zeros(cfg.enc_heads, cfg.head_dim),
                "bias_v": zeros(cfg.enc_heads, cfg.head_dim),
                "o": lin(d, d, False),
            },
            "conv": {
                "norm": norm(),
                "pw1": lin(d, 4 * d, False),
                "dw": {"w": normal(cfg.conv_kernel, 2 * d, std=0.05)},
                "ln": norm(2 * d),
                "pw2": lin(2 * d, d, False),
            },
            "ffn2": {"norm": norm(), "w1": lin(d, 4 * d), "w2": lin(4 * d, d)},
            "norm_out": norm(),
        }

    def dec_block():
        return {
            "ln1": norm(),
            "attn": {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "o": lin(d, d, False)},
            "ln_cross": norm(),
            "cross": {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "o": lin(d, d, False)},
            "ln2": norm(),
            "mlp": {"fc1": lin(d, cfg.dec_ffn), "fc2": lin(cfg.dec_ffn, d)},
        }

    ch = 32
    sub_freq = ((cfg.n_mels - 1) // 2 - 1) // 2
    return {
        "cmvn_means": zeros(cfg.n_mels),
        "cmvn_istd": torch.ones((cfg.n_mels,), device=device, dtype=dtype),
        "subsample": {
            "conv0": {"w": normal(3, 3, 1, ch, std=0.1), "b": zeros(ch)},
            "conv1": {"w": normal(3, 3, ch, ch, std=0.1), "b": zeros(ch)},
            "out": lin(ch * sub_freq, d),
        },
        "enc_blocks": [enc_block() for _ in range(cfg.enc_layers)],
        "decoder": {
            "embed": normal(cfg.vocab_size, d, std=0.02),
            "blocks": [dec_block() for _ in range(cfg.dec_layers)],
            "ln": norm(),
        },
    }


def _ffn(x: torch.Tensor, p: dict) -> torch.Tensor:
    y = layer_norm(x, p["norm"]["scale"], p["norm"]["bias"])
    return dense(F.silu(dense(y, p["w1"])), p["w2"])


def _rel_attention(x: torch.Tensor, p: dict, heads: int, pos_embed: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """Rel-pos MHSA with LayerNorm'd q / k / v inputs and the block's own
    ``pos`` projection of the relative table."""
    b, s, d = x.shape
    hd = d // heads

    def proj(norm, w):
        y = dense(layer_norm(x, p[norm]["scale"], p[norm]["bias"]), p[w])
        return y.reshape(b, s, heads, hd).transpose(1, 2)

    q, k, v = proj("norm_q", "q"), proj("norm_k", "k"), proj("norm_v", "v")
    rel_k = dense(pos_embed, p["pos"]).reshape(-1, heads, hd)
    qu = q + p["bias_u"][None, :, None, :]
    qv = q + p["bias_v"][None, :, None, :]
    ac = torch.einsum("bhsd,bhtd->bhst", qu, k)
    bd = rel_shift(torch.einsum("bhsd,phd->bhsp", qv, rel_k))[..., :s]
    scores = (ac + bd).to(torch.float32) * (hd ** -0.5) + bias
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhst,bhtd->bshd", probs, v).reshape(b, s, d)
    return dense(ctx, p["o"])


def _conv_module(x: torch.Tensor, p: dict, key_mask: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    y = layer_norm(x, p["norm"]["scale"], p["norm"]["bias"])
    y = dense(torch.where(key_mask[..., None], y, zero), p["pw1"])  # (B, S, 4d)
    a, g = torch.chunk(y, 2, dim=-1)
    y = a * torch.sigmoid(g)  # GLU -> 2d
    pad = (p["dw"]["w"].shape[0] - 1) // 2
    y = depthwise_conv1d_time(y, p["dw"]["w"], pad, pad)
    if "b" in p["dw"]:
        y = y + p["dw"]["b"]
    y = F.silu(layer_norm(y, p["ln"]["scale"], p["ln"]["bias"]))
    return torch.where(key_mask[..., None], dense(y, p["pw2"]), zero)


def encode(params: dict, cfg: FireRedConfig, audio: torch.Tensor,
           valid_samples: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw audio (B, S) in the int16 range -> (enc (B, T', D), valid counts)."""
    fb = cfg.fbank
    mel = log_mel_fbank(audio, fb, fb.num_frames(audio.shape[-1]))
    valid_frames = torch.clamp((valid_samples.to(torch.int64) - fb.win_length) // fb.hop_length + 1,
                               min=0)
    return encode_from_mel(params, cfg, mel, valid_frames)


def encode_from_mel(params: dict, cfg: FireRedConfig, mel: torch.Tensor,
                    valid_frames: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mel features (B, T, n_mels) -> (enc, valid): CMVN, lookahead pad,
    Conv2d subsampling, conformer stack."""
    mel = (mel - params["cmvn_means"]) * params["cmvn_istd"]
    keep = length_mask(valid_frames, mel.shape[1])
    mel = torch.where(keep[..., None], mel, torch.zeros((), dtype=mel.dtype, device=mel.device))
    mel = F.pad(mel, (0, 0, 0, cfg.pad_lookahead))
    sub = params["subsample"]
    x = torch.relu(conv2d(mel[..., None], sub["conv0"]["w"], sub["conv0"]["b"], (2, 2)))
    x = torch.relu(conv2d(x, sub["conv1"]["w"], sub["conv1"]["b"], (2, 2)))
    b, t = x.shape[0], x.shape[1]
    x = dense(x.transpose(2, 3).reshape(b, t, -1), sub["out"])  # channel-major flatten
    valid = subsampled_length(valid_frames)

    pe = torch.from_numpy(relative_position_embedding(t, cfg.d_model)).to(x.device, x.dtype)
    key_mask = length_mask(valid, t)
    bias = attention_bias_from_lengths(valid, t)
    for p in params["enc_blocks"]:
        x = x + 0.5 * _ffn(x, p["ffn1"])
        x = x + _rel_attention(x, p["attn"], cfg.enc_heads, pe, bias)
        x = x + _conv_module(x, p["conv"], key_mask)
        x = x + 0.5 * _ffn(x, p["ffn2"])
        x = layer_norm(x, p["norm_out"]["scale"], p["norm_out"]["bias"])
    return x, valid


def make_state(params: dict, cfg: FireRedConfig, enc: torch.Tensor) -> dict:
    """Decode state: per-layer cross-KV + zeroed self-KV caches ``(B, T_max, H, Dh)``."""
    b = enc.shape[0]
    shape = (b, cfg.max_target_positions, cfg.dec_heads, cfg.d_model // cfg.dec_heads)
    layers = []
    for p in params["decoder"]["blocks"]:
        ck, cv = cross_kv(enc, p, cfg.dec_heads)
        layers.append({"cross_k": ck, "cross_v": cv,
                       "self_k": torch.zeros(shape, dtype=enc.dtype, device=enc.device),
                       "self_v": torch.zeros(shape, dtype=enc.dtype, device=enc.device)})
    return {"layers": tuple(layers)}


def _decoder_pass(params: dict, cfg: FireRedConfig, state: dict, tokens: torch.Tensor, pos: int,
                  cross_bias: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """S tokens through every decoder block at ``pos`` (caches written in
    place) -> (logits (B, S, V), state). Untied checkpoints carry the head
    as ``dec["out"]``."""
    dec = params["decoder"]
    d, s = cfg.d_model, tokens.shape[1]
    pos_table = absolute_positions(cfg.max_target_positions, d, tokens.device)
    x = (dec["embed"][tokens] * (d ** 0.5) + pos_table[pos : pos + s][None]).to(dec["embed"].dtype)
    for p, ls in zip(dec["blocks"], state["layers"]):
        x, _, _ = decoder_block(x, p, cfg.dec_heads, ls["self_k"], ls["self_v"], pos,
                                ls["cross_k"], ls["cross_v"], cross_bias=cross_bias)
    x = layer_norm(x, dec["ln"]["scale"], dec["ln"]["bias"])
    return embedding_logits(dec["out"] if "out" in dec else dec["embed"], x), state


def prefill_window(params: dict, cfg: FireRedConfig, audio: torch.Tensor,
                   valid_samples: torch.Tensor, decode_cfg: DecodeConfig) -> dict:
    """Encoder + [SOS] prefill of one window batch: the front half of
    :func:`transcribe`, which the continuous AED engine also calls for one
    request. Returns ``state`` (prefilled), ``logits0`` (B, V) suppressed,
    ``enc_valid`` (B,) and ``enc``."""
    enc, enc_valid = encode(params, cfg, audio, valid_samples)
    cross_bias = attention_bias_from_lengths(enc_valid, enc.shape[1])
    state = make_state(params, cfg, enc)
    prompt = torch.full((audio.shape[0], 1), cfg.sos_id, dtype=torch.int64, device=enc.device)
    logits, state = _decoder_pass(params, cfg, state, prompt, 0, cross_bias)
    logits0 = suppress_tokens(logits[:, -1].to(torch.float32), decode_cfg.suppress_ids)
    return {"state": state, "logits0": logits0, "enc_valid": enc_valid, "enc": enc}


def transcribe(params: dict, cfg: FireRedConfig, audio: torch.Tensor,
               valid_samples: torch.Tensor, decode_cfg: DecodeConfig,
               generator: torch.Generator | None = None,
               stacked=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw audio -> (tokens (B, 1 + max_new + 1) starting from [SOS], counts).

    ``stacked``: the session's ``ops.fused_aed_step.FusedAedDecoder`` or q8
    step weights from ``ops.fused_aed_step.stack_aed_step_params``; with
    them a batch-1 decode in the bf16 mode runs each step as one fused step
    (``fused_ar_decode``), every other case the per-weight step."""
    from asr_tpu_torch.ops.fused_aed_step import fused_ar_decode

    pre = prefill_window(params, cfg, audio, valid_samples, decode_cfg)
    enc, enc_valid, state, logits0 = pre["enc"], pre["enc_valid"], pre["state"], pre["logits0"]
    cross_bias = attention_bias_from_lengths(enc_valid, enc.shape[1])
    b = audio.shape[0]
    buf = torch.zeros((b, 1 + decode_cfg.max_new_tokens + 1), dtype=torch.int64, device=enc.device)
    buf[:, 0] = cfg.sos_id
    first = select_token(logits0, buf, 1, decode_cfg, generator, history_start=1)
    fused = fused_ar_decode(params, cfg, state, enc, enc_valid, first, buf, decode_cfg, generator,
                            stacked, start_pos=1)
    if fused is not None:
        return fused

    def step(st, token, pos):
        lg, st = _decoder_pass(params, cfg, st, token, pos, cross_bias)
        return lg[:, -1], st

    return ar_decode(step, state, 1, first, buf, decode_cfg, generator)
