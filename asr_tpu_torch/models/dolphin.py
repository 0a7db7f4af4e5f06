"""Dolphin v1 / CN-Dialect: E-Branchformer encoder + AR decoder + CTC head.

Counterpart of ``asr_tpu/models/dolphin.py``: the espnet (OWSM-style) front
end (``frontend/espnet_mel.py``, global CMVN in the model), Conv2d
subsampling with the sqrt(d) embed scale, E-Branchformer blocks
(``layers/ebranchformer.py``) and ``after_norm``, an espnet transformer AR
decoder (self-KV caches, per-layer cross-KV, sqrt(d)-scaled tied embedding
plus sinusoid positions) and a CTC head over the encoder output.

Two-level language control: the prompt [sos, lang, region, ...] may hold
-1 / -2, which the prefill replaces by the language and region it probes:
the argmax over the language span of the [sos] step's logits, then over the
region span of the step after the language token.

Parameters are the JAX package's pytree; at batch 1 with stacked q8 weights
the decode runs each step as one fused step
(``ops.fused_aed_step.fused_ar_decode``; greedy decode replays one CUDA
graph a token on a card).
"""

from __future__ import annotations

import dataclasses

import torch

from asr_tpu_torch.decode.ar import DecodeConfig, ar_decode, select_token
from asr_tpu_torch.decode.ctc import ctc_greedy_collapse
from asr_tpu_torch.decode.strategies import suppress_tokens
from asr_tpu_torch.frontend.espnet_mel import EspnetMelConfig, log_mel
from asr_tpu_torch.layers.attention import attention_bias_from_lengths, length_mask
from asr_tpu_torch.layers.conformer import (
    absolute_positions,
    conv2d,
    relative_position_embedding,
    subsampled_length,
)
from asr_tpu_torch.layers.ebranchformer import ebranchformer_block, init_block_params
from asr_tpu_torch.layers.norms import layer_norm
from asr_tpu_torch.layers.transformer import cross_kv, decoder_block, dense
from asr_tpu_torch.quant.quantize import embedding_logits


@dataclasses.dataclass(frozen=True)
class DolphinConfig:
    vocab_size: int = 27588
    d_model: int = 512
    enc_layers: int = 12
    enc_heads: int = 8
    enc_ffn: int = 2048
    cgmlp_dim: int = 2048
    csgu_kernel: int = 31
    fusion_kernel: int = 3
    dec_layers: int = 6
    dec_heads: int = 8
    dec_ffn: int = 2048
    sos_id: int = 27586
    eos_id: int = 27587
    language_token_start: int = 0     # loader fills real ranges from vocab
    language_token_end: int = 0
    region_token_start: int = 0
    region_token_end: int = 0
    max_target_positions: int = 448
    sample_rate: int = 16000
    mel: EspnetMelConfig = EspnetMelConfig()

    @property
    def head_dim(self) -> int:
        return self.d_model // self.enc_heads


def init_params(cfg: DolphinConfig, generator: torch.Generator, device=None,
                dtype: torch.dtype = torch.float32) -> dict:
    """Random-init parameters with the checkpoint's layout and the JAX
    package's scales, drawn from ``generator`` on its own device and placed
    on ``device``."""
    device = torch.device(device) if device is not None else generator.device
    d = cfg.d_model

    def normal(*shape, std):
        t = torch.randn(shape, generator=generator, device=generator.device) * std
        return t.to(device=device, dtype=dtype)

    def zeros(n):
        return torch.zeros((n,), device=device, dtype=dtype)

    def lin(i, o, bias=True):
        p = {"w": normal(i, o, std=i ** -0.5)}
        if bias:
            p["b"] = zeros(o)
        return p

    def norm(dd=d):
        return {"scale": torch.ones((dd,), device=device, dtype=dtype), "bias": zeros(dd)}

    def dec_block():
        return {
            "ln1": norm(),
            "attn": {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "o": lin(d, d)},
            "ln_cross": norm(),
            "cross": {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "o": lin(d, d)},
            "ln2": norm(),
            "mlp": {"fc1": lin(d, cfg.dec_ffn), "fc2": lin(cfg.dec_ffn, d)},
        }

    sub_freq = ((cfg.mel.n_mels - 1) // 2 - 1) // 2
    return {
        "cmvn_mean": zeros(cfg.mel.n_mels),
        "cmvn_istd": torch.ones((cfg.mel.n_mels,), device=device, dtype=dtype),
        "subsample": {
            "conv0": {"w": normal(3, 3, 1, d, std=0.05), "b": zeros(d)},
            "conv1": {"w": normal(3, 3, d, d, std=0.05), "b": zeros(d)},
            "out": lin(d * sub_freq, d),
        },
        "enc_blocks": [
            init_block_params(generator, d, cfg.enc_heads, cfg.enc_ffn, cfg.cgmlp_dim,
                              cfg.csgu_kernel, cfg.fusion_kernel, device, dtype)
            for _ in range(cfg.enc_layers)
        ],
        "after_norm": norm(),
        "ctc": lin(d, cfg.vocab_size),
        "decoder": {
            "embed": normal(cfg.vocab_size, d, std=0.02),
            "blocks": [dec_block() for _ in range(cfg.dec_layers)],
            "ln": norm(),
        },
    }


def encode(params: dict, cfg: DolphinConfig, audio: torch.Tensor,
           valid_samples: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Audio (B, S) -> (encoder states (B, T', D), valid counts)."""
    return encode_from_mel(params, cfg, log_mel(audio, cfg.mel), cfg.mel.valid_frames(valid_samples))


def encode_from_mel(params: dict, cfg: DolphinConfig, mel: torch.Tensor,
                    valid_frames: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mel features (B, T, n_mels) -> (enc, valid): CMVN, Conv2d subsampling
    with the sqrt(d) embed scale, the E-Branchformer stack, ``after_norm``."""
    mel = (mel - params["cmvn_mean"]) * params["cmvn_istd"]
    keep = length_mask(valid_frames, mel.shape[1])
    mel = torch.where(keep[..., None], mel, torch.zeros((), dtype=mel.dtype, device=mel.device))
    sub = params["subsample"]
    x = torch.relu(conv2d(mel[..., None], sub["conv0"]["w"], sub["conv0"]["b"], (2, 2)))
    x = torch.relu(conv2d(x, sub["conv1"]["w"], sub["conv1"]["b"], (2, 2)))
    b, t = x.shape[0], x.shape[1]
    x = dense(x.transpose(2, 3).reshape(b, t, -1), sub["out"]) * (cfg.d_model ** 0.5)
    valid = subsampled_length(valid_frames)

    pe = torch.from_numpy(relative_position_embedding(t, cfg.d_model)).to(x.device, x.dtype)
    key_mask = length_mask(valid, t)
    bias = attention_bias_from_lengths(valid, t)
    for p in params["enc_blocks"]:
        x = ebranchformer_block(x, p, cfg.enc_heads, pe, bias, key_mask)
    return layer_norm(x, params["after_norm"]["scale"], params["after_norm"]["bias"]), valid


def ctc_decode(params: dict, cfg: DolphinConfig, enc: torch.Tensor, enc_valid: torch.Tensor,
               blank_id: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """CTC head over the encoder output (Dolphin's fast head) -> (tokens, counts)."""
    ids = torch.argmax(dense(enc, params["ctc"]), dim=-1)
    return ctc_greedy_collapse(ids, enc_valid, blank_id)


def make_state(params: dict, cfg: DolphinConfig, enc: torch.Tensor) -> dict:
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


def _decoder_pass(params: dict, cfg: DolphinConfig, state: dict, tokens: torch.Tensor, pos: int,
                  cross_bias: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """S tokens through every decoder block at ``pos`` (caches written in
    place) -> (logits (B, S, V), state)."""
    dec = params["decoder"]
    d, s = cfg.d_model, tokens.shape[1]
    pos_table = absolute_positions(cfg.max_target_positions, d, tokens.device)
    x = (dec["embed"][tokens] * (d ** 0.5) + pos_table[pos : pos + s][None]).to(dec["embed"].dtype)
    for p, ls in zip(dec["blocks"], state["layers"]):
        x, _, _ = decoder_block(x, p, cfg.dec_heads, ls["self_k"], ls["self_v"], pos,
                                ls["cross_k"], ls["cross_v"], cross_bias=cross_bias)
    x = layer_norm(x, dec["ln"]["scale"], dec["ln"]["bias"])
    return embedding_logits(dec["embed"], x), state


def _span_argmax(logits: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    return torch.argmax(logits[:, -1, lo:hi], dim=-1) + lo


def prefill_window(params: dict, cfg: DolphinConfig, audio: torch.Tensor,
                   valid_samples: torch.Tensor, prompt: torch.Tensor,
                   decode_cfg: DecodeConfig) -> dict:
    """Encoder + language / region probes + prompt prefill: the front half of
    :func:`transcribe`, which the continuous AED engine also calls for one
    request. Returns ``state``, ``logits0`` (suppressed), ``enc_valid``,
    ``prompt`` (probe slots resolved), ``enc`` and, when the language span
    is set, ``language`` (and ``region`` when its span is set too)."""
    enc, enc_valid = encode(params, cfg, audio, valid_samples)
    cross_bias = attention_bias_from_lengths(enc_valid, enc.shape[1])
    prompt = prompt.to(device=enc.device, dtype=torch.int64)
    out: dict = {}
    if cfg.language_token_end > cfg.language_token_start:
        st = make_state(params, cfg, enc)
        lg, st = _decoder_pass(params, cfg, st, prompt[:, :1], 0, cross_bias)
        lang = _span_argmax(lg, cfg.language_token_start, cfg.language_token_end)
        prompt = torch.where(prompt == -1, lang[:, None], prompt)
        if cfg.region_token_end > cfg.region_token_start:
            lg2, st = _decoder_pass(params, cfg, st, lang[:, None], 1, cross_bias)
            region = _span_argmax(lg2, cfg.region_token_start, cfg.region_token_end)
            prompt = torch.where(prompt == -2, region[:, None], prompt)
            out["region"] = region
        out["language"] = lang
        del st
    state = make_state(params, cfg, enc)
    logits, state = _decoder_pass(params, cfg, state, prompt, 0, cross_bias)
    logits0 = suppress_tokens(logits[:, -1].to(torch.float32), decode_cfg.suppress_ids)
    out.update({"state": state, "logits0": logits0, "enc_valid": enc_valid, "prompt": prompt,
                "enc": enc})
    return out


def transcribe(params: dict, cfg: DolphinConfig, audio: torch.Tensor, valid_samples: torch.Tensor,
               prompt: torch.Tensor, decode_cfg: DecodeConfig,
               generator: torch.Generator | None = None, stacked=None) -> dict:
    """Raw audio + prompt (B, P) -> ``tokens`` (B, P + max_new + 1, the
    resolved prompt first), ``counts`` and, when probed, ``language`` /
    ``region``. Prompt slots holding -1 / -2 take the probed language /
    region token. ``stacked``: as for ``models/firered.transcribe``."""
    from asr_tpu_torch.ops.fused_aed_step import fused_ar_decode

    b, p_len = prompt.shape
    pre = prefill_window(params, cfg, audio, valid_samples, prompt, decode_cfg)
    enc, enc_valid, state, logits0 = pre["enc"], pre["enc_valid"], pre["state"], pre["logits0"]
    cross_bias = attention_bias_from_lengths(enc_valid, enc.shape[1])
    out = {k: pre[k] for k in ("language", "region") if k in pre}
    buf = torch.zeros((b, p_len + decode_cfg.max_new_tokens + 1), dtype=torch.int64,
                      device=enc.device)
    buf[:, :p_len] = pre["prompt"]
    first = select_token(logits0, buf, p_len, decode_cfg, generator, history_start=p_len)
    fused = fused_ar_decode(params, cfg, state, enc, enc_valid, first, buf, decode_cfg, generator,
                            stacked, start_pos=p_len)
    if fused is not None:
        out["tokens"], out["counts"] = fused
        return out

    def step(st, token, pos):
        lg, st = _decoder_pass(params, cfg, st, token, pos, cross_bias)
        return lg[:, -1], st

    out["tokens"], out["counts"] = ar_decode(step, state, p_len, first, buf, decode_cfg, generator)
    return out
