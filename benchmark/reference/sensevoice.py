"""SenseVoiceSmall in plain float32 PyTorch: raw audio -> CTC logits.

The published model (FunAudioLLM/SenseVoiceSmall, ``SenseVoiceEncoderSmall``):
Kaldi fbank (80 mels) -> LFR stacking (7 frames every 6, edge frames
repeated) -> CMVN ``(x + means) * istd`` -> sinusoidal positions (from 1,
scaled by nothing) -> a language and three system-prompt embeddings in
front -> 70 SANM blocks (the first without a residual, then 49, a
LayerNorm, 20 more) -> LayerNorm -> the CTC head. A SANM block is a
LayerNorm, fused q|k|v, softmax attention over the valid keys, an FSMN
memory (a depthwise conv of v with symmetric zero padding, plus v), the
output projection plus the memory, the residual, then a ReLU FFN with its
own LayerNorm and residual.

Windows are run as one padded batch with per-window valid lengths, keys
past the valid length masked, as a variable-length run would see them.
Weights arrive as the benchmark's f32 tree; the linears are quantized here
(``quant.fake_quant``) at the configuration's bit width.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import frontend
from benchmark.reference.quant import fake_quant

NEG_INF = -1e30


def quantize_linears(params: dict, bits: int | None, block: int, refine: int) -> dict:
    """The tree with every linear ``w`` replaced by its dequantized fit
    (``bits`` None: kept in f32)."""
    def lin(p):
        if bits is None:
            return dict(p)
        return {**p, "w": fake_quant(p["w"], bits, block, refine)}

    def blk(p):
        return {**p, "qkv": lin(p["qkv"]), "out": lin(p["out"]),
                "ffn": {**p["ffn"], "w1": fake_quant(p["ffn"]["w1"], bits, block, refine)
                        if bits else p["ffn"]["w1"],
                        "w2": fake_quant(p["ffn"]["w2"], bits, block, refine)
                        if bits else p["ffn"]["w2"]}}

    out = dict(params)
    for key in ("encoders0", "encoders", "tp_encoders"):
        out[key] = [blk(p) for p in params[key]]
    out["ctc"] = lin(params["ctc"])
    return out


def layer_norm(x, p, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps)


def sinusoid(length: int, depth: int, device) -> torch.Tensor:
    pos = torch.arange(1, length + 1, dtype=torch.float32, device=device)[:, None]
    inv = torch.exp(torch.arange(depth // 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / (depth / 2 - 1)))[None]
    return torch.cat([torch.sin(pos * inv), torch.cos(pos * inv)], dim=1)


def sanm_block(x, p, heads, head_dim, valid, residual):
    b, t, _ = x.shape
    keep = torch.arange(t, device=x.device)[None] < valid[:, None]
    y = layer_norm(x, p["norm1"])
    q, k, v = torch.chunk(y @ p["qkv"]["w"] + p["qkv"]["b"], 3, dim=-1)
    v = v * keep[..., None]
    hid = v.shape[-1]
    qh, kh, vh = (z.reshape(b, t, heads, head_dim).transpose(1, 2) for z in (q, k, v))
    scores = (qh @ kh.transpose(-1, -2)) * head_dim ** -0.5
    scores = scores.masked_fill(~keep[:, None, None, :], NEG_INF)
    ctx = (torch.softmax(scores, dim=-1) @ vh).transpose(1, 2).reshape(b, t, hid)
    taps = p["fsmn_w"]
    pad = (taps.shape[0] - 1) // 2
    mem = F.conv1d(v.transpose(1, 2), taps.t()[:, None, :], padding=pad, groups=hid)
    mem = mem.transpose(1, 2) + v
    a = ctx @ p["out"]["w"] + p["out"]["b"] + mem
    if residual:
        a = a + x
    h = torch.relu(layer_norm(a, p["norm2"]) @ p["ffn"]["w1"] + p["ffn"]["b1"])
    return a + h @ p["ffn"]["w2"] + p["ffn"]["b2"]


def ctc_logits(params: dict, cfg: dict, audio: torch.Tensor, valid: torch.Tensor,
               language: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Windows ``(B, S)`` int16-range, valid samples ``(B,)`` -> (CTC logits
    ``(B, T, V)``, valid rows ``(B,)``, prompt rows included)."""
    win, hop, lfr_m, lfr_n = 400, 160, cfg["lfr_m"], cfg["lfr_n"]
    mel = frontend.kaldi_fbank(audio, n_mels=cfg["n_mels"], sample_rate=cfg["sample_rate"])
    b, t, d = mel.shape
    vframes = torch.clamp((valid.to(torch.int64) - win) // hop + 1, min=0)
    t_lfr = -(-t // lfr_n)
    idx = (torch.arange(t_lfr, device=mel.device)[:, None] * lfr_n
           + torch.arange(lfr_m, device=mel.device)[None] - (lfr_m - 1) // 2).clamp(min=0)
    idx = torch.minimum(idx[None], vframes[:, None, None] - 1)
    idx = torch.where(idx < 0, idx + t, idx).reshape(b, -1)
    feats = torch.gather(mel, 1, idx[..., None].expand(b, idx.shape[1], d)).reshape(b, t_lfr, d * lfr_m)
    vlfr = (vframes + lfr_n - 1) // lfr_n
    feats = (feats + params["cmvn_means"]) * params["cmvn_istd"]
    n_prompt = 4
    pe = sinusoid(t_lfr + n_prompt, feats.shape[-1], feats.device)
    feats = feats + pe[n_prompt:][None]
    lang = params["language_embed"][language] + pe[0]
    system = params["system_embed"] + pe[1:n_prompt]
    x = torch.cat([lang[None, None].expand(b, 1, -1), system[None].expand(b, -1, -1), feats], dim=1)
    vseq = vlfr + n_prompt
    keep = torch.arange(x.shape[1], device=x.device)[None] < vseq[:, None]
    x = x * keep[..., None]
    heads, hd = cfg["num_heads"], cfg["head_dim"]
    for i, p in enumerate(params["encoders0"]):
        x = sanm_block(x, p, heads, hd, vseq, residual=False)
    for p in params["encoders"]:
        x = sanm_block(x, p, heads, hd, vseq, residual=True)
    x = layer_norm(x, params["after_norm"])
    for p in params["tp_encoders"]:
        x = sanm_block(x, p, heads, hd, vseq, residual=True)
    x = layer_norm(x, params["tp_norm"])
    return x @ params["ctc"]["w"] + params["ctc"]["b"], vseq
