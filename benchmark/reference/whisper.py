"""Whisper (large-v3 family) in plain float32 PyTorch, teacher-forced.

The published model (openai/whisper-large-v3-turbo): 128-mel log-mel
spectrogram of a 30 s window -> two GELU convolutions (the second of stride
2) -> learned positions -> pre-LN encoder blocks (self-attention with
biased q and v, an unbiased k, exact-GELU MLP) -> LayerNorm; the decoder
embeds tokens with the tied embedding plus learned positions, runs pre-LN
blocks (causal self-attention, cross-attention over the encoder output,
MLP), a final LayerNorm and the tied head.

:func:`decoder_logits` runs a whole token sequence at once (causal mask),
which is what a cached step-by-step decode computes. Weights arrive as the
benchmark's f32 tree; linears and the tied embedding are quantized here
(``quant.fake_quant`` / ``fake_quant_rows``) at the configuration's bit
width.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.quant import fake_quant, fake_quant_rows

NEG_INF = -1e30


def quantize(params: dict, bits: int | None, block: int, refine: int) -> dict:
    """The tree with every attention and MLP ``w`` and the decoder's tied
    embedding replaced by their dequantized fits (``bits`` None: f32)."""
    if bits is None:
        return params

    def lin(p):
        return {**p, "w": fake_quant(p["w"], bits, block, refine)}

    def attn(p):
        return {k: lin(v) for k, v in p.items()}

    def block_(p):
        out = dict(p)
        for key in ("attn", "cross"):
            if key in p:
                out[key] = attn(p[key])
        out["mlp"] = {k: lin(v) for k, v in p["mlp"].items()}
        return out

    enc, dec = params["encoder"], params["decoder"]
    return {
        "encoder": {**enc, "blocks": [block_(p) for p in enc["blocks"]]},
        "decoder": {**dec, "blocks": [block_(p) for p in dec["blocks"]],
                    "embed": fake_quant_rows(dec["embed"], bits, block)},
    }


def _ln(x, p):
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], 1e-5)


def _lin(x, p):
    y = x @ p["w"]
    return y + p["b"] if "b" in p else y


def _attend(q, k, v, heads, mask=None):
    b, tq, d = q.shape
    hd = d // heads
    qh = q.reshape(b, tq, heads, hd).transpose(1, 2)
    kh = k.reshape(b, k.shape[1], heads, hd).transpose(1, 2)
    vh = v.reshape(b, v.shape[1], heads, hd).transpose(1, 2)
    scores = (qh @ kh.transpose(-1, -2)) * hd ** -0.5
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    return (torch.softmax(scores, dim=-1) @ vh).transpose(1, 2).reshape(b, tq, d)


def encode(params: dict, cfg: dict, mel: torch.Tensor) -> torch.Tensor:
    """(B, 3000, n_mels) -> (B, 1500, d_model)."""
    e = params["encoder"]
    x = F.gelu(F.conv1d(mel.transpose(1, 2), e["conv1"]["w"].permute(2, 1, 0), e["conv1"]["b"],
                        padding=1))
    x = F.gelu(F.conv1d(x, e["conv2"]["w"].permute(2, 1, 0), e["conv2"]["b"], stride=2,
                        padding=1)).transpose(1, 2)
    x = x + e["pos"][: x.shape[1]]
    h = cfg["num_heads"]
    for p in e["blocks"]:
        y = _ln(x, p["ln1"])
        x = x + _lin(_attend(_lin(y, p["attn"]["q"]), _lin(y, p["attn"]["k"]),
                             _lin(y, p["attn"]["v"]), h), p["attn"]["o"])
        y = _ln(x, p["ln2"])
        x = x + _lin(F.gelu(_lin(y, p["mlp"]["fc1"])), p["mlp"]["fc2"])
    return _ln(x, e["ln_post"])


def decoder_logits(params: dict, cfg: dict, enc: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Tokens ``(B, S)`` from position 0 -> logits ``(B, S, V)``: row i
    scores the token that follows ``tokens[:, i]``."""
    d = params["decoder"]
    s = tokens.shape[1]
    x = d["embed"][tokens] + d["pos"][:s]
    h = cfg["num_heads"]
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    for p in d["blocks"]:
        y = _ln(x, p["ln1"])
        x = x + _lin(_attend(_lin(y, p["attn"]["q"]), _lin(y, p["attn"]["k"]),
                             _lin(y, p["attn"]["v"]), h, causal), p["attn"]["o"])
        y = _ln(x, p["ln_cross"])
        x = x + _lin(_attend(_lin(y, p["cross"]["q"]), _lin(enc, p["cross"]["k"]),
                             _lin(enc, p["cross"]["v"]), h), p["cross"]["o"])
        y = _ln(x, p["ln2"])
        x = x + _lin(F.gelu(_lin(y, p["mlp"]["fc1"])), p["mlp"]["fc2"])
    return _ln(x, d["ln"]) @ d["embed"].t()
