"""Dolphin CN-Dialect streaming: chunked E-Branchformer + streaming CTC +
AR rescoring decoder.

Counterpart of ``asr_tpu/streaming/dolphin_stream.py``, written once over a
leading stream axis N (every state leaf is the JAX package's leaf with N in
front; ``valid`` is an ``(N,)`` counter). Per 16-encoder-frame (640 ms)
chunk:

- Kaldi fbank + CMVN over an overlapped audio window (3 mel frames of
  lookahead, so the subsampling's receptive fields are exact across
  chunks);
- Conv2d (k3, s2, no pad) x2 subsampling + sqrt(d) embed scale;
- E-Branchformer blocks in streaming form: attention over the full history
  through per-layer append-only K/V buffers, the rel-pos bias without the
  rel-shift (``(q + bias_v) @ pos[:kv_len]``, the checkpoint's
  convention), the causal CSGU conv with a carried ``lorder`` tail, and a
  per-chunk left-zero-padded merge fusion conv;
- per-chunk CTC argmax ids and per-layer cross-K/V appended to buffers for
  the final AR rescoring decode.

The history buffers hold ``max_frames`` rows with a valid count. Each
append writes the new rows at ``clamp(valid, 0, T - n) + arange(n)``, row
by row: JAX's ``dynamic_update_slice`` clamps its start the same way, so a
stream longer than ``max_frames`` overwrites the buffer's last rows. (The
JAX package's ``scatter_free`` one-hot write is TPU machinery with the same
result and is not ported.)
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from asr_tpu_torch.decode.ar import DecodeConfig, ar_decode, select_token
from asr_tpu_torch.decode.strategies import suppress_tokens
from asr_tpu_torch.frontend.kaldi_fbank import KaldiFbankConfig, log_mel_fbank
from asr_tpu_torch.layers.attention import NEG_INF
from asr_tpu_torch.layers.conformer import absolute_positions, conv2d
from asr_tpu_torch.layers.norms import layer_norm
from asr_tpu_torch.layers.sanm import depthwise_conv1d_time
from asr_tpu_torch.layers.transformer import dense
from asr_tpu_torch.models.dolphin import DolphinConfig, _decoder_pass


@dataclasses.dataclass(frozen=True)
class DolphinStreamConfig:
    base: DolphinConfig = DolphinConfig()
    chunk_frames: int = 16            # encoder frames per chunk (640 ms)
    max_frames: int = 752             # total encoder frames (~30 s)
    fbank: KaldiFbankConfig = KaldiFbankConfig()

    @property
    def mel_per_chunk(self) -> int:
        return self.chunk_frames * 4  # new mel frames per chunk

    @property
    def window_mel(self) -> int:
        # Encoder frame J of chunk c reads mel [4*(J-kc), 4*(J-kc)+6] within
        # the window (two k3/s2 convs, no padding): 3 lookahead frames.
        return self.mel_per_chunk + 3

    @property
    def window_samples(self) -> int:
        fb = self.fbank
        return (self.window_mel - 1) * fb.hop_length + fb.win_length

    @property
    def advance_samples(self) -> int:
        return self.mel_per_chunk * self.fbank.hop_length


def init_state(cfg: DolphinStreamConfig, n: int = 1, device="cpu", dtype: torch.dtype = torch.float32) -> dict:
    b = cfg.base

    def zeros(*shape, dt=dtype):
        return torch.zeros((n, *shape), dtype=dt, device=device)

    return {
        "att_k": zeros(b.enc_layers, cfg.max_frames, b.enc_heads, b.head_dim),
        "att_v": zeros(b.enc_layers, cfg.max_frames, b.enc_heads, b.head_dim),
        "cnn": zeros(b.enc_layers, b.csgu_kernel - 1, b.cgmlp_dim // 2),
        "cross_k": zeros(b.dec_layers, cfg.max_frames, b.dec_heads, b.head_dim),
        "cross_v": zeros(b.dec_layers, cfg.max_frames, b.dec_heads, b.head_dim),
        "valid": zeros(dt=torch.int64),
    }


def _append_rows(buf: torch.Tensor, new: torch.Tensor, li: int, start: torch.Tensor) -> None:
    """Write ``new`` (N, n, H, D) into layer ``li`` of the stacked history
    buffer ``buf`` (N, L, T, H, D), in place, at each row's ``start``
    clamped into [0, T - n] (``dynamic_update_slice``'s clamp)."""
    t, n = buf.shape[2], new.shape[1]
    rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
    idx = torch.clamp(start, 0, t - n)[:, None] + torch.arange(n, device=buf.device)
    buf[rows, li, idx] = new.to(buf.dtype)


def precompute_rel_k(params: dict, cfg: DolphinStreamConfig) -> torch.Tensor:
    """Per-layer projected position keys ``(enc_layers, max_frames,
    enc_heads, head_dim)``: a params-only constant that sessions and
    runners compute once and pass to :func:`encoder_step` (``None`` keeps
    the projection in the step)."""
    b = cfg.base
    pos = absolute_positions(cfg.max_frames, b.d_model, params["after_norm"]["scale"].device)
    return torch.stack([dense(pos, p["attn"]["rel_k"]).reshape(cfg.max_frames, b.enc_heads, b.head_dim)
                        for p in params["enc_blocks"]])


def encoder_step(params: dict, cfg: DolphinStreamConfig, state: dict, window: torch.Tensor,
                 rel_k_cache: torch.Tensor | None = None):
    """N chunk windows (N, window_samples), int16 range (the session slides
    windows by ``advance_samples``) -> (state', ctc_ids (N, chunk), enc_out
    (N, chunk, D)). ``rel_k_cache``: an optional :func:`precompute_rel_k`."""
    b = cfg.base
    nst = window.shape[0]
    mel = log_mel_fbank(window, cfg.fbank, cfg.window_mel)
    mel = (mel - params["cmvn_mean"]) * params["cmvn_istd"]

    sub = params["subsample"]
    x = torch.relu(conv2d(mel[..., None], sub["conv0"]["w"], sub["conv0"]["b"], (2, 2)))
    x = torch.relu(conv2d(x, sub["conv1"]["w"], sub["conv1"]["b"], (2, 2)))
    t = x.shape[1]
    x = dense(x.transpose(2, 3).reshape(nst, t, -1), sub["out"]) * (b.d_model ** 0.5)
    x = x[:, : cfg.chunk_frames]  # exactly `chunk` new encoder-rate frames

    valid = state["valid"]
    n, max_f, hd = cfg.chunk_frames, cfg.max_frames, b.head_dim
    kv_len_total = valid + n
    kpos = torch.arange(max_f, device=x.device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    key_bias = torch.where(kpos < kv_len_total[:, None], zero, NEG_INF)[:, None, None, :]
    pos = absolute_positions(max_f, b.d_model, x.device) if rel_k_cache is None else None

    # Functional like the JAX step: the history buffers are copied once,
    # then every layer's rows are written into the copies.
    att_k, att_v, cnn = state["att_k"].clone(), state["att_v"].clone(), state["cnn"].clone()
    for li, p in enumerate(params["enc_blocks"]):
        # macaron FFN
        y = layer_norm(x, p["ffn_macaron"]["norm"]["scale"], p["ffn_macaron"]["norm"]["bias"])
        x = x + 0.5 * dense(F.silu(dense(y, p["ffn_macaron"]["w1"])), p["ffn_macaron"]["w2"])
        xn = layer_norm(x, p["norm_mha"]["scale"], p["norm_mha"]["bias"])
        # attention over the full history buffer
        q = dense(xn, p["attn"]["q"]).reshape(nst, n, b.enc_heads, hd)
        _append_rows(att_k, dense(xn, p["attn"]["k"]).reshape(nst, n, b.enc_heads, hd), li, valid)
        _append_rows(att_v, dense(xn, p["attn"]["v"]).reshape(nst, n, b.enc_heads, hd), li, valid)
        rel_k = (rel_k_cache[li] if rel_k_cache is not None else
                 dense(pos, p["attn"]["rel_k"]).reshape(max_f, b.enc_heads, hd))
        qu = q + p["attn"]["bias_u"][None, None]
        qv = q + p["attn"]["bias_v"][None, None]
        ac = torch.einsum("bqhd,bkhd->bhqk", qu, att_k[:, li])
        bdm = torch.einsum("bqhd,khd->bhqk", qv, rel_k)  # no rel-shift (the checkpoint's convention)
        scores = (ac + bdm).to(torch.float32) * (hd ** -0.5) + key_bias
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        x1 = torch.einsum("bhqk,bkhd->bqhd", probs, att_v[:, li]).reshape(nst, n, b.d_model)
        x1 = dense(x1, p["attn"]["o"])
        # cgMLP branch with the causal CSGU conv
        xm = layer_norm(x, p["norm_mlp"]["scale"], p["norm_mlp"]["bias"])
        r, g = torch.chunk(F.gelu(dense(xm, p["cgmlp"]["proj1"]), approximate="none"), 2, dim=-1)
        g = layer_norm(g, p["cgmlp"]["csgu"]["norm"]["scale"], p["cgmlp"]["csgu"]["norm"]["bias"])
        g_in = torch.cat([state["cnn"][:, li], g], dim=1)  # (N, lorder + n, half)
        cnn[:, li] = g_in[:, -(b.csgu_kernel - 1) :]
        conv = p["cgmlp"]["csgu"]["conv"]
        g = depthwise_conv1d_time(g_in, conv["w"], 0, 0)
        if "b" in conv:
            g = g + conv["b"]
        x2 = dense(r * g, p["cgmlp"]["proj2"])
        # merge with the per-chunk left-padded fusion conv
        c = torch.cat([x1, x2], dim=-1)
        fk = p["fusion"]["w"].shape[0]
        fused = depthwise_conv1d_time(c, p["fusion"]["w"], fk - 1, 0)
        if "b" in p["fusion"]:
            fused = fused + p["fusion"]["b"]
        x = x + dense(c + fused, p["merge_proj"])
        y = layer_norm(x, p["ffn"]["norm"]["scale"], p["ffn"]["norm"]["bias"])
        x = x + 0.5 * dense(F.silu(dense(y, p["ffn"]["w1"])), p["ffn"]["w2"])
        x = layer_norm(x, p["norm_final"]["scale"], p["norm_final"]["bias"])

    enc_out = layer_norm(x, params["after_norm"]["scale"], params["after_norm"]["bias"])
    ctc_ids = torch.argmax(dense(enc_out, params["ctc"]), dim=-1).to(torch.int32)

    # Append per-layer cross-K/V for the rescoring decoder.
    cross_k, cross_v = state["cross_k"].clone(), state["cross_v"].clone()
    for li, p in enumerate(params["decoder"]["blocks"]):
        _append_rows(cross_k, dense(enc_out, p["cross"]["k"]).reshape(nst, n, b.dec_heads, hd), li, valid)
        _append_rows(cross_v, dense(enc_out, p["cross"]["v"]).reshape(nst, n, b.dec_heads, hd), li, valid)

    new_state = {
        "att_k": att_k,
        "att_v": att_v,
        "cnn": cnn,
        "cross_k": cross_k,
        "cross_v": cross_v,
        "valid": torch.clamp(kv_len_total, max=max_f),
    }
    return new_state, ctc_ids, enc_out


def rescore_decode(params: dict, cfg: DolphinStreamConfig, state: dict, prompt: torch.Tensor,
                   decode_cfg: DecodeConfig, generator: torch.Generator | None = None):
    """Final AR rescoring pass of ONE stream (``state`` at N = 1) over its
    accumulated cross-K/V buffers -> (tokens (1, P + max_new + 1), counts
    (1,)), the prompt first. Prompt ids are fed to the decoder as they are
    (a -1 / -2 probe slot indexes the embedding from its end, as in JAX)."""
    b = cfg.base
    dev = state["valid"].device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    cross_bias = torch.where(torch.arange(cfg.max_frames, device=dev)[None, :] < state["valid"][:1, None],
                             zero, NEG_INF)[:, None, None, :]
    t_max = b.max_target_positions
    shape = (1, t_max, b.dec_heads, b.head_dim)
    layers = tuple({"cross_k": state["cross_k"][:1, li], "cross_v": state["cross_v"][:1, li],
                    "self_k": torch.zeros(shape, device=dev), "self_v": torch.zeros(shape, device=dev)}
                   for li in range(len(params["decoder"]["blocks"])))
    dstate = {"layers": layers}

    prompt = prompt.to(device=dev, dtype=torch.int64)
    p_len = prompt.shape[1]
    logits, dstate = _decoder_pass(params, b, dstate, prompt, 0, cross_bias)
    logits0 = suppress_tokens(logits[:, -1].to(torch.float32), decode_cfg.suppress_ids)
    buf = torch.zeros((1, p_len + decode_cfg.max_new_tokens + 1), dtype=torch.int64, device=dev)
    buf[:, :p_len] = prompt
    first = select_token(logits0, buf, p_len, decode_cfg, generator, history_start=p_len)

    def step(st, token, pos):
        lg, st = _decoder_pass(params, b, st, token, pos, cross_bias)
        return lg[:, -1], st

    return ar_decode(step, dstate, p_len, first, buf, decode_cfg, generator)


def collapse_stream_ctc(all_ids: list, blank_id: int = 0) -> list[int]:
    """Collapse concatenated per-chunk CTC argmax ids (host-side)."""
    out: list[int] = []
    prev = -1
    for ids in all_ids:
        for t in ids:
            t = int(t)
            if t != prev and t != blank_id:
                out.append(t)
            prev = t
    return out
