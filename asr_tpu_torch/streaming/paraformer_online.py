"""Paraformer streaming: chunked SANM encoder + incremental CIF + decoder.

Counterpart of ``asr_tpu/streaming/paraformer_online.py``, written once
over a leading stream axis N: every state leaf is the JAX package's leaf
with N in front, every per-stream counter (``start_idx``, ``enc_valid``,
``dec_valid``) an ``(N,)`` integer tensor, and every mask built from those
counters is per row. A single-stream session calls the steps with N = 1,
the multi-stream runner with N = its slot count, so each linear runs on
all streams' rows in one call (the int8 kernel in the q8 form).

Per fixed 8,000-sample (0.5 s) chunk: Kaldi fbank + chunk-local LFR
(indices clamped both ends), CMVN, the absolute position encoding at the
running ``start_idx`` (clamped into the table the way JAX's
``dynamic_slice`` clamps it, so a stream past ``max_positions`` repeats
the table's last rows), the half-chunk feature overlap, per-layer rolling
attention K/V caches with validity masks, the incremental CIF recurrence
as a loop over ``(N, D)`` tensors, and the decoder (FFN -> causal FSMN
with a carried history -> cross-attention over [cached | current]
encoder frames). No step reads a value back to the host.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from asr_tpu_torch.frontend.kaldi_fbank import log_mel_fbank
from asr_tpu_torch.frontend.lfr import apply_cmvn_addmul
from asr_tpu_torch.layers.attention import NEG_INF
from asr_tpu_torch.layers.norms import layer_norm
from asr_tpu_torch.layers.sanm import depthwise_conv1d_time
from asr_tpu_torch.layers.transformer import dense
from asr_tpu_torch.models.paraformer import ParaformerConfig, _ffn_sanm_decoder
from asr_tpu_torch.models.sensevoice import sinusoid_position_encoding


@dataclasses.dataclass(frozen=True)
class ParaformerStreamConfig:
    base: ParaformerConfig = ParaformerConfig()
    chunk_samples: int = 8000
    look_back_encoder: int = 4
    look_back_decoder: int = 1
    look_back_a: int = 0
    max_positions: int = 502          # absolute PE table length (~30 s)
    tail_threshold: float = 0.45      # used by the session at stream end

    @property
    def stft_len(self) -> int:
        fb = self.base.fbank
        return (self.chunk_samples - fb.win_length) // fb.hop_length + 1  # 48

    @property
    def t_lfr(self) -> int:
        m_factor = (self.base.lfr_m - 1) // 2
        return (m_factor + self.stft_len) // self.base.lfr_n + 1  # 9 = look_back_B

    @property
    def look_back_b(self) -> int:
        return self.t_lfr

    @property
    def look_back_c(self) -> int:
        return self.look_back_b // 2  # 4

    @property
    def carry_feats(self) -> int:
        return self.look_back_a + self.look_back_c  # 4

    @property
    def chunk_positions(self) -> int:
        return self.carry_feats + self.t_lfr  # 13

    @property
    def enc_cache_len(self) -> int:
        # Keep slice [-(4B+C):-C] of the concatenated keys -> 4B positions (36).
        return self.look_back_encoder * self.look_back_b

    @property
    def dec_cache_len(self) -> int:
        return self.look_back_decoder * self.look_back_b  # 9

    @property
    def max_fires(self) -> int:
        return self.look_back_b + 1  # initial boundary step + B alpha steps


def init_state(cfg: ParaformerStreamConfig, params: dict, n: int = 1, device=None,
               dtype: torch.dtype = torch.float32) -> dict:
    """N streams' fresh state on ``device`` (default: the params')."""
    b = cfg.base
    if device is None:
        device = params["output"]["b"].device
    n_layers = b.num_encoders0 + b.num_encoders
    h, hd, d = b.num_heads, b.head_dim, b.hidden

    def zeros(*shape, dt=dtype):
        return torch.zeros((n, *shape), dtype=dt, device=device)

    return {
        "enc_k": zeros(n_layers, cfg.enc_cache_len, h, hd),
        "enc_v": zeros(n_layers, cfg.enc_cache_len, h, hd),
        "enc_valid": zeros(dt=torch.int64),
        "prev_feats": zeros(1, cfg.carry_feats, b.feature_size),
        "cif_hidden": zeros(1, 1, d),   # running weighted average
        "cif_alpha": zeros(1),
        "start_idx": zeros(dt=torch.int64),
        "dec_fsmn": zeros(b.num_decoders, b.fsmn_kernel - 1, d),
        "dec_k": zeros(b.num_decoders, cfg.dec_cache_len, h, hd),
        "dec_v": zeros(b.num_decoders, cfg.dec_cache_len, h, hd),
        "dec_valid": zeros(dt=torch.int64),
    }


@functools.lru_cache(maxsize=8)
def _lfr_index(cfg: ParaformerStreamConfig) -> np.ndarray:
    b = cfg.base
    base_idx = np.arange(0, cfg.t_lfr * b.lfr_n, b.lfr_n, dtype=np.int64)[:, None]
    offs = np.arange(b.lfr_m, dtype=np.int64)[None, :] - (b.lfr_m - 1) // 2
    return np.clip(base_idx + offs, 0, cfg.stft_len - 1).reshape(-1)


def _chunk_lfr(cfg: ParaformerStreamConfig, mel: torch.Tensor) -> torch.Tensor:
    """Chunk-local LFR with both-end clamping: (N, stft_len, n_mels) ->
    (N, t_lfr, feature_size)."""
    idx = torch.from_numpy(_lfr_index(cfg)).to(mel.device)
    return mel[:, idx].reshape(mel.shape[0], cfg.t_lfr, cfg.base.feature_size)


@functools.lru_cache(maxsize=8)
def _position_table(max_positions: int, feature_size: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(sinusoid_position_encoding(max_positions, feature_size)).to(device)


def _cif_chunk_scan(alphas: torch.Tensor, hidden: torch.Tensor, cif_avg: torch.Tensor,
                    cif_alpha: torch.Tensor):
    """Incremental CIF over one chunk for N streams, the reference
    recurrence step by step.

    Args:
      alphas: (N, B_steps) chunk alphas (the first look_back_b positions).
      hidden: (N, B_steps, D) matching encoder states.
      cif_avg: (N, 1, 1, D) carried weighted average; cif_alpha: (N, 1).

    Returns (frames (N, 1 + B_steps, D), fire flags (N, 1 + B_steps), new
    avg (N, 1, 1, D), new alpha (N, 1))."""
    a0 = cif_alpha[:, 0]
    # Initial boundary step: fire immediately if the carried alpha >= 1.
    fire0 = a0 >= 1.0
    avg0 = cif_avg[:, 0, 0]
    frames0 = torch.where(fire0[:, None], avg0, a0[:, None] * avg0)
    a = torch.where(fire0, a0 - 1.0, a0)
    f = torch.where(fire0[:, None], a[:, None] * avg0, frames0)
    frames, fires = [frames0], [fire0]
    for i in range(alphas.shape[1]):
        alpha, h = alphas[:, i], hidden[:, i]
        threshold = 1.0 - a
        fire = alpha >= threshold
        frame_out = torch.where(fire[:, None], f + threshold[:, None] * h, f + alpha[:, None] * h)
        a = a + alpha
        a = torch.where(fire, a - 1.0, a)
        f = torch.where(fire[:, None], a[:, None] * h, frame_out)
        frames.append(frame_out)
        fires.append(fire)
    new_avg = (f / torch.clamp(a, min=1e-9)[:, None])[:, None, None]
    return torch.stack(frames, 1), torch.stack(fires, 1), new_avg, a[:, None]


def _key_bias(valid: torch.Tensor, cache_len: int, current: int) -> torch.Tensor:
    """(N, 1, 1, cache_len + current) additive bias: the first ``cache_len
    - valid`` cache slots of each row masked with NEG_INF."""
    kpos = torch.arange(cache_len + current, device=valid.device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=valid.device)
    return torch.where(kpos >= cache_len - valid[:, None], zero, NEG_INF)[:, None, None, :]


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor, scale: float):
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    probs = torch.softmax(scores + bias, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def encoder_step(params: dict, cfg: ParaformerStreamConfig, state: dict, audio_chunk: torch.Tensor):
    """N chunks (N, chunk_samples) -> (state', fired frames (N, max_fires,
    D), fire counts (N,), encoder_out (N, P, D))."""
    b = cfg.base
    nst = audio_chunk.shape[0]
    mel = log_mel_fbank(audio_chunk, b.fbank, cfg.stft_len)
    feats = apply_cmvn_addmul(_chunk_lfr(cfg, mel), params["cmvn_means"], params["cmvn_istd"])
    # jax.lax.dynamic_slice clamps the start into [0, max_positions - t_lfr].
    pe = _position_table(cfg.max_positions, b.feature_size, feats.device)
    start = torch.clamp(state["start_idx"], 0, cfg.max_positions - cfg.t_lfr)
    feats = feats + pe[start[:, None] + torch.arange(cfg.t_lfr, device=feats.device)]
    x = torch.cat([state["prev_feats"][:, 0], feats], dim=1)  # (N, P, F)
    new_prev = x[:, None, -cfg.carry_feats :]

    p_cur, cache_len = cfg.chunk_positions, cfg.enc_cache_len
    heads, hd = b.num_heads, b.head_dim
    enc_valid = state["enc_valid"]
    key_bias = _key_bias(enc_valid, cache_len, p_cur)
    keep = cache_len + p_cur - (cache_len + cfg.look_back_c)  # new cache: slice [-(4B+C) : -C]
    pad = (b.fsmn_kernel - 1) // 2
    new_k, new_v = [], []
    for li, p in enumerate(params["encoders0"] + params["encoders"]):
        y = layer_norm(x, p["norm1"]["scale"], p["norm1"]["bias"])
        q, k, v = torch.chunk(dense(y, p["qkv"]), 3, dim=-1)
        k_full = torch.cat([state["enc_k"][:, li], k.reshape(nst, p_cur, heads, hd)], dim=1)
        v_full = torch.cat([state["enc_v"][:, li], v.reshape(nst, p_cur, heads, hd)], dim=1)
        new_k.append(k_full[:, keep : keep + cache_len])
        new_v.append(v_full[:, keep : keep + cache_len])
        ctx = _attend(q.reshape(nst, p_cur, heads, hd), k_full, v_full, key_bias, hd ** -0.5)
        mem = depthwise_conv1d_time(v, p["fsmn_w"], pad, pad) + v
        branch = dense(ctx.reshape(nst, p_cur, b.hidden), p["out"]) + mem
        x = branch + x if li > 0 else branch
        y2 = layer_norm(x, p["norm2"]["scale"], p["norm2"]["bias"])
        h = torch.relu(dense(y2, {"w": p["ffn"]["w1"], "b": p["ffn"]["b1"]}))
        x = x + dense(h, {"w": p["ffn"]["w2"], "b": p["ffn"]["b2"]})
    encoder_out = layer_norm(x, params["after_norm"]["scale"], params["after_norm"]["bias"])

    # CIF alphas over the chunk (the predictor's Conv1d has HIO weights).
    pp = params["predictor"]
    padc = (b.predictor_kernel - 1) // 2
    conv = F.conv1d(encoder_out.transpose(1, 2), pp["conv"]["w"].permute(2, 1, 0),
                    padding=padc).transpose(1, 2) + pp["conv"]["b"]
    alphas = torch.sigmoid(dense(torch.relu(conv), pp["out"]))[..., 0]

    a_lo = cfg.look_back_a
    frames, fires, new_avg, new_alpha = _cif_chunk_scan(
        alphas[:, a_lo : a_lo + cfg.look_back_b], encoder_out[:, a_lo : a_lo + cfg.look_back_b],
        state["cif_hidden"], state["cif_alpha"])
    # Compact each row's fired frames into (max_fires, D); the rest go to a dump slot.
    mf = cfg.max_fires
    dest = torch.where(fires, torch.cumsum(fires.to(torch.int64), dim=1) - 1, mf)
    buf = torch.zeros((nst, mf + 1, frames.shape[-1]), dtype=frames.dtype, device=frames.device)
    buf[torch.arange(nst, device=frames.device)[:, None], dest] = frames
    count = fires.sum(dim=1)

    new_state = {
        **state,
        "enc_k": torch.stack(new_k, dim=1),
        "enc_v": torch.stack(new_v, dim=1),
        "enc_valid": torch.clamp(enc_valid + cfg.look_back_b, max=cache_len),
        "prev_feats": new_prev,
        "cif_hidden": new_avg,
        "cif_alpha": new_alpha,
        "start_idx": state["start_idx"] + cfg.t_lfr,
    }
    return new_state, buf[:, :mf], count, encoder_out


def decoder_step(params: dict, cfg: ParaformerStreamConfig, state: dict, encoder_out: torch.Tensor,
                 fired: torch.Tensor, count: torch.Tensor, return_logits: bool = False):
    """Decode fired CIF frames -> (state', token ids (N, max_fires), count).

    A single stream runs it only when ``count > 0`` (the reference skips
    the decoder otherwise, keeping its caches untouched); the multi-stream
    runner runs it on every row and keeps a non-firing row's state.
    ``return_logits=True`` returns (state', logits (N, max_fires, V),
    count) instead."""
    b = cfg.base
    nst, n = fired.shape[0], fired.shape[1]
    dev = fired.device
    tok_mask = torch.arange(n, device=dev)[None, :] < count[:, None]
    zero = torch.zeros((), dtype=fired.dtype, device=dev)
    x = torch.where(tok_mask[..., None], fired, zero)
    p_enc, cache_len = encoder_out.shape[1], cfg.dec_cache_len
    heads, hd = b.num_heads, b.head_dim
    key_bias = _key_bias(state["dec_valid"], cache_len, p_enc)
    hist = b.fsmn_kernel - 1
    # New FSMN history: rows [count, count + hist) of [history | frames] (dynamic_slice clamps).
    hist_idx = torch.clamp(count, 0, n)[:, None] + torch.arange(hist, device=dev)

    new_fsmn, new_k, new_v = [], [], []
    for li, p in enumerate(params["decoders"]):
        residual = x
        y = _ffn_sanm_decoder(layer_norm(x, p["norm1"]["scale"], p["norm1"]["bias"]), p["ffn"])
        sa_in = torch.where(tok_mask[..., None], layer_norm(y, p["norm2"]["scale"], p["norm2"]["bias"]), zero)
        seq = torch.cat([state["dec_fsmn"][:, li], sa_in], dim=1)  # (N, hist + n, D)
        new_fsmn.append(torch.gather(seq, 1, hist_idx[..., None].expand(nst, hist, seq.shape[-1])))
        mem = depthwise_conv1d_time(seq, p["fsmn_w"], 0, 0)  # causal: the kernel eats the history
        x = mem + sa_in + residual
        c_in = layer_norm(x, p["norm3"]["scale"], p["norm3"]["bias"])
        q = dense(c_in, p["cross"]["q"]).reshape(nst, n, heads, hd)
        k, v = torch.chunk(dense(encoder_out, p["cross"]["kv"]), 2, dim=-1)
        k_full = torch.cat([state["dec_k"][:, li], k.reshape(nst, p_enc, heads, hd)], dim=1)
        v_full = torch.cat([state["dec_v"][:, li], v.reshape(nst, p_enc, heads, hd)], dim=1)
        new_k.append(k_full[:, -cache_len:])
        new_v.append(v_full[:, -cache_len:])
        ctx = _attend(q, k_full, v_full, key_bias, hd ** -0.5)
        x = x + dense(ctx.reshape(nst, n, b.hidden), p["cross"]["out"])

    for p in params["decoder_ffn"]:
        x = _ffn_sanm_decoder(layer_norm(x, p["norm1"]["scale"], p["norm1"]["bias"]), p["ffn"])
    x = layer_norm(x, params["decoder_after_norm"]["scale"], params["decoder_after_norm"]["bias"])
    logits = dense(x, params["output"])
    ids = torch.where(tok_mask, torch.argmax(logits, dim=-1), 0).to(torch.int32)

    new_state = {
        **state,
        "dec_fsmn": torch.stack(new_fsmn, dim=1),
        "dec_k": torch.stack(new_k, dim=1),
        "dec_v": torch.stack(new_v, dim=1),
        "dec_valid": torch.clamp(state["dec_valid"] + p_enc, max=cache_len),
    }
    return new_state, (logits if return_logits else ids), count
