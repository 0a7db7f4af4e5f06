"""Nemotron cache-aware streaming: chunked FastConformer + continuous RNN-T.

Counterpart of ``asr_tpu/streaming/nemotron_stream.py``, written once over
a leading stream axis N (every state leaf is the JAX package's leaf with N
in front; ``cache_len`` and ``nsym`` are ``(N,)`` counters). Per fixed
audio window (``chunk = right_context + 1`` output frames):

- snip-edges mel over the window (1 leading sample seeds pre-emphasis),
  with a ``pre_encode_cache`` mel-frame carry;
- the causal pre-encode producing exactly ``chunk + drop_extra`` frames;
- per-layer **cache_last_channel** (post-norm attention input, left
  context) and **cache_last_time** (depthwise-conv tail) carries, with a
  per-row startup mask (-128, the reference's constant) from ``cache_len``;
- relative attention against the fixed ``left_context + chunk``-key window
  through a gathered rel-shift;
- RNN-T greedy continued across chunks with the carried predictor state:
  a fixed-shape carry on the device, a per-row ``done``, and the host
  reading ``all(done)`` once every ``decode/tdt.SYNC_EVERY`` steps.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from asr_tpu_torch.decode import tdt
from asr_tpu_torch.frontend import framing
from asr_tpu_torch.frontend.nemo_mel import _device_constants, _exact_f32
from asr_tpu_torch.layers.conformer import conv2d, relative_position_embedding
from asr_tpu_torch.layers.norms import layer_norm
from asr_tpu_torch.layers.sanm import depthwise_conv1d_time
from asr_tpu_torch.layers.transformer import dense
from asr_tpu_torch.models.nemotron import NemotronConfig, _causal_conv2d, joint_step


@dataclasses.dataclass(frozen=True)
class NemotronStreamConfig:
    base: NemotronConfig = NemotronConfig()

    @property
    def chunk(self) -> int:                  # encoder frames per step
        return self.base.right_context + 1

    @property
    def mel_chunk(self) -> int:              # new mel frames per step
        return self.chunk * 8

    @property
    def mel_cache(self) -> int:
        return self.base.pre_encode_cache

    @property
    def window_samples(self) -> int:         # audio samples per step
        m = self.base.mel
        return m.n_fft + (self.mel_chunk - 1) * m.hop_length + 1

    @property
    def kv_len(self) -> int:
        return self.base.left_context + self.chunk


def init_state(cfg: NemotronStreamConfig, n: int = 1, device="cpu", dtype: torch.dtype = torch.float32) -> dict:
    """N streams' fresh state; ``token`` starts at 0 as in the JAX package
    (the session sets it to blank)."""
    b = cfg.base

    def zeros(*shape, dt=dtype):
        return torch.zeros((n, *shape), dtype=dt, device=device)

    return {
        # Zero-filled like the reference driver: the first chunk then
        # matches the offline zero padding.
        "mel_cache": zeros(1, cfg.mel_cache, b.mel.n_mels),
        "cache_last_channel": zeros(b.num_layers, cfg.kv_len - cfg.chunk, b.d_model),
        "cache_last_time": zeros(b.num_layers, b.conv_kernel - 1, b.d_model),
        "cache_len": zeros(dt=torch.int64),
        # RNN-T continuation state.
        "token": zeros(1, dt=torch.int64),
        "h": zeros(b.lstm_layers, 1, b.pred_hidden),
        "c": zeros(b.lstm_layers, 1, b.pred_hidden),
        "nsym": zeros(dt=torch.int64),
    }


def _stream_mel(cfg: NemotronStreamConfig, audio: torch.Tensor) -> torch.Tensor:
    """Snip-edges mel: (N, window_samples) -> (N, mel_chunk, n_mels)."""
    m = cfg.base.mel
    basis, mel = _device_constants(m, audio.device)
    x = audio.to(torch.float32) * m.input_scale
    x = x[:, 1:] - m.preemphasis * x[:, :-1]
    frames = framing.frame_signal(x, m.n_fft, m.hop_length, cfg.mel_chunk)
    with _exact_f32():
        spec = frames @ basis
        re, im = torch.chunk(spec * spec, 2, dim=-1)
        melspec = (re + im) @ mel
    return torch.log(torch.clamp(melspec, min=m.log_guard))


@functools.lru_cache(maxsize=8)
def _stream_rel_index(chunk: int, kv_len: int) -> np.ndarray:
    """Gathered rel-shift index: query i / key j reads column (chunk - 1 -
    i) + j of the (2 kv_len - 1)-row table, i.e. relative distance
    left + i - j."""
    i = np.arange(chunk, dtype=np.int64)[:, None]
    j = np.arange(kv_len, dtype=np.int64)[None, :]
    return (chunk - 1 - i) + j


def _rel_pe(cfg: NemotronStreamConfig, device) -> torch.Tensor:
    return torch.from_numpy(relative_position_embedding(cfg.kv_len, cfg.base.d_model)).to(device)


def precompute_rel_k(params: dict, cfg: NemotronStreamConfig) -> torch.Tensor:
    """Per-layer projected relative-position keys ``(num_layers, 2 kv_len
    - 1, num_heads, head_dim)``: a params-only constant that sessions and
    runners compute once and pass to :func:`encoder_step` (``None`` keeps
    the projection in the step)."""
    b = cfg.base
    hd = b.d_model // b.num_heads
    pe = _rel_pe(cfg, params["prompt"]["w0_enc"].device)
    return torch.stack([dense(pe, bp["attn"]["rel_k"]).reshape(-1, b.num_heads, hd)
                        for bp in params["blocks"]])


def encoder_step(params: dict, cfg: NemotronStreamConfig, state: dict, audio: torch.Tensor,
                 prompt_id: torch.Tensor, rel_k_cache: torch.Tensor | None = None):
    """N audio windows (N, window_samples) -> (state', enc_proj (N, chunk,
    joint_hidden)); ``prompt_id`` (N,)."""
    return encoder_step_features(params, cfg, state, _stream_mel(cfg, audio), prompt_id, rel_k_cache)


def encoder_step_features(params: dict, cfg: NemotronStreamConfig, state: dict, mel_new: torch.Tensor,
                          prompt_id: torch.Tensor, rel_k_cache: torch.Tensor | None = None):
    """N mel chunks (N, mel_chunk, n_mels) -> (state', enc_proj)."""
    b = cfg.base
    nst = mel_new.shape[0]
    mel_full = torch.cat([state["mel_cache"][:, 0], mel_new], dim=1)
    mel_cache_next = mel_full[:, None, -cfg.mel_cache :]

    # Causal pre-encode; the streaming path pads 2 on top (the mel cache
    # supplies the left context the offline pad emulates).
    p = params["pre_encode"]
    ch = p["conv0"]["w"].shape[-1]
    x = torch.relu(_causal_conv2d(mel_full[..., None], p["conv0"]["w"], p["conv0"]["b"], 1, 2))
    x = _causal_conv2d(x, p["dw1"]["w"], p["dw1"]["b"], ch)
    x = torch.relu(conv2d(x, p["pw1"]["w"], p["pw1"]["b"]))
    x = _causal_conv2d(x, p["dw2"]["w"], p["dw2"]["b"], ch)
    x = torch.relu(conv2d(x, p["pw2"]["w"], p["pw2"]["b"]))
    t = x.shape[1]
    x = dense(x.transpose(2, 3).reshape(nst, t, -1), p["out"])
    x = x[:, -cfg.chunk :]  # exactly `chunk` frames (1-chunk step latency)

    kv_len, chunk = cfg.kv_len, cfg.chunk
    left = kv_len - chunk
    dev = x.device
    # Startup mask: keys j valid when j >= left - cache_len, per row.
    j = torch.arange(kv_len, device=dev)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    neg = torch.where(j >= left - state["cache_len"][:, None], zero, -128.0)[:, None, None, :]
    rel_idx = torch.from_numpy(_stream_rel_index(chunk, kv_len)).to(dev)
    pe = _rel_pe(cfg, dev) if rel_k_cache is None else None

    heads, hd = b.num_heads, b.d_model // b.num_heads
    channel_next, time_next = [], []
    for li, bp in enumerate(params["blocks"]):
        residual = x
        m = layer_norm(x, bp["norm_ff1"]["scale"], bp["norm_ff1"]["bias"])
        residual = residual + 0.5 * dense(F.silu(dense(m, bp["ff1"]["w1"])), bp["ff1"]["w2"])

        m = layer_norm(residual, bp["norm_att"]["scale"], bp["norm_att"]["bias"])
        m_full = torch.cat([state["cache_last_channel"][:, li], m], dim=1)  # (N, kv_len, D)
        channel_next.append(m_full[:, -left:])
        q = dense(m, bp["attn"]["q"]).reshape(nst, chunk, heads, hd).transpose(1, 2)
        k = dense(m_full, bp["attn"]["k"]).reshape(nst, kv_len, heads, hd).transpose(1, 2)
        v = dense(m_full, bp["attn"]["v"]).reshape(nst, kv_len, heads, hd).transpose(1, 2)
        rel_k = (rel_k_cache[li] if rel_k_cache is not None else
                 dense(pe, bp["attn"]["rel_k"]).reshape(-1, heads, hd))
        qu = q + bp["attn"]["bias_u"][None, :, None, :]
        qv = q + bp["attn"]["bias_v"][None, :, None, :]
        ac = torch.einsum("nhqd,nhkd->nhqk", qu, k)
        bd_full = torch.einsum("nhqd,phd->nhqp", qv, rel_k)  # (N, H, Q, 2 kv_len - 1)
        bd = torch.gather(bd_full, 3, rel_idx.expand(nst, heads, chunk, kv_len))
        scores = (ac + bd).to(torch.float32) * (hd ** -0.5) + neg
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.einsum("nhqk,nhkd->nqhd", probs, v).reshape(nst, chunk, b.d_model)
        residual = residual + dense(ctx, bp["attn"]["o"])

        m = layer_norm(residual, bp["norm_conv"]["scale"], bp["norm_conv"]["bias"])
        a, g = torch.chunk(dense(m, bp["conv"]["pw1"]), 2, dim=-1)
        dw_in = torch.cat([state["cache_last_time"][:, li], a * torch.sigmoid(g)], dim=1)  # (N, K-1+chunk, D)
        time_next.append(dw_in[:, -(b.conv_kernel - 1) :])
        y = depthwise_conv1d_time(dw_in, bp["conv"]["dw"]["w"], 0, 0)
        y = F.silu(layer_norm(y, bp["conv"]["ln"]["scale"], bp["conv"]["ln"]["bias"]))
        residual = residual + dense(y, bp["conv"]["pw2"])

        m = layer_norm(residual, bp["norm_ff2"]["scale"], bp["norm_ff2"]["bias"])
        residual = residual + 0.5 * dense(F.silu(dense(m, bp["ff2"]["w1"])), bp["ff2"]["w2"])
        x = layer_norm(residual, bp["norm_out"]["scale"], bp["norm_out"]["bias"])

    pr = params["prompt"]
    # The prompt's w0_enc is a bare matrix: a plain f32 product, as in JAX.
    h0 = torch.relu(torch.matmul(x, pr["w0_enc"]) + pr["bias_table"][prompt_id][:, None, :])
    enc_proj = dense(dense(h0, pr["w2"]), pr["joint_enc"])

    new_state = {
        **state,
        "mel_cache": mel_cache_next,
        "cache_last_channel": torch.stack(channel_next, dim=1),
        "cache_last_time": torch.stack(time_next, dim=1),
        "cache_len": torch.clamp(state["cache_len"] + chunk, max=left),
    }
    return new_state, enc_proj


def rnnt_stream_step(params: dict, cfg: NemotronStreamConfig, state: dict, enc_proj: torch.Tensor,
                     max_new: int = 32):
    """Continue RNN-T greedy over this chunk's frames with the carried
    predictor state -> (state', ids (N, max_new), counts (N,)).

    JAX's ``while_loop`` runs while ``frame < t``, ``steps < max_steps``
    and ``count < max_new``; here each row stops on the first and third
    rule (its ``done``; a step after it changes nothing for the row) and
    the loop on the second (``tdt.run_chunked`` clips the last chunk of
    steps to ``max_steps``)."""
    b = cfg.base
    nst, t = enc_proj.shape[0], enc_proj.shape[1]
    dev = enc_proj.device
    rows = torch.arange(nst, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    max_sym = b.max_symbols_per_frame
    count = torch.zeros(nst, dtype=torch.int64, device=dev)
    st = {
        "frame": torch.zeros(nst, dtype=torch.int64, device=dev),
        "nsym": state["nsym"],
        "token": state["token"][:, 0],
        "h": state["h"][:, :, 0].transpose(0, 1),  # (L, N, H)
        "c": state["c"][:, :, 0].transpose(0, 1),
        "buf": torch.zeros((nst, max_new + 1), dtype=torch.int32, device=dev),  # + the dump slot
        "count": count,
        "done": torch.full((nst,), t == 0 or max_new == 0, dtype=torch.bool, device=dev),
    }

    def step() -> torch.Tensor:
        frame, nsym, token, h, c, count, done = (
            st[k] for k in ("frame", "nsym", "token", "h", "c", "count", "done"))
        logits, h2, c2 = joint_step(params, token, h, c, enc_proj[rows, frame.clamp(0, t - 1)])
        tok = torch.argmax(logits, dim=-1)
        is_blank = tok == b.blank_id
        emit = ~is_blank & (nsym < max_sym) & ~done
        st["buf"][rows, torch.where(emit, count, max_new)] = tok.to(torch.int32)
        count = count + emit.to(torch.int64)
        st["token"] = torch.where(emit, tok, token)
        st["h"] = torch.where(emit[None, :, None], h2, h)
        st["c"] = torch.where(emit[None, :, None], c2, c)
        advance = (is_blank | (nsym >= max_sym)) & ~done
        frame = frame + advance.to(torch.int64)
        st["nsym"] = torch.where(advance, zero, nsym + emit.to(torch.int64))
        st["frame"], st["count"] = frame, count
        st["done"] = done | (frame >= t) | (count >= max_new)
        return st["done"]

    if not (t == 0 or max_new == 0):
        tdt.run_chunked(step, (max_sym + 1) * t, tdt.SYNC_EVERY)
    new_state = {**state, "token": st["token"][:, None], "h": st["h"].transpose(0, 1)[:, :, None],
                 "c": st["c"].transpose(0, 1)[:, :, None], "nsym": st["nsym"]}
    return new_state, st["buf"][:, :max_new], st["count"].to(torch.int32)
