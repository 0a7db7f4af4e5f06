"""Zipformer2 streaming transducer (X-ASR, icefall).

Counterpart of ``asr_tpu/models/zipformer.py``, written once over a
leading stream axis N: every state leaf is the JAX package's leaf with N
in front and ``processed_lens`` is an ``(N,)`` counter, so the padding mask
over [left context | chunk] is per row. The model: a 6-stage U-Net encoder
(downsampling 1/2/4/8/4/2, 19 layers), per layer shared rel-pos attention
weights feeding a nonlin-attention and two self-attentions, three SwooshL
feed-forwards, two chunk-causal depthwise conv modules (SwooshR),
per-channel bypasses and a BiasNorm + bypass output; the Conv2dSubsampling
front (SwooshR convs and a ConvNeXt block with a cached left time pad);
the stateless context-2 decoder and joiner with greedy search; Kaldi
povey-window fbank (the session applies the snip_edges=False reflection
pad).

Streaming state: six caches a layer (attention key, nonlin-attention, two
values, two convs), the ConvNeXt left pad, ``processed_lens`` and the
decoder context. The geometry-baked tables (the projected relative
position tables ``pos_table`` and the fused causal + chunkwise depthwise
conv maps ``fused_w`` / ``fused_b``) are parameters, as in the JAX
package. In the q8 form every ``dense`` linear runs on the int8 kernel;
the joiner's output product is a plain f32 matmul, as in JAX (a quantized
joiner leaf is dequantized for it).
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from asr_tpu_torch.frontend.kaldi_fbank import KaldiFbankConfig, log_mel_fbank
from asr_tpu_torch.layers.conformer import conv2d
from asr_tpu_torch.layers.transformer import dense
from asr_tpu_torch.quant.quantize import QuantizedLinear, dequantize_weight


def swoosh_l(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(x - 4.0) - 0.08 * x - 0.035


def swoosh_r(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(x - 1.0) - 0.08 * x - 0.313261687


def bias_norm(x: torch.Tensor, bias: torch.Tensor, log_scale: torch.Tensor) -> torch.Tensor:
    """icefall BiasNorm: x * exp(log_scale) * sqrt(D) / ||x - bias||_2."""
    d = x.shape[-1]
    norm = torch.sqrt(torch.sum(torch.square(x - bias), dim=-1, keepdim=True))
    return x * (torch.exp(log_scale) * (d ** 0.5) / torch.clamp(norm, min=1e-9))


@dataclasses.dataclass(frozen=True)
class ZipformerConfig:
    vocab_size: int = 5000
    feature_dim: int = 80
    downsampling_factor: tuple = (1, 2, 4, 8, 4, 2)
    num_encoder_layers: tuple = (2, 2, 4, 5, 4, 2)
    encoder_dim: tuple = (192, 256, 512, 768, 512, 256)
    query_head_dim: tuple = (32,) * 6
    pos_head_dim: tuple = (4,) * 6
    value_head_dim: tuple = (12,) * 6
    num_heads: tuple = (4, 4, 4, 8, 4, 4)
    feedforward_dim: tuple = (512, 768, 1536, 2048, 1536, 768)
    cnn_module_kernel: tuple = (31, 31, 15, 15, 15, 31)
    nonlin_hidden: tuple = (576, 768, 1536, 2304, 1536, 768)  # 3 * dim // 4 * 4? loader-set
    output_downsampling_factor: int = 2
    chunk_size: int = 8                  # encoder frames (50 Hz) per chunk
    left_context_frames: int = 96
    # Subsampling / ConvNeXt geometry.
    sub_layer1: int = 8
    sub_layer2: int = 32
    sub_layer3: int = 128
    convnext_pad_time: int = 3
    convnext_pad_freq: int = 3
    # Transducer.
    decoder_dim: int = 512
    joiner_dim: int = 512
    context_size: int = 2
    decoder_conv_groups: int = 128   # icefall Decoder: groups = decoder_dim // 4
    blank_id: int = 0
    max_symbols_per_frame: int = 1
    fbank: KaldiFbankConfig = KaldiFbankConfig(window="povey")

    @property
    def mel_per_chunk(self) -> int:
        # Conv2dSubsampling consumes T = 2*chunk + 13 mel frames per window.
        return self.chunk_size * 2 + 13

    @property
    def window_samples(self) -> int:
        fb = self.fbank
        return (self.mel_per_chunk - 1) * fb.hop_length + fb.win_length

    @property
    def advance_samples(self) -> int:
        return self.chunk_size * 2 * self.fbank.hop_length

    @property
    def num_stacks(self) -> int:
        return len(self.downsampling_factor)

    def stack_geom(self, s: int) -> dict:
        ds = self.downsampling_factor[s]
        seq = self.chunk_size // ds
        left = self.left_context_frames // ds
        return {
            "ds": ds, "seq": seq, "left": left, "k_len": seq + left,
            "seq_len2": 2 * seq - 1 + left,
            "heads": self.num_heads[s], "qhd": self.query_head_dim[s],
            "phd": self.pos_head_dim[s], "vhd": self.value_head_dim[s],
            "dim": self.encoder_dim[s], "ffn": self.feedforward_dim[s],
            "kernel": self.cnn_module_kernel[s],
            "hidden": 3 * self.encoder_dim[s] // 4,
        }

    @property
    def output_dim(self) -> int:
        return max(self.encoder_dim)

    @property
    def embed_width(self) -> int:
        """Mel bins left after the subsampling's convs (19 for 80 mels)."""
        return (((self.feature_dim + 2 - 2) - 3) // 2 + 1 - 3) // 2 + 1


def init_params(cfg: ZipformerConfig, generator: torch.Generator, device=None,
                dtype: torch.dtype = torch.float32) -> dict:
    """Random-init parameters with the JAX package's layout and scales,
    drawn from ``generator`` on its own device and placed on ``device``."""
    device = torch.device(device) if device is not None else generator.device

    def normal(*shape, std):
        t = torch.randn(shape, generator=generator, device=generator.device) * std
        return t.to(device=device, dtype=dtype)

    def full(shape, value):
        return torch.full(shape, value, device=device, dtype=dtype)

    def lin(i, o, bias=True):
        p = {"w": normal(i, o, std=i ** -0.5)}
        if bias:
            p["b"] = full((o,), 0.0)
        return p

    def conv_params(g):
        d, seq, left_pad = g["dim"], g["seq"], g["kernel"] // 2
        return {"in": lin(d, 2 * d),
                "fused_w": normal(d, seq, left_pad + seq, std=g["kernel"] ** -0.5),
                "fused_b": full((d, seq), 0.0),
                "out": lin(d, d)}

    def layer(g):
        d, h, qhd, phd, vhd, f = g["dim"], g["heads"], g["qhd"], g["phd"], g["vhd"], g["ffn"]
        return {
            "attn_in_proj": lin(d, 2 * h * qhd + h * phd),
            "pos_table": normal(h, phd, g["seq_len2"], std=0.5),
            "ff1": {"in": lin(d, f * 3 // 4), "out": lin(f * 3 // 4, d)},
            "ff2": {"in": lin(d, f), "out": lin(f, d)},
            "ff3": {"in": lin(d, f * 5 // 4), "out": lin(f * 5 // 4, d)},
            "nonlin": {"in": lin(d, 3 * g["hidden"]), "out": lin(g["hidden"], d)},
            "sa1": {"in": lin(d, h * vhd), "out": lin(h * vhd, d)},
            "sa2": {"in": lin(d, h * vhd), "out": lin(h * vhd, d)},
            "conv1": conv_params(g),
            "conv2": conv_params(g),
            "bypass_mid": full((d,), 0.5),
            "bypass": full((d,), 0.5),
            "norm_bias": full((d,), 0.0),
            "norm_log_scale": full((), 0.0),
        }

    stacks = []
    for s in range(cfg.num_stacks):
        g = cfg.stack_geom(s)
        stack = {"layers": [layer(g) for _ in range(cfg.num_encoder_layers[s])]}
        if g["ds"] != 1:
            stack["downsample_w"] = full((g["ds"],), 1.0 / g["ds"])
            stack["out_combiner"] = full((g["dim"],), 0.5)
        stacks.append(stack)

    l1, l2, l3 = cfg.sub_layer1, cfg.sub_layer2, cfg.sub_layer3
    return {
        "embed": {
            "conv0": {"w": normal(3, 3, 1, l1, std=0.3), "b": full((l1,), 0.0)},
            "conv1": {"w": normal(3, 3, l1, l2, std=0.1), "b": full((l2,), 0.0)},
            "conv2": {"w": normal(3, 3, l2, l3, std=0.05), "b": full((l3,), 0.0)},
            "convnext": {
                "dw": {"w": normal(7, 7, 1, l3, std=0.05), "b": full((l3,), 0.0)},
                "pw1": lin(l3, 3 * l3),
                "pw2": {"w": normal(1, 1, 3 * l3, l3, std=0.05), "b": full((l3,), 0.0)},
            },
            "out": lin(l3 * cfg.embed_width, cfg.encoder_dim[0]),
            "out_norm_bias": full((cfg.encoder_dim[0],), 0.0),
            "out_norm_log_scale": full((), 0.0),
        },
        "stacks": stacks,
        "output_ds_w": full((cfg.output_downsampling_factor,), 1.0 / cfg.output_downsampling_factor),
        "encoder_proj": lin(cfg.output_dim, cfg.joiner_dim),
        "decoder": {
            "embed": normal(cfg.vocab_size, cfg.decoder_dim, std=0.02),
            # grouped context conv (torch layout: (out, in_per_group, ctx))
            "conv_w": normal(cfg.decoder_dim, cfg.decoder_dim // cfg.decoder_conv_groups, cfg.context_size,
                             std=0.1),
            "proj": lin(cfg.decoder_dim, cfg.joiner_dim),
        },
        "joiner": {"out": lin(cfg.joiner_dim, cfg.vocab_size)},
    }


def init_state(cfg: ZipformerConfig, n: int = 1, device="cpu", dtype: torch.dtype = torch.float32) -> dict:
    """N streams' fresh state (the decoder context starts at -1: no token)."""
    def zeros(*shape):
        return torch.zeros((n, *shape), dtype=dtype, device=device)

    stacks = []
    for s in range(cfg.num_stacks):
        g = cfg.stack_geom(s)
        stacks.append([{
            "key": zeros(g["left"], g["heads"] * g["qhd"]),
            "nonlin": zeros(g["left"], g["hidden"]),
            "val1": zeros(g["left"], g["heads"] * g["vhd"]),
            "val2": zeros(g["left"], g["heads"] * g["vhd"]),
            "conv1": zeros(g["kernel"] // 2, g["dim"]),
            "conv2": zeros(g["kernel"] // 2, g["dim"]),
        } for _ in range(cfg.num_encoder_layers[s])])
    return {
        "stacks": stacks,
        "embed_pad": zeros(cfg.convnext_pad_time, cfg.embed_width, cfg.sub_layer3),
        "processed_lens": torch.zeros((n,), dtype=torch.int64, device=device),
        # Transducer continuation (the context-2 stateless decoder).
        "context": torch.full((n, cfg.context_size), -1, dtype=torch.int64, device=device),
    }


def _subsample(params: dict, cfg: ZipformerConfig, mel: torch.Tensor, embed_pad: torch.Tensor):
    """(N, T_mel, 80) mel -> ((N, chunk, dim0), new ConvNeXt left pad)."""
    e = params["embed"]
    x = conv2d(mel[..., None], e["conv0"]["w"], e["conv0"]["b"], (1, 1), ((0, 0), (1, 1)))
    x = swoosh_r(x)
    x = swoosh_r(conv2d(x, e["conv1"]["w"], e["conv1"]["b"], (2, 2)))
    x = swoosh_r(conv2d(x, e["conv2"]["w"], e["conv2"]["b"], (1, 2)))  # (N, T', 19, 128)
    t_keep = cfg.chunk_size
    bypass = x[:, :t_keep]
    x = torch.cat([embed_pad, x], dim=1)  # prepend the cached time pad
    new_pad = x[:, t_keep : t_keep + cfg.convnext_pad_time]
    cx = e["convnext"]
    y = conv2d(x, cx["dw"]["w"], cx["dw"]["b"], (1, 1), (0, cfg.convnext_pad_freq), groups=cfg.sub_layer3)
    y = swoosh_l(dense(y, cx["pw1"]))
    y = conv2d(y, cx["pw2"]["w"], cx["pw2"]["b"])
    x = bypass + y[:, :t_keep]
    n, t = x.shape[0], x.shape[1]
    x = dense(x.transpose(2, 3).reshape(n, t, -1), e["out"])  # channel-major flatten (torch parity)
    return bias_norm(x, e["out_norm_bias"], e["out_norm_log_scale"]), new_pad


@functools.lru_cache(maxsize=32)
def _shift_index(seq: int, k_len: int, device: torch.device) -> torch.Tensor:
    """rel -> abs shift: row t reads columns [seq - 1 - t, seq - 1 - t + k_len)."""
    t = torch.arange(seq, device=device)[:, None]
    return (seq - 1 - t) + torch.arange(k_len, device=device)[None, :]


def _attn_weights(p: dict, g: dict, src: torch.Tensor, cached_key: torch.Tensor, kpm: torch.Tensor):
    """Shared attention weights: (N, heads, seq, k_len) probs + the new key cache."""
    h, qhd, phd = g["heads"], g["qhd"], g["phd"]
    seq, left, k_len = g["seq"], g["left"], g["k_len"]
    n, qdim = src.shape[0], h * qhd
    q, k, pos_q = torch.split(dense(src, p["attn_in_proj"]), [qdim, qdim, h * phd], dim=-1)
    k_full = torch.cat([cached_key, k], dim=1)  # (N, k_len, qdim)
    new_key = k_full[:, -left:]
    qh = q.reshape(n, seq, h, qhd).transpose(1, 2)
    kh = k_full.reshape(n, k_len, h, qhd).permute(0, 2, 3, 1)
    ph = pos_q.reshape(n, seq, h, phd).transpose(1, 2)
    scores = torch.einsum("nhsd,nhdk->nhsk", qh, kh)
    pos_full = torch.einsum("nhsd,hdp->nhsp", ph, p["pos_table"])  # (N, h, seq, seq_len2)
    idx = _shift_index(seq, k_len, src.device).expand(n, h, seq, k_len)
    scores = scores + torch.gather(pos_full, 3, idx)
    scores = torch.where(kpm[:, None, None, :], torch.full((), -1000.0, device=src.device), scores)
    return torch.softmax(scores, dim=-1), new_key


def _self_attn(p: dict, g: dict, src, weights, cached_val):
    h, vhd, seq, left, k_len = g["heads"], g["vhd"], g["seq"], g["left"], g["k_len"]
    n = src.shape[0]
    v_full = torch.cat([cached_val, dense(src, p["in"])], dim=1)
    new_val = v_full[:, -left:]
    vh = v_full.reshape(n, k_len, h, vhd).transpose(1, 2)
    x = torch.einsum("nhsk,nhkd->nshd", weights, vh).reshape(n, seq, h * vhd)
    return dense(x, p["out"]), new_val


def _nonlin_attn(p: dict, g: dict, src, weights0, cached_x):
    s, x, y = torch.chunk(dense(src, p["in"]), 3, dim=-1)
    x_full = torch.cat([cached_x, x * torch.tanh(s)], dim=1)  # (N, left + seq, hidden)
    new_cached = x_full[:, -g["left"]:]
    x = torch.einsum("nsk,nkd->nsd", weights0, x_full)
    return dense(x * y, p["out"]), new_cached


def _conv_module(p: dict, g: dict, src, cache):
    left_pad = g["kernel"] // 2
    x, s = torch.chunk(dense(src, p["in"]), 2, dim=-1)
    x_full = torch.cat([cache, x * torch.sigmoid(s)], dim=1)  # (N, left_pad + seq, d)
    new_cache = x_full[:, -left_pad:]
    # Fused per-timestep linear map: out[t, c] = sum_k fused_w[c, t, k] * x_full[k, c]
    y = torch.einsum("ctk,nkc->ntc", p["fused_w"], x_full) + p["fused_b"].T
    return dense(swoosh_r(y), p["out"]), new_cache


def _ff(p: dict, x):
    return dense(swoosh_l(dense(x, p["in"])), p["out"])


def _layer(p: dict, g: dict, src, lstate, kpm):
    src_orig = src
    weights, new_key = _attn_weights(p, g, src, lstate["key"], kpm)
    src = src + _ff(p["ff1"], src)
    na, new_nonlin = _nonlin_attn(p["nonlin"], g, src, weights[:, 0], lstate["nonlin"])
    src = src + na
    sa, new_val1 = _self_attn(p["sa1"], g, src, weights, lstate["val1"])
    src = src + sa
    sc, new_conv1 = _conv_module(p["conv1"], g, src, lstate["conv1"])
    src = src + sc
    src = src + _ff(p["ff2"], src)
    src = src_orig + (src - src_orig) * p["bypass_mid"]
    sa, new_val2 = _self_attn(p["sa2"], g, src, weights, lstate["val2"])
    src = src + sa
    sc, new_conv2 = _conv_module(p["conv2"], g, src, lstate["conv2"])
    src = src + sc
    src = src + _ff(p["ff3"], src)
    # BiasNorm + output bypass (the reference folds both into one expression).
    normed = bias_norm(src, p["norm_bias"], p["norm_log_scale"])
    src = src_orig + (normed - src_orig) * p["bypass"]
    new_state = {"key": new_key, "nonlin": new_nonlin, "val1": new_val1,
                 "val2": new_val2, "conv1": new_conv1, "conv2": new_conv2}
    return src, new_state


def _stack(params_s: dict, cfg: ZipformerConfig, s: int, x, states, kpm):
    g = cfg.stack_geom(s)
    ds = g["ds"]
    if ds != 1:
        kpm_s = kpm[:, ::ds]
        src_orig = x
        xd = x.reshape(x.shape[0], g["seq"], ds, -1)
        x = torch.sum(xd * torch.softmax(params_s["downsample_w"], dim=0)[None, None, :, None], dim=2)
    else:
        kpm_s = kpm
    new_states = []
    for p, lst in zip(params_s["layers"], states):
        x, ns = _layer(p, g, x, lst, kpm_s)
        new_states.append(ns)
    if ds != 1:
        x = torch.repeat_interleave(x, ds, dim=1)
        x = src_orig + (x - src_orig) * params_s["out_combiner"]
    return x, new_states


def _convert_channels(x, target):
    cur = x.shape[-1]
    if target == cur:
        return x
    if target < cur:
        return x[..., :target]
    return F.pad(x, (0, target - cur))


def encoder_step(params: dict, cfg: ZipformerConfig, state: dict, window: torch.Tensor):
    """N audio windows (N, window_samples), int16 range -> (state', enc
    (N, chunk // output_ds, joiner_dim))."""
    mel = log_mel_fbank(window, cfg.fbank, cfg.mel_per_chunk)
    x, new_pad = _subsample(params, cfg, mel, state["embed_pad"])

    # Padding mask over [left_context | chunk]: left slots not yet seen (True = masked).
    dev = x.device
    thresh = torch.cat([torch.arange(cfg.left_context_frames - 1, -1, -1, device=dev),
                        torch.full((cfg.chunk_size,), -1, device=dev)])
    kpm = state["processed_lens"][:, None] <= thresh[None, :]

    outputs, new_stack_states = [], []
    for s in range(cfg.num_stacks):
        x = _convert_channels(x, cfg.encoder_dim[s])
        x, ns = _stack(params["stacks"][s], cfg, s, x, state["stacks"][s], kpm)
        outputs.append(x)
        new_stack_states.append(ns)

    # Full-dim combine: each channel range from the most recent stack having it.
    dims = list(cfg.encoder_dim)
    pieces, cur = [outputs[-1]], dims[-1]
    for i in range(cfg.num_stacks - 2, -1, -1):
        if dims[i] > cur:
            pieces.append(outputs[i][..., cur : dims[i]])
            cur = dims[i]
    full = torch.cat(pieces, dim=-1)  # (N, chunk, output_dim)

    ds = cfg.output_downsampling_factor
    w = torch.softmax(params["output_ds_w"], dim=0)
    xd = full.reshape(full.shape[0], cfg.chunk_size // ds, ds, -1)
    enc = dense(torch.sum(xd * w[None, None, :, None], dim=2), params["encoder_proj"])

    new_state = {**state, "stacks": new_stack_states, "embed_pad": new_pad,
                 "processed_lens": state["processed_lens"] + cfg.chunk_size}
    return new_state, enc


def decoder_out(params: dict, cfg: ZipformerConfig, context: torch.Tensor) -> torch.Tensor:
    """Stateless context-2 decoder over (N, context) ids -> joiner-space
    vectors (N, joiner_dim). A negative (startup) id maps to a zero
    embedding row; the context conv is icefall's grouped Conv1d (groups =
    decoder_dim // 4, no bias)."""
    dec = params["decoder"]
    n = context.shape[0]
    emb = dec["embed"][torch.clamp(context, min=0)] * (context >= 0)[..., None]  # (N, ctx, D)
    groups = cfg.decoder_conv_groups
    per = cfg.decoder_dim // groups
    e = emb.reshape(n, cfg.context_size, groups, per)
    w = dec["conv_w"].reshape(groups, per, per, cfg.context_size)
    y = torch.einsum("goik,nkgi->ngo", w, e).reshape(n, cfg.decoder_dim)
    return dense(torch.relu(y), dec["proj"])


def _joiner_weight(w):
    return dequantize_weight(w) if isinstance(w, QuantizedLinear) else w


def greedy_chunk(params: dict, cfg: ZipformerConfig, state: dict, enc: torch.Tensor, max_new: int = 8):
    """Greedy transducer over each row's chunk frames (at most one symbol a
    frame) -> (state' with the updated context, ids (N, max_new), counts
    (N,)); emissions past ``max_new`` go to a dump slot but still move the
    context, as in JAX."""
    n, t = enc.shape[0], enc.shape[1]
    dev = enc.device
    rows = torch.arange(n, device=dev)
    w_out, b_out = _joiner_weight(params["joiner"]["out"]["w"]), params["joiner"]["out"]["b"]
    context = state["context"]
    buf = torch.zeros((n, max_new + 1), dtype=torch.int32, device=dev)
    count = torch.zeros((n,), dtype=torch.int64, device=dev)
    for f in range(t):
        d = decoder_out(params, cfg, context)
        # The joiner's output is a plain f32 product, as in JAX.
        logits = torch.matmul(torch.tanh(enc[:, f] + d), w_out) + b_out
        tok = torch.argmax(logits, dim=-1)
        emit = tok != cfg.blank_id
        context = torch.where(emit[:, None], torch.cat([context[:, 1:], tok[:, None]], dim=1), context)
        take = emit & (count < max_new)
        buf[rows, torch.where(take, count, max_new)] = tok.to(torch.int32)
        count = count + take.to(torch.int64)
    return {**state, "context": context}, buf[:, :max_new], count.to(torch.int32)


def transcribe_chunk(params: dict, cfg: ZipformerConfig, state: dict, window: torch.Tensor,
                     max_new: int = 8):
    """encoder_step + greedy_chunk for N windows."""
    state, enc = encoder_step(params, cfg, state, window)
    return greedy_chunk(params, cfg, state, enc, max_new)
