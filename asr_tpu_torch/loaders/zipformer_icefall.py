"""icefall Zipformer2 checkpoint -> X-ASR model params.

The reference (``X-ASR/Export_X_ASR.py:20-25,157-167``) loads an icefall
checkpoint (``ckpt["model_avg"]``) into four torch submodules
(``encoder_embed`` / ``encoder`` / ``decoder`` / ``joiner``) and then bakes
the fixed streaming geometry at export time (``:282-376``):

- the per-layer projected relative-position tables
  (``linear_pos(encoder_pos(...))`` -> one constant per stack layer),
- one fused per-timestep linear map per conv module (causal depthwise conv
  + chunk-scale-corrected chunkwise depthwise conv collapsed together),
- softmax of the SimpleDownsample bias logits.

This loader performs the same baking directly on the state-dict numpy
tensors — no torch module graph needed. Activation-constant folding the
reference also does (Swoosh offsets into biases) is *not* applied here:
``asr_tpu_torch.models.zipformer``'s swoosh_l/swoosh_r carry their own offsets,
so raw checkpoint biases are copied verbatim.

State-dict key layout (icefall zipformer2 recipe):
  encoder_embed.conv.{0,4,7}.{weight,bias}       Conv2dSubsampling convs
  encoder_embed.convnext.{depthwise_conv,pointwise_conv1,pointwise_conv2}
  encoder_embed.out.{weight,bias}, encoder_embed.out_norm.{bias,log_scale}
  encoder.encoders.{s}[.encoder].layers.{l}.<layer params>
  encoder.encoders.{s}.downsample.bias, .out_combiner.bypass_scale (ds>1)
  encoder.downsample_output.bias
  decoder.embedding.weight, decoder.conv.weight
  joiner.{encoder_proj,decoder_proj,output_linear}.{weight,bias}
"""

from __future__ import annotations

import numpy as np
from asr_tpu_torch.loaders._common import tree_asarray

from asr_tpu_torch.models.zipformer import ZipformerConfig

POS_DIM = 192  # icefall zipformer2 default pos_dim


def compact_rel_positional_encoding(
    positions: np.ndarray, pos_dim: int = POS_DIM, length_factor: float = 1.0
) -> np.ndarray:
    """icefall CompactRelPositionalEncoding rows for given relative positions.

    Positions are log-compressed (unit slope at 0, logarithmic growth for
    large |x|), squashed through atan into (-pi/2, pi/2), then expanded into
    interleaved cos/sin harmonics; the last column is a constant 1 bias
    channel. Returns (len(positions), pos_dim) float32.
    """
    x = np.asarray(positions, np.float64)[:, None]
    comp = float(pos_dim) ** 0.5
    x_compressed = comp * np.sign(x) * (np.log(np.abs(x) + comp) - np.log(comp))
    length_scale = length_factor * pos_dim / (2.0 * np.pi)
    x_atan = np.arctan(x_compressed / length_scale)
    freqs = 1.0 + np.arange(pos_dim // 2, dtype=np.float64)[None, :]
    pe = np.zeros((x.shape[0], pos_dim), np.float64)
    pe[:, 0::2] = np.cos(x_atan * freqs)
    pe[:, 1::2] = np.sin(x_atan * freqs)
    pe[:, -1] = 1.0
    return pe.astype(np.float32)


def streaming_positions(seq: int, left: int) -> np.ndarray:
    """Relative positions covered by a streaming window: the pe-slice the
    torch module returns for x of length ``seq`` with ``left`` cached
    frames — ``-(seq+left-1) .. seq-1`` (length ``2*seq-1+left``)."""
    return np.arange(-(seq + left - 1), seq)


def build_pos_table(
    linear_pos_w: np.ndarray, seq: int, left: int, heads: int, phd: int,
    length_factor: float = 1.0,
) -> np.ndarray:
    """linear_pos weight (heads*phd, pos_dim) -> baked (heads, phd, seq_len2)
    table (reference ``Export_X_ASR.py:321-323``)."""
    pos_dim = linear_pos_w.shape[1]
    pe = compact_rel_positional_encoding(
        streaming_positions(seq, left), pos_dim, length_factor
    )  # (seq_len2, pos_dim)
    proj = pe @ np.asarray(linear_pos_w, np.float64).T  # (seq_len2, heads*phd)
    seq_len2 = proj.shape[0]
    return (
        proj.reshape(seq_len2, heads, phd).transpose(1, 2, 0).astype(np.float32)
    )


def chunk_scale(scale_param: np.ndarray, seq: int) -> np.ndarray:
    """icefall ChunkCausalDepthwiseConv1d._get_chunk_scale: the learned
    (2, C, K) edge-correction logits become a (C, seq) multiplier —
    1 + left-edge corrections (first rows) + right-edge corrections
    (last rows), zero-filled in the middle when the chunk outgrows K."""
    left_edge, right_edge = np.asarray(scale_param, np.float64)
    c, k = left_edge.shape
    if seq < k:
        le = left_edge[:, :seq]
        re = right_edge[:, k - seq:]
    else:
        pad = np.zeros((c, seq - k), np.float64)
        le = np.concatenate([left_edge, pad], axis=1)
        re = np.concatenate([pad, right_edge], axis=1)
    return 1.0 + le + re


def fuse_streaming_conv(
    causal_w: np.ndarray,          # (C, left+1) depthwise taps
    causal_b: np.ndarray | None,   # (C,)
    chunk_w: np.ndarray,           # (C, K = 2*left+1)
    chunk_b: np.ndarray | None,    # (C,) or None
    scale: np.ndarray,             # (C, seq) chunk-scale multiplier
) -> tuple[np.ndarray, np.ndarray]:
    """Collapse the causal + chunkwise depthwise pair into one per-channel
    (seq, left+seq) linear map over [cached-left-pad | chunk] inputs.

    out[c, t] = sum_j causal_w[c, j] * xin[c, t+j]                (causal band)
              + scale[c, t] * sum_k chunk_w[c, k] * chunk[c, t+k-left]  (chunk-
                internal taps only: the chunkwise conv never sees the cache)
    """
    causal_w = np.asarray(causal_w, np.float64)
    chunk_w = np.asarray(chunk_w, np.float64)
    scale = np.asarray(scale, np.float64)
    c, k = chunk_w.shape
    left = k // 2
    seq = scale.shape[1]
    fused = np.zeros((c, seq, left + seq), np.float64)

    t = np.arange(seq)
    # Causal band: row t covers input columns t .. t+left.
    j = np.arange(left + 1)
    fused[:, t[:, None], t[:, None] + j[None, :]] += causal_w[:, None, :]
    # Chunkwise taps: output t reads chunk column u when |u - t| <= left.
    u = np.arange(seq)
    tap = u[None, :] - t[:, None] + left                  # (seq_t, seq_u) kernel index
    valid = (tap >= 0) & (tap < k)
    taps = np.where(valid[None], chunk_w[:, np.clip(tap, 0, k - 1)], 0.0)
    fused[:, :, left:] += taps * scale[:, :, None]

    bias = np.zeros((c, seq), np.float64)
    if causal_b is not None:
        bias += np.asarray(causal_b, np.float64)[:, None]
    if chunk_b is not None:
        bias += np.asarray(chunk_b, np.float64)[:, None] * scale
    return fused.astype(np.float32), bias.astype(np.float32)


def _lin(sd: dict, key: str) -> dict:
    p = {"w": np.asarray(sd[f"{key}.weight"], np.float32).T}
    if f"{key}.bias" in sd:
        p["b"] = np.asarray(sd[f"{key}.bias"], np.float32)
    return p


def _conv2d(sd: dict, key: str) -> dict:
    # torch OIHW -> HWIO
    return {
        "w": np.asarray(sd[f"{key}.weight"], np.float32).transpose(2, 3, 1, 0),
        "b": np.asarray(sd[f"{key}.bias"], np.float32),
    }


def _layer_params(sd: dict, pfx: str, g: dict, cfg: ZipformerConfig,
                  length_factor: float) -> dict:
    seq, left = g["seq"], g["left"]

    def conv(n: int) -> dict:
        dc = f"{pfx}.conv_module{n}.depthwise_conv"
        scale = chunk_scale(sd[f"{dc}.chunkwise_conv_scale"], seq)
        fused_w, fused_b = fuse_streaming_conv(
            np.asarray(sd[f"{dc}.causal_conv.weight"])[:, 0],
            sd.get(f"{dc}.causal_conv.bias"),
            np.asarray(sd[f"{dc}.chunkwise_conv.weight"])[:, 0],
            sd.get(f"{dc}.chunkwise_conv.bias"),
            scale,
        )
        return {
            "in": _lin(sd, f"{pfx}.conv_module{n}.in_proj"),
            "fused_w": fused_w,
            "fused_b": fused_b,
            "out": _lin(sd, f"{pfx}.conv_module{n}.out_proj"),
        }

    return {
        "attn_in_proj": _lin(sd, f"{pfx}.self_attn_weights.in_proj"),
        "pos_table": build_pos_table(
            np.asarray(sd[f"{pfx}.self_attn_weights.linear_pos.weight"]),
            seq, left, g["heads"], g["phd"], length_factor,
        ),
        "ff1": {"in": _lin(sd, f"{pfx}.feed_forward1.in_proj"),
                "out": _lin(sd, f"{pfx}.feed_forward1.out_proj")},
        "ff2": {"in": _lin(sd, f"{pfx}.feed_forward2.in_proj"),
                "out": _lin(sd, f"{pfx}.feed_forward2.out_proj")},
        "ff3": {"in": _lin(sd, f"{pfx}.feed_forward3.in_proj"),
                "out": _lin(sd, f"{pfx}.feed_forward3.out_proj")},
        "nonlin": {"in": _lin(sd, f"{pfx}.nonlin_attention.in_proj"),
                   "out": _lin(sd, f"{pfx}.nonlin_attention.out_proj")},
        "sa1": {"in": _lin(sd, f"{pfx}.self_attn1.in_proj"),
                "out": _lin(sd, f"{pfx}.self_attn1.out_proj")},
        "sa2": {"in": _lin(sd, f"{pfx}.self_attn2.in_proj"),
                "out": _lin(sd, f"{pfx}.self_attn2.out_proj")},
        "conv1": conv(1),
        "conv2": conv(2),
        "bypass_mid": np.asarray(sd[f"{pfx}.bypass_mid.bypass_scale"], np.float32),
        "bypass": np.asarray(sd[f"{pfx}.bypass.bypass_scale"], np.float32),
        "norm_bias": np.asarray(sd[f"{pfx}.norm.bias"], np.float32),
        "norm_log_scale": np.asarray(sd[f"{pfx}.norm.log_scale"], np.float32).reshape(()),
    }


def zipformer_params_from_state_dict(
    sd: dict, cfg: ZipformerConfig, length_factor: float = 1.0
) -> dict:
    """Full icefall state dict (encoder_embed./encoder./decoder./joiner.
    prefixes, e.g. ``ckpt["model_avg"]``) -> asr_tpu zipformer params."""
    stacks = []
    for s in range(cfg.num_stacks):
        g = cfg.stack_geom(s)
        base = f"encoder.encoders.{s}"
        inner = base if g["ds"] == 1 else f"{base}.encoder"
        stack = {
            "layers": [
                _layer_params(sd, f"{inner}.layers.{l}", g, cfg, length_factor)
                for l in range(cfg.num_encoder_layers[s])
            ]
        }
        if g["ds"] != 1:
            logits = np.asarray(sd[f"{base}.downsample.bias"], np.float64).reshape(-1)
            w = np.exp(logits - logits.max())
            stack["downsample_w"] = (w / w.sum()).astype(np.float32)
            stack["out_combiner"] = np.asarray(
                sd[f"{base}.out_combiner.bypass_scale"], np.float32
            )
        stacks.append(stack)

    dso = np.asarray(sd["encoder.downsample_output.bias"], np.float64).reshape(-1)
    w = np.exp(dso - dso.max())

    e = "encoder_embed"
    params = {
        "embed": {
            "conv0": _conv2d(sd, f"{e}.conv.0"),
            "conv1": _conv2d(sd, f"{e}.conv.4"),
            "conv2": _conv2d(sd, f"{e}.conv.7"),
            "convnext": {
                "dw": {
                    # depthwise (C,1,7,7) -> HWIO (7,7,1,C)
                    "w": np.asarray(sd[f"{e}.convnext.depthwise_conv.weight"],
                                    np.float32).transpose(2, 3, 1, 0),
                    "b": np.asarray(sd[f"{e}.convnext.depthwise_conv.bias"], np.float32),
                },
                # 1x1 conv (3C,C,1,1) consumed as a plain linear
                "pw1": {
                    "w": np.asarray(sd[f"{e}.convnext.pointwise_conv1.weight"],
                                    np.float32)[:, :, 0, 0].T,
                    "b": np.asarray(sd[f"{e}.convnext.pointwise_conv1.bias"], np.float32),
                },
                "pw2": _conv2d(sd, f"{e}.convnext.pointwise_conv2"),
            },
            "out": _lin(sd, f"{e}.out"),
            "out_norm_bias": np.asarray(sd[f"{e}.out_norm.bias"], np.float32),
            "out_norm_log_scale": np.asarray(sd[f"{e}.out_norm.log_scale"],
                                             np.float32).reshape(()),
        },
        "stacks": stacks,
        "output_ds_w": (w / w.sum()).astype(np.float32),
        "encoder_proj": _lin(sd, "joiner.encoder_proj"),
        "decoder": {
            "embed": np.asarray(sd["decoder.embedding.weight"], np.float32),
            "conv_w": np.asarray(sd["decoder.conv.weight"], np.float32),
            "proj": _lin(sd, "joiner.decoder_proj"),
        },
        "joiner": {"out": _lin(sd, "joiner.output_linear")},
    }
    return tree_asarray(params)
