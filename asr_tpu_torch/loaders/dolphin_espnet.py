"""Load Dolphin (espnet/OWSM-style) checkpoints into asr_tpu_torch pytrees.

Name-mapping knowledge from the reference exporter's module accesses
(``Dolphin/v1/Export_Dolphin.py:434-560``): E-Branchformer encoder layers
(``encoder.encoders.N.attn.linear_q/k/v/out, linear_pos, pos_bias_u/v``,
``cgmlp.channel_proj1.0 / csgu.norm / csgu.conv / channel_proj2``,
``depthwise_conv_fusion``, ``merge_proj``, macaron FFNs and the five
norms), espnet Conv2dSubsampling embed, espnet transformer decoder, CTC
head, and global CMVN stats.
"""

from __future__ import annotations

from typing import Mapping

from asr_tpu_torch.loaders._common import asarray
import numpy as np

from asr_tpu_torch.models.dolphin import DolphinConfig


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        return t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def _lin(sd, key, transpose=True):
    w = _np(sd[f"{key}.weight"])
    p = {"w": asarray(w.T if transpose else w)}
    if f"{key}.bias" in sd:
        p["b"] = asarray(_np(sd[f"{key}.bias"]))
    return p


def _norm(sd, key):
    return {"scale": asarray(_np(sd[f"{key}.weight"])),
            "bias": asarray(_np(sd[f"{key}.bias"]))}


def _dw1d(sd, key):
    """torch depthwise Conv1d (C, 1, K) -> {w: (K, C), b?}."""
    w = _np(sd[f"{key}.weight"])
    p = {"w": asarray(w[:, 0, :].T)}
    if f"{key}.bias" in sd:
        p["b"] = asarray(_np(sd[f"{key}.bias"]))
    return p


def _conv2d(sd, key):
    """torch Conv2d (O, I, H, W) -> {w: HWIO, b}."""
    return {"w": asarray(_np(sd[f"{key}.weight"]).transpose(2, 3, 1, 0)),
            "b": asarray(_np(sd[f"{key}.bias"]))}


def params_from_state_dict(sd: Mapping, cfg: DolphinConfig) -> dict:
    def enc_block(i):
        p = f"encoder.encoders.{i}"
        csgu_conv = _dw1d(sd, f"{p}.cgmlp.csgu.conv")
        fusion = _dw1d(sd, f"{p}.depthwise_conv_fusion")
        return {
            "ffn_macaron": {
                "norm": _norm(sd, f"{p}.norm_ff_macaron"),
                "w1": _lin(sd, f"{p}.feed_forward_macaron.w_1"),
                "w2": _lin(sd, f"{p}.feed_forward_macaron.w_2"),
            },
            "norm_mha": _norm(sd, f"{p}.norm_mha"),
            "attn": {
                "q": _lin(sd, f"{p}.attn.linear_q"),
                "k": _lin(sd, f"{p}.attn.linear_k"),
                "v": _lin(sd, f"{p}.attn.linear_v"),
                "o": _lin(sd, f"{p}.attn.linear_out"),
                "rel_k": {"w": asarray(_np(sd[f"{p}.attn.linear_pos.weight"]).T)},
                "bias_u": asarray(_np(sd[f"{p}.attn.pos_bias_u"])),
                "bias_v": asarray(_np(sd[f"{p}.attn.pos_bias_v"])),
            },
            "norm_mlp": _norm(sd, f"{p}.norm_mlp"),
            "cgmlp": {
                "proj1": _lin(sd, f"{p}.cgmlp.channel_proj1.0"),
                "csgu": {"norm": _norm(sd, f"{p}.cgmlp.csgu.norm"), "conv": csgu_conv},
                "proj2": _lin(sd, f"{p}.cgmlp.channel_proj2"),
            },
            "fusion": fusion,
            "merge_proj": _lin(sd, f"{p}.merge_proj"),
            "ffn": {
                "norm": _norm(sd, f"{p}.norm_ff"),
                "w1": _lin(sd, f"{p}.feed_forward.w_1"),
                "w2": _lin(sd, f"{p}.feed_forward.w_2"),
            },
            "norm_final": _norm(sd, f"{p}.norm_final"),
        }

    def dec_block(i):
        p = f"decoder.decoders.{i}"
        return {
            "ln1": _norm(sd, f"{p}.self_attn_norm") if f"{p}.self_attn_norm.weight" in sd
            else _norm(sd, f"{p}.norm1"),
            "attn": {
                "q": _lin(sd, f"{p}.self_attn.linear_q"),
                "k": _lin(sd, f"{p}.self_attn.linear_k"),
                "v": _lin(sd, f"{p}.self_attn.linear_v"),
                "o": _lin(sd, f"{p}.self_attn.linear_out"),
            },
            "ln_cross": _norm(sd, f"{p}.norm2"),
            "cross": {
                "q": _lin(sd, f"{p}.src_attn.linear_q"),
                "k": _lin(sd, f"{p}.src_attn.linear_k"),
                "v": _lin(sd, f"{p}.src_attn.linear_v"),
                "o": _lin(sd, f"{p}.src_attn.linear_out"),
            },
            "ln2": _norm(sd, f"{p}.norm3"),
            "mlp": {
                "fc1": _lin(sd, f"{p}.feed_forward.w_1"),
                "fc2": _lin(sd, f"{p}.feed_forward.w_2"),
            },
        }

    n_enc = 0
    while f"encoder.encoders.{n_enc}.norm_mha.weight" in sd:
        n_enc += 1
    n_dec = 0
    while f"decoder.decoders.{n_dec}.norm1.weight" in sd:
        n_dec += 1

    return {
        "cmvn_mean": asarray(_np(sd["encoder.global_cmvn.mean"]).reshape(-1)),
        "cmvn_istd": asarray(1.0 / _np(sd["encoder.global_cmvn.std"]).reshape(-1)),
        "subsample": {
            "conv0": _conv2d(sd, "encoder.embed.conv.0"),
            "conv1": _conv2d(sd, "encoder.embed.conv.2"),
            "out": _lin(sd, "encoder.embed.out.0"),
        },
        "enc_blocks": [enc_block(i) for i in range(n_enc)],
        "after_norm": _norm(sd, "encoder.after_norm"),
        "ctc": _lin(sd, "ctc.ctc_lo"),
        "decoder": {
            "embed": asarray(_np(sd["decoder.embed.0.weight"])),
            "blocks": [dec_block(i) for i in range(n_dec)],
            "ln": _norm(sd, "decoder.after_norm"),
        },
    }
