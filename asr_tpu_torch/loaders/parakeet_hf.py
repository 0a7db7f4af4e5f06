"""Load Parakeet checkpoints (HF parakeet-tdt safetensors / ParakeetEncoder
state dicts) into asr_tpu_torch pytrees.

The TDT snapshot keys are ``encoder.*`` / ``decoder.*`` / ``joint.head.*``
(reference mapping knowledge: ``Parakeet/Export_Parakeet_ASR.py:282-376,
474-517``). BatchNorm running stats fold to a per-channel affine at load —
the only weight transform retained from the reference's export passes.
"""

from __future__ import annotations

from typing import Mapping

from asr_tpu_torch.loaders._common import asarray
import numpy as np

from asr_tpu_torch.models.parakeet import ParakeetConfig

BN_EPS = 1e-5


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _lin(sd, key, bias=True):
    p = {"w": asarray(_np(sd[f"{key}.weight"]).T)}
    if bias and f"{key}.bias" in sd:
        p["b"] = asarray(_np(sd[f"{key}.bias"]))
    return p


def _norm(sd, key):
    return {"scale": asarray(_np(sd[f"{key}.weight"])),
            "bias": asarray(_np(sd[f"{key}.bias"]))}


def _conv2d_w(t, groups=False):
    # torch (O, I/g, H, W) -> HWIO (H, W, I/g, O)
    return asarray(_np(t).transpose(2, 3, 1, 0))


def encoder_params_from_state_dict(sd: Mapping, cfg: ParakeetConfig, prefix: str = "") -> dict:
    g = lambda k: sd[prefix + k]

    def block(i):
        p = f"layers.{i}."
        dw = _np(g(p + "conv.depthwise_conv.weight"))  # (D, 1, K)
        bn_w = _np(g(p + "conv.norm.weight"))
        bn_b = _np(g(p + "conv.norm.bias"))
        bn_rm = _np(g(p + "conv.norm.running_mean"))
        bn_rv = _np(g(p + "conv.norm.running_var"))
        scale = bn_w / np.sqrt(bn_rv + BN_EPS)
        shift = bn_b - bn_rm * scale
        return {
            "norm_ff1": _norm(sd, prefix + p + "norm_feed_forward1"),
            "ff1": {"w1": _lin(sd, prefix + p + "feed_forward1.linear1"),
                    "w2": _lin(sd, prefix + p + "feed_forward1.linear2")},
            "norm_att": _norm(sd, prefix + p + "norm_self_att"),
            "attn": {
                "q": _lin(sd, prefix + p + "self_attn.q_proj"),
                "k": _lin(sd, prefix + p + "self_attn.k_proj"),
                "v": _lin(sd, prefix + p + "self_attn.v_proj"),
                "o": _lin(sd, prefix + p + "self_attn.o_proj"),
                "rel_k": {"w": asarray(_np(g(p + "self_attn.relative_k_proj.weight")).T)},
                "bias_u": asarray(_np(g(p + "self_attn.bias_u"))),
                "bias_v": asarray(_np(g(p + "self_attn.bias_v"))),
            },
            "norm_conv": _norm(sd, prefix + p + "norm_conv"),
            "conv": {
                # pointwise Conv1d (2D, D, 1) -> dense (D, 2D)
                "pw1": {"w": asarray(_np(g(p + "conv.pointwise_conv1.weight"))[:, :, 0].T),
                        "b": asarray(_np(g(p + "conv.pointwise_conv1.bias")))},
                # depthwise (D, 1, K) -> (K, D)
                "dw": {"w": asarray(dw[:, 0, :].T),
                       "b": asarray(_np(g(p + "conv.depthwise_conv.bias")))},
                "bn": {"scale": asarray(scale), "shift": asarray(shift)},
                "pw2": {"w": asarray(_np(g(p + "conv.pointwise_conv2.weight"))[:, :, 0].T),
                        "b": asarray(_np(g(p + "conv.pointwise_conv2.bias")))},
            },
            "norm_ff2": _norm(sd, prefix + p + "norm_feed_forward2"),
            "ff2": {"w1": _lin(sd, prefix + p + "feed_forward2.linear1"),
                    "w2": _lin(sd, prefix + p + "feed_forward2.linear2")},
            "norm_out": _norm(sd, prefix + p + "norm_out"),
        }

    return {
        "subsample": {
            "conv0": {"w": _conv2d_w(g("subsampling.layers.0.weight")),
                      "b": asarray(_np(g("subsampling.layers.0.bias")))},
            "dw1": {"w": _conv2d_w(g("subsampling.layers.2.weight")),
                    "b": asarray(_np(g("subsampling.layers.2.bias")))},
            "pw1": {"w": _conv2d_w(g("subsampling.layers.3.weight")),
                    "b": asarray(_np(g("subsampling.layers.3.bias")))},
            "dw2": {"w": _conv2d_w(g("subsampling.layers.5.weight")),
                    "b": asarray(_np(g("subsampling.layers.5.bias")))},
            "pw2": {"w": _conv2d_w(g("subsampling.layers.6.weight")),
                    "b": asarray(_np(g("subsampling.layers.6.bias")))},
            "out": _lin(sd, prefix + "subsampling.linear"),
        },
        "blocks": [block(i) for i in range(cfg.num_layers)],
    }


def tdt_params_from_state_dict(sd: Mapping, cfg: ParakeetConfig) -> dict:
    """Full TDT snapshot: encoder.* + encoder_projector + decoder.* + joint.head."""
    params = encoder_params_from_state_dict(sd, cfg, prefix="encoder.")
    params["enc_proj"] = _lin(sd, "encoder_projector")
    lstm = []
    for li in range(cfg.lstm_layers):
        lstm.append(
            {
                "w_ih": asarray(_np(sd[f"decoder.lstm.weight_ih_l{li}"]).T),
                "w_hh": asarray(_np(sd[f"decoder.lstm.weight_hh_l{li}"]).T),
                "b_ih": asarray(_np(sd[f"decoder.lstm.bias_ih_l{li}"])),
                "b_hh": asarray(_np(sd[f"decoder.lstm.bias_hh_l{li}"])),
            }
        )
    params["decoder"] = {
        "embed": asarray(_np(sd["decoder.embedding.weight"])),
        "lstm": tuple(lstm),
        "proj": _lin(sd, "decoder.decoder_projector"),
        "head": _lin(sd, "joint.head"),
    }
    return params
