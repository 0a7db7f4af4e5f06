"""Load FireRedASR-AED checkpoints (``model.pth.tar``) into asr_tpu_torch pytrees.

The reference rebuilds ``FireRedAsrAed`` from the checkpoint package and
wraps it for ONNX export (``FireRedASR/Export_FireRedASR_AED.py:506-516``,
module structure :184-505, decoder attribute names :963-1163). Here the
same state-dict names map straight to the ``asr_tpu_torch.models.firered``
pytree — no weight folds: the exporter's qkv fusion / LayerNorm-affine
absorption / d_k^-0.25 scale splits are export-time rewrites of the same
math that XLA performs at runtime, so raw checkpoint weights + explicit
scaling reproduce the original model numerics.

Checkpoint format: ``torch.load`` package ``{"args": Namespace,
"model_state_dict": {...}}`` (mirrors ``fireredasr/asr.py``), plus a Kaldi
CMVN stats file (``cmvn.ark``) alongside for the feature normalizer.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import numpy as np
from asr_tpu_torch.loaders._common import asarray

from asr_tpu_torch.models.firered import FireRedConfig


from asr_tpu_torch.loaders._common import conv2d_hwio as _conv2d, dw1d as _dw1d, lin as _lin, ln as _ln, to_np as _np


def config_from_state_dict(sd: Mapping[str, Any], **overrides) -> FireRedConfig:
    """Derive the model geometry from checkpoint tensor shapes
    (heads/head_dim from ``pos_bias_u``, layer counts from key census)."""
    d_model = _np(sd["decoder.tgt_word_emb.weight"]).shape[1]
    vocab = _np(sd["decoder.tgt_word_emb.weight"]).shape[0]
    enc_layers = 1 + max(
        int(k.split(".")[2]) for k in sd if k.startswith("encoder.layer_stack.")
    )
    dec_layers = 1 + max(
        int(k.split(".")[2]) for k in sd if k.startswith("decoder.layer_stack.")
    )
    enc_heads = _np(sd["encoder.layer_stack.0.mhsa.pos_bias_u"]).shape[0]
    conv_kernel = _np(sd["encoder.layer_stack.0.conv.depthwise_conv.weight"]).shape[-1]
    dec_ffn = _np(sd["decoder.layer_stack.0.mlp.w_1.weight"]).shape[0]
    kw = dict(
        vocab_size=vocab,
        n_mels=80,  # fixed for FireRedASR-AED (not shape-derivable; override if needed)
        d_model=d_model,
        enc_layers=enc_layers,
        enc_heads=enc_heads,
        conv_kernel=conv_kernel,
        dec_layers=dec_layers,
        dec_heads=enc_heads,
        dec_ffn=dec_ffn,
    )
    kw.update(overrides)
    return FireRedConfig(**kw)


def firered_params_from_state_dict(
    sd: Mapping[str, Any],
    cfg: FireRedConfig,
    cmvn_means: np.ndarray | None = None,
    cmvn_istd: np.ndarray | None = None,
) -> dict:
    """Map a FireRedAsrAed state_dict to the ``models.firered`` pytree."""

    def enc_block(i: int) -> dict:
        p = f"encoder.layer_stack.{i}"
        return {
            "ffn1": {
                "norm": _ln(sd, f"{p}.ffn1.net.0"),
                "w1": _lin(sd, f"{p}.ffn1.net.1"),
                "w2": _lin(sd, f"{p}.ffn1.net.4"),
            },
            "attn": {
                "norm_q": _ln(sd, f"{p}.mhsa.layer_norm_q"),
                "norm_k": _ln(sd, f"{p}.mhsa.layer_norm_k"),
                "norm_v": _ln(sd, f"{p}.mhsa.layer_norm_v"),
                "q": _lin(sd, f"{p}.mhsa.w_qs"),
                "k": _lin(sd, f"{p}.mhsa.w_ks"),
                "v": _lin(sd, f"{p}.mhsa.w_vs"),
                "pos": {"w": asarray(_np(sd[f"{p}.mhsa.linear_pos.weight"]).T)},
                "bias_u": asarray(_np(sd[f"{p}.mhsa.pos_bias_u"])),
                "bias_v": asarray(_np(sd[f"{p}.mhsa.pos_bias_v"])),
                "o": _lin(sd, f"{p}.mhsa.fc"),
            },
            "conv": {
                "norm": _ln(sd, f"{p}.conv.pre_layer_norm"),
                # pointwise Conv1d k1 (Cout, Cin, 1) -> dense (Cin, Cout)
                "pw1": {"w": asarray(_np(sd[f"{p}.conv.pointwise_conv1.weight"])[:, :, 0].T)},
                "dw": _dw1d(sd, f"{p}.conv.depthwise_conv"),  # (K, 2d)
                "ln": _ln(sd, f"{p}.conv.batch_norm"),
                "pw2": {"w": asarray(_np(sd[f"{p}.conv.pointwise_conv2.weight"])[:, :, 0].T)},
            },
            "ffn2": {
                "norm": _ln(sd, f"{p}.ffn2.net.0"),
                "w1": _lin(sd, f"{p}.ffn2.net.1"),
                "w2": _lin(sd, f"{p}.ffn2.net.4"),
            },
            "norm_out": _ln(sd, f"{p}.layer_norm"),
        }

    def dec_block(i: int) -> dict:
        p = f"decoder.layer_stack.{i}"
        return {
            "ln1": _ln(sd, f"{p}.self_attn_norm"),
            "attn": {
                "q": _lin(sd, f"{p}.self_attn.w_qs"),
                "k": _lin(sd, f"{p}.self_attn.w_ks"),
                "v": _lin(sd, f"{p}.self_attn.w_vs"),
                "o": _lin(sd, f"{p}.self_attn.fc"),
            },
            "ln_cross": _ln(sd, f"{p}.cross_attn_norm"),
            "cross": {
                "q": _lin(sd, f"{p}.cross_attn.w_qs"),
                "k": _lin(sd, f"{p}.cross_attn.w_ks"),
                "v": _lin(sd, f"{p}.cross_attn.w_vs"),
                "o": _lin(sd, f"{p}.cross_attn.fc"),
            },
            "ln2": _ln(sd, f"{p}.mlp_norm"),
            "mlp": {"fc1": _lin(sd, f"{p}.mlp.w_1"), "fc2": _lin(sd, f"{p}.mlp.w_2")},
        }

    embed = asarray(_np(sd["decoder.tgt_word_emb.weight"]))
    decoder = {
        "embed": embed,
        "blocks": [dec_block(i) for i in range(cfg.dec_layers)],
        "ln": _ln(sd, "decoder.layer_norm_out"),
    }
    if "decoder.tgt_word_prj.weight" in sd:
        prj = _np(sd["decoder.tgt_word_prj.weight"])
        if prj.shape != embed.shape or not np.array_equal(prj, _np(embed)):
            decoder["out"] = asarray(prj)  # untied vocabulary projection

    return {
        "cmvn_means": asarray(
            cmvn_means if cmvn_means is not None else np.zeros((cfg.n_mels,), np.float32)
        ),
        "cmvn_istd": asarray(
            cmvn_istd if cmvn_istd is not None else np.ones((cfg.n_mels,), np.float32)
        ),
        "subsample": {
            "conv0": _conv2d(sd, "encoder.input_preprocessor.conv.0"),
            "conv1": _conv2d(sd, "encoder.input_preprocessor.conv.2"),
            "out": _lin(sd, "encoder.input_preprocessor.out"),
        },
        "enc_blocks": [enc_block(i) for i in range(cfg.enc_layers)],
        "decoder": decoder,
    }


def parse_kaldi_cmvn_stats(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """Kaldi text CMVN stats (2 x (dim+1): [sum, count; sumsq, 0]) ->
    (means, inverse std). Matches the reference feat extractor's
    ``cmvn.means`` / ``cmvn.inverse_std_variences``
    (``FIRE_RED_ENCODER.__init__``, ``Export_FireRedASR_AED.py:777-779``)."""
    text = Path(path).read_text()
    body = text[text.index("[") + 1 : text.rindex("]")]
    rows = [
        np.fromstring(line, dtype=np.float64, sep=" ")
        for line in body.strip().splitlines()
        if line.strip()
    ]
    if len(rows) != 2 or len(rows[0]) != len(rows[1]):
        raise ValueError(f"{path}: expected a 2x(dim+1) Kaldi CMVN stats matrix")
    count = rows[0][-1]
    means = rows[0][:-1] / count
    var = rows[1][:-1] / count - means * means
    istd = 1.0 / np.sqrt(np.maximum(var, 1e-20))
    return means.astype(np.float32), istd.astype(np.float32)


def load_checkpoint(path: str | Path) -> tuple[dict, Any]:
    """Read a ``model.pth.tar`` package -> (state_dict, args)."""
    import torch

    package = torch.load(
        str(path), map_location="cpu", weights_only=False
    )
    return package["model_state_dict"], package.get("args")
