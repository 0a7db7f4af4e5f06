"""Load Nemotron ASR ``.nemo`` archives into asr_tpu_torch pytrees — NeMo-free.

The reference reads the archive standalone (tar: ``model_weights.ckpt`` +
``model_config.yaml`` + tokenizer assets, ``Export_Nemotron_ASR.py:332-369``)
and wraps the state dict for export; the authoritative names are the
buffers it reads (``:456-590`` encoder, ``:833-849`` decoder/joint,
``:577-587`` prompt kernel). Here the same names map straight to the
``asr_tpu_torch.models.nemotron`` pytree. The exporter's folds (LN-affine into
qkv/ff1/pw1, 0.5 into ff linear2, d_k^-0.5 into q) re-express math our
model applies explicitly, so raw weights load unchanged.

One genuinely exact-math fold IS reproduced: the multilingual prompt
projection's one-hot half collapses into a per-language bias table
(``lang_bias = b0 + W0[:, d_model:].T``, reference ``:577-584``) — a
gather replaces a (d+num_prompts) GEMM at serving time.
"""

from __future__ import annotations

import tarfile
from pathlib import Path
from typing import Any, Mapping

import numpy as np
from asr_tpu_torch.loaders._common import asarray

from asr_tpu_torch.models.nemotron import NemotronConfig


from asr_tpu_torch.loaders._common import dw1d as _dw1d, conv2d_hwio as _conv2d_hwio, lin as _lin, ln as _ln, to_np as _np


def read_nemo_archive(
    nemo_path: str | Path, extract_dir: str | Path | None = None
) -> tuple[dict, dict, dict]:
    """``.nemo`` tar -> (state_dict, model_config dict, asset paths).

    Extracts ``model_weights.ckpt`` / ``model_config.yaml`` / tokenizer
    files next to ``extract_dir`` (default: alongside the archive) — no
    NeMo dependency, mirrors reference ``ensure_assets`` (:332-369).
    """
    import tempfile

    import torch
    import yaml

    nemo_path = Path(nemo_path)
    out_dir = Path(extract_dir) if extract_dir is not None else nemo_path.parent
    out_dir.mkdir(parents=True, exist_ok=True)
    assets: dict[str, Path] = {}
    with tarfile.open(nemo_path, "r:*") as tar:
        members = {Path(m.name).name: m for m in tar.getmembers() if m.isfile()}

        def extract(name: str, dst: Path) -> Path | None:
            m = members.get(name)
            if m is None:
                return None
            with tar.extractfile(m) as src, tempfile.NamedTemporaryFile(
                dir=out_dir, delete=False
            ) as out:
                out.write(src.read())
                tmp = Path(out.name)
            tmp.replace(dst)
            return dst

        ckpt = extract("model_weights.ckpt", out_dir / "model_weights.ckpt")
        cfg_file = extract("model_config.yaml", out_dir / "model_config.yaml")
        tok = next(
            (n for n in members if n.endswith("_tokenizer.model") or n == "tokenizer.model"),
            None,
        )
        if tok:
            assets["tokenizer_model"] = extract(tok, out_dir / "tokenizer.model")
    if ckpt is None or cfg_file is None:
        raise FileNotFoundError(f"{nemo_path}: missing model_weights.ckpt / model_config.yaml")
    sd = torch.load(str(ckpt), map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    cfg = yaml.safe_load(cfg_file.read_text())
    assets["ckpt"] = ckpt
    assets["config"] = cfg_file
    return sd, cfg, assets


def select_att_context(att_context, chunk_ms: float, frame_ms: float) -> tuple[int, int]:
    """Pick the trained [left, right] attention context (reference
    ``_select_att_context``, ``Export_Nemotron_ASR.py:96-111``): offline
    (chunk_ms<=0) takes the widest right context; streaming takes the pair
    whose chunk duration is closest to chunk_ms."""
    pairs = (
        [list(p) for p in att_context]
        if att_context and isinstance(att_context[0], (list, tuple))
        else [list(att_context)]
    )
    if chunk_ms <= 0:
        left, right = max(pairs, key=lambda p: p[1])
    else:
        left, right = min(pairs, key=lambda p: abs((int(p[1]) + 1) * frame_ms - chunk_ms))
    return int(left), int(right)


def config_from_model_config(cfg: Mapping[str, Any], chunk_ms: float = 0) -> NemotronConfig:
    """``model_config.yaml`` dict -> NemotronConfig (geometry extraction
    mirrors reference ``Export_Nemotron_ASR.py:114-152``)."""
    from asr_tpu_torch.frontend.nemo_mel import NemoMelConfig

    pre, enc = cfg["preprocessor"], cfg["encoder"]
    dec, joint = cfg["decoder"], cfg["joint"]
    defaults = cfg.get("model_defaults", {})
    sr = int(pre["sample_rate"])
    d_model = int(enc["d_model"])
    sub_factor = int(enc.get("subsampling_factor", 8))
    hop = int(round(float(pre["window_stride"]) * sr))
    frame_ms = sub_factor * hop / sr * 1000.0
    left, right = select_att_context(enc["att_context_size"], chunk_ms, frame_ms)
    vocab = int(dec.get("vocab_size", joint.get("num_classes")))
    return NemotronConfig(
        vocab_size=vocab,
        d_model=d_model,
        num_layers=int(enc["n_layers"]),
        num_heads=int(enc["n_heads"]),
        ffn_dim=int(round(d_model * float(enc["ff_expansion_factor"]))),
        conv_kernel=int(enc["conv_kernel_size"]),
        sub_channels=int(enc["subsampling_conv_channels"]),
        pred_hidden=int(dec["prednet"]["pred_hidden"]),
        joint_hidden=int(joint["jointnet"]["joint_hidden"]),
        prompt_hidden=int(joint["jointnet"]["joint_hidden"]),
        lstm_layers=int(dec["prednet"]["pred_rnn_layers"]),
        num_prompts=int(defaults.get("num_prompts", 128)),
        left_context=left,
        right_context=right,
        pre_encode_cache=sub_factor + 1,
        max_symbols_per_frame=int(
            cfg.get("decoding", {}).get("greedy", {}).get("max_symbols", 10)
        ),
        sample_rate=sr,
        mel=NemoMelConfig(
            n_mels=int(pre["features"]),
            n_fft=int(pre["n_fft"]),
            win_length=int(round(float(pre["window_size"]) * sr)),
            hop_length=hop,
            sample_rate=sr,
        ),
    )


def nemotron_params_from_state_dict(sd: Mapping[str, Any], cfg: NemotronConfig) -> dict:
    """Map a Nemotron ``model_weights.ckpt`` state dict to our pytree."""

    def block(l: int) -> dict:
        p = f"encoder.layers.{l}."
        return {
            "norm_ff1": _ln(sd, p + "norm_feed_forward1"),
            "ff1": {"w1": _lin(sd, p + "feed_forward1.linear1"),
                    "w2": _lin(sd, p + "feed_forward1.linear2")},
            "norm_att": _ln(sd, p + "norm_self_att"),
            "attn": {
                "q": _lin(sd, p + "self_attn.linear_q"),
                "k": _lin(sd, p + "self_attn.linear_k"),
                "v": _lin(sd, p + "self_attn.linear_v"),
                "o": _lin(sd, p + "self_attn.linear_out"),
                "rel_k": {"w": asarray(_np(sd[p + "self_attn.linear_pos.weight"]).T)},
                "bias_u": asarray(_np(sd[p + "self_attn.pos_bias_u"])),
                "bias_v": asarray(_np(sd[p + "self_attn.pos_bias_v"])),
            },
            "norm_conv": _ln(sd, p + "norm_conv"),
            "conv": {
                "pw1": {"w": asarray(_np(sd[p + "conv.pointwise_conv1.weight"])[:, :, 0].T)},
                "dw": _dw1d(sd, p + "conv.depthwise_conv"),  # (K, d)
                "ln": _ln(sd, p + "conv.batch_norm"),
                "pw2": {"w": asarray(_np(sd[p + "conv.pointwise_conv2.weight"])[:, :, 0].T)},
            },
            "norm_ff2": _ln(sd, p + "norm_feed_forward2"),
            "ff2": {"w1": _lin(sd, p + "feed_forward2.linear1"),
                    "w2": _lin(sd, p + "feed_forward2.linear2")},
            "norm_out": _ln(sd, p + "norm_out"),
        }

    # Prompt projection: one-hot half of prompt_kernel.0 collapses into a
    # per-language bias table (exact; reference :577-584).
    w0 = _np(sd["prompt_kernel.0.weight"])  # (ph, d + num_prompts)
    b0 = _np(sd["prompt_kernel.0.bias"])
    d = cfg.d_model
    lstm = tuple(
        {
            "w_ih": asarray(_np(sd[f"decoder.prediction.dec_rnn.lstm.weight_ih_l{li}"]).T),
            "w_hh": asarray(_np(sd[f"decoder.prediction.dec_rnn.lstm.weight_hh_l{li}"]).T),
            "b_ih": asarray(_np(sd[f"decoder.prediction.dec_rnn.lstm.bias_ih_l{li}"])),
            "b_hh": asarray(_np(sd[f"decoder.prediction.dec_rnn.lstm.bias_hh_l{li}"])),
        }
        for li in range(cfg.lstm_layers)
    )
    return {
        "pre_encode": {
            "conv0": _conv2d_hwio(sd, "encoder.pre_encode.conv.0"),
            "dw1": _conv2d_hwio(sd, "encoder.pre_encode.conv.2"),
            "pw1": _conv2d_hwio(sd, "encoder.pre_encode.conv.3"),
            "dw2": _conv2d_hwio(sd, "encoder.pre_encode.conv.5"),
            "pw2": _conv2d_hwio(sd, "encoder.pre_encode.conv.6"),
            "out": _lin(sd, "encoder.pre_encode.out"),
        },
        "blocks": [block(l) for l in range(cfg.num_layers)],
        "prompt": {
            "w0_enc": asarray(w0[:, :d].T),
            "bias_table": asarray(b0[None, :] + w0[:, d:].T),
            "w2": _lin(sd, "prompt_kernel.2"),
            "joint_enc": _lin(sd, "joint.enc"),
        },
        "decoder": {
            "embed": asarray(_np(sd["decoder.prediction.embed.weight"])),
            "lstm": lstm,
            "pred": _lin(sd, "joint.pred"),
            "joint_net": _lin(sd, "joint.joint_net.2"),
        },
    }
