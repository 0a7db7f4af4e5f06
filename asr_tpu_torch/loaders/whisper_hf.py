"""Load HF Whisper checkpoints directly into asr_tpu_torch pytrees.

Replaces the reference's torch.onnx export path (the checkpoint mapping
knowledge lives in ``Whisper/Export_Whisper.py:667-750``): reads
``model.safetensors`` (or a live ``transformers`` model's state_dict) and
emits the ``asr_tpu_torch.models.whisper`` param pytree + config. No folds are
applied — XLA performs at runtime what the exporter did offline.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

from asr_tpu_torch.loaders._common import asarray
import numpy as np

from asr_tpu_torch.models.whisper import WhisperConfig


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _lin(sd: Mapping[str, Any], prefix: str, bias: bool = True) -> dict:
    p = {"w": asarray(_np(sd[f"{prefix}.weight"]).T)}
    if bias and f"{prefix}.bias" in sd:
        p["b"] = asarray(_np(sd[f"{prefix}.bias"]))
    return p


def _ln(sd: Mapping[str, Any], prefix: str) -> dict:
    return {
        "scale": asarray(_np(sd[f"{prefix}.weight"])),
        "bias": asarray(_np(sd[f"{prefix}.bias"])),
    }


def _attn(sd: Mapping[str, Any], prefix: str) -> dict:
    return {
        "q": _lin(sd, f"{prefix}.q_proj"),
        "k": _lin(sd, f"{prefix}.k_proj", bias=False),
        "v": _lin(sd, f"{prefix}.v_proj"),
        "o": _lin(sd, f"{prefix}.out_proj"),
    }


def params_from_state_dict(sd: Mapping[str, Any], cfg: WhisperConfig) -> dict:
    """Map an HF WhisperForConditionalGeneration state_dict to our pytree."""
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}

    def enc_block(i):
        p = f"encoder.layers.{i}"
        return {
            "ln1": _ln(sd, f"{p}.self_attn_layer_norm"),
            "attn": _attn(sd, f"{p}.self_attn"),
            "ln2": _ln(sd, f"{p}.final_layer_norm"),
            "mlp": {"fc1": _lin(sd, f"{p}.fc1"), "fc2": _lin(sd, f"{p}.fc2")},
        }

    def dec_block(i):
        p = f"decoder.layers.{i}"
        return {
            "ln1": _ln(sd, f"{p}.self_attn_layer_norm"),
            "attn": _attn(sd, f"{p}.self_attn"),
            "ln_cross": _ln(sd, f"{p}.encoder_attn_layer_norm"),
            "cross": _attn(sd, f"{p}.encoder_attn"),
            "ln2": _ln(sd, f"{p}.final_layer_norm"),
            "mlp": {"fc1": _lin(sd, f"{p}.fc1"), "fc2": _lin(sd, f"{p}.fc2")},
        }

    return {
        "encoder": {
            # HF conv weight (Cout, Cin, K) -> ours (K, Cin, Cout)
            "conv1": {
                "w": asarray(_np(sd["encoder.conv1.weight"]).transpose(2, 1, 0)),
                "b": asarray(_np(sd["encoder.conv1.bias"])),
            },
            "conv2": {
                "w": asarray(_np(sd["encoder.conv2.weight"]).transpose(2, 1, 0)),
                "b": asarray(_np(sd["encoder.conv2.bias"])),
            },
            "pos": asarray(_np(sd["encoder.embed_positions.weight"])),
            "blocks": [enc_block(i) for i in range(cfg.encoder_layers)],
            "ln_post": _ln(sd, "encoder.layer_norm"),
        },
        "decoder": {
            "embed": asarray(_np(sd["decoder.embed_tokens.weight"])),
            "pos": asarray(_np(sd["decoder.embed_positions.weight"])),
            "blocks": [dec_block(i) for i in range(cfg.decoder_layers)],
            "ln": _ln(sd, "decoder.layer_norm"),
        },
    }


def config_from_hf(hf_config) -> WhisperConfig:
    """Build WhisperConfig from a transformers WhisperConfig object/dict."""
    get = (lambda k, d=None: getattr(hf_config, k, d)) if not isinstance(hf_config, dict) else (
        lambda k, d=None: hf_config.get(k, d)
    )
    vocab = get("vocab_size")
    return WhisperConfig(
        vocab_size=vocab,
        d_model=get("d_model"),
        encoder_layers=get("encoder_layers"),
        decoder_layers=get("decoder_layers"),
        num_heads=get("encoder_attention_heads"),
        ffn_dim=get("encoder_ffn_dim"),
        n_mels=get("num_mel_bins"),
        max_source_positions=get("max_source_positions"),
        max_target_positions=get("max_target_positions"),
        sot_id=get("decoder_start_token_id", 50258),
        eot_id=get("eos_token_id", 50257),
    )


def load_from_pretrained_dir(path: str | Path) -> tuple[dict, WhisperConfig]:
    """Load an HF checkpoint folder (config.json + model.safetensors)."""
    import json

    path = Path(path)
    hf_cfg = json.loads((path / "config.json").read_text())
    cfg = config_from_hf(hf_cfg)
    from asr_tpu_torch.runtime.artifact import read_safetensors as load_file

    sd: dict[str, np.ndarray] = {}
    for f in sorted(path.glob("model*.safetensors")):
        sd.update(load_file(str(f)))
    params = params_from_state_dict(sd, cfg)
    return params, cfg
