"""Load Qwen3-ASR / Qwen3-ForcedAligner HF checkpoints into asr_tpu_torch pytrees.

The reference re-implements the HF modeling standalone and registers it with
AutoModel (``Qwen_ASR/Export_Qwen_ASR.py:145-517``; aligner variant
``Qwen_ForcedAligner/Export_Qwen_ForcedAligner.py:531-583``). The module
tree gives the safetensors names:

- audio tower ``thinker.audio_tower.``: conv2d1/2/3 (k3 s2 p1),
  conv_out (no bias), layers.N.{self_attn.{q,k,v,out}_proj,
  self_attn_layer_norm, fc1, fc2, final_layer_norm}, ln_post, proj1, proj2
  (sinusoid position table is a non-persistent buffer — recomputed);
- text ``thinker.model.`` (Qwen3 layout, loaded via ``loaders.qwen3_hf``)
  plus ``thinker.lm_head.weight`` — for the aligner the lm_head is the
  ``classify_num``-bucket timestamp head (untied,
  ``Export_Qwen_ForcedAligner.py:546``).

No weight folds: the exporter's qkv fusion / LN-affine absorption /
sqrt(scale) splits re-express the same math XLA fuses at runtime.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping

import numpy as np
from asr_tpu_torch.loaders._common import asarray

from asr_tpu_torch.layers.qwen3 import Qwen3Config
from asr_tpu_torch.loaders import qwen3_hf
from asr_tpu_torch.models.qwen_asr import QwenAsrConfig


from asr_tpu_torch.loaders._common import conv2d_hwio as _conv2d, lin as _lin, ln as _ln, to_np as _np


def strip_thinker_prefix(sd: Mapping[str, Any]) -> dict:
    """``thinker.audio_tower.X`` -> ``audio_tower.X`` etc. (idempotent)."""
    if any(k.startswith("thinker.") for k in sd):
        return {k[len("thinker."):]: v for k, v in sd.items() if k.startswith("thinker.")}
    return dict(sd)


def tower_params_from_state_dict(
    sd: Mapping[str, Any], cfg: QwenAsrConfig, prefix: str = "audio_tower."
) -> dict:
    """Map the audio-tower half to the ``models.qwen_asr`` tower pytree."""
    g = lambda k: prefix + k

    def block(i: int) -> dict:
        p = f"layers.{i}."
        return {
            "ln1": _ln(sd, g(p + "self_attn_layer_norm")),
            "attn": {
                "q": _lin(sd, g(p + "self_attn.q_proj")),
                "k": _lin(sd, g(p + "self_attn.k_proj")),
                "v": _lin(sd, g(p + "self_attn.v_proj")),
                "o": _lin(sd, g(p + "self_attn.out_proj")),
            },
            "ln2": _ln(sd, g(p + "final_layer_norm")),
            "mlp": {"fc1": _lin(sd, g(p + "fc1")), "fc2": _lin(sd, g(p + "fc2"))},
        }

    return {
        "conv1": _conv2d(sd, g("conv2d1")),
        "conv2": _conv2d(sd, g("conv2d2")),
        "conv3": _conv2d(sd, g("conv2d3")),
        "conv_out": _lin(sd, g("conv_out")),
        "blocks": [block(i) for i in range(cfg.tower_layers)],
        "ln_post": _ln(sd, g("ln_post")),
        "proj1": _lin(sd, g("proj1")),
        "proj2": _lin(sd, g("proj2")),
    }


def config_from_hf_dir(checkpoint_dir: str | Path, **overrides) -> QwenAsrConfig:
    """Build QwenAsrConfig from the checkpoint's ``config.json``
    (``thinker_config.audio_config`` + ``text_config``)."""
    cfg_json = json.loads((Path(checkpoint_dir) / "config.json").read_text())
    thinker = cfg_json.get("thinker_config", cfg_json)
    audio = thinker.get("audio_config", {})
    text = thinker.get("text_config", {})
    llm = qwen3_hf.config_from_hf(text)
    chunk = int(audio.get("n_window", 50)) * 2  # mel frames per conv chunk (=100)
    kw = dict(
        n_mels=audio.get("num_mel_bins", 128),
        tower_dim=audio.get("d_model", 1280),
        tower_layers=audio.get("encoder_layers", 32),
        tower_heads=audio.get("encoder_attention_heads", 20),
        tower_ffn=audio.get("encoder_ffn_dim", 5120),
        downsample_hidden=audio.get("downsample_hidden_size", 480),
        chunk_frames=chunk,
        chunks_per_window=int(audio.get("n_window_infer", 400)) // chunk,
        output_dim=audio.get("output_dim", llm.hidden),
        llm=llm,
    )
    kw.update(overrides)
    return QwenAsrConfig(**kw)


def _read_safetensors_dir(checkpoint_dir: Path) -> dict:
    from asr_tpu_torch.runtime.artifact import read_safetensors as load_file

    sd: dict = {}
    for f in sorted(checkpoint_dir.glob("*.safetensors")):
        sd.update(load_file(str(f)))
    if not sd:
        raise FileNotFoundError(f"no *.safetensors under {checkpoint_dir}")
    return sd


def load_qwen_asr_dir(
    checkpoint_dir: str | Path,
) -> tuple[dict, dict, QwenAsrConfig]:
    """HF Qwen3-ASR snapshot dir -> (tower_params, llm_params, cfg)."""
    checkpoint_dir = Path(checkpoint_dir)
    cfg = config_from_hf_dir(checkpoint_dir)
    sd = strip_thinker_prefix(_read_safetensors_dir(checkpoint_dir))
    tower = tower_params_from_state_dict(sd, cfg)
    llm = qwen3_hf.params_from_state_dict(sd, cfg.llm, prefix="model.")
    if not cfg.llm.tie_embeddings and "lm_head.weight" in sd:
        llm["lm_head"] = _lin(sd, "lm_head")
    return tower, llm, cfg


def load_aligner_dir(
    checkpoint_dir: str | Path, segment_ms: int = 80
) -> tuple[dict, dict, dict, "Any"]:
    """HF Qwen3-ForcedAligner snapshot -> (tower_params, llm_params,
    classify head, ForcedAlignerConfig). The lm_head IS the timestamp
    classifier (classify_num buckets, untied)."""
    from asr_tpu_torch.models.forced_aligner import ForcedAlignerConfig

    checkpoint_dir = Path(checkpoint_dir)
    asr_cfg = config_from_hf_dir(checkpoint_dir)
    sd = strip_thinker_prefix(_read_safetensors_dir(checkpoint_dir))
    tower = tower_params_from_state_dict(sd, asr_cfg)
    llm = qwen3_hf.params_from_state_dict(sd, asr_cfg.llm, prefix="model.")
    head = _lin(sd, "lm_head")
    classify_num = head["w"].shape[1]
    cfg = ForcedAlignerConfig(asr=asr_cfg, classify_num=classify_num, segment_ms=segment_ms)
    return tower, llm, head, cfg
