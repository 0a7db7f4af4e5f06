"""Load FunASR checkpoints (SenseVoice / Paraformer) into asr_tpu_torch pytrees.

The reference loads these via the ``funasr`` package and re-implements the
forward (``SenseVoice/Export_SenseVoice.py:354-370``,
``Paraformer/Non-Streaming/Export_Paraformer.py:567-600``); here we map the
raw ``model.pt`` state dict directly (torch tensors or numpy arrays — the
file can be read with ``torch.load`` without FunASR installed).

Scale conventions folded at load (same exact math the reference folds,
``Export_SenseVoice.py:362-364``):
- FunASR's SinusoidalPositionEncoder multiplies its input by
  ``sqrt(hidden)`` before adding positions. Our models add positions
  directly, so the loader folds ``sqrt(hidden)`` into ``cmvn_istd`` and the
  prompt-embedding rows (SenseVoice) / into ``cmvn_istd`` (Paraformer).
- CMVN means/istd come from the checkpoint's ``am.mvn`` Kaldi file
  (``parse_kaldi_mvn``).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Mapping

from asr_tpu_torch.loaders._common import asarray
import numpy as np

from asr_tpu_torch.models.paraformer import ParaformerConfig
from asr_tpu_torch.models.sensevoice import SenseVoiceConfig


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        return t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def _lin(sd, key):
    p = {"w": asarray(_np(sd[f"{key}.weight"]).T)}
    if f"{key}.bias" in sd:
        p["b"] = asarray(_np(sd[f"{key}.bias"]))
    return p


def _norm(sd, key):
    return {"scale": asarray(_np(sd[f"{key}.weight"])),
            "bias": asarray(_np(sd[f"{key}.bias"]))}


def parse_kaldi_mvn(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """Parse a Kaldi ``am.mvn`` global-CMVN file -> (neg_means, istd)
    exactly as FunASR's WavFrontend consumes it (add-shift then re-scale)."""
    text = Path(path).read_text()
    floats = [np.fromstring(row, dtype=np.float64, sep=" ")
              for row in re.findall(r"\[([^\[\]]+)\]", text)]
    arrays = [a for a in floats if a.size > 1]
    if len(arrays) < 2:
        raise ValueError(f"unrecognized mvn file: {path}")
    # FunASR layout: first vector = -mean * scale? The stored AddShift row is
    # the negated mean; the Rescale row is 1/stddev.
    neg_means, istd = arrays[0][: arrays[0].size], arrays[1][: arrays[1].size]
    n = min(len(neg_means), len(istd))
    return neg_means[:n].astype(np.float32), istd[:n].astype(np.float32)


def _sanm_block(sd, prefix):
    fsmn = _np(sd[f"{prefix}.self_attn.fsmn_block.weight"])  # (hidden, 1, K)
    return {
        "norm1": _norm(sd, f"{prefix}.norm1"),
        "qkv": _lin(sd, f"{prefix}.self_attn.linear_q_k_v"),
        "fsmn_w": asarray(fsmn[:, 0, :].T),  # (K, hidden)
        "out": _lin(sd, f"{prefix}.self_attn.linear_out"),
        "norm2": _norm(sd, f"{prefix}.norm2"),
        "ffn": {
            "w1": asarray(_np(sd[f"{prefix}.feed_forward.w_1.weight"]).T),
            "b1": asarray(_np(sd[f"{prefix}.feed_forward.w_1.bias"])),
            "w2": asarray(_np(sd[f"{prefix}.feed_forward.w_2.weight"]).T),
            "b2": asarray(_np(sd[f"{prefix}.feed_forward.w_2.bias"])),
        },
    }


def _count_layers(sd: Mapping, pattern: str) -> int:
    n = 0
    while f"{pattern}.{n}.norm1.weight" in sd:
        n += 1
    return n


def sensevoice_config_from_state_dict(sd: Mapping, **overrides) -> SenseVoiceConfig:
    """Derive SenseVoice geometry from checkpoint shapes (layer counts,
    hidden/ffn widths, fsmn kernel, vocab; head count is not
    shape-derivable — override if a variant differs from SenseVoiceSmall)."""
    kw = dict(
        vocab_size=_np(sd["ctc.ctc_lo.weight"]).shape[0],
        hidden=_np(sd["encoder.encoders.0.norm2.weight"]).shape[0],
        ffn_dim=_np(sd["encoder.encoders.0.feed_forward.w_1.weight"]).shape[0],
        num_encoders0=_count_layers(sd, "encoder.encoders0"),
        num_encoders=_count_layers(sd, "encoder.encoders"),
        num_tp_encoders=_count_layers(sd, "encoder.tp_encoders"),
        fsmn_kernel=_np(sd["encoder.encoders.0.self_attn.fsmn_block.weight"]).shape[-1],
    )
    kw.update(overrides)
    return SenseVoiceConfig(**kw)


def paraformer_config_from_state_dict(sd: Mapping, **overrides) -> ParaformerConfig:
    """Derive Paraformer geometry from checkpoint shapes — the reference
    auto-detects the zh/en profile the same way
    (``Export_Paraformer.py:41-59``)."""
    kw = dict(
        vocab_size=_np(sd["decoder.output_layer.weight"]).shape[0],
        hidden=_np(sd["encoder.encoders.0.norm2.weight"]).shape[0],
        ffn_dim=_np(sd["encoder.encoders.0.feed_forward.w_1.weight"]).shape[0],
        num_encoders0=_count_layers(sd, "encoder.encoders0"),
        num_encoders=_count_layers(sd, "encoder.encoders"),
        num_decoders=_count_layers(sd, "decoder.decoders"),
        num_decoder_ffn=_count_layers(sd, "decoder.decoders3"),
        fsmn_kernel=_np(sd["encoder.encoders.0.self_attn.fsmn_block.weight"]).shape[-1],
    )
    kw.update(overrides)
    return ParaformerConfig(**kw)


def sensevoice_params_from_state_dict(
    sd: Mapping,
    cfg: SenseVoiceConfig,
    neg_means: np.ndarray,
    istd: np.ndarray,
) -> dict:
    """Map a FunASR SenseVoiceSmall ``model.pt`` state dict.

    ``neg_means``/``istd``: per-LFR-feature CMVN from ``am.mvn`` (already
    negated means / inverse stddev, width = n_mels * lfr_m).
    """
    scale = cfg.hidden ** 0.5  # SinusoidalPositionEncoder input scale fold
    embed = _np(sd["embed.weight"])  # prompt-token embedding table
    from asr_tpu_torch.models.sensevoice import LANGUAGE_PROFILES

    lang_rows = np.stack([embed[tok] for _, _, _, tok in LANGUAGE_PROFILES])
    sys_rows = np.stack([embed[t] for t in cfg.system_prompt_ids])
    return {
        "cmvn_means": asarray(neg_means),
        "cmvn_istd": asarray(istd * scale),
        "language_embed": asarray(lang_rows * scale),
        "system_embed": asarray(sys_rows * scale),
        "encoders0": [_sanm_block(sd, f"encoder.encoders0.{i}")
                      for i in range(_count_layers(sd, "encoder.encoders0"))],
        "encoders": [_sanm_block(sd, f"encoder.encoders.{i}")
                     for i in range(_count_layers(sd, "encoder.encoders"))],
        "tp_encoders": [_sanm_block(sd, f"encoder.tp_encoders.{i}")
                        for i in range(_count_layers(sd, "encoder.tp_encoders"))],
        "after_norm": _norm(sd, "encoder.after_norm"),
        "tp_norm": _norm(sd, "encoder.tp_norm"),
        "ctc": _lin(sd, "ctc.ctc_lo"),
    }


def paraformer_params_from_state_dict(
    sd: Mapping,
    cfg: ParaformerConfig,
    neg_means: np.ndarray,
    istd: np.ndarray,
) -> dict:
    """Map a FunASR Paraformer (non-streaming) state dict."""
    scale = cfg.hidden ** 0.5

    def dec_block(prefix):
        fsmn = _np(sd[f"{prefix}.self_attn.fsmn_block.weight"])
        return {
            "norm1": _norm(sd, f"{prefix}.norm1"),
            "ffn": {
                "w1": _lin(sd, f"{prefix}.feed_forward.w_1"),
                "norm": _norm(sd, f"{prefix}.feed_forward.norm"),
                "w2": _lin(sd, f"{prefix}.feed_forward.w_2"),
            },
            "norm2": _norm(sd, f"{prefix}.norm2"),
            "fsmn_w": asarray(fsmn[:, 0, :].T),
            "norm3": _norm(sd, f"{prefix}.norm3"),
            "cross": {
                "q": _lin(sd, f"{prefix}.src_attn.linear_q"),
                "kv": _lin(sd, f"{prefix}.src_attn.linear_k_v"),
                "out": _lin(sd, f"{prefix}.src_attn.linear_out"),
            },
        }

    n_dec = _count_layers(sd, "decoder.decoders")
    n_dec3 = _count_layers(sd, "decoder.decoders3")
    return {
        "cmvn_means": asarray(neg_means),
        "cmvn_istd": asarray(istd * scale),
        "encoders0": [_sanm_block(sd, f"encoder.encoders0.{i}")
                      for i in range(_count_layers(sd, "encoder.encoders0"))],
        "encoders": [_sanm_block(sd, f"encoder.encoders.{i}")
                     for i in range(_count_layers(sd, "encoder.encoders"))],
        "after_norm": _norm(sd, "encoder.after_norm"),
        "predictor": {
            "conv": {
                # torch Conv1d (hidden, hidden, K) -> HIO (K, hidden, hidden)
                "w": asarray(_np(sd["predictor.cif_conv1d.weight"]).transpose(2, 1, 0)),
                "b": asarray(_np(sd["predictor.cif_conv1d.bias"])),
            },
            "out": _lin(sd, "predictor.cif_output"),
        },
        "decoders": [dec_block(f"decoder.decoders.{i}") for i in range(n_dec)],
        "decoder_ffn": [
            {"norm1": _norm(sd, f"decoder.decoders3.{i}.norm1"),
             "ffn": {
                 "w1": _lin(sd, f"decoder.decoders3.{i}.feed_forward.w_1"),
                 "norm": _norm(sd, f"decoder.decoders3.{i}.feed_forward.norm"),
                 "w2": _lin(sd, f"decoder.decoders3.{i}.feed_forward.w_2"),
             }}
            for i in range(n_dec3)
        ],
        "decoder_after_norm": _norm(sd, "decoder.after_norm"),
        "output": _lin(sd, "decoder.output_layer"),
    }


def _mha_adaptor_block(sd: Mapping, prefix: str) -> dict:
    """Transformer-adaptor block (Fun-ASR-Nano audio_adaptor / ctc_decoder):
    unfused ``linear_q/k/v`` in the checkpoint are concatenated into the one
    qkv our ``_adaptor_block`` consumes (same exact fusion the exporter does,
    ``Export_Fun_ASR_Nano.py:669-690`` minus the scale folds — scaling stays
    explicit in our attention)."""
    q_w = _np(sd[f"{prefix}.self_attn.linear_q.weight"])
    k_w = _np(sd[f"{prefix}.self_attn.linear_k.weight"])
    v_w = _np(sd[f"{prefix}.self_attn.linear_v.weight"])
    q_b = _np(sd[f"{prefix}.self_attn.linear_q.bias"])
    k_b = _np(sd[f"{prefix}.self_attn.linear_k.bias"])
    v_b = _np(sd[f"{prefix}.self_attn.linear_v.bias"])
    return {
        "norm1": _norm(sd, f"{prefix}.norm1"),
        "qkv": {
            "w": asarray(np.concatenate([q_w, k_w, v_w], axis=0).T),
            "b": asarray(np.concatenate([q_b, k_b, v_b])),
        },
        "out": _lin(sd, f"{prefix}.self_attn.linear_out"),
        "norm2": _norm(sd, f"{prefix}.norm2"),
        "ffn": {
            "w1": _lin(sd, f"{prefix}.feed_forward.w_1"),
            "w2": _lin(sd, f"{prefix}.feed_forward.w_2"),
        },
    }


def fun_asr_nano_params_from_state_dict(sd: Mapping, cfg) -> dict:
    """Map a Fun-ASR-Nano ``model.pt`` state dict (FunASR layout,
    ``Export_Fun_ASR_Nano.py:517-640`` module tree) to the
    ``models.fun_asr_nano`` encoder/adaptor/CTC pytree. The LLM half loads
    separately via ``qwen3_hf.params_from_state_dict(sd, cfg.llm,
    prefix="llm.model.")``."""

    def stack(name: str, count: int) -> list:
        return [_sanm_block(sd, f"audio_encoder.{name}.{i}") for i in range(count)]

    def blocks(base: str) -> list:
        out = []
        i = 0
        while f"{base}.blocks.{i}.norm1.weight" in sd:
            out.append(_mha_adaptor_block(sd, f"{base}.blocks.{i}"))
            i += 1
        return out

    return {
        "encoders0": stack("encoders0", cfg.num_encoders0),
        "encoders": stack("encoders", cfg.num_encoders),
        "tp_encoders": stack("tp_encoders", cfg.num_tp_encoders),
        "after_norm": _norm(sd, "audio_encoder.after_norm"),
        "tp_norm": _norm(sd, "audio_encoder.tp_norm"),
        "adaptor": {
            "linear1": _lin(sd, "audio_adaptor.linear1"),
            "linear2": _lin(sd, "audio_adaptor.linear2"),
            "blocks": blocks("audio_adaptor"),
        },
        "ctc": {
            "linear1": _lin(sd, "ctc_decoder.linear1"),
            "linear2": _lin(sd, "ctc_decoder.linear2"),
            "blocks": blocks("ctc_decoder"),
            "lo": _lin(sd, "ctc.ctc_lo"),
        },
    }


def fun_asr_nano_config_from_state_dict(sd: Mapping, **overrides):
    """Derive FunAsrNanoConfig geometry from checkpoint shapes (encoder
    widths/counts, adaptor/CTC blocks, CTC vocab, Qwen3 LLM via
    ``qwen3_hf.config_from_state_dict``)."""
    from asr_tpu_torch.loaders.qwen3_hf import config_from_state_dict
    from asr_tpu_torch.models.fun_asr_nano import FunAsrNanoConfig

    hidden = _np(sd["audio_encoder.encoders.0.norm2.weight"]).shape[0]
    feature_size = _np(sd["audio_encoder.encoders0.0.norm1.weight"]).shape[0]
    base = FunAsrNanoConfig()
    kw = dict(
        hidden=hidden,
        ffn_dim=_np(sd["audio_encoder.encoders.0.feed_forward.w_1.weight"]).shape[0],
        num_encoders0=_count_layers(sd, "audio_encoder.encoders0"),
        num_encoders=_count_layers(sd, "audio_encoder.encoders"),
        num_tp_encoders=_count_layers(sd, "audio_encoder.tp_encoders"),
        fsmn_kernel=_np(sd["audio_encoder.encoders.0.self_attn.fsmn_block.weight"]).shape[-1],
        lfr_m=feature_size // base.n_mels,
        adaptor_hidden=_np(sd["audio_adaptor.linear1.weight"]).shape[0],
        adaptor_ffn=_np(sd["audio_adaptor.blocks.0.feed_forward.w_1.weight"]).shape[0],
        adaptor_blocks=sum(1 for k in sd if re.fullmatch(r"audio_adaptor\.blocks\.\d+\.norm1\.weight", k)),
        ctc_hidden=_np(sd["ctc_decoder.linear1.weight"]).shape[0],
        ctc_ffn=_np(sd["ctc_decoder.blocks.0.feed_forward.w_1.weight"]).shape[0],
        ctc_blocks=sum(1 for k in sd if re.fullmatch(r"ctc_decoder\.blocks\.\d+\.norm1\.weight", k)),
        ctc_vocab=_np(sd["ctc.ctc_lo.weight"]).shape[0],
        llm=config_from_state_dict(sd, prefix="llm.model."),
    )
    kw.update(overrides)
    return FunAsrNanoConfig(**kw)


def load_checkpoint_file(path: str | Path) -> dict:
    """torch.load a FunASR ``model.pt`` without needing funasr installed."""
    import torch

    ckpt = torch.load(str(path), map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return {k.removeprefix("model."): v for k, v in ckpt.items()}
