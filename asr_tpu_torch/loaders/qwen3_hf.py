"""Load HF Qwen3-style causal-LM weights into the asr_tpu Qwen3 pytree.

Covers Qwen3ForCausalLM checkpoints and the text half of Qwen3-ASR /
Fun-ASR-Nano (reference mapping knowledge: ``Qwen_ASR/Export_Qwen_ASR.py``
re-implements the HF modeling; names are ``model.layers.N.self_attn.q_proj``
etc., with per-head ``q_norm``/``k_norm`` and gate/up/down MLP)."""

from __future__ import annotations

from typing import Mapping

from asr_tpu_torch.loaders._common import asarray
import numpy as np

from asr_tpu_torch.layers.qwen3 import Qwen3Config


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        return t.detach().cpu().float().numpy()
    return np.asarray(t)


def _lin(sd, key):
    p = {"w": asarray(_np(sd[f"{key}.weight"]).T)}
    if f"{key}.bias" in sd:
        p["b"] = asarray(_np(sd[f"{key}.bias"]))
    return p


def params_from_state_dict(sd: Mapping, cfg: Qwen3Config, prefix: str = "model.") -> dict:
    g = lambda k: prefix + k

    def layer(i):
        p = f"layers.{i}."
        out = {
            "input_norm": {"scale": asarray(_np(sd[g(p + "input_layernorm.weight")]))},
            "attn": {
                "q": _lin(sd, g(p + "self_attn.q_proj")),
                "k": _lin(sd, g(p + "self_attn.k_proj")),
                "v": _lin(sd, g(p + "self_attn.v_proj")),
                "o": _lin(sd, g(p + "self_attn.o_proj")),
            },
            "post_norm": {"scale": asarray(_np(sd[g(p + "post_attention_layernorm.weight")]))},
            "mlp": {
                "gate": _lin(sd, g(p + "mlp.gate_proj")),
                "up": _lin(sd, g(p + "mlp.up_proj")),
                "down": _lin(sd, g(p + "mlp.down_proj")),
            },
        }
        if cfg.qk_norm:
            out["attn"]["q_norm"] = {"scale": asarray(_np(sd[g(p + "self_attn.q_norm.weight")]))}
            out["attn"]["k_norm"] = {"scale": asarray(_np(sd[g(p + "self_attn.k_norm.weight")]))}
        return out

    params = {
        "embed": asarray(_np(sd[g("embed_tokens.weight")])),
        "layers": [layer(i) for i in range(cfg.num_layers)],
        "final_norm": {"scale": asarray(_np(sd[g("norm.weight")]))},
    }
    head_key = prefix.removesuffix("model.") + "lm_head"
    if not cfg.tie_embeddings and f"{head_key}.weight" in sd:
        params["lm_head"] = _lin(sd, head_key)
    return params


def config_from_state_dict(sd: Mapping, prefix: str = "model.", **overrides) -> Qwen3Config:
    """Derive the Qwen3 geometry from checkpoint tensor shapes: head_dim
    from q_norm (per-head RMSNorm width), heads/kv-heads from the q/k
    projection widths, layer count by key census. rope_theta / rms_eps are
    not shape-derivable — pass overrides when the config file is absent."""
    g = lambda k: prefix + k
    vocab, hidden = _np(sd[g("embed_tokens.weight")]).shape
    num_layers = 1 + max(
        int(k[len(prefix) + len("layers."):].split(".")[0])
        for k in sd
        if k.startswith(g("layers."))
    )
    qk = g("layers.0.self_attn.")
    head_dim = (
        _np(sd[qk + "q_norm.weight"]).shape[0]
        if qk + "q_norm.weight" in sd
        else hidden // 16
    )
    num_heads = _np(sd[qk + "q_proj.weight"]).shape[0] // head_dim
    num_kv = _np(sd[qk + "k_proj.weight"]).shape[0] // head_dim
    ffn = _np(sd[g("layers.0.mlp.gate_proj.weight")]).shape[0]
    bare_prefix = prefix.removesuffix("model.")
    kw = dict(
        vocab_size=vocab,
        hidden=hidden,
        num_layers=num_layers,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=head_dim,
        ffn_dim=ffn,
        qk_norm=qk + "q_norm.weight" in sd,
        tie_embeddings=bare_prefix + "lm_head.weight" not in sd,
    )
    kw.update(overrides)
    return Qwen3Config(**kw)


def config_from_hf(hf_config) -> Qwen3Config:
    get = (lambda k, d=None: getattr(hf_config, k, d)) if not isinstance(hf_config, dict) else (
        lambda k, d=None: hf_config.get(k, d)
    )
    return Qwen3Config(
        vocab_size=get("vocab_size"),
        hidden=get("hidden_size"),
        num_layers=get("num_hidden_layers"),
        num_heads=get("num_attention_heads"),
        num_kv_heads=get("num_key_value_heads"),
        head_dim=get("head_dim") or get("hidden_size") // get("num_attention_heads"),
        ffn_dim=get("intermediate_size"),
        rms_eps=get("rms_norm_eps", 1e-6),
        rope_theta=get("rope_theta", 1e6),
        tie_embeddings=bool(get("tie_word_embeddings", True)),
    )
