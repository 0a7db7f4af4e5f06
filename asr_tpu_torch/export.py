"""Checkpoint -> artifact-folder builders (the reference's Export_*.py analog).

Each builder loads a source checkpoint directly into a pytree, stamps the
family's metadata contract (sample_rate, pcm scale, special tokens,
language catalog — reference ``SenseVoice/Export_SenseVoice.py:311-351``),
copies tokenizer assets, and writes a self-describing folder that
``asr_tpu_torch.cli`` / the sessions consume. No ONNX, no graph surgery: the
"export" is a name-mapped weight load plus metadata.
"""

from __future__ import annotations

import dataclasses
import shutil
from pathlib import Path

from asr_tpu_torch.runtime.artifact import save_model
from asr_tpu_torch.runtime.metadata import LanguageProfile, ModelMetadata


def _config_dict(cfg) -> dict:
    """Serializable config dict for ``meta.extra["config"]``: drop the
    derived ``fbank`` sub-config (reconstructed from the model config at
    load time, not stored)."""
    d = dataclasses.asdict(cfg)
    d.pop("fbank", None)
    return d


def _copy_asset(src_dir: Path, name: str, dst_dir: Path) -> str | None:
    src = src_dir / name
    if src.exists():
        shutil.copy2(src, dst_dir / name)
        return name
    return None


def build_sensevoice_artifact(
    checkpoint_dir: str | Path, out_dir: str | Path, cfg=None
) -> Path:
    """FunASR SenseVoiceSmall folder (model.pt + am.mvn + *.bpe.model) ->
    artifact."""
    from asr_tpu_torch.loaders import funasr
    from asr_tpu_torch.models.sensevoice import LANGUAGE_PROFILES, SenseVoiceConfig

    checkpoint_dir = Path(checkpoint_dir)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    sd = funasr.load_checkpoint_file(checkpoint_dir / "model.pt")
    cfg = cfg or funasr.sensevoice_config_from_state_dict(sd)
    neg_means, istd = funasr.parse_kaldi_mvn(checkpoint_dir / "am.mvn")
    params = funasr.sensevoice_params_from_state_dict(sd, cfg, neg_means, istd)

    tok_file = None
    for cand in checkpoint_dir.glob("*.bpe.model"):
        tok_file = _copy_asset(checkpoint_dir, cand.name, out_dir)
        break
    meta = ModelMetadata(
        family="sensevoice",
        sample_rate=cfg.sample_rate,
        audio_pcm_scale=32768.0,
        special_token_ids={"blank": cfg.blank_id},
        supported_languages=[
            LanguageProfile(code, desc, tuple(aliases), tok, i)
            for i, (code, desc, aliases, tok) in enumerate(LANGUAGE_PROFILES)
        ],
        tokenizer={"kind": "sentencepiece", "file": tok_file or ""},
        extra={"config": _config_dict(cfg)},
    )
    save_model(out_dir, params, meta)
    return out_dir


def build_whisper_artifact(checkpoint_dir: str | Path, out_dir: str | Path) -> Path:
    """HF Whisper snapshot (config.json + model.safetensors + tokenizer.json
    + generation_config.json) -> artifact."""
    import json

    from asr_tpu_torch.loaders.whisper_hf import load_from_pretrained_dir

    checkpoint_dir = Path(checkpoint_dir)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    params, cfg = load_from_pretrained_dir(checkpoint_dir)

    special = {"sot": cfg.sot_id, "eot": cfg.eot_id}
    suppress: list[int] = []
    begin_suppress: list[int] = []
    lang_map: dict[str, int] = {}
    gen_path = checkpoint_dir / "generation_config.json"
    if gen_path.exists():
        gen = json.loads(gen_path.read_text())
        suppress = list(gen.get("suppress_tokens", []) or [])
        begin_suppress = list(gen.get("begin_suppress_tokens", []) or [])
        lang_map = {
            code.strip("<|>"): int(tok)
            for code, tok in (gen.get("lang_to_id") or {}).items()
        }
        for key in ("no_timestamps_token_id", "no_speech_token_id"):
            if gen.get(key) is not None:
                special[key.removesuffix("_token_id")] = int(gen[key])
        task_map = gen.get("task_to_id") or {}
        for task, tok in task_map.items():
            special[task] = int(tok)
    tok_file = _copy_asset(checkpoint_dir, "tokenizer.json", out_dir)
    meta = ModelMetadata(
        family="whisper",
        sample_rate=cfg.sample_rate,
        audio_pcm_scale=1.0,
        special_token_ids=special,
        supported_languages=[
            LanguageProfile(code, code, (), tok) for code, tok in sorted(lang_map.items())
        ],
        max_seq_len=cfg.max_target_positions,
        tokenizer={"kind": "hf", "file": tok_file or ""},
        extra={
            "config": dataclasses.asdict(cfg),
            "suppress_tokens": suppress,
            "begin_suppress_tokens": begin_suppress,
        },
    )
    save_model(out_dir, params, meta)
    return out_dir


def build_paraformer_artifact(
    checkpoint_dir: str | Path, out_dir: str | Path, cfg=None,
    decode_mode: str = "zh", streaming: bool = False,
) -> Path:
    """FunASR Paraformer folder (model.pt + am.mvn + vocab txt) -> artifact.

    Mirrors the reference export entry points
    (``Paraformer/Non-Streaming/Export_Paraformer.py`` and the streaming
    variant): one weight map serves both; ``streaming=True`` stamps the
    streaming family so the CLI builds a chunked session."""
    from asr_tpu_torch.loaders import funasr
    from asr_tpu_torch.models.paraformer import ParaformerConfig

    checkpoint_dir = Path(checkpoint_dir)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    sd = funasr.load_checkpoint_file(checkpoint_dir / "model.pt")
    cfg = cfg or funasr.paraformer_config_from_state_dict(sd)
    neg_means, istd = funasr.parse_kaldi_mvn(checkpoint_dir / "am.mvn")
    params = funasr.paraformer_params_from_state_dict(sd, cfg, neg_means, istd)

    tok_file = None
    for name in ("tokens.txt", "vocab.txt", "tokens.json"):
        tok_file = _copy_asset(checkpoint_dir, name, out_dir)
        if tok_file:
            break
    meta = ModelMetadata(
        family="paraformer_streaming" if streaming else "paraformer",
        sample_rate=cfg.sample_rate,
        audio_pcm_scale=32768.0,
        special_token_ids={"blank": 0, "sos": 1, "eos": 2},
        tokenizer={"kind": "vocab_txt", "file": tok_file or ""},
        extra={"config": dataclasses.asdict(cfg), "decode_mode": decode_mode},
    )
    save_model(out_dir, params, meta)
    return out_dir


# English / native-name aliases for Dolphin's 2-level language tokens
# (factual ISO-639-style name table; only codes actually present in the
# artifact's vocab are stamped). "ct" is Dolphin's Cantonese/Yue code.
DOLPHIN_LANGUAGE_NAMES = {
    "zh": ("Chinese", "Mandarin", "中文", "普通话"),
    "ct": ("Cantonese", "Yue", "粤语", "粵語"),
    "ja": ("Japanese", "日本語"),
    "ko": ("Korean", "한국어"),
    "th": ("Thai",), "vi": ("Vietnamese",), "id": ("Indonesian",),
    "ms": ("Malay",), "ta": ("Tamil",), "te": ("Telugu",),
    "ur": ("Urdu",), "hi": ("Hindi",), "bn": ("Bengali",),
    "ar": ("Arabic",), "fa": ("Persian", "Farsi"), "ru": ("Russian",),
    "kk": ("Kazakh",), "ky": ("Kyrgyz",), "uz": ("Uzbek",),
    "tg": ("Tajik",), "mn": ("Mongolian",), "bo": ("Tibetan",),
    "ug": ("Uighur", "Uyghur"), "my": ("Burmese", "Myanmar"),
    "km": ("Khmer",), "lo": ("Lao",), "ne": ("Nepali",),
    "si": ("Sinhala",), "pa": ("Punjabi",), "gu": ("Gujarati",),
    "or": ("Odia", "Oriya"), "kn": ("Kannada",), "ml": ("Malayalam",),
    "mr": ("Marathi",), "as": ("Assamese",), "tl": ("Tagalog", "Filipino"),
    "jv": ("Javanese",), "su": ("Sundanese",), "ps": ("Pashto",),
    "az": ("Azerbaijani",), "en": ("English",),
}


def dolphin_language_catalog(tokens: list[str]) -> dict | None:
    """Scan a Dolphin vocab for the 2-level language/region token catalog.

    Reference semantics (``Dolphin/v1/Export_Dolphin.py:999-1046``):
    language tokens are ``<xx>`` (lowercase body) in the id range
    ``(<asr> + 1, <notimestamp>)``; region tokens are ``<XX>`` (uppercase
    body) in the same range, starting where the first uppercase body
    appears. Returns ``{"languages": {code: id}, "regions": {code: id},
    "asr_id": int, "notimestamp_id": int, "aliases": {name: code}}`` or
    None when the vocab has no such structure."""
    tok_to_id = {t: i for i, t in enumerate(tokens)}
    asr_id = tok_to_id.get("<asr>")
    nots_id = tok_to_id.get("<notimestamp>")
    if asr_id is None or nots_id is None or nots_id <= asr_id + 1:
        return None
    languages: dict[str, int] = {}
    regions: dict[str, int] = {}
    for i in range(asr_id + 1, nots_id):
        t = tokens[i]
        if len(t) < 3 or t[0] != "<" or t[-1] != ">":
            continue
        body = t[1:-1]
        if body.upper() == body and body.lower() != body:
            regions[body] = i
        elif body.lower() == body:
            languages[body] = i
    if not languages:
        return None
    aliases = {}
    for code in languages:
        for name in DOLPHIN_LANGUAGE_NAMES.get(code, ()):
            aliases[name] = code
    return {"languages": languages, "regions": regions,
            "asr_id": asr_id, "notimestamp_id": nots_id, "aliases": aliases}


def build_dolphin_artifact(
    checkpoint_path: str | Path, out_dir: str | Path, cfg=None,
    vocab_path: str | Path | None = None, streaming: bool = False,
) -> Path:
    """espnet Dolphin checkpoint (.pt state dict) -> artifact (reference
    ``Dolphin/v1/Export_Dolphin.py`` / CN-Dialect variants;
    ``streaming=True`` stamps the CN-Dialect-Streaming family — same espnet
    module tree, causal-CSGU/chunk-trained weights, reference
    ``Export_Dolphin_CN_Dialect_Streaming.py:254-305``)."""
    import torch

    from asr_tpu_torch.loaders.dolphin_espnet import params_from_state_dict
    from asr_tpu_torch.models.dolphin import DolphinConfig

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if streaming and cfg is not None and hasattr(cfg, "base"):
        stream_cfg, cfg = cfg, cfg.base
    else:
        stream_cfg = None
        cfg = cfg or DolphinConfig()
    ckpt = torch.load(checkpoint_path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt.get("state_dict", ckpt))
    params = params_from_state_dict(sd, cfg)

    tok_file = None
    catalog = None
    if vocab_path is not None:
        tok_file = _copy_asset(Path(vocab_path).parent, Path(vocab_path).name, out_dir)
        tokens = Path(vocab_path).read_text(encoding="utf-8").splitlines()
        catalog = dolphin_language_catalog(tokens)
    if streaming:
        from asr_tpu_torch.streaming.dolphin_stream import DolphinStreamConfig

        stream_cfg = stream_cfg or DolphinStreamConfig(base=cfg)
        cfg_dict = _config_dict(stream_cfg)
    else:
        cfg_dict = dataclasses.asdict(cfg)
    special = {"sos": cfg.sos_id, "eos": cfg.eos_id}
    extra = {"config": cfg_dict}
    if catalog is not None:
        special["asr"] = catalog["asr_id"]
        special["notimestamp"] = catalog["notimestamp_id"]
        # named 2-level language forcing: session/CLI resolve --language
        # "ja" / "Chinese-Sichuan" through this (reference stamps the same
        # catalog in metadata_props, Export_Dolphin.py:999-1046)
        extra["dolphin_language_catalog"] = catalog
    meta = ModelMetadata(
        family="dolphin_streaming" if streaming else "dolphin",
        sample_rate=cfg.sample_rate,
        audio_pcm_scale=32768.0,
        special_token_ids=special,
        tokenizer={"kind": "vocab_txt", "file": tok_file or ""},
        extra=extra,
    )
    save_model(out_dir, params, meta)
    return out_dir


def build_nemotron_artifact(
    nemo_path: str | Path, out_dir: str | Path, streaming: bool = False,
    chunk_ms: float = 560.0, cfg=None,
) -> Path:
    """Nemotron ``.nemo`` archive -> artifact, offline or cache-aware
    streaming (reference ``Nemotron/Export_Nemotron_ASR.py``: same weights,
    att-context pair selected by mode, ``:96-152``)."""
    from asr_tpu_torch.loaders import nemotron_nemo as nn_loader

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    sd, cfg_yaml, assets = nn_loader.read_nemo_archive(nemo_path, out_dir)
    cfg = cfg or nn_loader.config_from_model_config(
        cfg_yaml, chunk_ms=chunk_ms if streaming else 0
    )
    params = nn_loader.nemotron_params_from_state_dict(sd, cfg)

    tok_file = None
    tok_path = assets.get("tokenizer_model")
    if tok_path is not None and Path(tok_path).exists():
        tok_file = Path(tok_path).name
    # Language catalog from the prompt dictionary (reference :895-917).
    prompt_dict = cfg_yaml.get("model_defaults", {}).get("prompt_dictionary", {}) or {}
    grouped: dict[int, list[str]] = {}
    for spelling, pid in prompt_dict.items():
        grouped.setdefault(int(pid), []).append(spelling)
    languages = []
    for pid, spellings in sorted(grouped.items()):
        canonical = next((s for s in spellings if s == "auto"),
                         next((s for s in spellings if "-" in s), spellings[0]))
        aliases = tuple(sorted(s for s in spellings if s != canonical))
        languages.append(LanguageProfile(canonical, canonical, aliases, pid))
    # Temporary extraction artifacts stay (ckpt/yaml are the provenance), but
    # the heavyweight ckpt is redundant next to the saved pytree — drop it.
    ckpt_path = assets.get("ckpt")
    if ckpt_path is not None and Path(ckpt_path).exists():
        Path(ckpt_path).unlink()
    meta = ModelMetadata(
        family="nemotron_streaming" if streaming else "nemotron",
        sample_rate=cfg.sample_rate,
        audio_pcm_scale=32768.0,
        special_token_ids={"blank": cfg.blank_id},
        supported_languages=languages,
        tokenizer={"kind": "sentencepiece", "file": tok_file or ""},
        extra={"config": dataclasses.asdict(cfg) | {"mel": dataclasses.asdict(cfg.mel)}},
    )
    save_model(out_dir, params, meta)
    return out_dir


def build_xasr_artifact(
    checkpoint_path: str | Path, out_dir: str | Path, cfg=None,
    weight_key: str = "model_avg", bpe_model: str | Path | None = None,
) -> Path:
    """icefall Zipformer2 checkpoint (.pt) -> X-ASR streaming artifact.

    Mirrors reference ``X-ASR/Export_X_ASR.py:22-25,157-167``: reads
    ``ckpt[weight_key]`` (``model_avg`` = icefall's averaged weights) and
    bakes the fixed streaming geometry (pos tables, fused convs) for
    ``cfg.chunk_size``/``cfg.left_context_frames``."""
    import torch

    from asr_tpu_torch.loaders.zipformer_icefall import zipformer_params_from_state_dict
    from asr_tpu_torch.models.zipformer import ZipformerConfig

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg = cfg or ZipformerConfig()
    ckpt = torch.load(checkpoint_path, map_location="cpu", weights_only=False)
    sd = ckpt.get(weight_key, ckpt.get("model", ckpt))
    sd = {k: v.numpy() if hasattr(v, "numpy") else v for k, v in sd.items()}
    params = zipformer_params_from_state_dict(sd, cfg)

    tok_file = None
    if bpe_model is not None:
        tok_file = _copy_asset(Path(bpe_model).parent, Path(bpe_model).name, out_dir)
    meta = ModelMetadata(
        family="x_asr",
        sample_rate=cfg.fbank.sample_rate,
        audio_pcm_scale=32768.0,
        special_token_ids={"blank": cfg.blank_id},
        tokenizer={"kind": "sentencepiece", "file": tok_file or ""},
        extra={"config": dataclasses.asdict(cfg)},
    )
    save_model(out_dir, params, meta)
    return out_dir


# Language name -> (code, aliases) catalog shared by the Qwen exporters
# (factual table, reference ``Qwen_ASR/Export_Qwen_ASR.py:1460-1507`` /
# ``Qwen_ForcedAligner/Export_Qwen_ForcedAligner.py:1158-1171``).
QWEN_LANGUAGE_CODES: dict[str, tuple[str, tuple[str, ...]]] = {
    "Chinese": ("zh", ("chinese", "mandarin", "cn", "中文")),
    "Cantonese": ("yue", ("cantonese", "粤语", "廣東話", "广东话")),
    "English": ("en", ("english", "eng")),
    "German": ("de", ("german",)),
    "Spanish": ("es", ("spanish",)),
    "French": ("fr", ("french",)),
    "Italian": ("it", ("italian",)),
    "Portuguese": ("pt", ("portuguese",)),
    "Russian": ("ru", ("russian",)),
    "Korean": ("ko", ("korean", "한국어")),
    "Japanese": ("ja", ("japanese", "日本語")),
    "Arabic": ("ar", ("arabic",)),
    "Dutch": ("nl", ("dutch",)),
    "Indonesian": ("id", ("indonesian",)),
    "Turkish": ("tr", ("turkish",)),
    "Vietnamese": ("vi", ("vietnamese",)),
    "Thai": ("th", ("thai",)),
    "Polish": ("pl", ("polish",)),
    "Czech": ("cs", ("czech",)),
    "Ukrainian": ("uk", ("ukrainian",)),
    "Romanian": ("ro", ("romanian",)),
    "Swedish": ("sv", ("swedish",)),
    "Danish": ("da", ("danish",)),
    "Finnish": ("fi", ("finnish",)),
    "Norwegian": ("no", ("norwegian",)),
    "Greek": ("el", ("greek",)),
    "Hebrew": ("he", ("hebrew",)),
    "Hindi": ("hi", ("hindi",)),
    "Hungarian": ("hu", ("hungarian",)),
    "Macedonian": ("mk", ("macedonian",)),
}


def _hf_tokenizer(checkpoint_dir: Path):
    tok_path = checkpoint_dir / "tokenizer.json"
    if not tok_path.exists():
        return None
    from asr_tpu_torch.runtime.tokenizer import HFTokenizerDecoder

    return HFTokenizerDecoder(tok_path)


def build_qwen_asr_artifact(checkpoint_dir: str | Path, out_dir: str | Path) -> Path:
    """HF Qwen3-ASR snapshot (config.json + *.safetensors + tokenizer.json)
    -> artifact. Prompt layout ids (head / query-suffix / tail incl. the
    trained ``language `` assistant prefix) follow reference
    ``Qwen_ASR/Export_Qwen_ASR.py:1549-1599``."""
    import json

    from asr_tpu_torch.loaders.qwen_asr_hf import load_qwen_asr_dir

    checkpoint_dir = Path(checkpoint_dir)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tower, llm, cfg = load_qwen_asr_dir(checkpoint_dir)

    tok_file = _copy_asset(checkpoint_dir, "tokenizer.json", out_dir)
    tok = _hf_tokenizer(checkpoint_dir)
    special: dict = {}
    head_ids: list[int] = []
    suffix_ids: list[int] = []
    tail_ids: list[int] = []
    languages: list[LanguageProfile] = []
    lang_prompt_ids: dict[str, list[int]] = {}
    if tok is not None:
        tid = tok.token_to_id
        enc = tok.encode
        special = {
            "im_start": tid("<|im_start|>"), "im_end": tid("<|im_end|>"),
            "endoftext": tid("<|endoftext|>"),
            "audio_start": tid("<|audio_start|>"), "audio_end": tid("<|audio_end|>"),
            "audio_pad": tid("<|audio_pad|>"),
        }
        special = {k: int(v) for k, v in special.items() if v is not None}
        newline = enc("\n")
        head_ids = [special["im_start"], *enc("system"), *newline]
        suffix_ids = [special["im_end"], *newline, special["im_start"],
                      *enc("user"), *newline, special["audio_start"]]
        tail_ids = [special["audio_end"], special["im_end"], *newline,
                    special["im_start"], *enc("assistant"), *newline,
                    *enc("language ")]
        asr_text = tid("<asr_text>")
        cfg_json = json.loads((checkpoint_dir / "config.json").read_text())
        for name in cfg_json.get("support_languages") or []:
            code, aliases = QWEN_LANGUAGE_CODES.get(name, (name.lower(), ()))
            prompt = [int(t) for t in enc(name)] + (
                [int(asr_text)] if asr_text is not None else []
            )
            languages.append(LanguageProfile(code, name, tuple(aliases)))
            lang_prompt_ids[code] = prompt
    meta = ModelMetadata(
        family="qwen_asr",
        sample_rate=cfg.sample_rate,
        audio_pcm_scale=1.0,
        special_token_ids={k: v for k, v in special.items() if isinstance(v, int)},
        supported_languages=languages,
        max_seq_len=cfg.llm.max_seq_len,
        tokenizer={"kind": "hf", "file": tok_file or ""},
        extra={
            "config": dataclasses.asdict(cfg),
            "prompt_head_ids": head_ids,
            "prompt_suffix_ids": suffix_ids,
            "prompt_tail_ids": tail_ids,
            "language_prompt_ids": lang_prompt_ids,
        },
    )
    save_model(out_dir, {"tower": tower, "llm": llm}, meta)
    return out_dir


def build_qwen_aligner_artifact(
    checkpoint_dir: str | Path, out_dir: str | Path, timestamp_tokens_per_word: int = 2
) -> Path:
    """HF Qwen3-ForcedAligner snapshot -> artifact (reference
    ``Qwen_ForcedAligner/Export_Qwen_ForcedAligner.py:1150-1290``)."""
    from asr_tpu_torch.loaders.qwen_asr_hf import load_aligner_dir

    checkpoint_dir = Path(checkpoint_dir)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tower, llm, head, cfg = load_aligner_dir(checkpoint_dir)

    tok_file = _copy_asset(checkpoint_dir, "tokenizer.json", out_dir)
    tok = _hf_tokenizer(checkpoint_dir)
    special: dict[str, int] = {}
    if tok is not None:
        for key, token in (
            ("audio_start", "<|audio_start|>"), ("audio_end", "<|audio_end|>"),
            ("audio_pad", "<|audio_pad|>"), ("timestamp", "<timestamp>"),
        ):
            v = tok.token_to_id(token)
            if v is not None:
                special[key] = int(v)
    meta = ModelMetadata(
        family="qwen_aligner",
        sample_rate=cfg.asr.sample_rate,
        audio_pcm_scale=1.0,
        special_token_ids=special,
        tokenizer={"kind": "hf", "file": tok_file or ""},
        extra={
            "config": dataclasses.asdict(cfg),
            "timestamp_tokens_per_word": timestamp_tokens_per_word,
        },
    )
    save_model(out_dir, {"tower": tower, "llm": llm, "head": head}, meta)
    return out_dir


def build_fun_asr_nano_artifact(
    checkpoint_dir: str | Path, out_dir: str | Path, head: str = "ctc", cfg=None
) -> Path:
    """Fun-ASR-Nano FunASR folder (model.pt [+ *.tiktoken vocab,
    tokenizer.json]) -> artifact. ``head="ctc"`` writes the fast CTC family;
    ``head="llm"`` the Qwen3 AR family (reference
    ``Fun_ASR_Nano/Export_Fun_ASR_Nano.py:517-640,821-900``)."""
    from asr_tpu_torch.loaders import funasr, qwen3_hf

    checkpoint_dir = Path(checkpoint_dir)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    sd = funasr.load_checkpoint_file(checkpoint_dir / "model.pt")
    cfg = cfg or funasr.fun_asr_nano_config_from_state_dict(sd)
    encoder = funasr.fun_asr_nano_params_from_state_dict(sd, cfg)

    if head == "ctc":
        tok_file = None
        for cand in sorted(checkpoint_dir.glob("*.tiktoken")):
            tok_file = _copy_asset(checkpoint_dir, cand.name, out_dir)
            break
        special = {"blank": cfg.blank_id}
        meta = ModelMetadata(
            family="fun_asr_nano",
            sample_rate=cfg.sample_rate,
            audio_pcm_scale=32768.0,
            special_token_ids=special,
            tokenizer={"kind": "tiktoken", "file": tok_file or ""},
            extra={"config": _config_dict(cfg)},
        )
        save_model(out_dir, encoder, meta)
        return out_dir

    llm = qwen3_hf.params_from_state_dict(sd, cfg.llm, prefix="llm.model.")
    tok_file = _copy_asset(checkpoint_dir, "tokenizer.json", out_dir)
    tok = _hf_tokenizer(checkpoint_dir)
    head_ids: list[int] = []
    tail_ids: list[int] = []
    if tok is not None:
        head_ids = [int(t) for t in tok.encode("<|im_start|>user\n")]
        tail_ids = [int(t) for t in tok.encode("<|im_end|>\n<|im_start|>assistant\n")]
    meta = ModelMetadata(
        family="fun_asr_nano_llm",
        sample_rate=cfg.sample_rate,
        audio_pcm_scale=32768.0,
        special_token_ids={"eot": cfg.eot_id},
        tokenizer={"kind": "hf", "file": tok_file or ""},
        extra={
            "config": _config_dict(cfg),
            "prompt_head_ids": head_ids,
            "prompt_suffix_ids": [],
            "prompt_tail_ids": tail_ids,
        },
    )
    save_model(out_dir, {"encoder": encoder, "llm": llm}, meta)
    return out_dir


def build_firered_artifact(
    checkpoint_dir: str | Path, out_dir: str | Path, cfg=None
) -> Path:
    """FireRedASR-AED folder (model.pth.tar + cmvn.ark + dict.txt
    [+ train_bpe1000.model]) -> artifact (reference
    ``FireRedASR/Export_FireRedASR_AED.py:1231-1249`` load path)."""
    from asr_tpu_torch.loaders import firered as fr_loader

    checkpoint_dir = Path(checkpoint_dir)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    sd, _args = fr_loader.load_checkpoint(checkpoint_dir / "model.pth.tar")
    cfg = cfg or fr_loader.config_from_state_dict(sd)
    cmvn_means = cmvn_istd = None
    cmvn_path = checkpoint_dir / "cmvn.ark"
    if cmvn_path.exists():
        cmvn_means, cmvn_istd = fr_loader.parse_kaldi_cmvn_stats(cmvn_path)
    params = fr_loader.firered_params_from_state_dict(sd, cfg, cmvn_means, cmvn_istd)

    tok_file = _copy_asset(checkpoint_dir, "dict.txt", out_dir)
    _copy_asset(checkpoint_dir, "train_bpe1000.model", out_dir)  # encode-side spm
    meta = ModelMetadata(
        family="firered",
        sample_rate=cfg.sample_rate,
        audio_pcm_scale=32768.0,
        special_token_ids={"sos": cfg.sos_id, "eos": cfg.eos_id},
        max_seq_len=cfg.max_target_positions,
        tokenizer={"kind": "firered_dict", "file": tok_file or ""},
        extra={"config": _config_dict(cfg)},
    )
    save_model(out_dir, params, meta)
    return out_dir


def build_parakeet_artifact(checkpoint_dir: str | Path, out_dir: str | Path, cfg=None) -> Path:
    """HF parakeet-tdt safetensors snapshot -> artifact."""
    from asr_tpu_torch.runtime.artifact import read_safetensors as load_file

    from asr_tpu_torch.loaders.parakeet_hf import tdt_params_from_state_dict
    from asr_tpu_torch.models.parakeet import ParakeetConfig

    checkpoint_dir = Path(checkpoint_dir)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg = cfg or ParakeetConfig()
    sd: dict = {}
    for f in sorted(checkpoint_dir.glob("*.safetensors")):
        sd.update(load_file(str(f)))
    params = tdt_params_from_state_dict(sd, cfg)
    tok_file = _copy_asset(checkpoint_dir, "tokenizer.json", out_dir)
    meta = ModelMetadata(
        family="parakeet",
        sample_rate=cfg.sample_rate,
        audio_pcm_scale=1.0,
        special_token_ids={"blank": cfg.blank_id},
        tokenizer={"kind": "hf", "file": tok_file or ""},
        extra={"config": dataclasses.asdict(cfg), "durations": list(cfg.durations)},
    )
    save_model(out_dir, params, meta)
    return out_dir
