"""Self-describing artifact metadata contract.

The port's own copy of ``asr_tpu/runtime/metadata.py``: both packages read
and write the same ``metadata.json``.

The reference stamps all runtime facts into a 1-node ONNX "metadata
carrier" graph (``ASR_Metadata.onnx`` — reference
``SenseVoice/Export_SenseVoice.py:311-351``, read back by
``ORT_IO.py:131-168``): sample_rate, audio_pcm_scale, special_token_ids
JSON, supported_languages JSON (with aliases + prompt ids), max_seq_len and
family-specific keys. Here the same contract is a plain ``metadata.json``
next to the weights, so a model folder is fully self-describing.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any

METADATA_FILENAME = "metadata.json"


@dataclasses.dataclass
class LanguageProfile:
    code: str
    description: str
    aliases: tuple[str, ...] = ()
    prompt_token_id: int | None = None
    index: int | None = None  # row in the model's language table


@dataclasses.dataclass
class ModelMetadata:
    family: str
    sample_rate: int = 16000
    audio_pcm_scale: float = 32768.0  # int16 numeric range by default
    special_token_ids: dict[str, int] = dataclasses.field(default_factory=dict)
    supported_languages: list[LanguageProfile] = dataclasses.field(default_factory=list)
    max_seq_len: int | None = None
    tokenizer: dict[str, str] = dataclasses.field(default_factory=dict)  # {"kind": ..., "file": ...}
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)

    def resolve_language(self, name: str) -> LanguageProfile:
        """Resolve a user-supplied language name via code/description/aliases
        (case-insensitive), like reference ``ORT_IO.resolve_supported_language``."""
        want = name.strip().lower()
        for prof in self.supported_languages:
            names = (prof.code, prof.description, *prof.aliases)
            if any(want == n.lower() for n in names):
                return prof
        raise KeyError(
            f"language {name!r} not supported; choose from "
            f"{[p.code for p in self.supported_languages]}"
        )

    def save(self, folder: str | Path) -> Path:
        path = Path(folder) / METADATA_FILENAME
        payload = dataclasses.asdict(self)
        path.write_text(json.dumps(payload, ensure_ascii=False, indent=2), encoding="utf-8")
        return path

    @classmethod
    def load(cls, folder: str | Path) -> "ModelMetadata":
        payload = json.loads((Path(folder) / METADATA_FILENAME).read_text(encoding="utf-8"))
        langs = [LanguageProfile(**{**p, "aliases": tuple(p.get("aliases", ()))})
                 for p in payload.pop("supported_languages", [])]
        return cls(**{**payload, "supported_languages": langs})


def config_from_dict(cls, payload: dict):
    """Rebuild a (frozen) model-config dataclass from its JSON form.

    Nested config dataclasses (``mel=NemoMelConfig()``, ``fbank=...``,
    ``llm=Qwen3Config()``) are reconstructed by the *type of the field's
    default instance*, and JSON lists are coerced back to tuples where the
    default is a tuple — so ``config_from_dict(C, dataclasses.asdict(c))
    == c`` for every family config. Unknown keys are ignored (forward
    compatibility of artifact folders)."""
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key, val in payload.items():
        f = fields.get(key)
        if f is None:
            continue
        default = f.default
        if dataclasses.is_dataclass(default) and isinstance(val, dict):
            kwargs[key] = config_from_dict(type(default), val)
        elif isinstance(default, tuple) and isinstance(val, list):
            kwargs[key] = tuple(val)
        else:
            kwargs[key] = val
    return cls(**kwargs)
