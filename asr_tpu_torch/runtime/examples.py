"""Demo-audio registry (reference ``Example_Audio.py``): maps each model
family to (language, fixture) demo cases under ``Test_Examples/``."""

from __future__ import annotations

from pathlib import Path

TEST_EXAMPLES_DIR = Path("/root/reference/Test_Examples")

_MODEL_AUDIO_FILES: dict[str, list[tuple[str, str]]] = {
    "sensevoice": [("en", "en/test_sample.wav"), ("zh", "zh/zh-Shanghai.wav")],
    "whisper": [("en", "en/test_sample.wav")],
    "paraformer": [("zh", "zh/zh-Shanghai.wav")],
    "paraformer_streaming": [("zh", "zh/zh-Shanghai.wav")],
    "firered": [("zh", "zh/zh-Shanghai.wav")],
    "dolphin": [("zh", "zh/zh-Shanghai.wav"), ("ja", "ja/ja.mp3")],
    "dolphin_streaming": [("zh", "zh/zh-Shanghai.wav")],
    "fun_asr_nano": [("zh", "zh/zh-Shanghai.wav"), ("en", "en/en.mp3")],
    "qwen_asr": [("en", "en/test_sample.wav"), ("zh", "zh/zh-Shanghai.wav")],
    "forced_aligner": [("en", "en/test_sample.wav")],
    "parakeet": [("en", "en/test_sample.wav"), ("ko", "ko/ko.mp3")],
    "nemotron": [("en", "en/test_sample.wav"), ("yue", "yue/yue.mp3")],
    "xasr": [("zh", "zh/zh-Shanghai.wav"), ("en", "en/test_sample.wav")],
}


def model_audio_cases(family: str, root: Path | None = None) -> list[tuple[str, Path]]:
    """[(language, absolute path)] demo cases for a family; skips files the
    runtime cannot decode yet (mp3 without ffmpeg)."""
    root = root or TEST_EXAMPLES_DIR
    out = []
    for lang, rel in _MODEL_AUDIO_FILES.get(family, []):
        p = root / rel
        if p.suffix == ".mp3":
            from asr_tpu_torch.runtime.mp3 import mpg123_available

            if not mpg123_available():
                continue
        if p.exists():
            out.append((lang, p))
    return out
