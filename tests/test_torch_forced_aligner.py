"""PyTorch port: the Qwen3 forced aligner (the non-autoregressive timestamp
pass, the monotone repair, word grouping, the word splitters and the
session) against the JAX package.

Geometry: the JAX aligner test's tiny config (a 32-wide one-layer tower on
16 mels with 2-chunk windows, a 48-wide one-layer Qwen3 with 4/2 heads of
16, 25 classes). Inputs come from a seed with numpy; the head logits agree
to 1e-4 of max|ref| and the buckets are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.layers import qwen3 as jq3
from asr_tpu.models import forced_aligner as jfa
from asr_tpu.models import qwen_asr as jqa
from asr_tpu.quant.quantize import quantize_embedding as jquantize_embedding
from asr_tpu.runtime import aligner_session as jas
from asr_tpu.runtime import artifact as jart
from asr_tpu_torch.layers import qwen3 as tq3
from asr_tpu_torch.models import forced_aligner as tfa
from asr_tpu_torch.models import qwen_asr as tqa
from asr_tpu_torch.runtime import aligner_session as tas
from asr_tpu_torch.runtime import artifact as tart

LLM = dict(vocab_size=120, hidden=48, num_layers=1, num_heads=4, num_kv_heads=2, head_dim=16,
           ffn_dim=64, rope_theta=1e4)
TOWER = dict(n_mels=16, tower_dim=32, tower_layers=1, tower_heads=4, tower_ffn=48,
             downsample_hidden=8, chunks_per_window=2, output_dim=48, eot_id=-1)
JCFG = jfa.ForcedAlignerConfig(asr=jqa.QwenAsrConfig(**TOWER, llm=jq3.Qwen3Config(**LLM)),
                               classify_num=25)
TCFG = tfa.ForcedAlignerConfig(asr=tqa.QwenAsrConfig(**TOWER, llm=tq3.Qwen3Config(**LLM)),
                               classify_num=25)
SPECIAL = {"timestamp": 110, "audio_start": 111, "audio_end": 112}
TOL = 1e-4


def to_t(p):
    return tart.params_from_flat(jart.flatten_pytree(p), "cpu")


@pytest.fixture(scope="module")
def models():
    jt = jqa.init_tower_params(JCFG.asr, jax.random.PRNGKey(0))
    jl = jq3.init_params(JCFG.asr.llm, jax.random.PRNGKey(1))
    jh = {"w": jax.random.normal(jax.random.PRNGKey(2), (48, 25)) * 0.1}
    return {"jt": jt, "jl": jl, "jh": jh, "tt": to_t(jt), "tl": to_t(jl), "th": to_t(jh)}


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


class _Tok:
    def encode(self, text):
        return [ord(c) % 100 for c in text][:3]


def test_config_defaults_are_qwen3_forced_aligner_0_6b():
    t, j = tfa.ForcedAlignerConfig(), jfa.ForcedAlignerConfig()
    assert (t.classify_num, t.segment_ms) == (j.classify_num, j.segment_ms) == (375, 80)
    assert t.asr == tqa.QwenAsrConfig() and t.asr.llm.hidden == 1024


def test_forward_buckets_and_logits_match(models):
    audio = (np.random.default_rng(0).standard_normal((1, 32000)) * 0.1).astype(np.float32)
    text_ids = np.asarray([[11, 12, 110, 110, 13, 110, 110]], np.int32)
    jargs = (jnp.asarray(audio), jnp.asarray([32000]), models["jl"]["embed"][jnp.asarray([[111]])],
             models["jl"]["embed"][jnp.asarray([[112]])], jnp.asarray(text_ids))
    targs = (torch.from_numpy(audio), torch.tensor([32000]), models["tl"]["embed"][torch.tensor([[111]])],
             models["tl"]["embed"][torch.tensor([[112]])], torch.from_numpy(text_ids))
    jb, jv = jfa.forward(models["jt"], models["jl"], models["jh"], JCFG, *jargs)
    tb, tv = tfa.forward(models["tt"], models["tl"], models["th"], TCFG, *targs)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert int(tv[0]) == 1 + int(tqa.feat_output_len(200)) + 1 + text_ids.shape[1]
    _mel, je, _ = jfa.prompt_for(models["jt"], models["jl"], JCFG, *jargs)
    _mel, te, _ = tfa.prompt_for(models["tt"], models["tl"], TCFG, *targs)
    jl = np.asarray(jfa.align_logits(models["jl"], models["jh"], JCFG, je, jv))
    tl = tfa.align_logits(models["tl"], models["th"], TCFG, te, tv)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=TOL * np.abs(jl).max())


@pytest.mark.parametrize("buckets", [
    [1, 2, 2, 5], [1, 2, 100, 3, 4], [1, 2, 50, 50, 50, 50, 3, 4, 5, 6, 7], [], [9, 1, 2, 3],
    [5, 4, 3, 2, 1], [0, 0, 0], [3, 9, 9, 1, 2, 10, 11, 0, 12], [7],
])
def test_fix_timestamps_matches(buckets):
    assert tfa.fix_timestamps(buckets) == jfa.fix_timestamps(buckets)


@pytest.mark.parametrize("words,buckets,per_word", [
    (["foo", "bar"], [1, 2, 5, 6], 2), (["a", "b", "c"], [4, 1, 9], 1),
    (["x", "y"], [3], 1), (["p", "q"], [2, 2, 30, 3], 2),
])
def test_word_timestamps_matches(words, buckets, per_word):
    assert tfa.word_timestamps(words, buckets, per_word, 80) == jfa.word_timestamps(
        words, buckets, per_word, 80)


@pytest.mark.parametrize("splitter,text,language", [
    ("word_units", "Hello, world!", None), ("word_units", "don't stop", None),
    ("word_units", "我爱 NLP", None), ("word_units", "abc你好def", None),
    ("word_units", "  ...  ", None), ("word_units", "v2ray 2024", None),
    ("word_units_japanese", "私は東京タワーへ行きました。", None),
    ("word_units_japanese", "カタカナABC123ひらがな", None),
    ("word_units_japanese", "ラーメン", None), ("word_units_japanese", "", None),
    ("word_units_japanese", "データを読み込む", None),
    ("word_units_for_language", "行きます", "ja"),
    ("word_units_for_language", "안녕하세요 세계", "korean"),
    ("word_units_for_language", "hello world", None),
    ("word_units_for_language", "좋아요, 감사합니다!", "ko"),
    ("word_units_for_language", "私は走った", "japanese"),
])
def test_word_splitters_match(splitter, text, language):
    args = (text,) if language is None and splitter != "word_units_for_language" else (text, language)
    assert getattr(tas, splitter)(*args) == getattr(jas, splitter)(*args)


@pytest.mark.parametrize("quantized", [False, True])
def test_session_align_matches_jax(models, quantized):
    """End to end through both sessions, with a plain embedding table and
    with a QuantizedEmbedding (gather-dequant special-token rows)."""
    jl = dict(models["jl"])
    if quantized:
        jl["embed"] = jquantize_embedding(jnp.asarray(jl["embed"]), bits=8, block=48)
    tl = to_t(jl)
    kw = dict(tokenizer=_Tok(), special_ids=SPECIAL, tokens_per_word=2, max_seconds=2.0)
    jsess = jas.QwenAlignerSession(models["jt"], jl, models["jh"], JCFG, **kw)
    tsess = tas.QwenAlignerSession(models["tt"], tl, models["th"], TCFG, **kw)
    audio = (np.random.default_rng(3).standard_normal(24000) * 0.1).astype(np.float32)
    for text, lang in (("hello world again", None), ("私は走った", "ja")):
        got, want = tsess.align(audio, text, language=lang), jsess.align(audio, text, language=lang)
        assert got == want and got
    assert [o["text"] for o in tsess.align(audio, "hello world again")] == ["hello", "world", "again"]
    assert tsess.align(np.zeros(1000, np.float32), "...") == []
    with pytest.raises(ValueError, match="tokenizer"):
        tas.QwenAlignerSession(models["tt"], tl, models["th"], TCFG, None, SPECIAL).align(audio, "x")
