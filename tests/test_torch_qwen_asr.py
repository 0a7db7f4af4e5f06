"""PyTorch port: Qwen3-ASR (tower, prompt assembly, left-packed lockstep
decode on both routes, the session, its artifact loader and the HTTP
server) against the JAX package.

Geometry: a tiny tower (width 64, 2 layers, 16 mels, 2-chunk windows) over
the fused-decode test's 256-wide q4 LLM (head width 128, so the fused step
tiles). The per-weight route runs the port's quantized linears in the exact
``mm="f32"`` mode, which is the JAX package's CPU product: tower outputs
agree to 1e-4 of max|ref| and greedy ids are equal. The fused route runs
the step's plain version (the wrapper's route for CPU tensors) against JAX's
interpret kernel (``fused_interpret=True``), both in the ``bf16`` mode.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.decode.ar import DecodeConfig as JDecodeConfig
from asr_tpu.layers import qwen3 as jq3
from asr_tpu.models import qwen_asr as jqa
from asr_tpu.ops import fused_decode as jfd
from asr_tpu.ops import quant_matmul as jqm
from asr_tpu.quant.quantize import quantize_pytree as jquantize_pytree
from asr_tpu.runtime import artifact as jart
from asr_tpu.runtime import metadata as jmeta
from asr_tpu.runtime.qwen_session import QwenAsrSession as JSession
from asr_tpu.runtime.qwen_session import QwenPromptTemplate as JTemplate
from asr_tpu_torch.decode.ar import DecodeConfig as TDecodeConfig
from asr_tpu_torch.layers import qwen3 as tq3
from asr_tpu_torch.models import qwen_asr as tqa
from asr_tpu_torch.ops import fused_decode as tfd
from asr_tpu_torch.ops import quant_matmul as tqm
from asr_tpu_torch.parallel.http_server import SessionServer
from asr_tpu_torch.runtime import artifact as tart
from asr_tpu_torch.runtime.qwen_session import (QwenAsrSession, QwenPromptTemplate,
                                                load_qwen_session, parse_asr_output)

LLM = dict(vocab_size=64, hidden=256, num_layers=2, num_heads=2, num_kv_heads=1, head_dim=128,
           ffn_dim=512, rope_theta=1e4, max_seq_len=64)
TOWER = dict(n_mels=16, tower_dim=64, tower_layers=2, tower_heads=4, tower_ffn=128,
             downsample_hidden=8, chunks_per_window=2, output_dim=256)
JCFG = jqa.QwenAsrConfig(**TOWER, llm=jq3.Qwen3Config(**LLM), eot_id=5)
TCFG = tqa.QwenAsrConfig(**TOWER, llm=tq3.Qwen3Config(**LLM), eot_id=5)
TOL = 1e-4
IDS = {"head": [[1, 2, 3]], "query": [[7]], "suffix": [[4]], "tail": [[8, 9]]}


class _Tok:
    def encode(self, text):
        return [11, 12]

    def decode(self, ids):
        return "language English<asr_text>" + " ".join(str(i) for i in ids)


@pytest.fixture(scope="module")
def models():
    jt = jqa.init_tower_params(JCFG, jax.random.PRNGKey(0))
    jt8 = jquantize_pytree(jt, bits=8, min_size=0, refine_iters=0)
    jl = jquantize_pytree(jq3.init_params(JCFG.llm, jax.random.PRNGKey(3)), bits=4, block=128,
                          min_size=0, pack=True, refine_iters=0, quantize_embeddings=True)
    to_t = lambda p: tart.params_from_flat(jart.flatten_pytree(p), "cpu")  # noqa: E731
    return {"jt": jt, "jt8": jt8, "jl": jl, "tt": to_t(jt), "tt8": to_t(jt8), "tl": to_t(jl),
            "jlf": jq3.fuse_params(jl, JCFG.llm), "tlf": tq3.fuse_params(to_t(jl), TCFG.llm)}


@pytest.fixture(autouse=True)
def _f32_mode():
    prev, threads = tqm._CONFIG["mm"], torch.get_num_threads()
    torch.set_num_threads(2)
    tqm.set_quant_config(mm="f32")
    yield
    tqm._CONFIG["mm"] = prev
    torch.set_num_threads(threads)


def _audio(n, seed):
    return (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(np.float32)


def test_feat_output_len_matches():
    frames = np.asarray([0, 1, 7, 99, 100, 101, 250, 800, 801, 1234])
    np.testing.assert_array_equal(tqa.feat_output_len(torch.from_numpy(frames)).numpy(),
                                  np.asarray(jqa.feat_output_len(jnp.asarray(frames))))
    assert int(tqa.feat_output_len(3000)) == int(jqa.feat_output_len(jnp.asarray(3000)))


def test_assemble_prompt_matches():
    rng = np.random.default_rng(0)
    parts = [rng.standard_normal((2, n, 4)).astype(np.float32) for n in (2, 1, 1, 5, 2)]
    valid = np.asarray([3, 5], np.int32)
    je, jv = jqa.assemble_prompt(*(jnp.asarray(p) for p in parts[:4]), jnp.asarray(valid),
                                 jnp.asarray(parts[4]))
    te, tv = tqa.assemble_prompt(*(torch.from_numpy(p) for p in parts[:4]), torch.from_numpy(valid),
                                 torch.from_numpy(parts[4]))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("quant", ["f32", "q8"])
def test_encode_audio_matches(models, quant):
    jt, tt = (models["jt"], models["tt"]) if quant == "f32" else (models["jt8"], models["tt8"])
    from asr_tpu.frontend.whisper_mel import log_mel_spectrogram as jmel

    audio = np.stack([_audio(3 * 16000, 1), _audio(3 * 16000, 2)])
    mel = np.asarray(jmel(jnp.asarray(audio), JCFG.mel_config()))
    mel = np.pad(mel, ((0, 0), (0, (-mel.shape[1]) % 200), (0, 0)))
    valid = np.asarray([300, 117], np.int32)
    ja, jv = jqa.encode_audio(jt, JCFG, jnp.asarray(mel), jnp.asarray(valid))
    ta, tv = tqa.encode_audio(tt, TCFG, torch.from_numpy(mel), torch.from_numpy(valid))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    ja = np.asarray(ja)
    np.testing.assert_allclose(ta.numpy(), ja, rtol=0, atol=TOL * np.abs(ja).max())


def test_prompt_embeds_match(models):
    audio = np.stack([_audio(2 * 16000, 3), _audio(2 * 16000, 4)])
    valid = np.asarray([32000, 20000], np.int32)
    ids = {k: np.tile(np.asarray(v), (2, 1)) for k, v in IDS.items()}
    je, jv = jqa.prompt_embeds(models["jt8"], models["jl"], JCFG, jnp.asarray(audio),
                               jnp.asarray(valid), {k: jnp.asarray(v) for k, v in ids.items()})
    te, tv = tqa.prompt_embeds(models["tt8"], models["tl"], TCFG, torch.from_numpy(audio),
                               torch.from_numpy(valid), {k: torch.from_numpy(v) for k, v in ids.items()})
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    je = np.asarray(je)
    np.testing.assert_allclose(te.numpy(), je, rtol=0, atol=TOL * np.abs(je).max())


def _embeds(b, lf, seed):
    return (np.random.default_rng(seed).standard_normal((b, lf, 256)) * 0.3).astype(np.float32)


def test_transcribe_embeds_per_weight_ids_equal(models):
    x = _embeds(2, 7, 5)
    valid = np.asarray([7, 4], np.int32)
    jtok, jcnt, jst = jqa.transcribe_embeds(models["jlf"], JCFG, jnp.asarray(x), jnp.asarray(valid),
                                            JDecodeConfig(max_new_tokens=6, eot_id=5))
    ttok, tcnt, tst = tqa.transcribe_embeds(models["tlf"], TCFG, torch.from_numpy(x),
                                            torch.from_numpy(valid),
                                            TDecodeConfig(max_new_tokens=6, eot_id=5))
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


@pytest.mark.parametrize("head", ["in_kernel", "separate"])
def test_transcribe_embeds_fused_route_ids_equal(models, head):
    """Batch 1 on the fused route: the step's plain version (bf16 caches)
    against JAX's interpret-mode kernel, both in the bf16 mode; the ids are
    equal, and every decode step was one fused step."""
    sj = jfd.stack_decode_params(models["jlf"], JCFG.llm)
    st = tfd.stack_decode_params(models["tlf"], TCFG.llm)
    if head == "separate":
        sj = {k: v for k, v in sj.items() if k not in ("wh", "h_s", "h_zs")}
        st = {k: v for k, v in st.items() if k not in ("wh", "h_s", "h_zs")}
    x = _embeds(1, 6, 6)
    valid = np.asarray([5], np.int32)
    jprev = jqm._CONFIG["mm"]
    jqm.set_quant_config(mm="bf16")
    tqm.set_quant_config(mm="bf16")
    try:
        jtok, jcnt, _ = jqa.transcribe_embeds(models["jlf"], JCFG, jnp.asarray(x), jnp.asarray(valid),
                                              JDecodeConfig(max_new_tokens=5, eot_id=-1),
                                              stacked=sj, fused_interpret=True)
        calls = []
        orig = tfd.fused_decode_step_reference

        def counted(*a, **k):
            calls.append(1)
            return orig(*a, **k)

        tfd.fused_decode_step_reference = counted
        try:
            ttok, tcnt, _ = tqa.transcribe_embeds(models["tlf"], TCFG, torch.from_numpy(x),
                                                  torch.from_numpy(valid),
                                                  TDecodeConfig(max_new_tokens=5, eot_id=-1),
                                                  stacked=st)
        finally:
            tfd.fused_decode_step_reference = orig
    finally:
        jqm._CONFIG["mm"] = jprev
    assert len(calls) == int(tcnt[0]) - 1 == 5
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


def _save_jax_artifact(folder, models):
    meta = jmeta.ModelMetadata(
        family="qwen_asr", audio_pcm_scale=1.0,
        extra={"config": dataclasses.asdict(JCFG), "prompt_head_ids": [1, 2, 3],
               "prompt_suffix_ids": [4], "prompt_tail_ids": [8, 9],
               "language_prompt_ids": {"en": [20, 21]}})
    jart.save_model(folder, {"tower": models["jt8"], "llm": models["jl"]}, meta)


def test_load_qwen_session_reproduces_jax_session_ids(models, tmp_path):
    _save_jax_artifact(tmp_path, models)
    sess = load_qwen_session(tmp_path, "cpu", tokenizer=_Tok(), max_new_tokens=6, max_seconds=2.0)
    assert sess.cfg == TCFG and sess.stacked is None and sess.device.type == "cpu"
    assert sess.template == QwenPromptTemplate((1, 2, 3), (4,), (8, 9))
    assert "qkv" in sess.llm_params["layers"][0]["attn"]
    jp, _ = jart.load_model(tmp_path)
    jsess = JSession(jp["tower"], jp["llm"], JCFG, tokenizer=_Tok(),
                     template=JTemplate((1, 2, 3), (4,), (8, 9)),
                     language_prompt_ids={"en": [20, 21]}, max_new_tokens=6, max_seconds=2.0)
    clips = [_audio(int(1.5 * 16000), 7), _audio(3 * 16000, 8)]  # the second is cut to 2 s
    for clip in clips:
        want = jsess.transcribe(clip)
        got = sess.transcribe(clip)
        assert got.token_ids == want.token_ids and got.text == want.text
        assert sess.last_language == jsess.last_language
    got = sess.transcribe_batch(clips, context="hot words", language="en")
    want = jsess.transcribe_batch(clips, context="hot words", language="en")
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert all(r.batch_size == 2 for r in got)
    with pytest.raises(KeyError):
        sess.transcribe(clips[0], language="fr")


def test_parse_asr_output_matches():
    from asr_tpu.runtime.qwen_session import parse_asr_output as jparse

    for raw, lang in (("language English<asr_text>hello world", None), ("hello", None),
                      ("language zh<asr_text>你好", "zh"), ("", None), ("  language  <asr_text> x", None)):
        assert parse_asr_output(raw, lang) == jparse(raw, lang)


def _wav(pcm):
    import io
    import wave

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.asarray(pcm, np.int16).tobytes())
    return buf.getvalue()


def test_http_server_returns_session_ids_and_postprocesses_per_window(models):
    sess = QwenAsrSession(models["tt8"], models["tl"], TCFG, tokenizer=_Tok(),
                          template=QwenPromptTemplate(head_ids=(1, 2), tail_ids=(8,)),
                          max_new_tokens=4, max_seconds=1.0)
    srv = SessionServer(sess, max_batch=2, max_wait_ms=50.0, warmup=False)
    try:
        rng = np.random.default_rng(9)
        pcm = [(rng.standard_normal(n) * 900).astype(np.int16) for n in (12000, 7000)]
        outs = [None, None]

        def call(i):
            outs[i] = srv.transcribe_bytes(_wav(pcm[i]))

        threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i in range(2):
            want = sess.transcribe(pcm[i].astype(np.float32) / 32768.0)
            assert outs[i]["token_ids"] == want.token_ids
            assert outs[i]["text"] == want.text
        # a two-window request: each window's "language X<asr_text>" prefix
        # is stripped (decode and post-process per window)
        long = (rng.standard_normal(2 * srv.window) * 900).astype(np.int16)
        out = srv.transcribe_bytes(_wav(long))
        assert out["windows"] == 2
        assert "<asr_text>" not in out["text"] and "language" not in out["text"]
        want = [sess.transcribe(long[i * srv.window : (i + 1) * srv.window].astype(np.float32)
                                / 32768.0) for i in range(2)]
        assert out["token_ids"] == want[0].token_ids + want[1].token_ids
        assert out["text"] == " ".join(w.text for w in want if w.text)
    finally:
        srv.close()
