"""PyTorch port: Fun-ASR-Nano (SANM encoder, CTC head, audio adaptor, the LLM
path, both sessions and continuous serving) against the JAX package.

Geometry: the JAX Fun-ASR-Nano test's tiny config (a 32-wide, three-block
encoder, a 48-wide one-layer Qwen3 with 4/2 heads of 16). Inputs come from
a seed with numpy; JAX runs on the CPU at ``highest`` precision and the port
in f32, so encoder, CTC and adaptor outputs agree to 1e-4 of max|ref| and
greedy ids are equal. The fused batch-1 route runs on a q4 LLM at head width
128 (the fused step's tile): the step's plain version (the wrapper's route
for CPU tensors) against JAX's interpret-mode kernel, both in the ``bf16``
mode, as ``test_torch_qwen_asr.py`` holds Qwen3-ASR's.
"""

import dataclasses
import io
import threading
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.decode.ar import DecodeConfig as JDecodeConfig
from asr_tpu.layers import qwen3 as jq3
from asr_tpu.models import fun_asr_nano as jfn
from asr_tpu.models import qwen_asr as jqa
from asr_tpu.ops import fused_decode as jfd
from asr_tpu.ops import quant_matmul as jqm
from asr_tpu.quant.quantize import quantize_pytree as jquantize_pytree
from asr_tpu.runtime import artifact as jart
from asr_tpu.runtime.qwen_session import FunAsrNanoLlmSession as JLlmSession
from asr_tpu.runtime.qwen_session import QwenPromptTemplate as JTemplate
from asr_tpu.runtime.transducer_session import FunAsrNanoCtcSession as JCtcSession
from asr_tpu_torch.decode.ar import DecodeConfig as TDecodeConfig
from asr_tpu_torch.layers import qwen3 as tq3
from asr_tpu_torch.models import fun_asr_nano as tfn
from asr_tpu_torch.ops import fused_decode as tfd
from asr_tpu_torch.ops import quant_matmul as tqm
from asr_tpu_torch.parallel.llm_server import ContinuousSessionServer
from asr_tpu_torch.runtime import artifact as tart
from asr_tpu_torch.runtime.qwen_session import FunAsrNanoLlmSession, QwenPromptTemplate
from asr_tpu_torch.runtime.transducer_session import FunAsrNanoCtcSession, strip_language_tags

ENC = dict(hidden=32, num_heads=4, head_dim=8, ffn_dim=48, num_encoders0=1, num_encoders=1,
           num_tp_encoders=1, fsmn_kernel=5, adaptor_hidden=48, adaptor_blocks=1,
           adaptor_heads=4, adaptor_ffn=64, ctc_hidden=32, ctc_blocks=1, ctc_heads=4,
           ctc_ffn=48, ctc_vocab=50, eot_id=7)
LLM = dict(vocab_size=120, hidden=48, num_layers=1, num_heads=4, num_kv_heads=2, head_dim=16,
           ffn_dim=64, rope_theta=1e4)
JCFG = jfn.FunAsrNanoConfig(**ENC, llm=jq3.Qwen3Config(**LLM))
TCFG = tfn.FunAsrNanoConfig(**ENC, llm=tq3.Qwen3Config(**LLM))
TOL = 1e-4
IDS = {"head": [[1, 2, 3]], "query": [[4]], "tail": [[5, 6]]}


def to_t(p):
    return tart.params_from_flat(jart.flatten_pytree(p), "cpu")


class _Tok:
    def encode(self, text):
        return [11, 12]

    def decode(self, ids):
        return " ".join(str(i) for i in ids)


@pytest.fixture(scope="module")
def models():
    jp = jfn.init_params(JCFG, jax.random.PRNGKey(0))
    jl = jq3.init_params(JCFG.llm, jax.random.PRNGKey(1))
    return {"jp": jp, "jl": jl, "tp": to_t(jp), "tl": to_t(jl)}


@pytest.fixture(autouse=True)
def _f32_mode():
    prev, threads = tqm._CONFIG["mm"], torch.get_num_threads()
    torch.set_num_threads(2)
    tqm.set_quant_config(mm="f32")
    yield
    tqm._CONFIG["mm"] = prev
    torch.set_num_threads(threads)


def _audio(b, n, seed):
    return (np.random.default_rng(seed).standard_normal((b, n)) * 2000).astype(np.float32)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * np.abs(want).max())


def test_config_defaults_are_the_jax_package_s():
    assert dataclasses.asdict(tfn.FunAsrNanoConfig()) == dataclasses.asdict(jfn.FunAsrNanoConfig())
    assert tfn.FunAsrNanoConfig().feature_size == 560


def test_init_params_has_the_jax_layout():
    tp = tfn.init_params(TCFG, torch.Generator().manual_seed(0), "cpu")
    jp = jfn.init_params(JCFG, jax.random.PRNGKey(0))
    tflat, jflat = tart.flatten_pytree(tp), jart.flatten_pytree(jp)
    assert {k: v.shape for k, v in tflat.items()} == {k: v.shape for k, v in jflat.items()}


def test_encode_ctc_logits_and_audio_embeds_match(models):
    audio = _audio(2, 12800, 1)
    valid = np.asarray([12800, 7000], np.int32)
    je, jvl, jvf = jfn.encode(models["jp"], JCFG, jnp.asarray(audio), jnp.asarray(valid))
    te, tvl, tvf = tfn.encode(models["tp"], TCFG, torch.from_numpy(audio), torch.from_numpy(valid))
    np.testing.assert_array_equal(tvl.numpy(), np.asarray(jvl))
    np.testing.assert_array_equal(tvf.numpy(), np.asarray(jvf))
    _close(te, je)
    _close(tfn.ctc_logits(models["tp"], TCFG, te, tvl),
           jfn.ctc_logits(models["jp"], JCFG, je, jvl))
    ja, js = jfn.audio_embeds(models["jp"], JCFG, jnp.asarray(audio), jnp.asarray(valid))
    ta, ts = tfn.audio_embeds(models["tp"], TCFG, torch.from_numpy(audio), torch.from_numpy(valid))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert int(ts[0]) == -(-((12800 - 400) // 160 + 1) // 48)
    _close(ta, ja)


def test_forward_ctc_ids_equal(models):
    audio = _audio(2, 12800, 2)
    valid = np.asarray([6400, 12800], np.int32)
    jids, jn = jfn.forward_ctc(models["jp"], JCFG, jnp.asarray(audio), jnp.asarray(valid))
    tids, tn = tfn.forward_ctc(models["tp"], TCFG, torch.from_numpy(audio), torch.from_numpy(valid))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    for i in range(2):
        n = int(tn[i])
        np.testing.assert_array_equal(tids[i, :n].numpy(), np.asarray(jids)[i, :n])


def test_prompt_embeds_and_greedy_forward_llm_match(models):
    audio = _audio(2, 16000, 3)
    valid = np.asarray([16000, 9000], np.int32)
    ids = {k: np.tile(np.asarray(v), (2, 1)) for k, v in IDS.items()}
    jids = {k: jnp.asarray(v) for k, v in ids.items()}
    tids = {k: torch.from_numpy(v) for k, v in ids.items()}
    je, jv = jfn.prompt_embeds_llm(models["jp"], models["jl"], JCFG, jnp.asarray(audio),
                                   jnp.asarray(valid), jids)
    te, tv = tfn.prompt_embeds_llm(models["tp"], models["tl"], TCFG, torch.from_numpy(audio),
                                   torch.from_numpy(valid), tids)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    _close(te, je)
    jtok, jcnt, jst = jfn.forward_llm(models["jp"], models["jl"], JCFG, jnp.asarray(audio),
                                      jnp.asarray(valid), jids, JDecodeConfig(max_new_tokens=6, eot_id=7))
    ttok, tcnt, tst = tfn.forward_llm(models["tp"], models["tl"], TCFG, torch.from_numpy(audio),
                                      torch.from_numpy(valid), tids,
                                      TDecodeConfig(max_new_tokens=6, eot_id=7))
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


# A q4 LLM at the fused step's head width, as in test_torch_qwen_asr.py.
Q4_LLM = dict(vocab_size=64, hidden=256, num_layers=2, num_heads=2, num_kv_heads=1, head_dim=128,
              ffn_dim=512, rope_theta=1e4, max_seq_len=64)
Q4_ENC = {**ENC, "adaptor_hidden": 256}


def test_fused_batch1_route_ids_equal_jax_interpret():
    """Batch 1 on the fused route: the step's plain version (bf16 caches)
    against JAX's interpret-mode kernel, both in the bf16 mode; every decode
    step after the first token is one fused step."""
    jcfg = jfn.FunAsrNanoConfig(**Q4_ENC, llm=jq3.Qwen3Config(**Q4_LLM))
    tcfg = tfn.FunAsrNanoConfig(**Q4_ENC, llm=tq3.Qwen3Config(**Q4_LLM))
    jp = jquantize_pytree(jfn.init_params(jcfg, jax.random.PRNGKey(4)), bits=8, min_size=0,
                          refine_iters=0)
    jl = jq3.fuse_params(jquantize_pytree(jq3.init_params(jcfg.llm, jax.random.PRNGKey(5)), bits=4,
                                          block=128, min_size=0, pack=True, refine_iters=0,
                                          quantize_embeddings=True), jcfg.llm)
    tp, tl = to_t(jp), to_t(jl)  # the fused JAX tree: qkv / gateup leaves
    sj, st = jfd.stack_decode_params(jl, jcfg.llm), tfd.stack_decode_params(tl, tcfg.llm)
    assert st is not None and "wh" in st
    audio = _audio(1, 16000, 6)
    ids = {k: np.asarray(v) for k, v in IDS.items()}
    jprev = jqm._CONFIG["mm"]
    jqm.set_quant_config(mm="bf16")
    tqm.set_quant_config(mm="bf16")
    calls = []
    orig = tfd.fused_decode_step_reference

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    try:
        # JAX's forward_llm has no interpret switch: its front half, then
        # transcribe_embeds with the interpret-mode kernel
        je, jv = jfn.prompt_embeds_llm(jp, jl, jcfg, jnp.asarray(audio), jnp.asarray([16000]),
                                       {k: jnp.asarray(v) for k, v in ids.items()})
        jtok, jcnt, _ = jqa.transcribe_embeds(jl, jqa.QwenAsrConfig(llm=jcfg.llm, eot_id=-1), je, jv,
                                              JDecodeConfig(max_new_tokens=5, eot_id=-1),
                                              stacked=sj, fused_interpret=True)
        tfd.fused_decode_step_reference = counted
        ttok, tcnt, _ = tfn.forward_llm(tp, tl, dataclasses.replace(tcfg, eot_id=-1),
                                        torch.from_numpy(audio), torch.tensor([16000]),
                                        {k: torch.from_numpy(v) for k, v in ids.items()},
                                        TDecodeConfig(max_new_tokens=5, eot_id=-1), stacked=st)
    finally:
        tfd.fused_decode_step_reference = orig
        jqm._CONFIG["mm"] = jprev
    assert len(calls) == int(tcnt[0]) - 1 == 5
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


def _wav(path, pcm):
    with wave.open(path if isinstance(path, io.BytesIO) else str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.asarray(pcm, np.int16).tobytes())
    return path


def test_ctc_session_matches_jax_session(models, tmp_path):
    """Files shorter and longer than one (1 s) window, one at a time and as
    one batch (the longer file falls back to the windowed path)."""
    rng = np.random.default_rng(7)
    files = [_wav(tmp_path / f"{i}.wav", rng.standard_normal(n) * 2000)
             for i, n in enumerate((9000, 25000, 16000))]
    jsess = JCtcSession(models["jp"], JCFG, tokenizer=_Tok(), window_seconds=1.0)
    tsess = FunAsrNanoCtcSession(models["tp"], TCFG, tokenizer=_Tok(), window_seconds=1.0)
    assert tsess.device.type == "cpu" and tsess.window_samples == 16000
    for f in files:
        want, got = jsess.transcribe(str(f)), tsess.transcribe(str(f))
        assert got.token_ids == want.token_ids and got.text == want.text
        assert got.audio_seconds == want.audio_seconds
    want = jsess.transcribe_batch([str(f) for f in files])
    got = tsess.transcribe_batch([str(f) for f in files])
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert [r.text for r in got] == [r.text for r in want]
    assert [r.batch_size for r in got] == [3, 1, 3]
    assert got[1].token_ids == tsess.transcribe(str(files[1])).token_ids


def test_strip_language_tags_matches():
    from asr_tpu.runtime.transducer_session import strip_language_tags as jstrip

    for text in ("<en>hello", "<zh-CN> 你好 <en>", "plain", "<EN>kept", "a<yue>b"):
        assert strip_language_tags(text) == jstrip(text)


def _llm_sessions(models, **kw):
    tpl = dict(head_ids=(1, 2), suffix_ids=(3,), tail_ids=(5, 6))
    jsess = JLlmSession(models["jp"], models["jl"], JCFG, tokenizer=_Tok(), template=JTemplate(**tpl),
                        max_new_tokens=5, max_seconds=1.0, **kw)
    tsess = FunAsrNanoLlmSession(models["tp"], models["tl"], TCFG, tokenizer=_Tok(),
                                 template=QwenPromptTemplate(**tpl), max_new_tokens=5,
                                 max_seconds=1.0, **kw)
    return jsess, tsess


def test_llm_session_matches_jax_session(models, tmp_path):
    jsess, tsess = _llm_sessions(models)
    assert tsess.stacked is None and tsess.device.type == "cpu" and tsess.llm_cfg == TCFG.llm
    rng = np.random.default_rng(8)
    clips = [(rng.standard_normal(n) * 2000).astype(np.float32) for n in (12000, 20000)]
    path = _wav(tmp_path / "a.wav", rng.standard_normal(10000) * 2000)
    for item in (*clips, str(path)):
        want, got = jsess.transcribe(item, context="hot"), tsess.transcribe(item, context="hot")
        assert got.token_ids == want.token_ids and got.text == want.text
        assert got.audio_seconds == want.audio_seconds
    want, got = jsess.transcribe_batch(clips), tsess.transcribe_batch(clips)
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert all(r.batch_size == 2 for r in got)
    je, jv = jsess.prompt_embeds(clips[0], context="hot")
    te, tv = tsess.prompt_embeds(clips[0], context="hot")
    assert tv == jv
    _close(te, je)
    with pytest.raises(KeyError):
        tsess.prompt_embeds(clips[0], language="en")


def _wav_bytes(pcm):
    buf = io.BytesIO()
    _wav(buf, pcm)
    return buf.getvalue()


def test_continuous_server_ids_equal_the_session(models):
    """Three concurrent requests on two slots (one waits and joins
    mid-flight), one of them two windows long: the rowwise step on the CPU."""
    _, tsess = _llm_sessions(models)
    rng = np.random.default_rng(9)
    clips = [(rng.standard_normal(n) * 900).astype(np.int16) for n in (9000, 14000, 24000)]
    srv = ContinuousSessionServer(tsess, n_slots=2)
    outs = [None] * len(clips)
    try:
        threads = [threading.Thread(target=lambda i=i: outs.__setitem__(
            i, srv.transcribe_bytes(_wav_bytes(clips[i])))) for i in range(len(clips))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        st = srv.stats()
    finally:
        srv.close()
    assert st["decoder"] == "llm" and st["step_kernel"] == "rowwise" and st["requests_served"] == 4
    w = srv.window
    for i, clip in enumerate(clips):
        want = [t for s in range(0, len(clip), w)
                for t in tsess.transcribe(clip[s : s + w].astype(np.float32)).token_ids]
        assert outs[i]["token_ids"] == want, i
    assert outs[2]["windows"] == 2
