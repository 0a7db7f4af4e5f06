"""PyTorch port: Qwen3-ASR with a packed-int2 LLM (every linear 2-bit packed,
a 2-bit embedding whose tied head stays centered int8) against the JAX
package: the per-weight decode route, a JAX-written q2 artifact through
``load_qwen_session``, the HTTP micro-batcher and the continuous server.

Geometry: a tiny tower (width 32, one layer) over a 2-layer Qwen3 of hidden
512 with 4 / 2 heads of 128 and FFN 1024, so K/4 of every linear (q|k|v
and gate|up 512 / 4, o 512 / 4, down 1024 / 4) is a multiple of the
128-row block and every linear packs (``min_size=0``). A q2 LLM does not
stack for the fused step, which takes packed 4-bit leaves only, so every
route here is the per-weight one, whose linears go through ``quant_dense``
and, on a CPU tensor, the int2 kernel's plain version. Both packages run
the exact ``mm="f32"`` product and greedy argmax: ids are compared exactly.
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
from asr_tpu.models import qwen_asr as jqa
from asr_tpu.ops import fused_decode as jfd
from asr_tpu.ops import quant_matmul as jqm
from asr_tpu.parallel.llm_server import ContinuousSessionServer as JaxServer
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
from asr_tpu_torch.parallel import llm_server as tls
from asr_tpu_torch.parallel.http_server import SessionServer
from asr_tpu_torch.parallel.llm_batcher import ContinuousLlmBatcher
from asr_tpu_torch.quant.quantize import QuantizedEmbedding, QuantizedLinear
from asr_tpu_torch.runtime import artifact as tart
from asr_tpu_torch.runtime.qwen_session import QwenAsrSession, QwenPromptTemplate, load_qwen_session

LLM = dict(vocab_size=300, hidden=512, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
           ffn_dim=1024, rope_theta=1e4, max_seq_len=64)
TOWER = dict(n_mels=16, tower_dim=32, tower_layers=1, tower_heads=4, tower_ffn=48,
             downsample_hidden=8, chunks_per_window=2, output_dim=512)
JCFG = jqa.QwenAsrConfig(**TOWER, llm=jq3.Qwen3Config(**LLM), eot_id=5)
TCFG = tqa.QwenAsrConfig(**TOWER, llm=tq3.Qwen3Config(**LLM), eot_id=5)
HEAD, TAIL = (1, 2), (4,)


class _Tok:
    def encode(self, text):
        return [11, 12]

    def decode(self, ids):
        return "language English<asr_text>" + " ".join(str(i) for i in ids)


@pytest.fixture(scope="module")
def models():
    jt = jquantize_pytree(jqa.init_tower_params(JCFG, jax.random.PRNGKey(0)), bits=8, min_size=0,
                          refine_iters=0)
    jl = jquantize_pytree(jq3.init_params(JCFG.llm, jax.random.PRNGKey(3)), bits=2, block=128,
                          min_size=0, pack=True, refine_iters=0, quantize_embeddings=True)
    to_t = lambda p: tart.params_from_flat(jart.flatten_pytree(p), "cpu")  # noqa: E731
    return {"jt": jt, "jl": jl, "tt": to_t(jt), "tl": to_t(jl),
            "jlf": jq3.fuse_params(jl, JCFG.llm), "tlf": tq3.fuse_params(to_t(jl), TCFG.llm)}


@pytest.fixture(autouse=True)
def _f32_mode():
    prev, jprev, threads = tqm._CONFIG["mm"], jqm._CONFIG["mm"], torch.get_num_threads()
    torch.set_num_threads(2)
    tqm.set_quant_config(mm="f32")
    jqm.set_quant_config(mm="f32")
    yield
    tqm._CONFIG["mm"], jqm._CONFIG["mm"] = prev, jprev
    torch.set_num_threads(threads)


@pytest.fixture
def p2_calls(monkeypatch):
    """Counts the int2 kernel's plain version, the route of packed 2-bit
    linears on CPU tensors."""
    calls = []
    ref = tqm.quant_dense_p2_reference

    def counted(*a, **k):
        calls.append(a[0].shape[0])
        return ref(*a, **k)

    monkeypatch.setattr(tqm, "quant_dense_p2_reference", counted)
    return calls


def _audio(n, seed):
    return (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(np.float32)


def _embeds(b, lf, seed):
    return (np.random.default_rng(seed).standard_normal((b, lf, 512)) * 0.3).astype(np.float32)


def test_every_llm_linear_packs_and_nothing_stacks(models):
    lin = [leaf for layer in models["tlf"]["layers"] for part in ("attn", "mlp")
           for name, leaf in layer[part].items() if isinstance(leaf, dict) and "w" in leaf]
    assert len(lin) == 4 * LLM["num_layers"]
    for leaf in lin:
        w = leaf["w"]
        assert isinstance(w, QuantizedLinear) and w.packed and w.bits == 2 and w.block == 128
    emb = models["tlf"]["embed"]
    assert isinstance(emb, QuantizedEmbedding) and emb.bits == 2 and not emb.q_t_packed
    assert tuple(emb.q_t.shape) == (512, 512)  # centered int8, V padded to a 512 multiple
    assert tfd.stack_decode_params(models["tlf"], TCFG.llm) is None
    assert jfd.stack_decode_params(models["jlf"], JCFG.llm) is None


@pytest.mark.parametrize("b,lf", [(2, 7), (1, 6)])
def test_transcribe_embeds_per_weight_ids_equal(models, p2_calls, b, lf):
    x = _embeds(b, lf, b + lf)
    valid = np.asarray([lf, 4][:b], np.int32)
    jtok, jcnt, jst = jqa.transcribe_embeds(models["jlf"], JCFG, jnp.asarray(x), jnp.asarray(valid),
                                            JDecodeConfig(max_new_tokens=6, eot_id=-1))
    ttok, tcnt, tst = tqa.transcribe_embeds(models["tlf"], TCFG, torch.from_numpy(x),
                                            torch.from_numpy(valid),
                                            TDecodeConfig(max_new_tokens=6, eot_id=-1))
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    # every linear of the prefill and of the 6 steps took the int2 route
    per_pass = 4 * LLM["num_layers"]
    assert len(p2_calls) == 7 * per_pass
    assert p2_calls[per_pass:] == [b] * (6 * per_pass)


def _save_jax_artifact(folder, models):
    meta = jmeta.ModelMetadata(
        family="qwen_asr", audio_pcm_scale=1.0,
        extra={"config": dataclasses.asdict(JCFG), "prompt_head_ids": list(HEAD),
               "prompt_suffix_ids": [3], "prompt_tail_ids": list(TAIL),
               "language_prompt_ids": {"en": [20, 21]}})
    jart.save_model(folder, {"tower": models["jt"], "llm": models["jl"]}, meta)


def test_load_qwen_session_reproduces_jax_session_ids(models, tmp_path):
    _save_jax_artifact(tmp_path, models)
    sess = load_qwen_session(tmp_path, "cpu", tokenizer=_Tok(), max_new_tokens=6, max_seconds=1.0)
    assert sess.cfg == TCFG and sess.stacked is None
    qkv = sess.llm_params["layers"][0]["attn"]["qkv"]["w"]
    assert qkv.packed and qkv.bits == 2
    jp, _ = jart.load_model(tmp_path)
    jsess = JSession(jp["tower"], jp["llm"], JCFG, tokenizer=_Tok(), template=JTemplate(HEAD, (3,), TAIL),
                     language_prompt_ids={"en": [20, 21]}, max_new_tokens=6, max_seconds=1.0)
    assert jsess.stacked is None
    clips = [_audio(int(0.7 * 16000), 7), _audio(2 * 16000, 8)]  # the second is cut to 1 s
    for clip in clips:
        want = jsess.transcribe(clip)
        got = sess.transcribe(clip)
        assert got.token_ids == want.token_ids and got.text == want.text
        assert len(got.token_ids) > 0
    got = sess.transcribe_batch(clips, language="en")
    want = jsess.transcribe_batch(clips, language="en")
    assert [r.token_ids for r in got] == [r.token_ids for r in want]


def _wav(pcm):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.asarray(pcm, np.int16).tobytes())
    return buf.getvalue()


def _concurrent(srv, clips):
    outs = [None] * len(clips)

    def call(i):
        outs[i] = srv.transcribe_bytes(_wav(clips[i]))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(clips))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return outs


def _sessions(models, max_new_tokens=4):
    kw = dict(tokenizer=_Tok(), max_new_tokens=max_new_tokens, max_seconds=0.5)
    tsess = QwenAsrSession(models["tt"], models["tl"], TCFG,
                           template=QwenPromptTemplate(head_ids=HEAD, tail_ids=TAIL), **kw)
    jsess = JSession(models["jt"], models["jl"], JCFG, template=JTemplate(head_ids=HEAD, tail_ids=TAIL),
                     **kw)
    return tsess, jsess


def test_micro_batcher_returns_each_requests_solo_ids(models, p2_calls):
    tsess, _ = _sessions(models)
    srv = SessionServer(tsess, max_batch=3, max_wait_ms=100.0, warmup=False)
    try:
        rng = np.random.default_rng(9)
        clips = [(rng.standard_normal(n) * 900).astype(np.int16) for n in (6000, 7000, 3000)]
        outs = _concurrent(srv, clips)
    finally:
        srv.close()
    assert max(p2_calls) > 1  # the batch ran the int2 route at M > 1
    for i, clip in enumerate(clips):
        want = tsess.transcribe(clip.astype(np.float32) / 32768.0)
        assert outs[i]["token_ids"] == want.token_ids and outs[i]["text"] == want.text, i


def test_continuous_server_rowwise_matches_jax_server(models, p2_calls):
    """Three concurrent requests on two slots (one waits and joins
    mid-flight): the rowwise route, whose linears run at M = n_slots."""
    tsess, jsess = _sessions(models)
    rng = np.random.default_rng(2)
    clips = [(rng.standard_normal(n) * 900).astype(np.int16) for n in (6000, 3000, 7000)]
    srv = tls.ContinuousSessionServer(tsess, n_slots=2, warmup=False)
    try:
        outs = _concurrent(srv, clips)
        st = srv.stats()
        t_max = srv.batcher.t_max
    finally:
        srv.close()
    assert st["step_kernel"] == "rowwise" and st["decode_steps"] > 0
    assert 2 in p2_calls  # the rowwise step's linears at M = n_slots
    jsrv = JaxServer(jsess, n_slots=2, warmup=False)
    try:
        jouts = _concurrent(jsrv, clips)
    finally:
        jsrv.close()
    for i, clip in enumerate(clips):
        assert outs[i]["token_ids"] == jouts[i]["token_ids"], i
        assert outs[i]["text"] == jouts[i]["text"]
        assert outs[i]["token_ids"] == tsess.transcribe(clip.astype(np.float32) / 32768.0).token_ids
        # and the same request alone through a batcher of the server's shape
        bat = ContinuousLlmBatcher(tsess.llm_params, TCFG.llm, tsess.decode_cfg, n_slots=2,
                                   t_max=t_max)
        emb, valid = tsess.prompt_embeds(clip.astype(np.float32) / 32768.0)
        slot = bat.try_submit(emb, valid)
        while bat.is_active(slot):
            bat.step()
        assert [t for t in bat.take_result(slot) if t != TCFG.eot_id] == outs[i]["token_ids"], i
