"""PyTorch port: continuous Qwen3-ASR serving (``parallel/llm_server.py``,
the LLM branch) against the port's own ``QwenAsrSession.transcribe`` and the
JAX package's continuous server on the same WAV bytes, at the JAX server
test's geometry (a 32-wide tower, a 48-wide one-layer Qwen3 with 4/2 heads
of 16, 0.5 s windows: the rowwise step on the CPU).

Ids are compared exactly: the session and both servers run f32 matmuls and
greedy argmax. A last test serves a q4 session at head width 128 on the
kernel route (the multi-slot step's plain version on the CPU) and holds each
request against the same request run alone through the batcher.
"""

import io
import json
import threading
import urllib.request
import wave

import jax
import numpy as np
import pytest
import torch

from asr_tpu.layers import qwen3 as jq3
from asr_tpu.models import qwen_asr as jqa
from asr_tpu.parallel.llm_server import ContinuousSessionServer as JaxServer
from asr_tpu.runtime import artifact as jart
from asr_tpu.runtime.qwen_session import QwenAsrSession as JSession
from asr_tpu.runtime.qwen_session import QwenPromptTemplate as JTemplate
from asr_tpu_torch.layers import qwen3 as tq3
from asr_tpu_torch.models import qwen_asr as tqa
from asr_tpu_torch.ops import fused_decode as tfd
from asr_tpu_torch.ops import fused_decode_multi as tfm
from asr_tpu_torch.ops import quant_matmul as tqm
from asr_tpu_torch.parallel import llm_server as tls
from asr_tpu_torch.parallel.llm_batcher import ContinuousLlmBatcher, _bucket
from asr_tpu_torch.quant.quantize import quantize_pytree
from asr_tpu_torch.runtime import artifact as tart
from asr_tpu_torch.runtime.qwen_session import QwenAsrSession, QwenPromptTemplate

LLM = dict(vocab_size=120, hidden=48, num_layers=1, num_heads=4, num_kv_heads=2, head_dim=16,
           ffn_dim=64, rope_theta=1e4)
TOWER = dict(n_mels=16, tower_dim=32, tower_layers=1, tower_heads=4, tower_ffn=48,
             downsample_hidden=8, chunks_per_window=2, output_dim=48, eot_id=-1)
STATS_KEYS = {"ok", "engine", "decoder", "step_kernel", "replicas", "tensor_parallel", "slots",
              "slots_active", "queue_depth", "requests_served", "decode_steps",
              "tokens_generated", "steps_per_tick", "step_latency_avg_s", "queue_wait_avg_s",
              "window_samples", "sample_rate"}


class _Tok:
    def decode(self, ids):
        return " ".join(map(str, ids))


class _TagTok:  # every window's decode carries a "language X<asr_text>" prefix
    def decode(self, ids):
        return "language Chinese<asr_text>w" + str(len(ids))


def _wav_bytes(samples: np.ndarray, rate: int = 16000) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.asarray(samples, np.int16).tobytes())
    return buf.getvalue()


@pytest.fixture(autouse=True)
def _torch_mode():
    prev, mm = torch.get_num_threads(), tqm._CONFIG["mm"]
    torch.set_num_threads(2)
    tqm.set_quant_config(mm="f32")
    yield
    tqm._CONFIG["mm"] = mm
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def params():
    jcfg = jqa.QwenAsrConfig(**TOWER, llm=jq3.Qwen3Config(**LLM))
    jt = jqa.init_tower_params(jcfg, jax.random.PRNGKey(0))
    jl = jq3.init_params(jcfg.llm, jax.random.PRNGKey(1))
    to_t = lambda p: tart.params_from_flat(jart.flatten_pytree(p), "cpu")  # noqa: E731
    return jcfg, jt, jl, to_t(jt), to_t(jl)


def _sessions(params, tokenizer=None, max_new_tokens=4):
    jcfg, jt, jl, tt, tl = params
    kw = dict(template=None, max_new_tokens=max_new_tokens, max_seconds=0.5)
    jsess = JSession(jt, jl, jcfg, tokenizer=tokenizer or _Tok(),
                     **dict(kw, template=JTemplate(head_ids=(1, 2), tail_ids=(4,))))
    tsess = QwenAsrSession(tt, tl, tqa.QwenAsrConfig(**TOWER, llm=tq3.Qwen3Config(**LLM)),
                           tokenizer=tokenizer or _Tok(),
                           **dict(kw, template=QwenPromptTemplate(head_ids=(1, 2), tail_ids=(4,))))
    return jsess, tsess


def _concurrent(srv, clips, seeds=None):
    outs = [None] * len(clips)

    def call(i):
        outs[i] = srv.transcribe_bytes(_wav_bytes(clips[i]),
                                       seed=None if seeds is None else seeds[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(clips))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return outs


def _solo(tsess, clip):
    return tsess.transcribe(clip.astype(np.float32) / 32768.0).token_ids


def test_prompt_embeds_match_jax(params):
    jsess, tsess = _sessions(params)
    audio = (np.random.default_rng(0).standard_normal(5000) * 0.02).astype(np.float32)
    je, jv = jsess.prompt_embeds(audio)
    te, tv = tsess.prompt_embeds(audio)
    assert tv == jv and tuple(te.shape) == tuple(je.shape)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(je)).max())
    assert tsess.llm_cfg == tq3.Qwen3Config(**LLM)


def test_server_matches_session_and_jax_server(params):
    """Four concurrent requests on two slots (two wait in the queue and join
    mid-flight), one of them two windows long; the caches hold one prefill
    bucket and the budget."""
    jsess, tsess = _sessions(params)
    rng = np.random.default_rng(2)
    clips = [(rng.standard_normal(n) * 900).astype(np.int16) for n in (6000, 7000, 3000, 12000)]
    srv = tls.ContinuousSessionServer(tsess, n_slots=2, warmup=True)
    try:
        outs = _concurrent(srv, clips)
        st = srv.stats()
        lf = int(tsess.prompt_embeds(np.zeros(16, np.float32))[0].shape[0])
        assert srv.batcher.t_max == -(-(_bucket(lf) + 5) // 8) * 8
    finally:
        srv.close()
    jsrv = JaxServer(jsess, n_slots=2, warmup=True)
    try:
        jouts = _concurrent(jsrv, clips)
    finally:
        jsrv.close()
    for i, clip in enumerate(clips):
        want = [t for s in range(0, len(clip), srv.window)
                for t in _solo(tsess, clip[s : s + srv.window])]
        assert outs[i]["token_ids"] == want == jouts[i]["token_ids"], i
        assert outs[i]["text"] == jouts[i]["text"] and outs[i]["engine"] == "continuous"
    assert outs[3]["windows"] == 2 and "windows" not in outs[0]
    assert set(st) == STATS_KEYS
    assert st["ok"] and st["decoder"] == "llm" and st["step_kernel"] == "rowwise"
    assert st["requests_served"] == 5  # windows: 3 + 2
    assert st["slots_active"] == 0 and st["queue_depth"] == 0 and st["slots"] == 2
    assert st["tokens_generated"] > 0 and st["decode_steps"] > 0 and st["step_latency_avg_s"] > 0


def test_long_audio_is_post_processed_per_window(params):
    """Over-window audio splits into window requests; each window's
    "language X<asr_text>" prefix is stripped, as the JAX server does."""
    jsess, tsess = _sessions(params, tokenizer=_TagTok())
    long = (np.random.default_rng(3).standard_normal(16000) * 900).astype(np.int16)
    srv = tls.ContinuousSessionServer(tsess, n_slots=2, warmup=False)
    try:
        out = srv.transcribe_bytes(_wav_bytes(long))
    finally:
        srv.close()
    jsrv = JaxServer(jsess, n_slots=2, warmup=False)
    try:
        jout = jsrv.transcribe_bytes(_wav_bytes(long))
    finally:
        jsrv.close()
    assert out["windows"] == 2 and out["token_ids"] == jout["token_ids"]
    assert out["text"] == jout["text"] == "w5 w5"


def test_http_round_trip_with_seed(params):
    """``POST /transcribe?seed=N`` reaches the engine (a no-op for greedy:
    the ids are the session's); bf16 caches; ``/healthz``."""
    _, tsess = _sessions(params)
    httpd, srv, thread = tls.start_background_continuous(tsess, n_slots=2, kv_dtype="bf16")
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        clip = (np.random.default_rng(4).standard_normal(5000) * 800).astype(np.int16)
        req = urllib.request.Request(base + "/transcribe?seed=7", data=_wav_bytes(clip),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            out = json.loads(resp.read())
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
        thread.join(timeout=10)
    assert out["engine"] == "continuous" and out["token_ids"] == _solo(tsess, clip)
    assert set(health) == STATS_KEYS and health["requests_served"] == 1
    assert health["decoder"] == "llm" and health["ok"]
    assert srv.batcher.state["layers"][0]["k"].dtype == torch.bfloat16


def test_steps_per_tick_matches_session_and_jax(params):
    jsess, tsess = _sessions(params)
    rng = np.random.default_rng(7)
    clips = [(rng.standard_normal(6000) * 900).astype(np.int16) for _ in range(3)]
    srv = tls.ContinuousSessionServer(tsess, n_slots=2, warmup=True, steps_per_tick=3)
    try:
        outs = _concurrent(srv, clips)
        st = srv.stats()
    finally:
        srv.close()
    jsrv = JaxServer(jsess, n_slots=2, warmup=True, steps_per_tick=3)
    try:
        jouts = _concurrent(jsrv, clips)
    finally:
        jsrv.close()
    for i, clip in enumerate(clips):
        assert outs[i]["token_ids"] == _solo(tsess, clip) == jouts[i]["token_ids"], i
    assert st["steps_per_tick"] == 3 and st["requests_served"] == 3


def test_refusals(params):
    _, tsess = _sessions(params)
    with pytest.raises(TypeError, match="no continuous serving surface"):
        tls.ContinuousSessionServer(object(), warmup=False)  # neither LLM nor AED
    with pytest.raises(ValueError, match="data_parallel"):
        tls.ContinuousSessionServer(tsess, warmup=False, data_parallel=2)
    with pytest.raises(ValueError, match="tensor_parallel=2 needs 2 devices but only 1"):
        tls.ContinuousSessionServer(tsess, warmup=False, tensor_parallel=2)
    with pytest.raises(ValueError, match="kv_dtype"):
        tls.ContinuousSessionServer(tsess, warmup=False, kv_dtype="f16")


def test_kernel_route_serves_each_request_as_alone():
    """A q4 session at head width 128 with stacked weights: every decode step
    of the served requests is one multi-slot step, and each request's ids
    equal that request run alone through the same batcher."""
    lcfg = tq3.Qwen3Config(vocab_size=300, hidden=256, num_layers=2, num_heads=2, num_kv_heads=1,
                           ffn_dim=512)
    cfg = tqa.QwenAsrConfig(**dict(TOWER, output_dim=256), llm=lcfg)
    g = torch.Generator().manual_seed(0)
    tower = tqa.init_tower_params(cfg, g)
    llm = quantize_pytree(tq3.init_params(lcfg, g), bits=4, pack=True, refine_iters=0, min_size=0,
                          quantize_embeddings=True)
    tqm.set_quant_config(mm="bf16")
    sess = QwenAsrSession(tower, llm, cfg, tokenizer=_Tok(), max_new_tokens=4, max_seconds=0.5,
                          template=QwenPromptTemplate(head_ids=(1, 2), tail_ids=(4,)))
    sess.stacked = tfd.stack_decode_params(sess.llm_params, lcfg)  # a session stacks on a card only
    rng = np.random.default_rng(9)
    clips = [(rng.standard_normal(n) * 900).astype(np.int16) for n in (6000, 3000, 7000)]
    calls = []
    ref = tfm.fused_decode_step_multi_reference

    def counted(*a, **k):
        calls.append(1)
        return ref(*a, **k)

    tfm.fused_decode_step_multi_reference = counted
    try:
        srv = tls.ContinuousSessionServer(sess, n_slots=2, warmup=False, kv_dtype="bf16")
        try:
            outs = _concurrent(srv, clips)
            st = srv.stats()
        finally:
            srv.close()
    finally:
        tfm.fused_decode_step_multi_reference = ref
    assert st["step_kernel"] == "fused" and len(calls) == st["decode_steps"] > 0
    for i, clip in enumerate(clips):
        bat = ContinuousLlmBatcher(sess.llm_params, lcfg, sess.decode_cfg, n_slots=2,
                                   t_max=srv.batcher.t_max, kv_dtype=torch.bfloat16,
                                   stacked=sess.stacked)
        emb, valid = sess.prompt_embeds(clip.astype(np.float32) / 32768.0)
        slot = bat.try_submit(emb, valid)
        while bat.is_active(slot):
            bat.step()
        assert outs[i]["token_ids"] == bat.take_result(slot), i


def _count_submits(srv):
    """Per replica, the requests its batcher took."""
    counts = [0] * len(srv.replicas)
    for i, rep in enumerate(srv.replicas):
        orig = rep.batcher.try_submit

        def counted(*a, _i=i, _orig=orig, **k):
            slot = _orig(*a, **k)
            counts[_i] += slot is not None
            return slot

        rep.batcher.try_submit = counted
    return counts


def test_continuous_server_data_parallel_identity(params):
    """``data_parallel=2`` on two CPU positions: two batcher replicas behind
    one queue; every request's ids equal the session's and JAX's dp 2
    server's, both replicas serve, ``/healthz`` shows 2 replicas (JAX:
    ``test_continuous_server_data_parallel_identity``)."""
    jsess, tsess = _sessions(params)
    rng = np.random.default_rng(7)
    clips = [(rng.standard_normal(6000) * 900).astype(np.int16) for _ in range(5)]
    srv = tls.ContinuousSessionServer(tsess, n_slots=1, warmup=True, data_parallel=2,
                                      devices=[torch.device("cpu")] * 2)
    try:
        st = srv.stats()
        assert st["replicas"] == 2 and st["slots"] == 2 and st["tensor_parallel"] == 1
        counts = _count_submits(srv)
        outs = _concurrent(srv, clips)
        st = srv.stats()
    finally:
        srv.close()
    jsrv = JaxServer(jsess, n_slots=1, warmup=False, data_parallel=2)
    try:
        jouts = _concurrent(jsrv, clips)
    finally:
        jsrv.close()
    for i, clip in enumerate(clips):
        assert outs[i]["token_ids"] == _solo(tsess, clip) == jouts[i]["token_ids"], i
    assert all(c > 0 for c in counts), counts
    assert st["requests_served"] == 5 and st["slots_active"] == 0 and st["queue_depth"] == 0
    assert set(st) == STATS_KEYS


def test_continuous_server_tensor_parallel_identity(params):
    """``data_parallel=2, tensor_parallel=2`` on four CPU positions: each
    replica a (1, 2) sub-mesh on the rowwise tensor-parallel engine; the ids
    equal the session's and JAX's dp 2 x tp 2 server's (JAX:
    ``test_continuous_server_tensor_parallel_identity``)."""
    jsess, tsess = _sessions(params)
    rng = np.random.default_rng(13)
    clips = [(rng.standard_normal(6000) * 900).astype(np.int16) for _ in range(4)]
    srv = tls.ContinuousSessionServer(tsess, n_slots=2, warmup=True, data_parallel=2,
                                      tensor_parallel=2, devices=[torch.device("cpu")] * 4)
    try:
        assert all(r.batcher.mesh is not None for r in srv.replicas)
        outs = _concurrent(srv, clips)
        st = srv.stats()
    finally:
        srv.close()
    jsrv = JaxServer(jsess, n_slots=2, warmup=False, data_parallel=2, tensor_parallel=2)
    try:
        jouts = _concurrent(jsrv, clips)
    finally:
        jsrv.close()
    for i, clip in enumerate(clips):
        assert outs[i]["token_ids"] == _solo(tsess, clip) == jouts[i]["token_ids"], i
    assert st["tensor_parallel"] == 2 and st["replicas"] == 2 and st["requests_served"] == 4
    assert st["step_kernel"] == "rowwise"  # the multi-slot kernel is single-device


def test_a_failing_replica_fails_every_request_and_stops(params):
    """A replica whose step raises: its requests and the queue fail with the
    error, ``/healthz`` reports it, new submissions are refused, and the
    sibling replica stops."""
    _, tsess = _sessions(params)
    srv = tls.ContinuousSessionServer(tsess, n_slots=1, warmup=False, data_parallel=2,
                                      devices=[torch.device("cpu")] * 2)
    try:
        for rep in srv.replicas:
            rep.batcher.step_tick = lambda: (_ for _ in ()).throw(RuntimeError("device lost"))
        rng = np.random.default_rng(1)
        reqs = [srv.submit((rng.standard_normal(3000) * 0.02).astype(np.float32)) for _ in range(3)]
        for r in reqs:
            assert r.event.wait(60)
            assert isinstance(r.error, RuntimeError)
        st = srv.stats()
        assert st["ok"] is False and "device lost" in st["error"]
        with pytest.raises(RuntimeError, match="device lost"):
            srv.submit(np.zeros(100, np.float32))
    finally:
        srv.close()
    assert not any(rep.thread.is_alive() for rep in srv.replicas)
