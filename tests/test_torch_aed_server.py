"""PyTorch port: continuous Whisper serving (``parallel/llm_server.py``)
against the port's own ``WhisperSession.transcribe`` and the JAX package's
continuous server on the same WAV bytes, at the JAX server test's geometry
(d 32, 4 heads, 0.8 s windows: the rowwise step on the CPU).

Ids are compared exactly: the session and both servers run f32 matmuls and
greedy argmax.
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

from asr_tpu.models import whisper as jwh
from asr_tpu.parallel.llm_server import ContinuousSessionServer as JaxServer
from asr_tpu.runtime import artifact as jart
from asr_tpu.runtime import whisper_session as jws
from asr_tpu_torch.models import whisper as twh
from asr_tpu_torch.ops import quant_matmul as tqm
from asr_tpu_torch.parallel import llm_server as tls
from asr_tpu_torch.parallel.aed_batcher import AedEngineSpec
from asr_tpu_torch.runtime import artifact as tart
from asr_tpu_torch.runtime import whisper_session as tws

WTINY = dict(vocab_size=96, d_model=32, encoder_layers=1, decoder_layers=2, num_heads=4,
             n_mels=16, ffn_dim=48, max_source_positions=40, max_target_positions=24, sot_id=1,
             eot_id=2, first_language_id=10, num_languages=4, no_speech_id=30,
             no_timestamps_id=5, transcribe_id=6, translate_id=7)
STATS_KEYS = {"ok", "engine", "decoder", "step_kernel", "replicas", "tensor_parallel", "slots",
              "slots_active", "queue_depth", "requests_served", "decode_steps",
              "tokens_generated", "steps_per_tick", "step_latency_avg_s", "queue_wait_avg_s",
              "window_samples", "sample_rate"}


class _Tok:
    def decode(self, ids):
        return " ".join(map(str, ids))


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
    jp = jwh.init_params(jwh.WhisperConfig(**WTINY), jax.random.PRNGKey(0))
    return jp, tart.params_from_flat(jart.flatten_pytree(jp), "cpu")


def _sessions(params, max_new_tokens=6, no_speech_threshold=None):
    jp, tp = params
    kw = dict(max_new_tokens=max_new_tokens, no_speech_threshold=no_speech_threshold,
              suppress_ids=(3,), begin_suppress_ids=(8,))
    jsess = jws.WhisperSession(jp, jwh.WhisperConfig(**WTINY), tokenizer=_Tok(),
                               session_cfg=jws.WhisperSessionConfig(**kw), window_seconds=0.8)
    tsess = tws.WhisperSession(tp, twh.WhisperConfig(**WTINY), tokenizer=_Tok(),
                               session_cfg=tws.WhisperSessionConfig(**kw), window_seconds=0.8)
    return jsess, tsess


def _concurrent(srv, clips):
    outs = [None] * len(clips)

    def call(i):
        outs[i] = srv.transcribe_bytes(_wav_bytes(clips[i]))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(clips))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return outs


def test_server_matches_session_and_jax_server(params):
    """Four concurrent requests on two slots (two wait in the queue and join
    mid-flight), one of them two windows long."""
    jsess, tsess = _sessions(params)
    rng = np.random.default_rng(2)
    clips = [(rng.standard_normal(n) * 900).astype(np.int16) for n in (9000, 12000, 5000, 20000)]
    srv = tls.ContinuousSessionServer(tsess, n_slots=2, warmup=True)
    try:
        outs = _concurrent(srv, clips)
        st = srv.stats()
    finally:
        srv.close()
    jsrv = JaxServer(jsess, n_slots=2, warmup=True)
    try:
        jouts = _concurrent(jsrv, clips)
    finally:
        jsrv.close()
    for i, clip in enumerate(clips):
        want = tsess.transcribe(clip.astype(np.float32) / 32768.0).token_ids
        assert outs[i]["token_ids"] == want == jouts[i]["token_ids"], i
        assert outs[i]["text"] == jouts[i]["text"] and outs[i]["engine"] == "continuous"
    assert outs[3]["windows"] == 2 and "windows" not in outs[0]
    assert set(st) == STATS_KEYS
    assert st["ok"] and st["decoder"] == "aed" and st["step_kernel"] == "rowwise"
    assert st["requests_served"] == 5  # windows: 3 + 2
    assert st["slots_active"] == 0 and st["queue_depth"] == 0 and st["slots"] == 2
    assert st["tokens_generated"] > 0 and st["decode_steps"] > 0 and st["step_latency_avg_s"] > 0


def test_http_round_trip(params):
    _, tsess = _sessions(params)
    httpd, srv, thread = tls.start_background_continuous(tsess, n_slots=2, kv_dtype="bf16")
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        clip = (np.random.default_rng(4).standard_normal(7000) * 900).astype(np.int16)
        req = urllib.request.Request(base + "/transcribe", data=_wav_bytes(clip), method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            out = json.loads(resp.read())
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
        thread.join(timeout=10)
    assert out["engine"] == "continuous" and isinstance(out["token_ids"], list)
    assert health["requests_served"] == 1 and set(health) == STATS_KEYS
    assert srv.batcher.state["layers"][0]["self_k"].dtype == torch.bfloat16


def test_no_speech_window_skips_the_slot(params):
    """A window over the no-speech threshold returns empty ids without taking
    a slot, as the session's transcribe drops it."""
    _, tsess = _sessions(params, no_speech_threshold=-1.0)  # every window "silent"
    srv = tls.ContinuousSessionServer(tsess, n_slots=2, warmup=True)
    try:
        clip = (np.random.default_rng(3).standard_normal(6000) * 900).astype(np.int16)
        out = srv.transcribe_bytes(_wav_bytes(clip))
        st = srv.stats()
    finally:
        srv.close()
    assert tsess.transcribe(clip.astype(np.float32) / 32768.0).token_ids == []
    assert out["token_ids"] == [] and out["text"] == ""
    assert st["requests_served"] == 1 and st["tokens_generated"] == 0 and st["decode_steps"] == 0


def test_refusals(params):
    _, tsess = _sessions(params)

    class LlmSession:  # the LLM families' surface, without the AED one
        device = torch.device("cpu")

        def prompt_embeds(self, *a, **k):
            raise AssertionError

    # served on the LLM engine (tests/test_torch_llm_server.py), whose
    # tensor-parallel form takes T devices a replica
    with pytest.raises(ValueError, match="tensor_parallel=2 needs 2 devices"):
        tls.ContinuousSessionServer(LlmSession(), warmup=False, tensor_parallel=2)
    with pytest.raises(TypeError, match="no continuous serving surface"):
        tls.ContinuousSessionServer(object(), warmup=False)
    with pytest.raises(ValueError, match="data_parallel"):
        tls.ContinuousSessionServer(tsess, warmup=False, data_parallel=2)
    with pytest.raises(ValueError, match="does not compose with the AED continuous engine"):
        tls.ContinuousSessionServer(tsess, warmup=False, tensor_parallel=2)
    with pytest.raises(ValueError, match="kv_dtype"):
        tls.ContinuousSessionServer(tsess, warmup=False, kv_dtype="f16")


def test_continuous_prefill_matches_jax(params):
    jsess, tsess = _sessions(params, no_speech_threshold=0.6)
    audio = (np.random.default_rng(9).standard_normal(9000) * 0.03).astype(np.float32)
    jpre, tpre = jsess.continuous_prefill(audio), tsess.continuous_prefill(audio)
    assert (tpre["p_len"], tpre["tc_valid"], tpre["skip"]) == (jpre["p_len"], jpre["tc_valid"],
                                                              jpre["skip"])
    want = np.asarray(jpre["logits0"])
    np.testing.assert_allclose(tpre["logits0"].numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    assert tsess.aed_engine_spec() == AedEngineSpec(**jsess.aed_engine_spec().__dict__)


def test_data_parallel_replicas_match_session_and_jax(params):
    """``data_parallel=2`` for the AED engine on two CPU positions: each
    replica its own batcher behind one queue, the session's prefill placed
    on the replica's device; ids equal the session's and JAX's dp 2
    server's."""
    jsess, tsess = _sessions(params)
    rng = np.random.default_rng(21)
    clips = [(rng.standard_normal(n) * 900).astype(np.int16) for n in (9000, 5000, 12000, 7000)]
    srv = tls.ContinuousSessionServer(tsess, n_slots=1, warmup=True, data_parallel=2,
                                      devices=[torch.device("cpu")] * 2)
    try:
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
        solo = tsess.transcribe(clip.astype(np.float32) / 32768.0).token_ids
        assert outs[i]["token_ids"] == solo == jouts[i]["token_ids"], i
    assert st["replicas"] == 2 and st["slots"] == 2 and st["requests_served"] == 4
