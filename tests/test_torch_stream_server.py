"""PyTorch port: the chunked-HTTP stream server over the batched runner
(``tests/test_stream_server.py``'s cases on the port), and its one named
divergence from the JAX package's copy: ``sync_latency_max_s``, the raw
per-sync latency maximum, beside the per-subtick ``tick_latency_max_s``.

Checks: concurrent connections emit exactly the single-stream session's
ids (and JAX's session's); masked ticks leave idle streams untouched;
overlapped windows follow the sessions' geometry; a failing extract fails
one stream and the ticker lives on; K ticks a sync give the same ids.
"""

import json
import socket
import threading
import types
import urllib.request

import jax
import numpy as np
import pytest
import torch

from asr_tpu.models import paraformer as jpf
from asr_tpu.runtime import artifact as jart
from asr_tpu.runtime import streaming_session as jss
from asr_tpu.streaming import paraformer_online as jpo
from asr_tpu_torch.models import paraformer as tpf
from asr_tpu_torch.ops import quant_matmul as tqm
from asr_tpu_torch.parallel import stream_server as ss
from asr_tpu_torch.parallel.stream_server import StreamingServer, start_stream_background, stream_pcm_over_http
from asr_tpu_torch.runtime import artifact as tart
from asr_tpu_torch.runtime.streaming_session import ParaformerStreamingSession
from asr_tpu_torch.streaming import multistream as ms
from asr_tpu_torch.streaming import paraformer_online as po

TINY = dict(vocab_size=50, hidden=32, num_heads=4, head_dim=8, ffn_dim=48, num_encoders0=1, num_encoders=1,
            num_decoders=1, num_decoder_ffn=1, fsmn_kernel=5, predictor_kernel=3)
CFG = po.ParaformerStreamConfig(base=tpf.ParaformerConfig(**TINY))


@pytest.fixture(autouse=True)
def _modes():
    prev, threads = tqm._CONFIG["mm"], torch.get_num_threads()
    torch.set_num_threads(2)
    tqm.set_quant_config(mm="f32")
    yield
    tqm._CONFIG["mm"] = prev
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    return tpf.init_params(CFG.base, torch.Generator().manual_seed(0), "cpu")


def _pcm(seed, chunks=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(chunks * CFG.chunk_samples) * 2000).astype(np.int16)


def _sequential_ids(params, pcm: np.ndarray) -> list[list[int]]:
    sess = ParaformerStreamingSession(params, CFG)
    c = CFG.chunk_samples
    out = [sess.push_chunk(pcm[i * c : (i + 1) * c].astype(np.float32)) for i in range(len(pcm) // c)]
    return [ids for ids in out if ids]


def _health(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
        return json.loads(r.read())


def test_concurrent_streams_token_identical_to_sequential_and_to_jax():
    jparams = jpf.init_params(jpf.ParaformerConfig(**TINY), jax.random.PRNGKey(0))
    params = tart.params_from_flat(jart.flatten_pytree(jparams), "cpu")
    runner = ms.paraformer_multistream(params, CFG, 4)
    httpd, srv, _ = start_stream_background(runner, CFG.chunk_samples, tick_wait_ms=40.0)
    port = httpd.server_address[1]
    try:
        pcms = [_pcm(seed) for seed in range(3)]
        want = [_sequential_ids(params, p) for p in pcms]
        jsess = jss.ParaformerStreamingSession(jparams, jpo.ParaformerStreamConfig(base=jpf.ParaformerConfig(**TINY)))
        jwant = [sum(want[0], [])]
        assert jsess.transcribe(pcms[0].astype(np.float32)).token_ids == jwant[0]
        results = [None] * 3

        def client(i):
            results[i] = stream_pcm_over_http("127.0.0.1", port, pcms[i], send_chunk=4096)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for i in range(3):
            evs = results[i]
            assert evs and evs[-1].get("done"), evs
            assert [e["ids"] for e in evs if "ids" in e] == want[i]
            ticks = [e["tick"] for e in evs if "ids" in e]
            assert ticks == sorted(ticks)
        health = _health(port)
        assert health["ok"] and health["ticks"] >= 3 and health["tick_latency_avg_s"] > 0
        assert health["slots_active"] == 0
        assert health["sync_latency_max_s"] >= health["tick_latency_max_s"] > 0
    finally:
        httpd.shutdown()
        srv.close()


def test_slot_reuse_and_exhaustion(params):
    runner = ms.paraformer_multistream(params, CFG, 1)  # a single slot
    httpd, srv, _ = start_stream_background(runner, CFG.chunk_samples, tick_wait_ms=10.0)
    port = httpd.server_address[1]
    try:
        pcm = _pcm(7, chunks=2)
        want = _sequential_ids(params, pcm)
        for _ in range(2):  # the per-connect reset restarts the slot cleanly
            evs = stream_pcm_over_http("127.0.0.1", port, pcm, send_chunk=8192)
            assert [e["ids"] for e in evs if "ids" in e] == want
        hold = socket.create_connection(("127.0.0.1", port), timeout=30)
        try:
            hold.sendall(b"POST /stream HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: chunked\r\n\r\n")
            assert hold.recv(64).startswith(b"HTTP/1.1 200")
            other = socket.create_connection(("127.0.0.1", port), timeout=30)
            other.sendall(b"POST /stream HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: chunked\r\n\r\n")
            assert other.recv(64).startswith(b"HTTP/1.1 503")  # every slot busy
            other.close()
            hold.sendall(b"0\r\n\r\n")
        finally:
            hold.close()
    finally:
        httpd.shutdown()
        srv.close()


def test_masked_tick_leaves_idle_stream_state_untouched(params):
    runner = ms.paraformer_multistream(params, CFG, 2)
    a0, a1 = _pcm(1, chunks=2).astype(np.float32), _pcm(2, chunks=2).astype(np.float32)
    c = CFG.chunk_samples
    out1 = runner.step(np.stack([a0[:c], a1[:c]]))
    runner.step(np.stack([a0[c : 2 * c], np.zeros(c, np.float32)]), active=np.array([True, False]))
    out3 = runner.step(np.stack([a0[:c], a1[c : 2 * c]]), active=np.array([False, True]))
    sess = ParaformerStreamingSession(params, CFG)
    w1, w2 = sess.push_chunk(a1[:c]), sess.push_chunk(a1[c : 2 * c])
    assert out1["ids"][1, : out1["count"][1]].tolist() == w1
    assert out3["ids"][1, : out3["count"][1]].tolist() == w2


class _EchoRunner:
    """A fake runner recording every (slot, window) fed to it; ``step_n``
    moves the server's clock by ``sync_s`` a call."""

    def __init__(self, n, clock=None, sync_s=0.0):
        self.n_streams = n
        self.windows = {i: [] for i in range(n)}
        self.resets = []
        self.clock, self.sync_s = clock, sync_s

    def reset(self, i):
        self.resets.append(i)

    def step(self, chunks, active=None):
        ids = np.zeros((self.n_streams, 1), np.int32)
        count = np.zeros((self.n_streams,), np.int32)
        for i in range(self.n_streams):
            if active is None or active[i]:
                self.windows[i].append(chunks[i].copy())
                ids[i, 0] = len(self.windows[i])
                count[i] = 1
        return {"ids": ids, "count": count}

    def step_n(self, chunks, active):
        outs = [self.step(c, a) for c, a in zip(chunks, active) if a.any()]
        outs += [{k: np.zeros_like(v) for k, v in outs[0].items()}] * (len(chunks) - len(outs))
        if self.clock is not None:
            self.clock[0] += self.sync_s
        return {k: np.stack([o[k] for o in outs]) for k in outs[0]}


def _wait(pred, timeout=10.0):
    import time

    deadline = time.time() + timeout
    while not pred() and time.time() < deadline:
        time.sleep(0.02)


def test_overlapped_windows_match_session_geometry():
    chunk, adv, tail = 8, 4, 6
    runner = _EchoRunner(1)
    srv = StreamingServer(runner, chunk, tick_wait_ms=1.0, advance_samples=adv, tail_pad_samples=tail,
                          drain_min_samples=chunk)
    try:
        i = srv.acquire()
        audio = np.arange(1, 15, dtype=np.float32)  # 14 samples
        srv.feed(i, audio)
        srv.finish_input(i)
        _wait(lambda: len(runner.windows[0]) >= 4)
        ws = runner.windows[0]
        assert len(ws) == 4, [w.tolist() for w in ws]
        padded = np.concatenate([audio, np.zeros(tail, np.float32)])
        for t, w in enumerate(ws):
            np.testing.assert_array_equal(w, padded[t * adv : t * adv + chunk])
        assert runner.resets == [0]
    finally:
        srv.close()


def test_ticker_survives_extract_exception(params):
    runner = ms.paraformer_multistream(params, CFG, 2)
    boom = {"armed": True}

    def extract(outs, i, st):
        if boom["armed"]:
            raise RuntimeError("synthetic extract failure")
        return [int(t) for t in np.asarray(outs["ids"][i])[: int(np.asarray(outs["count"][i]))]]

    httpd, srv, _ = start_stream_background(runner, CFG.chunk_samples, extract=extract, tick_wait_ms=10.0)
    port = httpd.server_address[1]
    try:
        evs = stream_pcm_over_http("127.0.0.1", port, _pcm(0), send_chunk=4096)
        assert any("error" in e for e in evs), evs
        health = _health(port)
        assert health["ok"] is False and "synthetic extract failure" in health["last_error"]
        boom["armed"] = False
        evs2 = stream_pcm_over_http("127.0.0.1", port, _pcm(1), send_chunk=4096)
        assert evs2 and evs2[-1].get("done") and any("ids" in e for e in evs2)
    finally:
        httpd.shutdown()
        srv.close()


def _dechunk(body: bytes) -> bytes:
    out = b""
    while body:
        line, _, rest = body.partition(b"\r\n")
        try:
            size = int(line.strip().split(b";")[0], 16)
        except ValueError:
            break
        if size == 0:
            break
        out += rest[:size]
        body = rest[size + 2 :]
    return out


def test_chunk_extension_size_line(params):
    runner = ms.paraformer_multistream(params, CFG, 2)
    httpd, srv, _ = start_stream_background(runner, CFG.chunk_samples, tick_wait_ms=10.0)
    port = httpd.server_address[1]
    try:
        pcm = _pcm(0, chunks=1)
        want = _sequential_ids(params, pcm)
        data = np.asarray(pcm, "<i2").tobytes()
        sock = socket.create_connection(("127.0.0.1", port), timeout=60)
        try:
            sock.sendall(b"POST /stream HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: chunked\r\n\r\n")
            ext = b";name=" + b"v" * 100  # a 100+-byte extension
            sock.sendall(f"{len(data):x}".encode() + ext + b"\r\n" + data + b"\r\n")
            sock.sendall(b"0\r\n\r\n")
            buf = b""
            while b"\r\n0\r\n\r\n" not in buf:
                piece = sock.recv(65536)
                if not piece:
                    break
                buf += piece
        finally:
            sock.close()
        text = buf.split(b"\r\n\r\n", 1)[1]
        assert b'"done"' in text
        got = [json.loads(ln)["ids"] for ln in _dechunk(text).decode().splitlines() if '"ids"' in ln]
        assert got == want
    finally:
        httpd.shutdown()
        srv.close()


def test_ticks_per_sync_identical_token_stream(params):
    pcms = [_pcm(seed, chunks=6) for seed in range(2)]
    want = [_sequential_ids(params, p) for p in pcms]
    runner = ms.paraformer_multistream(params, CFG, 2)
    httpd, srv, _ = start_stream_background(runner, CFG.chunk_samples, tick_wait_ms=40.0, ticks_per_sync=3)
    port = httpd.server_address[1]
    try:
        results = [None] * 2

        def client(i):
            results[i] = stream_pcm_over_http("127.0.0.1", port, pcms[i], send_chunk=1 << 16)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for i in range(2):
            assert results[i] and results[i][-1].get("done"), results[i]
            assert [e["ids"] for e in results[i] if "ids" in e] == want[i]
        health = _health(port)
        assert health["ok"] and health["ticks_per_sync"] == 3
        assert health["device_syncs"] < health["ticks"]
    finally:
        httpd.shutdown()
        srv.close()


def test_extract_failure_stops_subticks_within_sync(params):
    runner = ms.paraformer_multistream(params, CFG, 2)
    calls = []

    def extract(outs, i, st):
        calls.append(i)
        raise RuntimeError("always failing")

    httpd, srv, _ = start_stream_background(runner, CFG.chunk_samples, extract=extract, tick_wait_ms=10.0,
                                            ticks_per_sync=3)
    port = httpd.server_address[1]
    try:
        evs = stream_pcm_over_http("127.0.0.1", port, _pcm(5, chunks=6), send_chunk=200_000)
        assert len([e for e in evs if "error" in e]) == 1, evs
        assert not any("ids" in e for e in evs)
        assert len(calls) == 1, calls
    finally:
        httpd.shutdown()
        srv.close()


def test_sync_latency_max_is_the_raw_per_sync_time(monkeypatch):
    """The port's one divergence from the JAX package's server: with K = 3
    ticks a sync, a burst of 3 subticks and one of 2 each hold the device
    for one sync of 0.3 s (a fake clock moved by the runner). The
    per-subtick figure stays 0.3 / 2 = 0.15 s, as in JAX; the raw per-sync
    maximum, what a client waits, is 0.3 s."""
    clock = [0.0]
    monkeypatch.setattr(ss, "time", types.SimpleNamespace(
        perf_counter=lambda: clock[0], sleep=__import__("time").sleep, monotonic=__import__("time").monotonic))
    runner = _EchoRunner(1, clock, sync_s=0.3)
    srv = StreamingServer(runner, 8, tick_wait_ms=50.0, ticks_per_sync=3)
    try:
        i = srv.acquire()
        srv.feed(i, np.arange(40, dtype=np.float32))  # five windows of 8
        srv.finish_input(i)
        _wait(lambda: srv.stats()["device_syncs"] >= 2)
        st = srv.stats()
        assert (st["ticks"], st["device_syncs"]) == (5, 2)
        assert st["tick_latency_max_s"] == 0.15
        assert st["sync_latency_max_s"] == 0.3 >= st["tick_latency_max_s"]
    finally:
        srv.close()
