"""HTTP serving: a session behind the micro-batching scheduler.

Counterpart of ``asr_tpu/parallel/http_server.py``: a stdlib threaded HTTP
server whose POST handler enqueues each request's windows into
:class:`MicroBatcher`, so concurrent requests coalesce into fixed-shape
batches.

Endpoints:
- ``POST /transcribe``  body = WAV / FLAC / OGG / MP3 bytes (any rate,
  resampled server-side). Response JSON: text, token_ids, audio_seconds.
- ``GET /healthz``      scheduler counters and batch latency.
"""

from __future__ import annotations

import inspect
import io
import json
import tempfile
import threading
import time
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

import numpy as np
import torch

from asr_tpu_torch.parallel.server import MicroBatcher
from asr_tpu_torch.runtime import audio as audio_io


def _join_window_texts(texts: list[str]) -> str:
    """Join per-window transcripts of a long request: a space only where both
    sides of the boundary are word characters of a space-delimited script
    (below U+2E80), so CJK text gets no spurious separators."""
    out = ""
    for t in texts:
        if not t:
            continue
        if out and (out[-1].isalnum() and ord(out[-1]) < 0x2E80
                    and t[0].isalnum() and ord(t[0]) < 0x2E80):
            out += " "
        out += t
    return out


def decode_audio_bytes(data: bytes, target_rate: int) -> np.ndarray:
    """Sniff the body format (WAV / FLAC / OGG / MP3) and decode to mono
    float32 in the int16 numeric range at ``target_rate``."""
    if data[:4] == b"RIFF":
        return decode_wav_bytes(data, target_rate)
    if data[:4] == b"fLaC":
        from asr_tpu_torch.runtime.flac import read_flac_bytes

        samples, rate = read_flac_bytes(data)
    elif data[:4] == b"OggS":
        from asr_tpu_torch.runtime.ogg import read_ogg

        with tempfile.NamedTemporaryFile(suffix=".ogg") as f:
            f.write(data)
            f.flush()
            ch_samples, rate = read_ogg(f.name)
        samples = ch_samples.T  # (n, channels) for the shared downmix below
    elif data[:3] == b"ID3" or (len(data) > 2 and data[0] == 0xFF and (data[1] & 0xE0) == 0xE0):
        from asr_tpu_torch.runtime.mp3 import read_mp3

        with tempfile.NamedTemporaryFile(suffix=".mp3") as f:
            f.write(data)
            f.flush()
            samples, rate = read_mp3(f.name)
    else:
        raise ValueError(
            "unrecognized audio body (expected WAV 'RIFF', FLAC 'fLaC', "
            "OGG 'OggS', or MP3)")
    if samples.ndim > 1:
        samples = samples.mean(axis=1)
    if rate != target_rate:
        samples = audio_io.resample(samples, rate, target_rate)
    return np.ascontiguousarray(samples, np.float32)


def decode_wav_bytes(data: bytes, target_rate: int) -> np.ndarray:
    """In-memory WAV -> mono float32 in the int16 numeric range."""
    with wave.open(io.BytesIO(data), "rb") as w:
        rate = w.getframerate()
        channels = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        samples = np.frombuffer(raw, np.int16).astype(np.float32)
    elif width == 4:
        # The wave module only delivers integer PCM, so width 4 is int32.
        samples = np.frombuffer(raw, np.int32).astype(np.float32) / 65536.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if channels > 1:
        samples = samples.reshape(-1, channels).mean(axis=1)
    if rate != target_rate:
        samples = audio_io.resample(samples, rate, target_rate)
    return np.ascontiguousarray(samples, np.float32)


class SessionServer:
    """Wraps a session's batch forward (the windowed families, and
    Qwen3-ASR's batched left-padded lockstep decode) in a MicroBatcher.
    Long requests window-split into the batcher as extra rows."""

    def __init__(self, session, max_batch: int = 8, max_wait_ms: float = 5.0,
                 warmup: bool = True, language: str | None = None):
        self.session = session
        fwd_kw = {}
        if language and "language" in inspect.signature(session._forward).parameters:
            fwd_kw["language"] = language
        self._forward_kw = fwd_kw
        self.sample_rate = getattr(session, "sample_rate", 16000)
        self.pcm_scale = getattr(session, "pcm_scale", 32768.0)
        self.window = session.window_samples
        self.device = session.device
        self._lat_lock = threading.Lock()
        self._lat_total = 0.0
        self._lat_count = 0
        self._lat_max = 0.0

        def batch_fn(audio: np.ndarray, valid: np.ndarray):
            t0 = time.perf_counter()
            runner = getattr(session, "runner", None)
            if runner is not None:
                # a session built with mesh=: the micro-batch splits over the
                # mesh's data axis (serve --data-parallel)
                toks, counts = runner(
                    lambda p, a, v: session._forward(p, a, v, **self._forward_kw),
                    session.params, audio, valid)
            else:
                toks, counts = session._forward(
                    session.params, torch.from_numpy(audio).to(self.device),
                    torch.from_numpy(valid).to(self.device), **self._forward_kw,
                )
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            with self._lat_lock:
                self._lat_total += dt
                self._lat_count += 1
                self._lat_max = max(self._lat_max, dt)
            return {"tokens": toks, "counts": counts}

        self.batcher = MicroBatcher(batch_fn, self.window, max_batch=max_batch, max_wait_ms=max_wait_ms)
        if warmup:
            self.batcher.submit(np.zeros(self.window, np.float32)).result()

    def transcribe_bytes(self, data: bytes, seed: int | None = None) -> dict:
        if seed is not None:
            raise ValueError("?seed= is not supported by the micro-batched surface")
        samples = decode_audio_bytes(data, self.sample_rate)
        if self.pcm_scale != 32768.0:
            samples = samples * np.float32(self.pcm_scale / 32768.0)
        n = len(samples)
        w = self.window
        stride = getattr(self.session, "stride_samples", None) or w
        starts = audio_io.iter_windows(n, w, stride)
        futures = [self.batcher.submit(np.ascontiguousarray(samples[s : s + w])) for s in starts]
        ids: list[int] = []
        texts: list[str] = []
        tok = self.session.tokenizer
        # LLM sessions mark postprocess_per_window: each window carries its own
        # "language X<asr_text>" prefix, which _postprocess strips, so decode
        # and strip run per window. Every other family decodes the joined ids
        # once, as session.transcribe does.
        per_window = bool(getattr(self.session, "postprocess_per_window", False))
        for fut in futures:
            out = fut.result()
            win_ids = [int(t) for t in out["tokens"][: int(out["counts"])]]
            ids.extend(win_ids)
            if tok and per_window:
                texts.append(self.session._postprocess(tok.decode(win_ids)))
        if tok and not per_window:
            texts = [self.session._postprocess(tok.decode(ids))]
        resp = {"text": _join_window_texts(texts), "token_ids": ids,
                "audio_seconds": n / self.sample_rate}
        if len(starts) > 1:
            resp["windows"] = len(starts)
        return resp

    def stats(self) -> dict:
        with self._lat_lock:
            avg = self._lat_total / self._lat_count if self._lat_count else 0.0
            mx = self._lat_max
        return {
            "ok": True,
            "batches_dispatched": self.batcher.batches_dispatched,
            "requests_served": self.batcher.requests_served,
            "window_samples": self.window,
            "sample_rate": self.sample_rate,
            "batch_latency_avg_s": round(avg, 4),
            "batch_latency_max_s": round(mx, 4),
        }

    def close(self) -> None:
        self.batcher.close()


def make_http_server(server: SessionServer, host: str = "127.0.0.1", port: int = 8000):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, server.stats())
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            parts = urlsplit(self.path)
            if parts.path != "/transcribe":
                self._reply(404, {"error": "not found"})
                return
            data = self.rfile.read(int(self.headers.get("Content-Length", "0")))
            try:
                q = parse_qs(parts.query)
                seed = int(q["seed"][0]) if "seed" in q else None
                self._reply(200, server.transcribe_bytes(data, seed=seed))
            except Exception as exc:  # malformed audio etc.
                self._reply(400, {"error": str(exc)})

    return ThreadingHTTPServer((host, port), Handler)


def serve_forever(session, host: str = "127.0.0.1", port: int = 8000, max_batch: int = 8,
                  max_wait_ms: float = 5.0, warmup: bool = True, language: str | None = None):
    """Blocking entry point."""
    srv = SessionServer(session, max_batch=max_batch, max_wait_ms=max_wait_ms,
                        warmup=warmup, language=language)
    httpd = make_http_server(srv, host, port)
    print(f"serving on http://{host}:{httpd.server_address[1]} "
          f"(max_batch={max_batch}, max_wait_ms={max_wait_ms})")
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        srv.close()


def start_background(session, host: str = "127.0.0.1", port: int = 0, max_batch: int = 8,
                     max_wait_ms: float = 5.0, warmup: bool = True, language: str | None = None):
    """Non-blocking start: returns (httpd, SessionServer, thread); the port
    is ``httpd.server_address[1]``. Stop with ``httpd.shutdown()``,
    ``httpd.server_close()`` and ``SessionServer.close()``."""
    srv = SessionServer(session, max_batch=max_batch, max_wait_ms=max_wait_ms,
                        warmup=warmup, language=language)
    httpd = make_http_server(srv, host, port)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, srv, thread
