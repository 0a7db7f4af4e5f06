"""Network surface for batched real-time streaming: N concurrent HTTP
connections -> one vmapped device step per tick.

The reference's streaming runtimes are single-process script loops, one
stream per process (``Paraformer/Streaming/Inference_Paraformer_Streaming_
ONNX.py:405-449``). The TPU-native serving shape is the opposite: every
concurrent connection maps to one slot of a :class:`MultiStreamRunner`
(``streaming/multistream.py``), and a single ticker thread advances ALL
active streams with ONE jitted dispatch per chunk tick — per-stream
latency stays ~flat while throughput scales with the slot count.

Wire protocol (stdlib-only full duplex over one HTTP/1.1 connection):

- ``POST /stream`` with ``Transfer-Encoding: chunked``; the body is raw
  16 kHz mono **int16 little-endian PCM**, sent in any chunk sizes.
- The response starts immediately (also chunked); every tick on which the
  stream emits tokens produces one JSON line ``{"tick": T, "ids": [...]}``
  and the final chunk is ``{"done": true, "ticks": N}``.
- Slots are allocated on connect and reset+freed on disconnect; when all
  slots are busy the server answers 503.
- ``GET /healthz``: slot occupancy + per-tick device latency.

Idle handling: a tick runs as soon as ANY active stream has a full chunk
buffered (after ``tick_wait_ms`` of coalescing); connections without fresh
audio ride the fixed-shape batch as masked slots — their caches are left
untouched (``MultiStreamRunner.step(active=...)``) and their outputs
dropped, which keeps tick semantics identical to running each stream
alone.
"""

from __future__ import annotations

import json
import queue
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


class _Slot:
    def __init__(self):
        self.buffer = np.zeros(0, np.float32)
        self.ext_state: dict = {}
        self.out_q: queue.Queue = queue.Queue()
        self.lock = threading.Lock()
        self.draining = False
        self.finished = False  # sentinel already queued
        self.ticks = 0


class StreamingServer:
    """Owns the MultiStreamRunner, slot allocation and the ticker thread.

    ``extract(outs, i, ext_state) -> list[int]`` maps the runner's
    per-tick output pytree to stream ``i``'s newly emitted token ids
    (family-specific; ``ext_state`` is a per-connection dict for carry
    state such as dedup history; the default reads
    ``outs["ids"][i][:outs["count"][i]]``).
    """

    def __init__(self, runner, chunk_samples: int, extract=None,
                 tick_wait_ms: float = 20.0, sample_rate: int = 16000,
                 pcm_scale: float = 32768.0, advance_samples: int | None = None,
                 tail_pad_samples: int = 0, drain_min_samples: int = 1,
                 ticks_per_sync: int = 1):
        self.runner = runner
        self.chunk = int(chunk_samples)
        # K chunk ticks fused into ONE device dispatch + host sync
        # (MultiStreamRunner.step_n): a remote-host deployment pays its
        # device round trip once per K chunks instead of per chunk, at the
        # cost of emitting results in K-chunk batches (the per-token
        # latency trade documented for the continuous engine's
        # --steps-per-tick). Token streams are identical (tested).
        self.ticks_per_sync = max(int(ticks_per_sync), 1)
        # new audio consumed per tick; < chunk for overlapped-window
        # families (the window re-includes chunk - advance old samples)
        self.advance = int(advance_samples or chunk_samples)
        assert 0 < self.advance <= self.chunk
        self.tail_pad = int(tail_pad_samples)
        # smallest buffered remainder that still fires a (zero-padded)
        # window while draining — family stop-condition knob: 1 =
        # pad-and-fire everything (paraformer), advance = dolphin's
        # `pos + adv <= n`, chunk = X-ASR's `pos + w <= len(padded)`
        self.drain_min = max(1, int(drain_min_samples))
        self.sample_rate = sample_rate
        # model input convention: 32768 = int16 numeric range (Kaldi
        # families), 1.0 = [-1, 1] PCM
        self.pcm_gain = np.float32(pcm_scale / 32768.0)
        self.tick_wait = tick_wait_ms / 1000.0
        self.extract = extract or (
            lambda outs, i, st: [int(t) for t in np.asarray(outs["ids"][i])[
                : int(np.asarray(outs["count"][i]))]])
        self.slots: list[_Slot | None] = [None] * runner.n_streams
        self._pending_resets: list[int] = []
        self._slot_lock = threading.Lock()
        self._wake = threading.Event()
        self._closed = False
        self._lat_total = 0.0
        self._lat_max = 0.0
        self._sync_lat_max = 0.0
        self._tick_count = 0
        self._sync_count = 0
        self.last_error: str | None = None
        self._ticker = threading.Thread(target=self._tick_loop, daemon=True)
        self._ticker.start()

    # ── slot management ───────────────────────────────────────────────────
    def acquire(self) -> int | None:
        with self._slot_lock:
            for i, s in enumerate(self.slots):
                if s is None:
                    # reset happens IN the ticker thread (it owns
                    # runner.states; resetting here would race an
                    # in-flight runner.step whose output overwrites it)
                    self._pending_resets.append(i)
                    self.slots[i] = _Slot()
                    return i
        return None

    def release(self, i: int) -> None:
        with self._slot_lock:
            slot, self.slots[i] = self.slots[i], None
        if slot is not None and not slot.finished:
            slot.finished = True
            slot.out_q.put(None)  # unblock the connection's writer thread

    def feed(self, i: int, samples: np.ndarray) -> None:
        slot = self.slots[i]
        with slot.lock:
            slot.buffer = np.concatenate([slot.buffer, samples])
        if len(slot.buffer) >= self.chunk:
            self._wake.set()

    def finish_input(self, i: int) -> None:
        """No more audio for slot i: append the family tail pad (so the
        final tokens flush — e.g. X-ASR's 0.3 s zero tail) and mark
        draining; remaining windows fire zero-padded."""
        slot = self.slots[i]
        if slot is None:
            return
        with slot.lock:
            if self.tail_pad:
                slot.buffer = np.concatenate(
                    [slot.buffer, np.zeros(self.tail_pad, np.float32)])
            slot.draining = True
        self._wake.set()

    # ── ticker ────────────────────────────────────────────────────────────
    def _tick_loop(self) -> None:
        """Ticker thread body. Any exception from runner.step/reset or an
        extract callback must not kill the thread silently (every stream
        would hang until its writer-join deadline while /healthz kept
        reporting ok): the failing tick is reported to every live stream
        as an ``{"error": ...}`` event + end-of-stream, recorded in
        ``last_error`` (healthz flips ok=false), and the loop continues —
        transient device errors don't take the process down."""
        while not self._closed:
            if not self._wake.wait(timeout=0.2):
                continue
            time.sleep(self.tick_wait)  # coalesce concurrent arrivals
            self._wake.clear()
            try:
                self._tick_burst()
            except Exception as e:  # noqa: BLE001 — see docstring
                self.last_error = f"{type(e).__name__}: {e}"
                with self._slot_lock:
                    live = [s for s in self.slots if s is not None]
                for slot in live:
                    if not slot.finished:
                        slot.finished = True
                        slot.out_q.put({"error": self.last_error})
                        slot.out_q.put(None)

    def _gather_subtick(self, live, done_slots):
        """Consume one window from every ready slot -> (chunks, active).
        ready: a FULL window buffered; while draining, any remaining audio
        fires as a zero-padded window (window covers [t*adv, t*adv+chunk),
        so overlapped families see exactly the single-stream sequence —
        live output lags by chunk-advance of lookahead)."""
        n = self.runner.n_streams
        chunks = np.zeros((n, self.chunk), np.float32)
        active = np.zeros((n,), bool)
        for i, slot in live:
            if slot.finished or slot in done_slots:
                continue  # already errored/ended — don't step it again
            with slot.lock:
                have = len(slot.buffer)
                if have >= self.chunk or (slot.draining and have >= self.drain_min):
                    w = slot.buffer[: self.chunk]
                    if len(w) < self.chunk:
                        w = np.concatenate(
                            [w, np.zeros(self.chunk - len(w), np.float32)])
                    chunks[i] = w
                    slot.buffer = slot.buffer[self.advance:]
                    active[i] = True
                    if slot.draining and len(slot.buffer) < self.drain_min:
                        done_slots.append(slot)
                elif slot.draining:
                    done_slots.append(slot)
        return chunks, active

    def _tick_burst(self) -> None:
        k = self.ticks_per_sync
        while not self._closed:
            done_slots: list[_Slot] = []
            with self._slot_lock:
                live = [(i, s) for i, s in enumerate(self.slots) if s is not None]
                resets, self._pending_resets = self._pending_resets, []
            for i in resets:
                self.runner.reset(i)
            # gather up to K subticks from the snapshot; short bursts pad
            # with all-inactive rows (no-op subticks) so ONE executable
            # serves every burst length
            planes = []
            for _t in range(k):
                chunks, active = self._gather_subtick(live, done_slots)
                if not active.any():
                    break
                planes.append((chunks, active))
            if not planes:
                for slot in done_slots:
                    if not slot.finished:
                        slot.finished = True
                        slot.out_q.put(None)
                break
            t0 = time.perf_counter()
            if k == 1:
                outs_k = [self.runner.step(planes[0][0], planes[0][1])]
                outs_k = [{kk: np.asarray(v) for kk, v in outs_k[0].items()}]
                actives = [planes[0][1]]
            else:
                n = self.runner.n_streams
                chunks_k = np.zeros((k, n, self.chunk), np.float32)
                active_k = np.zeros((k, n), bool)
                for t, (c, a) in enumerate(planes):
                    chunks_k[t], active_k[t] = c, a
                outs = self.runner.step_n(chunks_k, active_k)
                outs = {kk: np.asarray(v) for kk, v in outs.items()}
                outs_k = [{kk: v[t] for kk, v in outs.items()}
                          for t in range(len(planes))]
                actives = [a for _c, a in planes]
            dt = time.perf_counter() - t0
            self._lat_total += dt
            # per-TICK max: a K-subtick burst spans one sync, so divide
            # by the subtick count or max/avg dashboards misread K>1 as
            # a K-fold tail spike
            self._lat_max = max(self._lat_max, dt / len(planes))
            # the raw per-sync maximum: what a client waits for a K-subtick burst
            self._sync_lat_max = max(self._sync_lat_max, dt)
            self._tick_count += len(planes)
            self._sync_count += 1
            for outs, active in zip(outs_k, actives):
                for i, slot in live:
                    # a stream failed at an earlier subtick of this same
                    # sync: skip its remaining subticks (its out_q already
                    # carries the None terminator)
                    if not active[i] or slot.finished:
                        continue
                    slot.ticks += 1
                    try:
                        ids = self.extract(outs, i, slot.ext_state)
                    except Exception as e:  # noqa: BLE001 — per-stream
                        # callback fault: fail THIS stream loudly; other
                        # slots and the ticker keep running (device faults
                        # in runner.step are handled in _tick_loop).
                        self.last_error = f"extract[{i}] {type(e).__name__}: {e}"
                        if not slot.finished:
                            slot.finished = True
                            slot.out_q.put({"error": self.last_error})
                            slot.out_q.put(None)
                        continue
                    if ids:
                        slot.out_q.put({"tick": slot.ticks, "ids": ids})
            for slot in done_slots:
                if not slot.finished:
                    slot.finished = True
                    slot.out_q.put(None)

    def stats(self) -> dict:
        with self._slot_lock:
            used = sum(s is not None for s in self.slots)
        avg = self._lat_total / self._tick_count if self._tick_count else 0.0
        return {
            "ok": self.last_error is None,
            "last_error": self.last_error,
            "slots_total": self.runner.n_streams,
            "slots_active": used,
            "chunk_samples": self.chunk,
            "sample_rate": self.sample_rate,
            "ticks": self._tick_count,
            "ticks_per_sync": self.ticks_per_sync,
            "device_syncs": self._sync_count,
            "tick_latency_avg_s": round(avg, 5),
            "tick_latency_max_s": round(self._lat_max, 5),
            "sync_latency_max_s": round(self._sync_lat_max, 5),
        }

    def close(self) -> None:
        self._closed = True
        self._wake.set()
        self._ticker.join(timeout=5)


def make_stream_http_server(server: StreamingServer, host="127.0.0.1", port=0):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            pass

        def do_GET(self):
            if self.path != "/healthz":
                self.send_error(404)
                return
            body = json.dumps(server.stats()).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_chunk(self) -> bytes | None:
            """One chunked-transfer frame from the request body; None = end."""
            # The size line can exceed any fixed readline cap (RFC 9112
            # chunk extensions); a truncated read would leak the remainder
            # into the PCM body and desync the framing. Accumulate to the
            # CRLF with a hard 16 KiB bound.
            line = b""
            while not line.endswith(b"\n"):
                part = self.rfile.readline(16384 - len(line))
                if not part:
                    if line:  # connection closed mid-size-line
                        raise ValueError("truncated chunk-size line")
                    return None
                line += part
                if len(line) >= 16384 and not line.endswith(b"\n"):
                    raise ValueError("chunk-size line exceeds 16 KiB")
            size = int(line.strip().split(b";")[0], 16)
            if size == 0:
                self.rfile.readline()  # trailing CRLF
                return None
            data = self.rfile.read(size)
            self.rfile.readline()
            return data

        def do_POST(self):
            if self.path != "/stream":
                self.send_error(404)
                return
            if self.headers.get("Transfer-Encoding", "").lower() != "chunked":
                self.send_error(400, "body must be Transfer-Encoding: chunked int16 PCM")
                return
            slot = server.acquire()
            if slot is None:
                self.send_error(503, "all stream slots busy")
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/jsonlines")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            wlock = threading.Lock()

            def emit(obj: dict) -> None:
                payload = (json.dumps(obj) + "\n").encode()
                with wlock:
                    self.wfile.write(f"{len(payload):x}\r\n".encode() + payload + b"\r\n")
                    self.wfile.flush()

            sl = server.slots[slot]

            def writer():
                while True:
                    item = sl.out_q.get()
                    if item is None:
                        return
                    try:
                        emit(item)
                    except OSError:
                        return

            wt = threading.Thread(target=writer, daemon=True)
            wt.start()
            try:
                carry = b""
                while True:
                    data = self._read_chunk()
                    if data is None:
                        break
                    data = carry + data
                    usable = len(data) - (len(data) % 2)
                    carry = data[usable:]
                    if usable:
                        pcm = np.frombuffer(data[:usable], "<i2").astype(np.float32)
                        server.feed(slot, pcm * server.pcm_gain)
                server.finish_input(slot)
                # Drain until the ticker finishes the slot. A fixed join cap
                # would silently truncate fully-buffered uploads whose drain
                # outlasts it (hours of audio arrive faster than real time);
                # instead wait as long as ticks keep PROGRESSING, and only
                # give up — loudly — after 60 s of zero tick progress.
                truncated = False
                last_ticks, idle_t0 = sl.ticks, time.monotonic()
                while wt.is_alive():
                    wt.join(timeout=0.5)
                    if not wt.is_alive():
                        break
                    if sl.ticks != last_ticks:
                        last_ticks, idle_t0 = sl.ticks, time.monotonic()
                    elif time.monotonic() - idle_t0 > 60:
                        truncated = True  # ticker stalled — do not hang forever
                        break
                # release BEFORE emitting done: a client acting on the done
                # event (health checks, immediate reconnect) must observe the
                # slot as free — the finally-release below is then a no-op
                server.release(slot)
                if truncated:
                    wt.join(timeout=5)  # release() queued the sentinel
                    emit({"done": True, "ticks": sl.ticks, "truncated": True,
                          "error": "drain stalled: no tick progress for 60 s"})
                else:
                    emit({"done": True, "ticks": sl.ticks})
                with wlock:
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
            except (OSError, ValueError):
                pass  # client went away mid-stream
            finally:
                # release() queues the writer sentinel if the normal drain
                # never did (aborted body) — no leaked blocked threads
                server.release(slot)
                wt.join(timeout=10)
                self.close_connection = True

    return ThreadingHTTPServer((host, port), Handler)


def stream_pcm_over_http(host: str, port: int, pcm_int16: np.ndarray,
                         send_chunk: int = 3200, timeout: float = 120.0) -> list[dict]:
    """Test/client helper: raw-socket full-duplex chunked POST of int16 PCM;
    returns the parsed JSON-line events (incremental + final)."""
    sock = socket.create_connection((host, port), timeout=timeout)
    try:
        sock.sendall(
            b"POST /stream HTTP/1.1\r\nHost: x\r\n"
            b"Transfer-Encoding: chunked\r\n\r\n")
        data = np.asarray(pcm_int16, "<i2").tobytes()
        events: list[dict] = []
        recv_buf = b""

        def pump_recv(block=False):
            nonlocal recv_buf
            # non-blocking drain between sends; blocking wait keeps the
            # caller timeout (setblocking(True) would clear it)
            sock.settimeout(timeout if block else 0.0)
            try:
                while True:
                    piece = sock.recv(65536)
                    if not piece:
                        return False
                    recv_buf += piece
                    if not block:
                        continue
                    return True
            except (BlockingIOError, TimeoutError):
                if not block:
                    return True
                raise
            finally:
                sock.settimeout(timeout)

        for off in range(0, len(data), send_chunk):
            piece = data[off: off + send_chunk]
            sock.sendall(f"{len(piece):x}\r\n".encode() + piece + b"\r\n")
            pump_recv(block=False)  # drain incremental results as they come
        sock.sendall(b"0\r\n\r\n")
        # read until the terminating 0-length response chunk
        while b"\r\n0\r\n\r\n" not in recv_buf:
            if not pump_recv(block=True):
                break
        # parse: skip headers, de-chunk, split JSON lines
        body = recv_buf.split(b"\r\n\r\n", 1)[1]
        text = b""
        while body:
            line, _, rest = body.partition(b"\r\n")
            try:
                size = int(line.strip().split(b";")[0], 16)
            except ValueError:
                break
            if size == 0:
                break
            text += rest[:size]
            body = rest[size + 2:]
        for ln in text.decode().splitlines():
            if ln.strip():
                events.append(json.loads(ln))
        return events
    finally:
        sock.close()


def serve_streams(runner, chunk_samples: int, host="127.0.0.1", port=8001,
                  extract=None, pcm_scale: float = 32768.0,
                  advance_samples: int | None = None,
                  tail_pad_samples: int = 0, drain_min_samples: int = 1,
                  ticks_per_sync: int = 1):
    """Blocking entry point (CLI ``serve-stream``)."""
    srv = StreamingServer(runner, chunk_samples, extract=extract,
                          pcm_scale=pcm_scale, advance_samples=advance_samples,
                          tail_pad_samples=tail_pad_samples,
                          drain_min_samples=drain_min_samples,
                          ticks_per_sync=ticks_per_sync)
    httpd = make_stream_http_server(srv, host, port)
    print(f"streaming on http://{host}:{httpd.server_address[1]} "
          f"({runner.n_streams} slots, chunk {chunk_samples})")
    try:
        httpd.serve_forever()
    finally:
        srv.close()


def start_stream_background(runner, chunk_samples: int, host="127.0.0.1",
                            port=0, extract=None, tick_wait_ms: float = 20.0,
                            pcm_scale: float = 32768.0,
                            advance_samples: int | None = None,
                            tail_pad_samples: int = 0,
                            drain_min_samples: int = 1,
                            ticks_per_sync: int = 1):
    """Non-blocking start for tests/embedding; returns (httpd, server, thread)."""
    srv = StreamingServer(runner, chunk_samples, extract=extract,
                          tick_wait_ms=tick_wait_ms, pcm_scale=pcm_scale,
                          advance_samples=advance_samples,
                          tail_pad_samples=tail_pad_samples,
                          drain_min_samples=drain_min_samples,
                          ticks_per_sync=ticks_per_sync)
    httpd = make_stream_http_server(srv, host, port)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, srv, t
