"""Continuous-batching HTTP serving (the LLM families: Qwen3-ASR,
Fun-ASR-Nano; the AED families: Whisper, FireRed, Dolphin).

Counterpart of ``asr_tpu/parallel/llm_server.py``. The micro-batched
``SessionServer`` (``http_server.py``) runs each batch to its end before the
next starts; this server keeps one continuous batcher running and lets
requests join and leave it mid-flight: every admitted request starts
decoding on the very next step, and a finished slot frees at once. An LLM
session (``prompt_embeds``) runs on
:class:`~asr_tpu_torch.parallel.llm_batcher.ContinuousLlmBatcher`, an AED
session (``continuous_prefill``) on
:class:`~asr_tpu_torch.parallel.aed_batcher.ContinuousAedBatcher`.

Scale-out is replica per device (``data_parallel=N``): the weights are
placed on N devices, each runs its own batcher (the single-device engine,
multi-slot kernel included) behind one admission queue, and replicas never
communicate. ``tensor_parallel=T`` gives each LLM replica a (1, T)
sub-mesh: its batcher is the tensor-parallel engine (``llm_batcher.py``,
``mesh=``). ``devices`` defaults to every visible card (the session's own
device when it is not a card) and may repeat one.

Each replica's device work (the slot insert and the decode steps) happens
on its own driver thread, which enters ``torch.inference_mode`` itself;
the session's prompt embeddings or prefill run under one lock (one shared
front end) and hop to the replica's device. HTTP handler threads only
enqueue requests and wait on per-request events.

Endpoints are those of ``http_server.py`` (``POST /transcribe`` with a
WAV/FLAC/OGG/MP3 body, ``GET /healthz``); ``/healthz`` adds slot occupancy,
replicas, decode steps and step latency.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import numpy as np
import torch

from asr_tpu_torch.parallel.aed_batcher import ContinuousAedBatcher
from asr_tpu_torch.parallel.llm_batcher import ContinuousLlmBatcher, _bucket
from asr_tpu_torch.parallel.http_server import (
    _join_window_texts,
    decode_audio_bytes,
    make_http_server,
)
from asr_tpu_torch.parallel.mesh import Mesh, device_lock, shard_params, visible_devices
from asr_tpu_torch.runtime import audio as audio_io

KV_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


class _Req:
    __slots__ = ("samples", "event", "ids", "error", "t_enqueue", "t_admit", "seed")

    def __init__(self, samples: np.ndarray, seed: int | None = None):
        self.samples = samples
        self.event = threading.Event()
        self.ids: list[int] | None = None
        self.error: Exception | None = None
        self.t_enqueue = time.perf_counter()
        self.t_admit = 0.0
        self.seed = seed  # per-request sampling seed (the batcher's own stream)


class _Replica:
    __slots__ = ("index", "device", "batcher", "slot_req", "thread", "ready")

    def __init__(self, index: int, device: torch.device, batcher):
        self.index = index
        self.device = device
        self.batcher = batcher
        self.slot_req: dict[int, _Req] = {}
        self.thread: threading.Thread | None = None
        self.ready = threading.Event()


def _to(tree, device: torch.device):
    """A tree of tensors (and quantized leaves) on ``device``."""
    return shard_params(tree, Mesh([[device]])).local(0, 0)


class ContinuousSessionServer:
    """Continuous decode batches behind an HTTP front end.

    ``session`` exposes the LLM continuous surface (``prompt_embeds``,
    ``llm_params``, ``llm_cfg``, ``decode_cfg``, ``window_samples``), as
    ``QwenAsrSession`` does, or the AED one (``continuous_prefill``,
    ``aed_engine_spec``, ``params``, ``decode_cfg``, ``window_samples``), as
    ``WhisperSession``, ``FireRedSession`` and ``DolphinSession`` do. With
    the session's stacked weights (q4 for the LLM, q8 for AED) every decode
    step is one multi-slot kernel call
    (``step_kernel`` "fused" in ``/healthz``), else the rowwise step
    ("rowwise": a q2 LLM, which does not stack, and every tensor-parallel
    replica serve this way). An LLM engine's caches hold one prefill bucket
    of the session's (fixed) prompt length plus the token budget. Run the
    session itself unsharded (no ``mesh=``): ``data_parallel`` counts
    replicas, so ``data_parallel=2, tensor_parallel=2`` takes 4 devices.
    """

    def __init__(self, session, n_slots: int = 8, language: str | None = None,
                 context: str = "", warmup: bool = True, kv_dtype: str = "f32",
                 data_parallel: int = 1, steps_per_tick: int = 1, tensor_parallel: int = 1,
                 devices=None):
        self._aed = hasattr(session, "continuous_prefill")
        if not self._aed and not hasattr(session, "prompt_embeds"):
            raise TypeError(
                f"{type(session).__name__} has no continuous serving surface; continuous "
                "batching serves the LLM families (qwen_asr) and the AED families (whisper)")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype must be f32 or bf16, got {kv_dtype!r}")
        dp, tp = max(int(data_parallel), 1), max(int(tensor_parallel), 1)
        self.tensor_parallel = tp
        if self._aed and tp > 1:
            raise ValueError("--tensor-parallel does not compose with the AED continuous engine "
                             "(its decoders fit one chip; scale out with --data-parallel "
                             "replicas)")
        if devices is None:
            own = session.device
            devices = visible_devices() if own.type == "cuda" else [own]
        devices = [torch.device(d) for d in devices]
        if dp * tp > len(devices):
            raise ValueError(f"data_parallel={dp} x tensor_parallel={tp} needs {dp * tp} "
                             f"devices but only {len(devices)} available")
        self.session = session
        self._language = language
        self._context = context
        self.sample_rate = getattr(session, "sample_rate", 16000)
        self.pcm_scale = getattr(session, "pcm_scale", 32768.0)
        self.window = session.window_samples
        dc, kvd, stacked0 = session.decode_cfg, KV_DTYPES[kv_dtype], getattr(session, "stacked", None)
        self.replicas: list[_Replica] = []
        if self._aed:
            spec = session.aed_engine_spec()
            for i in range(dp):
                dev = devices[i]
                same = dev == session.device
                params = session.params if same else _to(session.params, dev)
                stacked = stacked0 if stacked0 is None or same else _to(stacked0, dev)
                self.replicas.append(_Replica(i, dev, ContinuousAedBatcher(
                    params, spec, dc, n_slots=n_slots, kv_dtype=kvd, stacked=stacked,
                    steps_per_tick=steps_per_tick)))
        else:
            # The prompt length is the same for every request (the audio pads
            # to the window): the caches hold its bucket and the budget.
            self._probe, _ = session.prompt_embeds(np.zeros(16, np.float32), context=context,
                                                   language=language)
            t_max = _bucket(int(self._probe.shape[0])) + dc.max_new_tokens + 1
            for i in range(dp):
                if tp > 1:  # replica i owns a (1, tp) sub-mesh
                    sub = Mesh([devices[i * tp : (i + 1) * tp]])
                    batcher = ContinuousLlmBatcher(
                        session.llm_params, session.llm_cfg, dc, n_slots=n_slots, t_max=t_max,
                        kv_dtype=kvd, steps_per_tick=steps_per_tick, mesh=sub)
                    self.replicas.append(_Replica(i, sub.devices[0][0], batcher))
                    continue
                dev = devices[i]
                same = dev == session.device
                params = session.llm_params if same else _to(session.llm_params, dev)
                stacked = stacked0 if stacked0 is None or same else _to(stacked0, dev)
                self.replicas.append(_Replica(i, dev, ContinuousLlmBatcher(
                    params, session.llm_cfg, dc, n_slots=n_slots, t_max=t_max, kv_dtype=kvd,
                    stacked=stacked, steps_per_tick=steps_per_tick)))
        self.batcher = self.replicas[0].batcher  # the single-device alias
        self._cv = threading.Condition()
        self._pending: collections.deque[_Req] = collections.deque()
        self._stop = False
        self._fatal: Exception | None = None
        self._pending_failed = False
        self._stats_lock = threading.Lock()
        self._requests_served = 0
        self._tokens_generated = 0
        self._steps = 0
        self._step_time = 0.0
        self._queue_wait_total = 0.0
        # the session's front end (prompt embeds / prefill) serves every
        # replica: one call at a time
        self._embed_lock = threading.Lock()

        for rep in self.replicas:
            rep.thread = threading.Thread(target=self._drive, args=(rep, warmup), daemon=True)
            rep.thread.start()
        for rep in self.replicas:
            rep.ready.wait()
        if self._fatal is not None:
            self.close()
            raise self._fatal

    # ── driver threads: one per replica (the only thread touching its
    #    device state) ─────────────────────────────────────────────────────
    def _warmup(self, rep: _Replica) -> None:
        """Load the kernels and run one prefill, insert and step."""
        if self._aed:
            with self._embed_lock:
                pre = self.session.continuous_prefill(np.zeros(16, np.float32),
                                                      language=self._language)
            slot = rep.batcher.try_submit(_to(pre["state"], rep.device), pre["p_len"],
                                          pre["logits0"].to(rep.device), pre["tc_valid"])
        else:
            slot = rep.batcher.try_submit(self._probe.to(rep.device), 1)
        if rep.batcher.is_active(slot):
            rep.batcher.step_tick()
            rep.batcher.cancel(slot)
        else:
            rep.batcher.take_result(slot)

    def _drive(self, rep: _Replica, warmup: bool) -> None:
        dev_ctx = (torch.cuda.device(rep.device) if rep.device.type == "cuda"
                   else contextlib.nullcontext())
        # a single-device replica takes turns with the other threads that
        # drive its device; a tensor-parallel one's rank threads take theirs
        turn = (device_lock(rep.device) if getattr(rep.batcher, "mesh", None) is None
                else contextlib.nullcontext())
        try:
            with dev_ctx, torch.inference_mode():
                if warmup:
                    with turn:
                        self._warmup(rep)
                rep.ready.set()
                while True:
                    with self._cv:
                        while not self._stop and not self._pending and not rep.slot_req:
                            self._cv.wait(timeout=0.2)
                        if self._stop:
                            self._fail_replica(rep, RuntimeError("server shut down"))
                            return
                        admit = []
                        while (self._pending
                               and len(admit) + len(rep.slot_req) < rep.batcher.n_slots):
                            admit.append(self._pending.popleft())
                    with turn:
                        for req in admit:
                            self._admit(rep, req)
                        t0 = time.perf_counter()
                        events = rep.batcher.step_tick()
                    if events:
                        dt = time.perf_counter() - t0
                        with self._stats_lock:
                            # substeps that advanced >= 1 active slot
                            self._steps += rep.batcher.last_tick_substeps
                            self._step_time += dt
                            self._tokens_generated += len(events)
                    for slot, _tok, fin in events:
                        if fin:
                            self._finish(rep, slot)
        except Exception as exc:  # device error: the engine is dead
            with self._cv:
                self._stop = True
                self._fatal = exc
                self._fail_replica(rep, exc)
                self._cv.notify_all()  # sibling drivers fail theirs
            rep.ready.set()

    def _fail_replica(self, rep: _Replica, exc: Exception) -> None:
        """Fail the shared queue (once) and this replica's admitted
        requests; sibling replicas fail their own when they see ``_stop``.
        Caller holds ``_cv``."""
        if not self._pending_failed:
            self._pending_failed = True
            for req in self._pending:
                req.error = exc
                req.event.set()
            self._pending.clear()
        for req in rep.slot_req.values():
            req.error = exc
            req.event.set()
        rep.slot_req.clear()

    def _admit(self, rep: _Replica, req: _Req) -> None:
        try:
            if not self._aed:
                with self._embed_lock:
                    embeds, valid = self.session.prompt_embeds(
                        req.samples, context=self._context, language=self._language)
                slot = rep.batcher.try_submit(embeds.to(rep.device), max(valid, 1),
                                              seed=req.seed)
            else:
                with self._embed_lock:
                    pre = self.session.continuous_prefill(req.samples, language=self._language)
                if pre["skip"]:  # no-speech window: empty result, no slot
                    req.t_admit = time.perf_counter()
                    with self._stats_lock:
                        self._queue_wait_total += req.t_admit - req.t_enqueue
                    req.ids = []
                    self._complete(req)
                    return
                slot = rep.batcher.try_submit(_to(pre["state"], rep.device), pre["p_len"],
                                              pre["logits0"].to(rep.device), pre["tc_valid"],
                                              seed=req.seed)
        except Exception as exc:  # bad audio etc.: fail this request only
            req.error = exc
            req.event.set()
            return
        if slot is None:  # no free slot after all: retry next tick
            with self._cv:
                self._pending.appendleft(req)
                self._cv.notify_all()  # an idle sibling may own a free slot
            return
        req.t_admit = time.perf_counter()
        with self._stats_lock:
            self._queue_wait_total += req.t_admit - req.t_enqueue
        if not rep.batcher.is_active(slot):
            # the first token was already EOT (or a budget of one): no step
            # will report this slot, so drain it here
            req.ids = rep.batcher.take_result(slot)
            self._complete(req)
        else:
            rep.slot_req[slot] = req

    def _finish(self, rep: _Replica, slot: int) -> None:
        ids = rep.batcher.take_result(slot)
        req = rep.slot_req.pop(slot, None)
        if req is None:  # cancelled (warmup)
            return
        req.ids = ids
        self._complete(req)

    def _complete(self, req: _Req) -> None:
        eot = self.session.decode_cfg.eot_id
        req.ids = [t for t in req.ids if t != eot]
        with self._stats_lock:
            self._requests_served += 1
        req.event.set()

    # ── handler-thread API ───────────────────────────────────────────────
    def submit(self, samples: np.ndarray, seed: int | None = None) -> _Req:
        req = _Req(np.ascontiguousarray(samples, np.float32), seed=seed)
        with self._cv:
            if self._stop:
                raise (self._fatal or RuntimeError("server shut down"))
            self._pending.append(req)
            # every replica driver waits on this condition: wake them all
            self._cv.notify_all()
        return req

    def transcribe_bytes(self, data: bytes, seed: int | None = None) -> dict:
        samples = decode_audio_bytes(data, self.sample_rate)
        if self.pcm_scale != 32768.0:
            samples = samples * np.float32(self.pcm_scale / 32768.0)
        n = len(samples)
        w = self.window
        starts = audio_io.iter_windows(n, w, w)
        # per-window derived seeds: each window's decode its own sample stream
        reqs = [self.submit(samples[s : s + w], seed=None if seed is None else seed + k)
                for k, s in enumerate(starts)]
        ids: list[int] = []
        texts: list[str] = []
        tok = self.session.tokenizer
        per_window = bool(getattr(self.session, "postprocess_per_window", False))
        post = getattr(self.session, "_postprocess", lambda s: s)
        for req in reqs:
            req.event.wait()
            if req.error is not None:
                raise req.error
            ids.extend(req.ids)
            if tok and per_window:
                texts.append(post(tok.decode(req.ids)))
        if tok and not per_window:
            texts = [post(tok.decode(ids))]
        resp = {"text": _join_window_texts(texts), "token_ids": ids,
                "audio_seconds": n / self.sample_rate, "engine": "continuous"}
        if len(starts) > 1:
            resp["windows"] = len(starts)
        return resp

    def stats(self) -> dict:
        with self._stats_lock:
            served = self._requests_served
            steps = self._steps
            avg_step = self._step_time / steps if steps else 0.0
            toks = self._tokens_generated
            qwait = self._queue_wait_total / served if served else 0.0
        fatal = self._fatal
        return {
            "ok": fatal is None,
            **({"error": f"{type(fatal).__name__}: {fatal}"} if fatal else {}),
            "engine": "continuous",
            "decoder": "aed" if self._aed else "llm",
            "step_kernel": "fused" if self.batcher.stacked is not None else "rowwise",
            "replicas": len(self.replicas),
            "tensor_parallel": self.tensor_parallel,
            "slots": sum(r.batcher.n_slots for r in self.replicas),
            "slots_active": sum(len(r.slot_req) for r in self.replicas),
            "queue_depth": len(self._pending),
            "requests_served": served,
            "decode_steps": steps,
            "tokens_generated": toks,
            "steps_per_tick": self.batcher.steps_per_tick,
            "step_latency_avg_s": round(avg_step, 5),
            "queue_wait_avg_s": round(qwait, 5),
            "window_samples": self.window,
            "sample_rate": self.sample_rate,
        }

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for rep in self.replicas:
            if rep.thread is not None and rep.thread is not threading.current_thread():
                rep.thread.join(timeout=10)


def serve_continuous(session, host: str = "127.0.0.1", port: int = 8000, n_slots: int = 8,
                     language: str | None = None, context: str = "", warmup: bool = True,
                     kv_dtype: str = "f32", data_parallel: int = 1, steps_per_tick: int = 1,
                     tensor_parallel: int = 1, devices=None):
    """Blocking entry point (``serve --continuous``)."""
    srv = ContinuousSessionServer(session, n_slots=n_slots, language=language, context=context,
                                  warmup=warmup, kv_dtype=kv_dtype, data_parallel=data_parallel,
                                  steps_per_tick=steps_per_tick, tensor_parallel=tensor_parallel,
                                  devices=devices)
    httpd = make_http_server(srv, host, port)
    print(f"serving on http://{host}:{httpd.server_address[1]} "
          f"(engine=continuous, slots={n_slots}"
          + (f" x {data_parallel} replicas" if data_parallel > 1 else "")
          + (f", tp={tensor_parallel}" if tensor_parallel > 1 else "") + ")")
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        srv.close()


def start_background_continuous(session, host: str = "127.0.0.1", port: int = 0,
                                n_slots: int = 8, language: str | None = None,
                                context: str = "", warmup: bool = True, kv_dtype: str = "f32",
                                data_parallel: int = 1, steps_per_tick: int = 1,
                                tensor_parallel: int = 1, devices=None):
    """Non-blocking start: returns (httpd, server, thread); the port is
    ``httpd.server_address[1]``. Stop with ``httpd.shutdown()``,
    ``httpd.server_close()`` and ``server.close()``."""
    srv = ContinuousSessionServer(session, n_slots=n_slots, language=language, context=context,
                                  warmup=warmup, kv_dtype=kv_dtype, data_parallel=data_parallel,
                                  steps_per_tick=steps_per_tick, tensor_parallel=tensor_parallel,
                                  devices=devices)
    httpd = make_http_server(srv, host, port)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, srv, thread
