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

All device work (each request's prompt embeddings or prefill, the slot
insert, the decode steps) happens on one decode thread, which enters
``torch.inference_mode`` itself; HTTP handler threads only enqueue requests
and wait on per-request events.

Endpoints are those of ``http_server.py`` (``POST /transcribe`` with a
WAV/FLAC/OGG/MP3 body, ``GET /healthz``); ``/healthz`` adds slot occupancy,
decode steps and step latency. Left out: replicas across cards
(``data_parallel`` > 1) and the tensor-parallel engine (``tensor_parallel``
> 1); both raise.
"""

from __future__ import annotations

import collections
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
    ("rowwise": a q2 LLM, which does not stack, serves this way). An LLM engine's caches hold one prefill bucket of the
    session's (fixed) prompt length plus the token budget.
    """

    def __init__(self, session, n_slots: int = 8, language: str | None = None,
                 context: str = "", warmup: bool = True, kv_dtype: str = "f32",
                 data_parallel: int = 1, steps_per_tick: int = 1, tensor_parallel: int = 1):
        self._aed = hasattr(session, "continuous_prefill")
        if not self._aed and not hasattr(session, "prompt_embeds"):
            raise TypeError(
                f"{type(session).__name__} has no continuous serving surface; continuous "
                "batching serves the LLM families (qwen_asr) and the AED families (whisper)")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype must be f32 or bf16, got {kv_dtype!r}")
        if int(tensor_parallel) > 1:
            raise ValueError("--tensor-parallel does not compose with the AED continuous engine"
                             if self._aed else
                             "tensor_parallel > 1 (the tensor-parallel LLM engine) is not in the "
                             "port yet")
        if int(data_parallel) > 1:
            raise ValueError("data_parallel > 1 (one replica per card) is not in the port yet")
        self.session = session
        self._language = language
        self._context = context
        self.sample_rate = getattr(session, "sample_rate", 16000)
        self.pcm_scale = getattr(session, "pcm_scale", 32768.0)
        self.window = session.window_samples
        dc, kvd, stacked = session.decode_cfg, KV_DTYPES[kv_dtype], getattr(session, "stacked", None)
        if self._aed:
            self.batcher = ContinuousAedBatcher(
                session.params, session.aed_engine_spec(), dc, n_slots=n_slots, kv_dtype=kvd,
                stacked=stacked, steps_per_tick=steps_per_tick)
        else:
            # The prompt length is the same for every request (the audio pads
            # to the window): the caches hold its bucket and the budget.
            self._probe, _ = session.prompt_embeds(np.zeros(16, np.float32), context=context,
                                                   language=language)
            self.batcher = ContinuousLlmBatcher(
                session.llm_params, session.llm_cfg, dc, n_slots=n_slots,
                t_max=_bucket(int(self._probe.shape[0])) + dc.max_new_tokens + 1, kv_dtype=kvd,
                stacked=stacked, steps_per_tick=steps_per_tick)
        self._slot_req: dict[int, _Req] = {}
        self._cv = threading.Condition()
        self._pending: collections.deque[_Req] = collections.deque()
        self._stop = False
        self._fatal: Exception | None = None
        self._stats_lock = threading.Lock()
        self._requests_served = 0
        self._tokens_generated = 0
        self._steps = 0
        self._step_time = 0.0
        self._queue_wait_total = 0.0

        self._ready = threading.Event()
        self._thread = threading.Thread(target=self._drive, args=(warmup,), daemon=True)
        self._thread.start()
        self._ready.wait()
        if self._fatal is not None:
            raise self._fatal

    # ── the decode thread (the only thread touching device state) ────────
    def _warmup(self) -> None:
        """Load the kernels and run one prefill, insert and step."""
        if self._aed:
            pre = self.session.continuous_prefill(np.zeros(16, np.float32), language=self._language)
            slot = self.batcher.try_submit(pre["state"], pre["p_len"], pre["logits0"],
                                           pre["tc_valid"])
        else:
            slot = self.batcher.try_submit(self._probe, 1)
        if self.batcher.is_active(slot):
            self.batcher.step_tick()
            self.batcher.cancel(slot)
        else:
            self.batcher.take_result(slot)

    def _drive(self, warmup: bool) -> None:
        try:
            with torch.inference_mode():
                if warmup:
                    self._warmup()
                self._ready.set()
                while True:
                    with self._cv:
                        while not self._stop and not self._pending and not self._slot_req:
                            self._cv.wait(timeout=0.2)
                        if self._stop:
                            self._fail_all(RuntimeError("server shut down"))
                            return
                        admit = []
                        while (self._pending
                               and len(admit) + len(self._slot_req) < self.batcher.n_slots):
                            admit.append(self._pending.popleft())
                    for req in admit:
                        self._admit(req)
                    t0 = time.perf_counter()
                    events = self.batcher.step_tick()
                    if events:
                        dt = time.perf_counter() - t0
                        with self._stats_lock:
                            # substeps that advanced >= 1 active slot
                            self._steps += self.batcher.last_tick_substeps
                            self._step_time += dt
                            self._tokens_generated += len(events)
                    for slot, _tok, fin in events:
                        if fin:
                            self._finish(slot)
        except Exception as exc:  # device error: the engine is dead
            with self._cv:
                self._stop = True
                self._fatal = exc
                self._fail_all(exc)
                self._cv.notify_all()
            self._ready.set()

    def _fail_all(self, exc: Exception) -> None:
        """Fail every queued and admitted request. Caller holds ``_cv``."""
        for req in [*self._pending, *self._slot_req.values()]:
            req.error = exc
            req.event.set()
        self._pending.clear()
        self._slot_req.clear()

    def _admit(self, req: _Req) -> None:
        try:
            if not self._aed:
                embeds, valid = self.session.prompt_embeds(req.samples, context=self._context,
                                                            language=self._language)
                slot = self.batcher.try_submit(embeds, max(valid, 1), seed=req.seed)
            else:
                pre = self.session.continuous_prefill(req.samples, language=self._language)
                if pre["skip"]:  # no-speech window: empty result, no slot
                    req.t_admit = time.perf_counter()
                    with self._stats_lock:
                        self._queue_wait_total += req.t_admit - req.t_enqueue
                    req.ids = []
                    self._complete(req)
                    return
                slot = self.batcher.try_submit(pre["state"], pre["p_len"], pre["logits0"],
                                               pre["tc_valid"], seed=req.seed)
        except Exception as exc:  # bad audio etc.: fail this request only
            req.error = exc
            req.event.set()
            return
        if slot is None:  # no free slot after all: retry next tick
            with self._cv:
                self._pending.appendleft(req)
            return
        req.t_admit = time.perf_counter()
        with self._stats_lock:
            self._queue_wait_total += req.t_admit - req.t_enqueue
        if not self.batcher.is_active(slot):
            # the first token was already EOT (or a budget of one): no step
            # will report this slot, so drain it here
            req.ids = self.batcher.take_result(slot)
            self._complete(req)
        else:
            self._slot_req[slot] = req

    def _finish(self, slot: int) -> None:
        ids = self.batcher.take_result(slot)
        req = self._slot_req.pop(slot, None)
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
            "replicas": 1,
            "tensor_parallel": 1,
            "slots": self.batcher.n_slots,
            "slots_active": len(self._slot_req),
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
        self._thread.join(timeout=10)


def serve_continuous(session, host: str = "127.0.0.1", port: int = 8000, n_slots: int = 8,
                     language: str | None = None, context: str = "", warmup: bool = True,
                     kv_dtype: str = "f32", data_parallel: int = 1, steps_per_tick: int = 1,
                     tensor_parallel: int = 1):
    """Blocking entry point (``serve --continuous``)."""
    srv = ContinuousSessionServer(session, n_slots=n_slots, language=language, context=context,
                                  warmup=warmup, kv_dtype=kv_dtype, data_parallel=data_parallel,
                                  steps_per_tick=steps_per_tick, tensor_parallel=tensor_parallel)
    httpd = make_http_server(srv, host, port)
    print(f"serving on http://{host}:{httpd.server_address[1]} "
          f"(engine=continuous, slots={n_slots})")
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        srv.close()


def start_background_continuous(session, host: str = "127.0.0.1", port: int = 0,
                                n_slots: int = 8, language: str | None = None,
                                context: str = "", warmup: bool = True, kv_dtype: str = "f32",
                                data_parallel: int = 1, steps_per_tick: int = 1,
                                tensor_parallel: int = 1):
    """Non-blocking start: returns (httpd, server, thread); the port is
    ``httpd.server_address[1]``. Stop with ``httpd.shutdown()``,
    ``httpd.server_close()`` and ``server.close()``."""
    srv = ContinuousSessionServer(session, n_slots=n_slots, language=language, context=context,
                                  warmup=warmup, kv_dtype=kv_dtype, data_parallel=data_parallel,
                                  steps_per_tick=steps_per_tick, tensor_parallel=tensor_parallel)
    httpd = make_http_server(srv, host, port)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, srv, thread
