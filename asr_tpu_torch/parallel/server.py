"""Micro-batching request scheduler for serving.

Counterpart of ``asr_tpu/parallel/server.py``: requests enqueue one mono
window and get a Future; a worker thread drains the queue into batches of
``max_batch`` (waiting at most ``max_wait_ms`` after the first request),
pads every dispatch to exactly ``max_batch`` rows by repeating the last
row, and splits the results back per request.

``batch_fn(audio (max_batch, window), valid (max_batch,))`` returns a dict
of tensors with a leading batch dimension; the worker copies them to the
host, which waits for the device.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable

import numpy as np
import torch


class MicroBatcher:
    def __init__(self, batch_fn: Callable, window_samples: int, max_batch: int = 8,
                 max_wait_ms: float = 5.0):
        self.batch_fn = batch_fn
        self.window = int(window_samples)
        self.max_batch = int(max_batch)
        self.max_wait = max_wait_ms / 1000.0
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self.batches_dispatched = 0
        self.requests_served = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, audio: np.ndarray) -> Future:
        """Enqueue one mono window (<= window_samples); resolves to the
        per-request row of batch_fn's outputs as numpy arrays."""
        if self._closed:
            raise RuntimeError("batcher closed")
        audio = np.asarray(audio, np.float32)
        if audio.ndim != 1 or len(audio) > self.window:
            raise ValueError(f"expected mono audio of <= {self.window} samples")
        fut: Future = Future()
        self._q.put((audio, fut))
        return fut

    def close(self) -> None:
        self._closed = True
        self._q.put(None)
        self._worker.join()

    def _collect(self) -> list | None:
        first = self._q.get()
        if first is None:
            return None
        batch = [first]
        # Absolute deadline from the first queued request.
        deadline = time.monotonic() + self.max_wait
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                self._q.put(None)  # re-signal shutdown after this batch
                break
            batch.append(item)
        return batch

    def _run(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            audio_buf = np.zeros((self.max_batch, self.window), np.float32)
            valid = np.zeros((self.max_batch,), np.int32)
            for i, (a, _) in enumerate(batch):
                audio_buf[i, : len(a)] = a
                valid[i] = len(a)
            if len(batch) < self.max_batch:  # fixed shape: repeat last row
                audio_buf[len(batch):] = audio_buf[len(batch) - 1]
                valid[len(batch):] = valid[len(batch) - 1]
            try:
                out = self.batch_fn(audio_buf, valid)
                host = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                        for k, v in out.items()}
                for i, (_, fut) in enumerate(batch):
                    fut.set_result({k: v[i] for k, v in host.items()})
            except Exception as exc:  # propagate to every waiter
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(exc)
            self.batches_dispatched += 1
            self.requests_served += len(batch)
