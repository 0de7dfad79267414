"""Dynamic micro-batching ensemble server.

Concurrent requests land in a queue; a collector thread drains up to
`max_batch` of them (waiting at most `max_delay_ms` for followers after the
first), pads the group up to a fixed bucket size by repeating the last
sample, and runs ONE ensemble forward for the whole group.  Padding rows'
outputs are dropped.  No op in the model mixes rows, so a request's result
does not depend on what it was batched with.

Each bucket has one pinned, packed host buffer and one program
(`stream.PackedProgram`): on a CUDA device a captured CUDA graph, so a
batch costs one host-to-device copy, one graph launch and one copy back.
`warmup` captures every bucket, as JAX compiles every bucket.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, Sequence

import numpy as np
import torch

from .stream import (PackedProgram, _device_of, ensemble_serve_fn,
                     packed_layout)


class BatchingServer:
    """Thread-safe dynamic batcher over a k-member ensemble.

    submit(sample) -> Future resolving to (logits (E,), calibrated probs
    (E',)) numpy arrays; predict(sample) is the blocking convenience.  Use
    as a context manager or call close().  `stacked_grid`: every bucket's
    program on the stacked RealFormer grid (stream.ensemble_serve_fn)."""

    def __init__(self, members: Sequence[torch.nn.Module],
                 offsets: Sequence[float], *, impl: str = "xla",
                 max_delay_ms: float = 2.0,
                 buckets: Sequence[int] = (1, 2, 4, 8),
                 dtype: str = "float32", stacked_grid: bool = False):
        if not buckets or sorted(buckets) != list(buckets):
            raise ValueError("buckets must be a sorted, non-empty sequence")
        self.buckets = tuple(int(b) for b in buckets)
        self.max_batch = self.buckets[-1]
        self.max_delay = float(max_delay_ms) / 1e3
        self.device = _device_of(members)
        self.k = len(members)
        self.n_off = len(offsets)
        self._serve = ensemble_serve_fn(
            members, offsets, impl=impl, dtype=dtype,
            stacked=True if stacked_grid else None)
        self._programs: Dict[int, PackedProgram] = {}
        self._layout = None   # (keys, shapes), fixed by the first sample
        self._q: "queue.Queue" = queue.Queue()
        self._stats = {"requests": 0, "batches": 0, "padded_rows": 0,
                       "by_bucket": {b: 0 for b in self.buckets}}
        self._closed = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="mep-torch-batching-server")
        self._thread.start()

    # -- client side ------------------------------------------------------
    def submit(self, sample: Dict[str, np.ndarray]) -> Future:
        if self._closed.is_set():
            raise RuntimeError("server is closed")
        fut: Future = Future()
        self._q.put((sample, fut))
        if self._closed.is_set():
            # lost the race with close(): its drain may already have run
            self._fail_pending()
        return fut

    def predict(self, sample: Dict[str, np.ndarray]):
        return self.submit(sample).result()

    def warmup(self, sample: Dict[str, np.ndarray]) -> None:
        """Capture every bucket's program up front (and build the kernels),
        so that no request pays for it."""
        for b in self.buckets:
            self._forward([sample] * b)

    def stats(self) -> Dict:
        by = dict(self._stats["by_bucket"])
        return {**{k: v for k, v in self._stats.items() if k != "by_bucket"},
                "by_bucket": by}

    def _fail_pending(self) -> None:
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                try:
                    item[1].set_exception(RuntimeError("server closed"))
                except Exception:   # already resolved: nothing to do
                    pass

    def close(self) -> None:
        self._closed.set()
        self._q.put(None)                   # wake the collector
        self._thread.join(timeout=10)
        self._fail_pending()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- collector side ---------------------------------------------------
    def _forward(self, samples):
        if self._layout is None:
            self._layout = packed_layout(samples[0])
        prog = self._programs.get(len(samples))
        if prog is None:
            prog = PackedProgram(self._serve.fn, *self._layout, len(samples),
                                 self.device,
                                 name=f"packed predict, bucket {len(samples)}")
            self._programs[len(samples)] = prog
        out = prog(samples)
        return out[:, : out.shape[1] - self.n_off], out[:, out.shape[1] - self.n_off:]

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.max_batch

    def _drain_group(self):
        """Block for the first request, then wait up to max_delay (total)
        for followers, capped at max_batch.  Returns [] on shutdown."""
        first = self._q.get()
        if first is None:
            return []
        group = [first]
        deadline = time.perf_counter() + self.max_delay
        while len(group) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                break
            group.append(item)
        return group

    def _loop(self):
        while not self._closed.is_set():
            group = self._drain_group()
            if not group:
                continue
            samples, futs = zip(*group)
            bucket = self._bucket_for(len(samples))
            padded = list(samples) + [samples[-1]] * (bucket - len(samples))
            try:
                pred, probs = self._forward(padded)
            except Exception as e:  # deliver, don't kill the collector
                for f in futs:
                    f.set_exception(e)
                continue
            self._stats["requests"] += len(futs)
            self._stats["batches"] += 1
            self._stats["padded_rows"] += bucket - len(futs)
            self._stats["by_bucket"][bucket] += 1
            for i, f in enumerate(futs):
                f.set_result((pred[i], probs[i]))
