"""Open-loop serving driver: independent callers whose requests arrive as
a Poisson process at a fixed rate into `serve.server.BatchingServer`
(dynamic micro-batching into padded buckets, one captured program per
bucket).

The arrivals of a window are fixed by the rate and the window: n =
rate x seconds gaps, the exponential distribution's n quantiles at
(i + 1/2) / n, in an order drawn from the seed, so every seed offers the
same load in another order; the samples come from the seeded pool.  A
request is timed from when it was due to when its answer is on the host
(its future resolved); one still in flight when the window closes is
waited for, up to `grace_s`, and counts in the tail.  How late the
generator itself sent is printed on standard error.  A `--trace 1` run
traces from the window's middle to its end.

Set-up makes the pool and the members, starts the server and captures
every bucket (`warmup`), then sends `warm_requests` requests.

End to end: `serve_p95_ms` over every request of the window, and
`serve_req_per_s`, requests answered inside the window over its length;
a request that fails, or never answers, counts as attempted and not
answered.
"""

from __future__ import annotations

import threading
import time
from collections import Counter

import numpy as np

from ..core import device as card
from ..core.harness import Window
from . import serving


class Cell(serving.Served):
    def __init__(self, ctx):
        from multimodal_emotion_processing_tpu_torch.serve import BatchingServer

        super().__init__(ctx)
        p = ctx.params
        self.server = BatchingServer(
            self.members, self.offsets, impl=ctx.impl, dtype=ctx.dtype,
            max_delay_ms=float(p["max_delay_ms"]),
            buckets=tuple(int(b) for b in p["buckets"]))
        self.server.warmup(self.pool[0])
        for f in [self.server.submit(s)
                  for s in self.pool[: int(p["warm_requests"])]]:
            f.result(timeout=120)

    def release(self):
        if self.server is not None:
            self.server.close()
        self.server = None
        super().release()


def _rows(stats) -> Counter:
    return Counter({int(b): n for b, n in stats["by_bucket"].items()})


def window(cell: Cell, seconds: float, tracer, rate: float = None) -> Window:
    p = cell.ctx.params
    rate = float(p["rate_per_s"] if rate is None else rate)
    members = int(cell.ctx.config["members"])
    rng = np.random.default_rng(cell.ctx.seed_for("arrivals"))
    n = int(rate * seconds)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    rng.shuffle(gaps)
    picks = rng.integers(0, len(cell.pool), size=n)
    done = np.full(n, np.nan)
    results = [None] * n
    late = np.empty(n)
    lock = threading.Lock()
    answered = [0]
    all_answered = threading.Event()

    def finished(i):
        def cb(fut):
            done[i] = time.perf_counter()
            try:
                results[i] = fut.result()
            except Exception as e:   # counted below
                results[i] = e
            with lock:
                answered[0] += 1
                if answered[0] == n:
                    all_answered.set()
        return cb

    def drain(submitted):
        while answered[0] < submitted:
            time.sleep(0.0005)

    before = cell.server.stats()
    traced_stats = None
    t0 = time.perf_counter()
    due = t0 + np.cumsum(gaps)
    for i in range(n):
        if tracer.enabled and traced_stats is None and due[i] >= t0 + seconds / 2:
            # the traced stretch starts with nothing in flight, so that
            # the trace, the launch counters and the server's counts
            # cover the same batches (a traced run's own timing pays)
            drain(i)
            t_traced = time.perf_counter()
            tracer.start()
            traced_stats = cell.server.stats()
        wait = due[i] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        f = cell.server.submit(cell.pool[int(picks[i])])
        late[i] = time.perf_counter() - due[i]
        f.add_done_callback(finished(i))
    close = t0 + seconds
    wait = close - time.perf_counter()
    if wait > 0:
        time.sleep(wait)
    answered_in_window = int(np.sum(done <= close))
    all_answered.wait(timeout=max(1.0, close + float(p["grace_s"])
                                  - time.perf_counter()))
    if traced_stats is not None:
        delta = _rows(cell.server.stats()) - _rows(traced_stats)
        tracer.stop({"forward": Counter({b: k * members
                                         for b, k in delta.items()})})
    failed = 0
    for i, r in enumerate(results):
        if not isinstance(r, tuple):
            failed += 1
            card.log(f"[serve] request {i} failed: {r!r}")
            done[i] = np.inf
            continue
        cell.served.append((int(picks[i]), r[0], r[1]))
    after = cell.server.stats()
    latency = done - due
    lat_ms = latency * 1e3
    card.log(f"[serve] rate {rate} req/s, {n} requests, {answered_in_window} "
             f"answered in the window, {failed} failed; generator late ms "
             f"p50 {np.median(late) * 1e3:.4f} p99 "
             f"{np.percentile(late, 99) * 1e3:.4f} max {late.max() * 1e3:.4f}; "
             f"latency ms p50 {np.median(lat_ms):.4f} p99 "
             f"{np.percentile(lat_ms, 99):.4f} max {np.max(lat_ms):.4f}")
    rows = _rows(after) - _rows(before)
    card.log(f"[serve] batches by bucket {dict(sorted(rows.items()))}")
    # the per-layer readers divide the counts before the traced half
    upto = after if traced_stats is None else traced_stats
    rows = _rows(upto) - _rows(before)
    requests = upto["requests"] - before["requests"]
    return Window(metrics={"serve_p95_ms": serving.p95_ms(latency),
                           "serve_req_per_s": answered_in_window / seconds},
                  wall_s=seconds if traced_stats is None else t_traced - t0,
                  work={"requests": requests, "forwards": requests * members,
                        "batch_rows": sum(b * k for b, k in rows.items()),
                        "members": members,
                        "late_p99_ms": float(np.percentile(late, 99) * 1e3),
                        "first_fifth_p50_ms": float(np.median(lat_ms[: n // 5])),
                        "last_fifth_p50_ms": float(np.median(lat_ms[-(n // 5):]))},
                  attempted=n, failed=failed)


reference = serving.reference
compare = serving.compare
