"""Batch-1 streaming driver: one closed-loop client of
`serve.stream.StreamingPredictor`, one request in flight (the robot demo
itself: one robot, one utterance at a time).  The batching layer is
bypassed.

Set-up makes the seeded request pool, the members from the benchmark's
weights, the predictor at the configuration's impl, and captures its
programs (`warmup`, then `warm_requests` requests).  The window sends the
pool's samples in a seeded order, each as soon as the previous answer is
on the host, until `--seconds` have passed; each request is timed from
its send to its answer on the host.  A `--trace 1` run traces from the
window's middle to its end.

End to end: `stream_p95_ms`, the 95th percentile of every request's
latency, and `stream_req_per_s`, requests answered over the window's
wall.
"""

from __future__ import annotations

import time
from collections import Counter

import numpy as np

from ..core import device as card
from ..core.harness import Window
from . import serving


class Cell(serving.Served):
    def __init__(self, ctx):
        from multimodal_emotion_processing_tpu_torch.serve import StreamingPredictor

        super().__init__(ctx)
        self.predictor = StreamingPredictor(self.members, self.offsets,
                                            impl=ctx.impl, dtype=ctx.dtype)
        self.predictor.warmup(self.pool[0])
        for s in self.pool[: int(ctx.params["warm_requests"])]:
            self.predictor.predict(s)

    def release(self):
        self.predictor = None
        super().release()


def window(cell: Cell, seconds: float, tracer) -> Window:
    members = int(cell.ctx.config["members"])
    rng = np.random.default_rng(cell.ctx.seed_for("order"))
    order = rng.permutation(len(cell.pool))
    latencies = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    traced_from = None
    i = 0
    while True:
        if traced_from is None and time.perf_counter() >= t0 + seconds / 2:
            tracer.start()
            traced_from = i
        k = int(order[i % len(order)])
        a = time.perf_counter()
        logits, probs = cell.predictor.predict(cell.pool[k])
        b = time.perf_counter()
        latencies.append(b - a)
        cell.served.append((k, logits, probs))
        i += 1
        if b >= deadline:
            break
    wall = b - t0 - tracer.overhead_s
    n_traced = i - (traced_from or 0)
    tracer.stop({"forward": Counter({1: n_traced * members})})
    # the per-layer readers divide the requests before the traced half
    untraced = i if traced_from is None or not tracer.summary else traced_from
    stretch = tracer.summary.window_s if tracer.summary else 0.0
    lat = np.asarray(latencies) * 1e3
    card.log(f"[stream] {i} requests; latency ms p50 {np.median(lat):.4f} "
             f"p95 {np.percentile(lat, 95):.4f} p99 {np.percentile(lat, 99):.4f} "
             f"max {lat.max():.4f}")
    failed = sum(1 for _, lg, _ in cell.served if not np.isfinite(lg).all())
    return Window(metrics={"stream_p95_ms": serving.p95_ms(latencies),
                           "stream_req_per_s": i / wall},
                  wall_s=wall - stretch,
                  work={"requests": untraced, "forwards": untraced * members,
                        "members": members},
                  attempted=i, failed=failed)


reference = serving.reference
compare = serving.compare
