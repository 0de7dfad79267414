"""Concurrent serving throughput: the micro-batching server against the
reference's sequential batch-1 loop (bench/serving.py of the JAX package,
its keys).

N requests through `serve.BatchingServer` (grouped into bucketed batches,
one captured program per bucket) against the same N through the
sequential batch-1 `StreamingPredictor` loop (one captured program per
request, the reference's serving structure, robot_demo.py:594-640), then
the same concurrent load through the HTTP front end
(serve/http_api.HttpFrontend on a local ephemeral port) in both wire
formats, JSON and raw float32.

    python -m multimodal_emotion_processing_tpu_torch.bench.serving \
        [config] [N] [--device cpu] [--set K=V]

Prints one JSON line.  Every request's result is fetched to the host
(through its future, or its HTTP response) before the clock stops.
"""

from __future__ import annotations

import json
import time


def measure(config_name: str = "robot_demo", n_requests: int = 64, *,
            members: int = 4, reps: int = 3, buckets=(1, 2, 4, 8, 16),
            max_delay_ms: float = 3.0, device=None, sets=()):
    from . import device_line, with_sets
    from .. import configs
    from ..data.synthetic import synthetic_dataset
    from ..models import build_model
    from ..serve import BatchingServer, StreamingPredictor
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    exp = with_sets(configs.get(config_name), sets)
    impl, dtype = exp.model.attn_impl, exp.train.compute_dtype
    params = [build_model(exp, device=dev, seed=i).eval()
              for i in range(members)]
    samples = synthetic_dataset(config_name, exp.model, n_requests, seed=0)

    sp = StreamingPredictor(params, exp.thresholds, impl=impl, dtype=dtype)
    sp.warmup(samples[0])
    seq_best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for s in samples:
            sp.predict(s)                      # fetches the full result
        seq_best = min(seq_best, time.perf_counter() - t0)

    srv = BatchingServer(params, exp.thresholds, impl=impl, dtype=dtype,
                         buckets=buckets, max_delay_ms=max_delay_ms)
    try:
        srv.warmup(samples[0])
        srv_best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            futs = [srv.submit(s) for s in samples]
            for f in futs:
                f.result(timeout=600)          # fetches the full result
            srv_best = min(srv_best, time.perf_counter() - t0)
        stats = srv.stats()
        http = _measure_http(srv, exp, samples, reps=reps)
    finally:
        srv.close()

    return {
        "config": config_name,
        "n_requests": n_requests,
        "members": members,
        "sequential_rps": round(n_requests / seq_best, 1),
        "server_rps": round(n_requests / srv_best, 1),
        "speedup": round(seq_best / srv_best, 2),
        "ms_per_req": {"sequential": round(seq_best * 1e3 / n_requests, 2),
                       "server": round(srv_best * 1e3 / n_requests, 2)},
        "server_batches": stats["batches"],
        "by_bucket": {str(k): v for k, v in stats["by_bucket"].items() if v},
        "http": http,
        "device": device_line(dev),
    }


def _measure_http(srv, exp, samples, *, reps: int = 3):
    """The same concurrent load through the HTTP front end, both wire
    formats, one thread a request (payloads encoded beforehand, so the
    server side's wire cost is what is timed)."""
    import threading
    import urllib.request

    import numpy as np

    from ..serve import HttpFrontend

    keys = sorted(k for k in samples[0] if k != "label")
    spec = {k: samples[0][k].shape for k in keys}
    n = len(samples)
    out = {}
    with HttpFrontend(srv, spec, exp.emotion_names[:len(exp.thresholds)],
                      port=0) as fe:
        payloads = {
            "json": [json.dumps({k: np.asarray(s[k]).tolist() for k in keys})
                     .encode() for s in samples],
            "binary": [b"".join(np.ascontiguousarray(
                np.asarray(s[k], np.float32)).tobytes() for k in keys)
                for s in samples],
        }
        ctypes = {"json": "application/json",
                  "binary": "application/octet-stream"}
        failures = []

        def call(body, ctype):
            req = urllib.request.Request(
                f"http://127.0.0.1:{fe.port}/predict", data=body,
                headers={"Content-Type": ctype}, method="POST")
            try:
                urllib.request.urlopen(req, timeout=600).read()
            except Exception as e:  # counted, then raised by the caller
                failures.append(e)

        for wire in ("binary", "json"):
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                ts = [threading.Thread(target=call, args=(p, ctypes[wire]))
                      for p in payloads[wire]]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join()
                best = min(best, time.perf_counter() - t0)
            if failures:
                raise RuntimeError(f"{len(failures)} HTTP {wire} requests "
                                   f"failed: {failures[0]!r}")
            out[f"{wire}_rps"] = round(n / best, 1)
        out["payload_mb"] = {
            w: round(sum(len(p) for p in payloads[w]) / 2**20, 1)
            for w in payloads}
    return out


def main(argv=None):
    from . import entry_parser

    ap = entry_parser("concurrent serving throughput: BatchingServer "
                      "against the sequential batch-1 loop, and over HTTP")
    ap.add_argument("config", nargs="?", default="robot_demo")
    ap.add_argument("n", nargs="?", type=int, default=64)
    ap.add_argument("--members", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    out = measure(args.config, args.n, members=args.members, reps=args.reps,
                  device=args.device, sets=args.set)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
