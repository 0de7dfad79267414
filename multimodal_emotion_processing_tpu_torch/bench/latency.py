"""Batch-1 ensemble latency: the reference's p50 path (bench/latency.py of
the JAX package, its legs and keys without the `jax_` prefix).

The reference's test protocol runs batch 1 through four sequential member
forwards per sample (cmu-mosei/run.py:456-476), and the robot demo does
the same for live streaming (robot_demo.py:611-614); throughput benches
never measure it, so this module does.

    python -m multimodal_emotion_processing_tpu_torch.bench.latency \
        [config] [--reps N] [--device cpu] [--set K=V]

Prints one JSON line: per-call latency percentiles of
  * compute: the batch-1 sample already on the device, one replay of
    `StreamingPredictor`'s captured ensemble program, timed to the
    probabilities fetched to the host (`reps` calls);
  * end_to_end: `StreamingPredictor.predict(sample)` from a host sample,
    the packed copy up and the copy down included (reps // 4 calls, at
    least 10);
  * torch_cpu: the reference protocol, four sequential member forwards at
    batch 1 on the CPU with the port's plain PyTorch path (impl "xla"),
    the mean of their logits fetched as numpy;
and the ratio of the torch_cpu p50 to the compute p50.  The members are
four seeded random ones; weights do not change the time.
"""

from __future__ import annotations

import json
import time

import numpy as np


def _percentiles(times_s):
    t = np.asarray(times_s) * 1e3
    return {"p50_ms": round(float(np.percentile(t, 50)), 3),
            "p90_ms": round(float(np.percentile(t, 90)), 3),
            "best_ms": round(float(t.min()), 3)}


def _members(exp, device, n):
    from ..models import build_model

    return [build_model(exp, device=device, seed=i).eval() for i in range(n)]


def _sample(exp):
    from ..data.synthetic import synthetic_dataset

    return synthetic_dataset(exp.name, exp.model, 1, seed=7)[0]


def time_calls(call, n: int):
    """Host seconds of each of `n` calls of `call` (each ends in a fetch)."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    return times


def predictor_legs(exp, *, members: int = 4, device=None, impl=None):
    """(StreamingPredictor, a call of one replay of its captured ensemble
    program on the batch-1 sample already on the device, fetching the
    probabilities, and the host sample)."""
    from ..serve import StreamingPredictor
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    sp = StreamingPredictor(_members(exp, dev, members), exp.thresholds,
                            impl=impl or exp.model.attn_impl,
                            dtype=exp.train.compute_dtype)
    sample = _sample(exp)
    sp.warmup(sample)
    dev_batch = sp._batch1(sample)

    def compute():
        return sp._run(dev_batch)[1].cpu().numpy()

    compute()   # the program of this key is captured by warmup already
    return sp, compute, sample


def measure_device(exp, *, members: int = 4, reps: int = 200, device=None,
                   impl=None):
    """(compute, end_to_end) percentiles on `device`."""
    sp, compute, sample = predictor_legs(exp, members=members, device=device,
                                         impl=impl)
    comp = time_calls(compute, reps)
    e2e = time_calls(lambda: sp.predict(sample), max(reps // 4, 10))
    return _percentiles(comp), _percentiles(e2e)


def measure_torch_cpu(exp, *, members: int = 4, reps: int = 30):
    """The reference's sequential batch-1 loop: `members` forwards one
    after another on the CPU (impl "xla"), their logits' mean as numpy."""
    import torch

    models = _members(exp, torch.device("cpu"), members)
    sample = _sample(exp)
    batch = {k: torch.from_numpy(np.asarray(v)[None])
             for k, v in sample.items() if k != "label"}
    with torch.no_grad():
        for mod in models:
            mod(batch, impl="xla")   # warm-up
        times = time_calls(lambda: torch.stack(
            [mod(batch, impl="xla") for mod in models]).mean(0).numpy(), reps)
    return _percentiles(times)


def measure(config_name: str = "mosei_trans", *, members: int = 4,
            reps: int = 200, cpu_reps: int = 30, device=None, sets=()):
    from . import device_line, with_sets
    from .. import configs
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    exp = with_sets(configs.get(config_name), sets)
    compute, e2e = measure_device(exp, members=members, reps=reps, device=dev)
    torch_lat = measure_torch_cpu(exp, members=members, reps=cpu_reps)
    return {"metric": f"{config_name} batch-1 {members}-member ensemble "
                      "latency",
            "compute": compute, "end_to_end": e2e, "torch_cpu": torch_lat,
            "compute_speedup_p50": round(
                torch_lat["p50_ms"] / compute["p50_ms"], 1),
            "reps": reps, "device": device_line(dev)}


def main(argv=None):
    from . import entry_parser

    ap = entry_parser("batch-1 ensemble latency percentiles")
    ap.add_argument("config", nargs="?", default="mosei_trans")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--cpu-reps", type=int, default=30)
    ap.add_argument("--members", type=int, default=4)
    args = ap.parse_args(argv)
    out = measure(args.config, members=args.members, reps=args.reps,
                  cpu_reps=args.cpu_reps, device=args.device, sets=args.set)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
