"""Per-config throughput sweep: one JSON line per registered config
(bench/all_configs.py of the JAX package, its keys), so that every
family's hot path is measured, not just the flagship's.

    python -m multimodal_emotion_processing_tpu_torch.bench.all_configs \
        [impl] [--steps N] [--reps R] [--scan-k K] [--configs a,b]
        [--device cpu] [--set K=V]

Each line, at one attention impl and the config's batch size:
  * train_sps: the Trainer's captured step (bench/autotune.train_windows,
    the program `train` runs), best of `reps` epochs of `steps` steps;
  * infer_sps: the Ensemble's captured forward (best_window_ms);
  * scan_train_sps: `Trainer(scan_steps=scan_k)`, epochs of 2 x scan_k
    steps, scan_k copied together and replayed back to back;
  * scan_infer_sps: scan_k forwards captured in one graph over a stacked
    (scan_k, B, ...) batch on the device, two replays a window.
Every window ends in a host fetch of its result.
"""

from __future__ import annotations

import json


def synth_batch(name, m, b):
    from ..data.loader import Batcher
    from ..data.synthetic import synthetic_dataset

    samples = synthetic_dataset(name, m, b, seed=0)
    return next(iter(Batcher(samples, b, shuffle=False, pad_final=False)()))


def scan_infer_sps(exp, host, *, impl: str, device, scan_k: int,
                   reps: int) -> float:
    """Samples/s of `scan_k` forwards of the Ensemble's combination
    captured as one program over a (scan_k, B, ...) stack of `host` on the
    device: the port's counterpart of JAX's make_scan_predict_step."""
    import numpy as np
    import torch

    from .autotune import _release
    from ..eval.ensemble import Ensemble
    from ..models import build_model
    from ..serve.graphs import GraphedFunction
    from ..utils.timing import best_window_ms

    stacked = {k: torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        a[None], (scan_k,) + a.shape))).to(device)
        for k, a in host.items() if k != "label"}
    ens = Ensemble([build_model(exp, device=device)], impl=impl,
                   dtype=exp.train.compute_dtype)
    combine = ens.program.fn

    def scan_forward():
        return torch.stack([combine({k: v[i] for k, v in stacked.items()})
                            for i in range(scan_k)])

    ms = best_window_ms(GraphedFunction(scan_forward, device,
                                        name=f"scan forward x{scan_k}"),
                        steps=2, reps=reps)
    b = next(iter(host.values())).shape[0]
    del ens, stacked
    _release(torch, device)
    return b * scan_k * 1e3 / ms


def measure(name, *, impl="xla", steps=20, reps=4, scan_k=32, device=None,
            sets=()):
    from . import device_line, with_sets
    from .autotune import _measure_infer, train_windows
    from .. import configs
    from ..data.loader import to_device
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    exp = with_sets(configs.get(name), sets)
    b = exp.train.batch_size
    host = synth_batch(name, exp.model, b)

    def train(n, scan_steps=1):
        batches = [host] * n
        return max(train_windows(exp, lambda: iter(batches), impl=impl,
                                 device=dev, epochs=1 + reps,
                                 scan_steps=scan_steps))

    train_sps = train(steps)
    infer_sps = _measure_infer(exp, impl=impl, device=dev, steps=steps,
                               reps=reps, batch=to_device(host, dev))
    scan_train = train(2 * scan_k, scan_steps=scan_k)
    scan_infer = scan_infer_sps(exp, host, impl=impl, device=dev,
                                scan_k=scan_k, reps=reps)
    return {"config": name, "impl": impl, "batch": b,
            "train_sps": round(train_sps, 1), "infer_sps": round(infer_sps, 1),
            "scan_k": scan_k, "scan_train_sps": round(scan_train, 1),
            "scan_infer_sps": round(scan_infer, 1),
            "device": device_line(dev)}


def main(argv=None):
    from . import entry_parser
    from .. import configs

    ap = entry_parser("one train / infer / scan throughput line per config")
    ap.add_argument("impl", nargs="?", default="xla")
    ap.add_argument("--configs", default=None,
                    help="comma-separated subset of the registered configs")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--scan-k", type=int, default=32)
    args = ap.parse_args(argv)
    names = (args.configs.split(",") if args.configs
             else sorted(configs.REGISTRY))
    rows = []
    for name in names:
        row = measure(name, impl=args.impl, steps=args.steps, reps=args.reps,
                      scan_k=args.scan_k, device=args.device, sets=args.set)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
