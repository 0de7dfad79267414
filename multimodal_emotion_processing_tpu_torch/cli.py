"""Command line of the PyTorch port.

  serve <config> [--concurrent N] [--device cpu] [--impl xla|flash]
        Serve a 4-member ensemble of seeded random members on synthetic
        requests: N concurrent requests through the micro-batching server,
        or one batch-1 request without --concurrent.

Runs on the GPU unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

N_MEMBERS = 4


def parse_overrides(pairs):
    out = {"model": {}, "train": {}}
    for kv in pairs:
        key, _, raw = kv.partition("=")
        section, _, field = key.partition(".")
        if section not in out or not field:
            raise SystemExit(f"--set expects model.X=V or train.X=V, got {kv!r}")
        try:
            out[section][field] = json.loads(raw)
        except json.JSONDecodeError:
            out[section][field] = raw
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="multimodal_emotion_processing_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    sv = sub.add_parser("serve", help="ensemble serving on synthetic requests")
    sv.add_argument("config")
    sv.add_argument("--impl", choices=["xla", "flash"], default=None,
                    help="attention implementation (default: the config's)")
    sv.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    sv.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="config override, model.K=V or train.K=V")
    sv.add_argument("--concurrent", type=int, default=0, metavar="N",
                    help="drive N concurrent requests through the "
                         "micro-batching server instead of one batch-1 "
                         "request")
    sv.add_argument("--max-delay-ms", type=float, default=3.0)
    return p


def load_members(exp, device):
    """Seeded random members: this slice has no checkpoints."""
    from .models import build_model

    return [build_model(exp, device=device, seed=i) for i in range(N_MEMBERS)]


def cmd_serve(args):
    from . import configs
    from .data.synthetic import synthetic_dataset
    from .serve import BatchingServer, StreamingPredictor
    from .utils.device import resolve_device

    exp = configs.with_overrides(configs.get(args.config),
                                 parse_overrides(args.set))
    device = resolve_device(args.device)
    impl = args.impl or exp.model.attn_impl
    members = load_members(exp, device)
    print(f"({len(members)}-member seeded random ensemble on {device}, "
          f"impl={impl}, dtype={exp.train.compute_dtype})", file=sys.stderr)
    offsets = exp.thresholds
    names = exp.emotion_names[: len(offsets)]

    if args.concurrent > 0:
        samples = synthetic_dataset(args.config, exp.model, args.concurrent,
                                    seed=7)
        with BatchingServer(members, offsets, impl=impl,
                            max_delay_ms=args.max_delay_ms,
                            dtype=exp.train.compute_dtype) as srv:
            srv.warmup(samples[0])
            t0 = time.perf_counter()
            futs = [srv.submit(s) for s in samples]
            results = [f.result(timeout=600) for f in futs]
            elapsed = time.perf_counter() - t0
            stats = srv.stats()
        print("The emotion(s) is(are)  [request 1 of "
              f"{len(results)} concurrent]")
        for name, prob in zip(names, results[0][1]):
            print(name, round(float(prob), 2))
        print(f"({args.concurrent} requests in {elapsed * 1e3:.1f} ms = "
              f"{args.concurrent / elapsed:.1f} req/s; "
              f"batches={stats['batches']} "
              f"by_bucket={ {b: c for b, c in stats['by_bucket'].items() if c} })",
              file=sys.stderr)
        return results

    sp = StreamingPredictor(members, offsets, impl=impl,
                            dtype=exp.train.compute_dtype)
    sample = synthetic_dataset(args.config, exp.model, 1, seed=7)[0]
    sp.warmup(sample)
    t0 = time.perf_counter()
    emotions = sp.emotions(sample, names)
    latency_ms = (time.perf_counter() - t0) * 1e3
    print("The emotion(s) is(are)")
    for name, prob in emotions.items():
        print(name, prob)
    print(f"(latency: {latency_ms:.2f} ms batch-1, {len(members)}-model "
          "ensemble)", file=sys.stderr)
    return emotions


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.cmd == "serve":
        return cmd_serve(args)
    raise SystemExit(f"unknown command {args.cmd!r}")
