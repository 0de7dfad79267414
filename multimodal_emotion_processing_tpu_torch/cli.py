"""Command line of the PyTorch port.

  train <config> [--epochs E] [--n-train N] [--n-test M]
        [--impl xla|flash|pallas|pallas_fused] [--device cpu] [--set K=V]
        Train one member of any of the five families with the port's
        Trainer on synthetic data and print one JSON line per epoch; under
        the config's R-Drop (`ren_mme`) both loaders duplicate every
        sample into adjacent rows.
  serve [<config>] [--concurrent N] [--device cpu]
        [--impl xla|flash|pallas|pallas_fused] [--thresholds T1,T2,...]
        Serve a 4-member ensemble of seeded random members on synthetic
        requests: N concurrent requests through the micro-batching server,
        or one batch-1 request without --concurrent.  The config defaults
        to robot_demo, the reference's streaming demo.  The paragraph model
        (`mosei_realformer`, head state_transfer) streams one synthetic
        paragraph clip by clip with its recurrence state on the device; it
        has no thresholds of its own, so it needs --thresholds.
        `serve ren_mme --impl pallas_fused` serves Ren-MME through the
        whole-block kernel.

Runs on the GPU unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

N_MEMBERS = 4
IMPLS = ["xla", "flash", "pallas", "pallas_fused"]


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
    tr = sub.add_parser(
        "train", help="train one member on synthetic data",
        description="Train one member of <config> with the port's Trainer "
                    "on synthetic data (train split seed 0, valid split "
                    "seed 1) and print one JSON line per epoch.  K-fold "
                    "bagging, checkpoints and ensemble evaluation are not "
                    "ported yet.")
    tr.add_argument("config")
    tr.add_argument("--epochs", type=int, default=None,
                    help="epochs (default: the config's, with its early stop)")
    tr.add_argument("--n-train", type=int, default=256)
    tr.add_argument("--n-test", type=int, default=64)
    tr.add_argument("--impl", choices=IMPLS, default=None,
                    help="attention implementation (default: the config's)")
    tr.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    tr.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="config override, model.K=V or train.K=V")
    sv = sub.add_parser("serve", help="ensemble serving on synthetic requests")
    sv.add_argument("config", nargs="?", default="robot_demo")
    sv.add_argument("--impl", choices=IMPLS, default=None,
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
    sv.add_argument("--thresholds", default=None, metavar="T1,T2,...",
                    help="per-emotion calibration offsets, in place of the "
                         "config's (needed by configs without any, such as "
                         "mosei_realformer); use --thresholds=-0.3,... for "
                         "negative values")
    return p


def load_members(exp, device):
    """Seeded random members: this slice has no checkpoints."""
    from .models import build_model

    return [build_model(exp, device=device, seed=i) for i in range(N_MEMBERS)]


def cmd_train(args):
    from . import configs
    from .data.loader import Batcher
    from .data.synthetic import synthetic_dataset
    from .train.engine import Trainer

    exp = configs.with_overrides(configs.get(args.config),
                                 parse_overrides(args.set))
    impl = args.impl or exp.model.attn_impl
    train = synthetic_dataset(args.config, exp.model, args.n_train, seed=0)
    valid = synthetic_dataset(args.config, exp.model, args.n_test, seed=1)
    bs = exp.train.batch_size

    def log(epoch, stats):
        print(json.dumps({"epoch": epoch, "train_loss": stats.train_loss,
                          "valid_loss": stats.valid_loss, "steps": stats.steps,
                          "samples": stats.samples, "seconds": stats.seconds,
                          "samples_per_sec": stats.samples_per_sec}),
              flush=True)

    trainer = Trainer(exp, exp.train, impl=impl, device=args.device, log_cb=log)
    dup = exp.train.rdrop_kl
    print(f"(training {exp.name} on {trainer.device}, impl={impl}, "
          f"dtype={exp.train.compute_dtype}, dropout={exp.model.dropout}, "
          f"R-Drop={dup}, {len(train)} train / {len(valid)} valid synthetic "
          "samples)", file=sys.stderr)
    return trainer.fit(Batcher(train, bs, duplicate=dup, seed=1),
                       Batcher(valid, bs, duplicate=dup, shuffle=False),
                       epochs=args.epochs)


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
    offsets = (tuple(float(t) for t in args.thresholds.split(","))
               if args.thresholds else exp.thresholds)
    names = exp.emotion_names[: len(offsets)]

    if exp.model.head == "state_transfer":
        return _serve_paragraph(args, exp, members, offsets, impl)
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


def _serve_paragraph(args, exp, members, offsets, impl):
    """Stream one synthetic paragraph clip by clip (JAX cli.py:544-577)."""
    from .data.synthetic import synthetic_dataset
    from .serve import ParagraphStreamingPredictor

    if args.concurrent > 0:
        raise SystemExit(
            "state_transfer configs stream clip-by-clip with carried "
            "recurrence state; --concurrent serves stateless per-sample heads")
    sp = ParagraphStreamingPredictor(members, offsets, impl=impl,
                                     dtype=exp.train.compute_dtype)
    sample = synthetic_dataset(args.config, exp.model, 1, seed=7)[0]
    plen = sample["l"].shape[0]
    clips = [{k: sample[k][t] for k in sp._CLIP_KEYS} for t in range(plen)]
    sp.warmup(clips[0])
    sp.reset()
    t0 = time.perf_counter()
    per_clip = [sp.emotions(c, exp.emotion_names) for c in clips]
    latency_ms = (time.perf_counter() - t0) * 1e3 / plen
    print(f"Streaming paragraph ({plen} clips, state carried on the device)")
    for t, emos in enumerate(per_clip):
        print(f"clip {t}: " + "  ".join(f"{n} {p}" for n, p in emos.items()))
    print(f"(latency: {latency_ms:.2f} ms per clip, {len(members)}-model "
          "ensemble)", file=sys.stderr)
    return per_clip


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.cmd == "train":
        return cmd_train(args)
    if args.cmd == "serve":
        return cmd_serve(args)
    raise SystemExit(f"unknown command {args.cmd!r}")
