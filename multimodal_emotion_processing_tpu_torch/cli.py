"""Command line of the PyTorch port.

  train <config>  k-fold bagged training and ensemble evaluation of one
        reference script on synthetic data, or on the corpus tree at
        --data-root R (pipelines.run_experiment):
        [--checkpoint-dir D] [--log-dir L] [--resume] [--sweep-thresholds]
        [--seeds-per-fold S] [--epochs E] [--n-train N] [--n-test M]
        [--impl xla|flash|pallas|pallas_fused] [--set K=V] [--device cpu]
        [--transfer-dtype float16|bfloat16|int8] [--async-checkpoint]
        [--scan-steps N] [--device-resident] [--one-dispatch]
        [--accum-steps N]; prints one JSON line per member epoch, then the
        report and any swept thresholds as JSON lines.
  sweep <config> --lrs L1,L2,... [--wds W1,...] [--seeds-per-lr S]
        [--epochs E] [--n-train N] [--data-root R] [--checkpoint-dir D]
        [--transfer-dtype float16|bfloat16] [--impl ...] [--set K=V]: every
        (lr x wd x seed) candidate trained together on fold 0's split,
        ranked by best valid loss, printed as one JSON document; with
        --checkpoint-dir the winner is saved as '<config>_sweep_winner'
        (pipelines.run_lr_sweep_experiment).
  eval <config> --checkpoint-dir D   the same evaluation of the store's
        best members, training nothing (epochs 0); [--data-root R].
  predict <config> -o OUT.npz|.csv|.jsonl  [--checkpoint-dir D |
        --init-random] [--split test|train|all] [--data-root R]
        [--thresholds T1,...] [--calibration] [--transfer-dtype W]
        [--device-resident]: every sample's ensemble logits, calibrated
        probabilities and decisions to a file (pipelines.run_predict).
  check-data <config> --data-root R   what the corpus tree lacks for the
        config, as one JSON document (data/validate.py); exit 1 on any
        problem.
  checkpoints <dir> [--prefix P]  the store's members, losses, best
        epochs, resume points and bytes.
  configs   the registered configs.
  serve [<config>] [--checkpoint-dir D] [--concurrent N] [--device cpu]
        [--impl ...] [--thresholds T1,T2,...]
        Serve the store's best members, or without a store four seeded
        random members, on synthetic requests: N concurrent requests
        through the micro-batching server, or one batch-1 request without
        --concurrent.  The config defaults to robot_demo, the reference's
        streaming demo.  The paragraph model (`mosei_realformer`, head
        state_transfer) streams one synthetic paragraph clip by clip with
        its recurrence state on the device.  The calibration offsets are
        --thresholds, else the store's tuned thresholds.json, else the
        config's; `mosei_realformer` has none of its own.  With
        --http-port P [--http-host H] the micro-batching server answers
        HTTP (GET /healthz, GET /spec, POST /predict as JSON or raw
        float32; serve/http_api.py) until Ctrl-C.
  export [<config>] [--checkpoint-dir D] [--set K=V] [--out F]
        [--batch B] [--device cpu]   the ensemble's serving computation at
        impl=xla, weights included, as one torch.export artifact
        (serve/export.py) for one device and one batch size.

Every command runs on the GPU unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import os
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

    def device(sp):
        sp.add_argument("--device", default=None,
                        help="'cuda' (default) or 'cpu'")

    def transfer(sp):
        sp.add_argument("--transfer-dtype",
                        choices=["float16", "bfloat16", "int8"], default=None,
                        help="wire format of the batches' copies to the "
                             "device, restored to f32 there before any "
                             "math: float16/bfloat16 halve the bytes (~1e-3 "
                             "feature rounding), int8 quantizes features 4x "
                             "(masks, labels and weights stay exact); "
                             "default f32")

    def overrides(sp):
        sp.add_argument("--set", action="append", default=[], metavar="K=V",
                        help="config override, model.K=V or train.K=V "
                             "(values parsed as JSON)")

    def common(sp):
        sp.add_argument("config")
        sp.add_argument("--epochs", type=int, default=None,
                        help="epochs (default: the config's, with its "
                             "early stop)")
        sp.add_argument("--data-root", default=None,
                        help="real corpus root (docs/REAL_DATA.md); omit "
                             "for synthetic data")
        sp.add_argument("--n-train", type=int, default=256)
        sp.add_argument("--n-test", type=int, default=64)
        sp.add_argument("--log-dir", default=None,
                        help="one CSV of epoch losses per member")
        sp.add_argument("--checkpoint-dir", default=None)
        sp.add_argument("--impl", choices=IMPLS, default=None,
                        help="attention implementation (default: the config's)")
        sp.add_argument("--sweep-thresholds", action="store_true",
                        help="choose the thresholds by the reference's "
                             "search over the test logits instead of the "
                             "config's fixed ones")
        sp.add_argument("--quiet", action="store_true")
        sp.add_argument("--resume", action="store_true",
                        help="resume an interrupted k-fold run from its "
                             "per-epoch checkpoints (needs --checkpoint-dir)")
        sp.add_argument("--seeds-per-fold", type=int, default=1,
                        help="train N members from different seeds per fold "
                             "and ensemble all k*N")
        transfer(sp)
        sp.add_argument("--async-checkpoint", action="store_true",
                        help="write checkpoint files on a worker thread: the "
                             "copy to the host is inline, torch.save "
                             "overlaps the next epoch; restores join any "
                             "save in flight")
        sp.add_argument("--scan-steps", type=int, default=1,
                        help="copy N host-fed batches to the device together "
                             "and launch their N captured steps back to back "
                             "(the same math as 1)")
        sp.add_argument("--device-resident", action="store_true",
                        help="stage the samples on the device once and "
                             "gather every batch there; every step is one "
                             "replay of the members' captured step (needs "
                             "the corpus to fit device memory)")
        sp.add_argument("--one-dispatch", action="store_true",
                        help="the whole k-fold run (all folds x all epochs, "
                             "plateau LR and early stop on the device) "
                             "launched without a host round trip between "
                             "epochs (the same memory needs)")
        sp.add_argument("--accum-steps", type=int, default=1,
                        help="gradient accumulation: each batch split into "
                             "this many micro-batches (the exact full-batch "
                             "gradient, ~N-fold less activation memory; the "
                             "sequential k-fold driver)")
        overrides(sp)
        device(sp)

    common(sub.add_parser(
        "train", help="k-fold bagged training and ensemble evaluation",
        description="Carve the config's k folds from synthetic samples "
                    "or the corpus at --data-root, train one member per "
                    "fold (best checkpoints and per-epoch resume points "
                    "with --checkpoint-dir), then evaluate the members' "
                    "ensemble on held-out samples."))
    common(sub.add_parser("eval", help="ensemble evaluation of a "
                                       "checkpoint store's members"))

    sw = sub.add_parser(
        "sweep", help="learning-rate sweep: every (lr x seed) candidate "
                      "trained together on the fold-0 split and ranked by "
                      "best valid loss")
    sw.add_argument("config")
    sw.add_argument("--lrs", required=True,
                    help="comma-separated learning-rate candidates, e.g. "
                         "1e-3,3e-4,1e-4")
    sw.add_argument("--wds", default=None,
                    help="comma-separated AdamW weight-decay candidates: "
                         "the grid becomes lr x wd x seed, still one run")
    sw.add_argument("--seeds-per-lr", type=int, default=1,
                    help="init seeds per candidate; candidates share seeds "
                         "and batch orders, so trajectory differences are "
                         "the hyperparameter's alone")
    sw.add_argument("--data-root", default=None,
                    help="real corpus root (default: synthetic data)")
    sw.add_argument("--epochs", type=int, default=None)
    sw.add_argument("--n-train", type=int, default=256)
    sw.add_argument("--n-test", type=int, default=64)
    sw.add_argument("--impl", choices=IMPLS, default=None)
    sw.add_argument("--checkpoint-dir", default=None,
                    help="save the winner's best parameters as "
                         "'<config>_sweep_winner'")
    sw.add_argument("--transfer-dtype", choices=["float16", "bfloat16"],
                    default=None,
                    help="stage the sweep's datasets half-width on the "
                         "device (restored to f32 before any math)")
    sw.add_argument("--quiet", action="store_true")
    overrides(sw)
    device(sw)

    pd = sub.add_parser(
        "predict", help="per-sample ensemble logits, calibrated "
                        "probabilities and decisions to .npz/.csv/.jsonl")
    pd.add_argument("config")
    pd.add_argument("--output", "-o", required=True,
                    help="output path; the format by extension: "
                         ".npz/.csv/.jsonl")
    pd.add_argument("--checkpoint-dir", default=None)
    pd.add_argument("--init-random", action="store_true",
                    help="smoke mode: one fresh member instead of trained "
                         "checkpoints")
    pd.add_argument("--data-root", default=None,
                    help="real corpus root (default: synthetic samples)")
    pd.add_argument("--n-test", type=int, default=64,
                    help="synthetic test-split size")
    pd.add_argument("--n-train", type=int, default=None,
                    help="synthetic train-split size for --split train/all "
                         "(default: --n-test)")
    pd.add_argument("--split", choices=["test", "train", "all"],
                    default="test")
    pd.add_argument("--impl", choices=IMPLS, default=None)
    pd.add_argument("--thresholds", default=None, metavar="T1,T2,...",
                    help="per-emotion decision thresholds (default: the "
                         "store's tuned ones, else the config's); use "
                         "--thresholds=-0.3,... for negative values")
    pd.add_argument("--calibration", action="store_true",
                    help="add the per-emotion calibration report (ECE and "
                         "reliability bins) to the printed summary")
    pd.add_argument("--quiet", action="store_true")
    pd.add_argument("--device-resident", action="store_true",
                    help="stage the split on the device once and replay one "
                         "captured program per batch (the same logits as "
                         "the per-batch path)")
    transfer(pd)
    overrides(pd)
    device(pd)

    cp = sub.add_parser("checkpoints", help="inspect a checkpoint store")
    cp.add_argument("checkpoint_dir")
    cp.add_argument("--prefix", default="",
                    help="only members whose name starts with this")

    sub.add_parser("configs", help="list the configs")

    cd = sub.add_parser(
        "check-data",
        help="validate a real corpus tree for a config before training: "
             "every file and directory it reads, the corpus counts and the "
             "feature coverage as one JSON document (exit 1 on problems)")
    cd.add_argument("config")
    cd.add_argument("--data-root", required=True)

    sv = sub.add_parser("serve", help="ensemble serving on synthetic requests")
    sv.add_argument("config", nargs="?", default="robot_demo")
    sv.add_argument("--checkpoint-dir", default=None,
                    help="serve the store's best members (default: four "
                         "seeded random members)")
    sv.add_argument("--impl", choices=IMPLS, default=None,
                    help="attention implementation (default: the config's)")
    sv.add_argument("--concurrent", type=int, default=0, metavar="N",
                    help="drive N concurrent requests through the "
                         "micro-batching server instead of one batch-1 "
                         "request")
    sv.add_argument("--max-delay-ms", type=float, default=3.0)
    sv.add_argument("--thresholds", default=None, metavar="T1,T2,...",
                    help="per-emotion calibration offsets, in place of the "
                         "store's tuned ones and the config's (needed by "
                         "configs without any, such as mosei_realformer); "
                         "use --thresholds=-0.3,... for negative values")
    sv.add_argument("--http-port", type=int, default=None, metavar="PORT",
                    help="serve the ensemble over HTTP: GET /healthz, GET "
                         "/spec (feature shapes, emotion names, the binary "
                         "wire's order), POST /predict (one JSON sample, or "
                         "raw float32 as application/octet-stream); "
                         "concurrent requests micro-batch; blocks until "
                         "Ctrl-C")
    sv.add_argument("--http-host", default="127.0.0.1")
    overrides(sv)
    device(sv)

    ex = sub.add_parser(
        "export", help="export the serving computation (ensemble and "
                       "calibrated sigmoid, weights included) as one "
                       "torch.export artifact")
    ex.add_argument("config", nargs="?", default="robot_demo")
    ex.add_argument("--checkpoint-dir", default=None,
                    help="export the store's best members (default: four "
                         "seeded random members)")
    ex.add_argument("--out", default="predictor.pt2")
    ex.add_argument("--batch", type=int, default=1,
                    help="static batch size of the artifact: 1 = the live "
                         "batch-1 predictor, >1 = a micro-batching bucket "
                         "program (one artifact per bucket size)")
    overrides(ex)
    device(ex)
    return p


def cmd_train(args, eval_only: bool = False):
    from .pipelines import run_experiment

    if eval_only and not args.checkpoint_dir:
        raise SystemExit(
            "eval requires --checkpoint-dir (otherwise there are no trained "
            "members to ensemble; run `train` first)")
    result = run_experiment(
        args.config, synthetic_data=args.data_root is None,
        data_root=args.data_root, n_train=args.n_train, n_test=args.n_test,
        epochs=0 if eval_only else args.epochs, log_dir=args.log_dir,
        checkpoint_dir=args.checkpoint_dir, impl=args.impl,
        sweep_thresholds=args.sweep_thresholds, quiet=args.quiet,
        overrides=parse_overrides(args.set), resume=args.resume,
        seeds_per_fold=args.seeds_per_fold, device=args.device,
        transfer_dtype=args.transfer_dtype,
        async_checkpoint=args.async_checkpoint, scan_steps=args.scan_steps,
        # the members' lockstep where a flag needs it (JAX's CLI always
        # takes it; the port's run_experiment defaults to the sequential
        # driver, as fast on the card)
        vmap_folds=args.device_resident or args.one_dispatch,
        device_resident=args.device_resident, one_dispatch=args.one_dispatch,
        accum_steps=args.accum_steps)
    for i, hist in enumerate(result.fold_histories):
        for epoch, stats in enumerate(hist):
            print(json.dumps({
                "member": f"{args.config}_{i + 1}", "epoch": epoch,
                "train_loss": stats.train_loss,
                "valid_loss": stats.valid_loss, "steps": stats.steps,
                "samples": stats.samples, "seconds": stats.seconds,
                "samples_per_sec": stats.samples_per_sec}), flush=True)
    if result.report is not None:
        print(json.dumps({"report": result.report}))
    if result.sweep is not None:
        print(json.dumps({"best_thresholds": result.sweep}))
    return result


def cmd_predict(args):
    from .pipelines import run_predict

    if not args.checkpoint_dir and not args.init_random:
        raise SystemExit("predict requires --checkpoint-dir (trained members) "
                         "or --init-random (an untrained smoke run)")
    table = run_predict(
        args.config, checkpoint_dir=args.checkpoint_dir,
        init_random=args.init_random,
        synthetic_data=args.data_root is None, data_root=args.data_root,
        n_test=args.n_test,
        n_train=args.n_train, impl=args.impl,
        overrides=parse_overrides(args.set),
        thresholds=([float(t) for t in args.thresholds.split(",")]
                    if args.thresholds else None),
        split=args.split, output=args.output, quiet=args.quiet,
        device=args.device, transfer_dtype=args.transfer_dtype,
        device_resident=args.device_resident)
    summary = {
        "config": args.config, "output": args.output,
        "rows": table["rows"], "members": table["members"],
        "emotions": table["emotions"],
        "positives": {n: int(table["pred"][:, j].sum())
                      for j, n in enumerate(table["emotions"])},
    }
    if args.calibration:
        from .eval.predictions import calibration_report

        summary["calibration"] = calibration_report(table)
    print(json.dumps(summary, indent=2))
    return table


def cmd_sweep(args):
    from .pipelines import run_lr_sweep_experiment

    def floats(flag, raw):
        try:
            return [float(x) for x in raw.split(",") if x.strip()]
        except ValueError:
            raise SystemExit(f"{flag} expects comma-separated floats, got "
                             f"{raw!r}")

    lrs = floats("--lrs", args.lrs)
    if not lrs:
        raise SystemExit("--lrs expects at least one learning rate")
    wds = floats("--wds", args.wds) if args.wds else None
    out = run_lr_sweep_experiment(
        args.config, lrs=lrs, wds=wds, seeds_per_lr=args.seeds_per_lr,
        synthetic_data=args.data_root is None, data_root=args.data_root,
        n_train=args.n_train, n_test=args.n_test, epochs=args.epochs,
        impl=args.impl, quiet=args.quiet,
        overrides=parse_overrides(args.set),
        checkpoint_dir=args.checkpoint_dir,
        transfer_dtype=args.transfer_dtype, device=args.device)
    print(json.dumps(out, indent=2))
    return out


def cmd_checkpoints(args):
    from .train.checkpoint import CheckpointStore

    def size(path):
        return os.path.getsize(path) if os.path.isfile(path) else 0

    store = CheckpointStore(args.checkpoint_dir)
    members = {}
    for name, e in sorted(store.manifest.items()):
        if not name.startswith(args.prefix):
            continue
        kinds = [k for k in ("params", "full") if k in e]
        resume = e.get("last") or e.get("last_prev")
        nbytes = sum(size(e[k]) for k in kinds)
        nbytes += sum(size(e[s]["path"]) for s in ("last", "last_prev")
                      if e.get(s))
        members[name] = {
            "valid_loss": e.get("valid_loss"),
            "best_epoch": e.get("epoch"),
            "kinds": kinds + (["resume"] if resume else []),
            "resume_epoch": resume["epoch"] if resume else None,
            "done": bool(e.get("done", False)),
            "imported": bool(e.get("imported", False)),
            "bytes": nbytes,
        }
    ranked = sorted((n for n in members if members[n]["valid_loss"] is not None),
                    key=lambda n: members[n]["valid_loss"])
    meta = os.path.join(args.checkpoint_dir, "run_meta.json")
    out = {"checkpoint_dir": args.checkpoint_dir, "members": members,
           "ranked_by_valid_loss": ranked,
           "total_bytes": sum(m["bytes"] for m in members.values()),
           "run_meta": meta if os.path.isfile(meta) else None}
    print(json.dumps(out, indent=2))
    return out


def cmd_check_data(args):
    from .data.validate import validate_tree

    report = validate_tree(args.config, args.data_root)
    print(json.dumps(report, indent=2))
    if not report["ok"]:
        raise SystemExit(1)
    return report


def cmd_configs():
    from . import configs

    for name in sorted(configs.REGISTRY):
        exp = configs.get(name)
        m, t = exp.model, exp.train
        print(f"{name}: dim={m.dim} heads={m.n_heads} layers={m.n_layers} "
              f"block={m.block} head={m.head} "
              f"lens=({m.l_len},{m.v_len},{m.a_len}) batch={t.batch_size} "
              f"lr={t.lr} folds={t.n_folds} E={m.n_emotions}")


def load_members(args, exp, device):
    """Serving members: the checkpoint store's best members, or without a
    store four seeded random ones (with a note on stderr)."""
    from .models import build_model

    if args.checkpoint_dir:
        from .pipelines import _restore_members
        from .train.checkpoint import CheckpointStore

        try:
            members, _ = _restore_members(
                args.config, exp, CheckpointStore(args.checkpoint_dir), device)
        except ValueError as e:
            raise SystemExit(str(e))
        print(f"({len(members)} trained members from {args.checkpoint_dir})",
              file=sys.stderr)
        return members
    print(f"(no --checkpoint-dir: {N_MEMBERS}-member seeded random ensemble)",
          file=sys.stderr)
    return [build_model(exp, device=device, seed=i) for i in range(N_MEMBERS)]


def resolve_offsets(args, exp):
    """Calibration offsets: `--thresholds` wins over the tuned thresholds a
    swept eval saved in the store (pipelines.save_tuned_thresholds), which
    win over the config's table."""
    if getattr(args, "thresholds", None):
        return tuple(float(t) for t in args.thresholds.split(","))
    if args.checkpoint_dir:
        from .pipelines import load_tuned_thresholds

        t = load_tuned_thresholds(args.checkpoint_dir, args.config, exp)
        if t is not None:
            print(f"(using tuned thresholds from "
                  f"{args.checkpoint_dir}/thresholds.json)", file=sys.stderr)
            return tuple(t)
    return exp.thresholds


def cmd_serve(args):
    from . import configs
    from .data.synthetic import synthetic_dataset
    from .serve import BatchingServer, StreamingPredictor
    from .utils.device import resolve_device

    exp = configs.with_overrides(configs.get(args.config),
                                 parse_overrides(args.set))
    device = resolve_device(args.device)
    impl = args.impl or exp.model.attn_impl
    members = load_members(args, exp, device)
    print(f"({len(members)}-member ensemble on {device}, impl={impl}, "
          f"dtype={exp.train.compute_dtype})", file=sys.stderr)
    offsets = resolve_offsets(args, exp)
    names = exp.emotion_names[: len(offsets)]

    if exp.model.head == "state_transfer":
        return _serve_paragraph(args, exp, members, offsets, impl)
    if args.http_port is not None:
        return _serve_http(args, exp, members, offsets, impl, names)
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


def _serve_http(args, exp, members, offsets, impl, names):
    """The micro-batching server over HTTP until Ctrl-C (JAX
    cli.py:579-602); its buckets are captured before the port opens."""
    from .data.synthetic import synthetic_dataset
    from .serve import BatchingServer, HttpFrontend

    sample = synthetic_dataset(args.config, exp.model, 1, seed=7)[0]
    spec = {k: v.shape for k, v in sample.items() if k != "label"}
    with BatchingServer(members, offsets, impl=impl,
                        max_delay_ms=args.max_delay_ms,
                        dtype=exp.train.compute_dtype) as srv:
        srv.warmup(sample)
        fe = HttpFrontend(srv, spec, names, host=args.http_host,
                          port=args.http_port)
        print(f"serving {args.config} ({len(members)}-member ensemble) on "
              f"http://{fe.host}:{fe.port}; GET /spec for the feature "
              "contract; Ctrl-C stops", file=sys.stderr, flush=True)
        try:
            fe.serve_forever()
        finally:
            fe.close()
    return fe


def cmd_export(args):
    """Write the serving computation of the store's best members (or four
    seeded ones) as one torch.export artifact (JAX cli.py:651-671)."""
    from . import configs
    from .data.synthetic import synthetic_dataset
    from .serve import export_predictor
    from .utils.device import resolve_device

    exp = configs.with_overrides(configs.get(args.config),
                                 parse_overrides(args.set))
    device = resolve_device(args.device)
    members = load_members(args, exp, device)
    sample = synthetic_dataset(args.config, exp.model, 1, seed=0)[0]
    blob = export_predictor(members, resolve_offsets(args, exp), sample,
                            batch_size=args.batch,
                            dtype=exp.train.compute_dtype, device=device)
    with open(args.out, "wb") as f:
        f.write(blob)
    print(f"wrote {args.out} ({len(blob)} bytes, device={device}, "
          f"batch={args.batch}, {len(members)}-member ensemble, impl=xla)")
    return blob


def _serve_paragraph(args, exp, members, offsets, impl):
    """Stream one synthetic paragraph clip by clip (JAX cli.py:544-577)."""
    from .data.synthetic import synthetic_dataset
    from .serve import ParagraphStreamingPredictor

    if args.concurrent > 0 or args.http_port is not None:
        raise SystemExit(
            "state_transfer configs stream clip-by-clip with carried "
            "recurrence state; --http-port/--concurrent serve stateless "
            "per-sample heads")
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
    if args.cmd == "eval":
        return cmd_train(args, eval_only=True)
    if args.cmd == "sweep":
        return cmd_sweep(args)
    if args.cmd == "predict":
        return cmd_predict(args)
    if args.cmd == "checkpoints":
        return cmd_checkpoints(args)
    if args.cmd == "configs":
        return cmd_configs()
    if args.cmd == "check-data":
        return cmd_check_data(args)
    if args.cmd == "serve":
        return cmd_serve(args)
    if args.cmd == "export":
        return cmd_export(args)
    raise SystemExit(f"unknown command {args.cmd!r}")
