"""Command line of the PyTorch port.

  train <config>  k-fold bagged training and ensemble evaluation of one
        reference script on synthetic data, or on the corpus tree at
        --data-root R (pipelines.run_experiment):
        [--checkpoint-dir D] [--log-dir L] [--resume] [--sweep-thresholds]
        [--seeds-per-fold S] [--epochs E] [--n-train N] [--n-test M]
        [--impl xla|flash|pallas|pallas_fused|cp] [--set K=V] [--device cpu]
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
        [--device-resident] [--stacked-grid]: every sample's ensemble
        logits, calibrated probabilities and decisions to a file
        (pipelines.run_predict).
  check-data <config> --data-root R   what the corpus tree lacks for the
        config, as one JSON document (data/validate.py); exit 1 on any
        problem.
  checkpoints <dir> [--prefix P]  the store's members, losses, best
        epochs, resume points and bytes.
  configs   the registered configs.
  serve [<config>] [--checkpoint-dir D] [--concurrent N] [--device cpu]
        [--impl ...] [--thresholds T1,T2,...] [--stacked-grid]
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
        float32; serve/http_api.py) until Ctrl-C.  --stacked-grid (on
        predict too) builds the served programs on the stacked RealFormer
        grid (models/grid.py; impl xla, RealFormer blocks; ignored
        elsewhere).
  export [<config>] [--checkpoint-dir D] [--set K=V] [--out F]
        [--batch B] [--device cpu]   the ensemble's serving computation at
        impl=xla, weights included, as one torch.export artifact
        (serve/export.py) for one device and one batch size.
  import-torch <config> A.pt B.pt ... --checkpoint-dir D [--force]
        [--set K=V]   reference `.pt` state dicts (cmu-mosei/run.py:446-453) into the
        store as members <config>_1, _2, ... with the valid loss their
        file names carry; then `eval`, `serve`, `predict` and `export`
        use them.
  export-torch <config> --checkpoint-dir D [--out DIR] [--set K=V]   each
        best member written as a reference `.pt` state dict,
        `<name>_<loss>.pt`.
  acceptance <config> --data-root R --checkpoint-dir D [--torch-ckpts
        ...] [--train-from-scratch] [--impl ...] [--device cpu] [-o F]
        the real-corpus acceptance flow (eval/acceptance.py): check-data,
        import, the reference's evaluation or the robot golden demo.
  summary <config> [--set K=V] [--depth N]   per-module parameter counts,
        the total and the analytic FLOPs a sample (bench/flops.py).
  doctor [--json-only]   the card's launch floor, host-to-device
        bandwidth, matmul rates and sync honesty (bench/doctor.py).
  tune <config> [-o F] [--arms scan,stacked,transfer,remat,impl]
        [--allow-lossy] [--steps N] [--reps R]   this card's winners of
        the performance knobs (bench/autotune.py), which train, eval,
        predict and serve apply with --tuned F.
  bench [--budget-s S] [--scan-ks K1,K2] [--set K=V]   the flagship's
        train + infer samples/s on the card against the plain path on the
        CPU, one JSON line (bench/flagship.py, JAX's bench.py); the
        latency, serving, breakdown, scaling and all_configs entry points
        run as `python -m multimodal_emotion_processing_tpu_torch.bench.
        <module>`.

Every command's positional config may also be a `.json` file: overrides
({"config": name, "model": {...}, "train": {...}}) or a run's
run_meta.json, replayed field for field (configs.load_config_file);
explicit --set pairs win over the file.  `train` and `eval` take
--profile-dir DIR (a torch.profiler trace of the first epoch after the
captures) and --debug-nans (fail on the first non-finite value, naming
the module; the steps then run eagerly).

Several devices: `train` and `eval` take --dp N and --tp M (with any
driver: --device-resident and --one-dispatch too), `predict` --dp N, one
process per device under `torchrun --nproc-per-node N*M -m
multimodal_emotion_processing_tpu_torch ...` (parallel/mesh.py; a
--dp x --tp that is not the world's rank count fails with that line);
rank 0 alone prints and writes.  `--impl cp` (train, eval, sweep, predict,
serve) shards the attention's sequence over every rank
(ops/context_parallel.py; one rank without torchrun).

Every command runs on the GPU unless `--device cpu` is given; import-torch
and export-torch convert files on the host.  JAX's --compile-cache has no
counterpart: the port compiles no programs, and its kernels are cached in
`_build/` by the hash of their sources.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

N_MEMBERS = 4
IMPLS = ["xla", "flash", "pallas", "pallas_fused", "cp"]
TORCHRUN = "torchrun --nproc-per-node {n} -m multimodal_emotion_processing_tpu_torch"


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

    def config(sp, **kw):
        sp.add_argument("config", help="config name (see `configs`), or a "
                        ".json file ({'config': name, 'model'/'train': "
                        "overrides}, or a run's run_meta.json)", **kw)

    def tuned(sp):
        sp.add_argument("--tuned", default=None, metavar="TUNED_JSON",
                        help="apply the winners a `tune` run measured; "
                             "explicit flags win over the file")

    def stacked_grid(sp):
        sp.add_argument("--stacked-grid", action="store_true",
                        help="the stacked RealFormer grid in the inference "
                             "program: each target's three streams as "
                             "batched products, unequal lengths padded to "
                             "the longest (impl xla, RealFormer blocks; "
                             "ignored elsewhere)")

    def common(sp):
        config(sp)
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
        sp.add_argument("--profile-dir", default=None, metavar="DIR",
                        help="write a torch.profiler trace (Chrome/Perfetto) "
                             "of the first epoch after the captures into DIR "
                             "(one-dispatch runs trace their whole run)")
        sp.add_argument("--debug-nans", action="store_true",
                        help="fail on the first NaN or inf, naming the module "
                             "(forward) or the autograd function (backward); "
                             "the steps then run eagerly")
        sp.add_argument("--dp", type=int, default=None,
                        help="data-parallel over N mesh devices: batches "
                             "sharded on the 'data' axis, gradients "
                             "all-reduced (identical math to single-device); "
                             "one process per device, under " +
                             TORCHRUN.format(n="N"))
        sp.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel width on the 'model' mesh axis "
                             "(head-sharded attention; demonstrative at "
                             "these model sizes); composes with --dp, "
                             "--device-resident and --one-dispatch")
        tuned(sp)
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
    config(sw)
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
    config(pd)
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
    pd.add_argument("--dp", type=int, default=None, metavar="N",
                    help="shard batch inference over N devices on a mesh "
                         "'data' axis (members replicate; logits identical "
                         "to single-device)")
    stacked_grid(pd)
    transfer(pd)
    tuned(pd)
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
    config(cd)
    cd.add_argument("--data-root", required=True)

    sv = sub.add_parser("serve", help="ensemble serving on synthetic requests")
    config(sv, nargs="?", default="robot_demo")
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
    stacked_grid(sv)
    tuned(sv)
    overrides(sv)
    device(sv)

    ex = sub.add_parser(
        "export", help="export the serving computation (ensemble and "
                       "calibrated sigmoid, weights included) as one "
                       "torch.export artifact")
    config(ex, nargs="?", default="robot_demo")
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

    it = sub.add_parser(
        "import-torch",
        help="reference .pt checkpoints (torch state dicts, the files "
             "cmu-mosei/run.py:446-453 reloads by name) into the checkpoint "
             "store; then eval/serve/predict/export use them")
    config(it)
    it.add_argument("pt", nargs="+", help=".pt files, one ensemble member "
                    "each (member order = argument order)")
    it.add_argument("--checkpoint-dir", required=True)
    it.add_argument("--force", action="store_true",
                    help="overwrite members that already exist in the store")
    overrides(it)

    et = sub.add_parser(
        "export-torch",
        help="write each best member as a reference-format torch state dict "
             "(.pt) that the reference's scripts load")
    config(et)
    et.add_argument("--checkpoint-dir", required=True)
    et.add_argument("--out", default=".", help="output directory")
    overrides(et)

    ac = sub.add_parser(
        "acceptance",
        help="real-corpus acceptance flow: validate the tree, optionally "
             "import reference .pt checkpoints, then the reference's "
             "evaluation or the golden demo (docs/REAL_DATA.md)",
        add_help=False)
    ac.add_argument("rest", nargs=argparse.REMAINDER)

    sm = sub.add_parser(
        "summary", help="per-module parameter counts, the total and the "
                        "analytic FLOPs a sample")
    config(sm)
    overrides(sm)
    sm.add_argument("--depth", type=int, default=2,
                    help="dotted name depth to group parameters by")
    device(sm)

    dr = sub.add_parser(
        "doctor", help="environment diagnostics: launch floor, H2D "
                       "bandwidth, matmul rates, sync honesty (one JSON "
                       "line on stdout)")
    dr.add_argument("--json-only", action="store_true")
    dr.add_argument("--scan-k", type=int, default=64)
    device(dr)

    tn = sub.add_parser(
        "tune", help="measure this card's winners for the selectable "
                     "performance knobs and write a record that train, "
                     "eval, predict and serve apply with --tuned")
    config(tn)
    tn.add_argument("-o", "--out", default=None,
                    help="write the tuned record here (also printed)")
    tn.add_argument("--allow-lossy", action="store_true",
                    help="also tune knobs that change numerics (the int8 "
                         "and float16 wires)")
    tn.add_argument("--arms", default=None, metavar="A,B,...",
                    help="subset of scan,stacked,transfer,remat,impl")
    tn.add_argument("--steps", type=int, default=20)
    tn.add_argument("--reps", type=int, default=4)
    device(tn)

    from .bench.flagship import add_options

    bn = sub.add_parser(
        "bench", help="flagship train+infer samples/s on the card against "
                      "the plain path on the CPU (one JSON line; "
                      "bench/flagship.py)")
    add_options(bn)
    overrides(bn)
    device(bn)
    return p


def apply_config_file(args) -> None:
    """If the positional `config` is a `.json` file, resolve it
    (configs.load_config_file): the registered name replaces args.config
    and the file's model/train overrides go before args.set, so explicit
    --set pairs still win (parse_overrides applies them last).  `train
    run_meta.json` reproduces a recorded run's config (JAX cli.py:373-406)."""
    name = getattr(args, "config", None)
    if not (isinstance(name, str) and name.endswith(".json")):
        return
    if not os.path.exists(name):
        raise SystemExit(f"config file {name!r} does not exist")
    from . import configs

    try:
        cfg_name, file_overrides = configs.load_config_file(name)
    except ValueError as e:
        raise SystemExit(str(e))
    if cfg_name is None:
        raise SystemExit(
            f"{name} names no base config; add a top-level "
            "\"config\": \"<registry name>\" key")
    pairs = [f"{sec}.{k}={json.dumps(v)}"
             for sec in ("model", "train")
             for k, v in file_overrides.get(sec, {}).items()]
    if pairs and not hasattr(args, "set"):
        raise SystemExit(
            f"`{args.cmd}` takes no config overrides; {name} carries "
            f"{len(pairs)}: pass the bare config name instead")
    args.config = cfg_name
    if hasattr(args, "set"):
        args.set = pairs + list(args.set)


def check_world(args) -> None:
    """--dp x --tp must be the world's rank count (torchrun's WORLD_SIZE,
    1 without it): anything else fails here, with the launch line."""
    dp, tp = getattr(args, "dp", None), getattr(args, "tp", 1)
    if dp is None and tp == 1:
        return
    if (dp is not None and dp < 1) or tp < 1:
        raise SystemExit(f"--dp ({dp}) and --tp ({tp}) must be >= 1")
    world = int(os.environ.get("WORLD_SIZE", 1))
    n = (dp if dp is not None else world // tp) * tp
    if n != world or n == 0:
        raise SystemExit(
            f"--dp {dp} x --tp {tp} needs {max(n, tp)} ranks, but this world "
            f"has {world}: launch it as `{TORCHRUN.format(n=max(n, tp))} "
            f"{args.cmd} ...` (one process per device)")


def writes() -> bool:
    """Only rank 0 (torchrun's RANK) prints reports and results."""
    return int(os.environ.get("RANK", 0)) == 0


def cmd_train(args, eval_only: bool = False):
    from .pipelines import run_experiment

    check_world(args)
    if eval_only and not args.checkpoint_dir:
        raise SystemExit(
            "eval requires --checkpoint-dir (otherwise there are no trained "
            "members to ensemble; run `train` first)")
    if args.debug_nans:
        from .utils.logging import enable_nan_debugging

        enable_nan_debugging(True)
        try:
            return _train(args, eval_only, run_experiment)
        finally:
            enable_nan_debugging(False)
    return _train(args, eval_only, run_experiment)


def _train(args, eval_only, run_experiment):
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
        accum_steps=args.accum_steps, profile_dir=args.profile_dir,
        dp=args.dp, tp=args.tp)
    if not writes():
        return result
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
    check_world(args)
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
        device_resident=args.device_resident, dp=args.dp,
        stacked=args.stacked_grid)
    if not writes():
        return table
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
    if writes():
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
    from .ops.context_parallel import ensure_cp

    # --impl cp: a psum-mode context over every rank (one without torchrun)
    with ensure_cp(args.impl or "xla", device=args.device):
        return _serve(args)


def _serve(args):
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
                            dtype=exp.train.compute_dtype,
                            stacked_grid=args.stacked_grid) as srv:
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
                            dtype=exp.train.compute_dtype,
                            stacked_grid=args.stacked_grid)
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
                        dtype=exp.train.compute_dtype,
                        stacked_grid=args.stacked_grid) as srv:
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


def cmd_import_torch(args):
    """The reference user's migration path: their loss-tagged .pt files
    (cmu-mosei/run.py:446-453) become store members that eval, serve,
    predict and export use, with no retraining."""
    from .eval.acceptance import import_torch_members

    try:
        names = import_torch_members(args.config, args.pt,
                                     args.checkpoint_dir, force=args.force,
                                     overrides=parse_overrides(args.set))
    except ValueError as e:
        raise SystemExit(str(e))
    from .train.checkpoint import CheckpointStore

    manifest = CheckpointStore(args.checkpoint_dir).manifest
    for path, name in zip(args.pt, names):
        print(f"imported {path} -> {name} "
              f"(valid_loss={manifest[name]['valid_loss']})")
    print(f"{len(names)} member(s) in {args.checkpoint_dir}; use them via "
          f"`eval|serve|predict|export {args.config} --checkpoint-dir "
          f"{args.checkpoint_dir}`")
    return names


def cmd_export_torch(args):
    """Each best member as a reference `.pt` state dict named by the
    reference's convention, `{name}_{str(valid_loss)[:4]}.pt`
    (cmu-mosei/run.py:415)."""
    import torch

    from . import configs
    from .interop.torch_compat import to_reference_state_dict
    from .models import build_model
    from .train.checkpoint import CheckpointStore

    exp = configs.with_overrides(configs.get(args.config),
                                 parse_overrides(args.set))
    store = CheckpointStore(args.checkpoint_dir)
    names = store.best_members(args.config)
    if not names:
        raise SystemExit(f"no '{args.config}*' members in {args.checkpoint_dir}")
    os.makedirs(args.out, exist_ok=True)
    paths = []
    for name in names:
        model = store.restore_params(name, build_model(exp, device="cpu"))
        sd = to_reference_state_dict(model)
        loss = store.manifest[name].get("valid_loss", 0.0)
        path = os.path.join(args.out, f"{name}_{str(loss)[:4]}.pt")
        torch.save(sd, path)
        print(f"wrote {path} ({len(sd)} tensors)")
        paths.append(path)
    return paths


def cmd_summary(args):
    from . import configs
    from .bench import flops
    from .models import build_model
    from .utils import parameter_breakdown, parameter_count

    exp = configs.with_overrides(configs.get(args.config),
                                 parse_overrides(args.set))
    model = build_model(exp, device=args.device)
    out = {
        "config": args.config,
        "parameters": parameter_breakdown(model, depth=args.depth),
        "total": parameter_count(model)["Total"],
        "flops_per_sample": {
            "forward": flops.forward_flops_per_sample(exp.model),
            "train_step": flops.train_flops_per_sample(exp.model),
        },
    }
    print(json.dumps(out, indent=2))
    return out


def cmd_tune(args):
    from .bench.autotune import tune

    rec = tune(args.config, arms=args.arms.split(",") if args.arms else None,
               allow_lossy=args.allow_lossy, steps=args.steps, reps=args.reps,
               device=args.device, quiet=False)
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return rec


def cmd_bench(args):
    from .bench.flagship import run, scan_ks

    out = run(device=args.device, sets=args.set, budget_s=args.budget_s,
              scan_ks=scan_ks(args.scan_ks))
    print(json.dumps(out), flush=True)
    return out


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
                                     dtype=exp.train.compute_dtype,
                                     stacked_grid=args.stacked_grid)
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
    apply_config_file(args)
    if getattr(args, "tuned", None):
        from .bench.autotune import apply_tuned

        applied = apply_tuned(args, args.tuned)
        if applied and not getattr(args, "quiet", False):
            print(f"(tuned knobs applied: {applied})", file=sys.stderr)
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
    if args.cmd == "import-torch":
        return cmd_import_torch(args)
    if args.cmd == "export-torch":
        return cmd_export_torch(args)
    if args.cmd == "acceptance":
        from .eval.acceptance import main as acceptance_main

        raise SystemExit(acceptance_main(args.rest))
    if args.cmd == "summary":
        return cmd_summary(args)
    if args.cmd == "doctor":
        from .bench.doctor import main as doctor_main

        argv = ["--scan-k", str(args.scan_k)]
        if args.json_only:
            argv.append("--json-only")
        if args.device:
            argv += ["--device", args.device]
        return doctor_main(argv)
    if args.cmd == "tune":
        return cmd_tune(args)
    if args.cmd == "bench":
        return cmd_bench(args)
    raise SystemExit(f"unknown command {args.cmd!r}")
