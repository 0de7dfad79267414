"""One-command real-corpus acceptance flow (eval/acceptance.py of the JAX
package).

A reference user holding the real corpora and the reference's trained `.pt`
checkpoints runs one command to produce the parity evidence:

    python -m multimodal_emotion_processing_tpu_torch acceptance mosei_trans \
        --data-root /data/mosei --checkpoint-dir ./ck \
        --torch-ckpts model_1_2.18.pt model_2_2.20.pt model_3_2.22.pt \
                      model_4_2.17.pt -o acceptance.json

Steps, each one an existing front door, chained:
  1. validate the corpus tree (data/validate.py, the `check-data` command);
  2. import the reference `.pt` files as checkpoint-store members
     (interop/torch_compat.load_reference_checkpoint, the `import-torch`
     command), or use a trained store as it is;
  3. ensemble-evaluate on the real test split with the reference's decision
     protocol (pipelines.run_experiment(epochs=0): the family's ensemble,
     per-emotion thresholds and the reference's metrics, the numbers
     cmu-mosei/run.py:456-513 prints);
  4. robot_demo only: the golden-demo calibrated probabilities
     (sigmoid(logit − offset), robot_demo.py:609) of the requested clips
     through the port's StreamingPredictor (one captured program on the
     card), next to the output the reference records in comments
     (robot_demo.py:643-649).

The flow runs on the card unless `device="cpu"` is given, at the config's
attention implementation unless `impl` names another.  It is tested on
miniature layout-faithful corpora with torch-oracle checkpoints
(tests/test_torch_acceptance.py); the real numbers need the real
artifacts.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Sequence

# robot_demo.py:643-649: the reference's recorded demo output for its
# trained 4-model ensemble on its demo files (happy .74 / sad .85 / ...)
GOLDEN_DEMO_EXPECTED = {"happ": 0.74, "sadn": 0.85, "ange": 0.02,
                        "disg": 0.02, "surp": 0.02, "fear": 0.43}

# The reference's recorded per-fold best valid losses, the only trained-run
# numbers it keeps (in the checkpoint file names its eval blocks hard-code;
# the per-emotion acc/F1 are printed, never stored).  A --train-from-scratch
# run reports its own fold losses next to these.
REFERENCE_FOLD_LOSSES = {
    "mosei_trans": {"losses": [2.18, 2.20, 2.22, 2.17],
                    "source": "cmu-mosei/run.py:447-453 (model_{1..4}_*.pt)"},
    "rencecps": {"losses": [2.11, 2.12, 2.09, 2.09],
                 "source": "rencecps/run.py:245-251 (model_d{1..4}_*.pt)"},
    "ren_mme": {"losses": [2.47, 2.55, 2.52, 2.54],
                "source": "Ren-MME/run.py:455-535 (base_{1..4}_*.pt)"},
    "mosei_realformer": {"losses": [1.33, 1.37],
                         "source": "others/realformer.py:483-485 "
                                   "(model_{1,2}_*.pt)"},
    "robot_demo": {"losses": [1.31, 1.37, 1.39, 1.32],
                   "source": "robot_demo.py:584-590 (model_{1..4}_*.pt)"},
}


def import_torch_members(config_name: str, pt_paths: Sequence[str],
                         checkpoint_dir: str, *, overrides=None,
                         force: bool = False) -> List[str]:
    """`import-torch` as a library call: reference `.pt` state dicts become
    store members named {config}_{i} (i from 1, in argument order), each
    with the valid loss its file name carries (`..._2.18.pt`,
    cmu-mosei/run.py:446-453; 0.0 where it carries none), saved as
    imported parameters-only members.  Existing members are refused
    unless `force`."""
    from .. import configs
    from ..interop.torch_compat import load_reference_checkpoint
    from ..train.checkpoint import CheckpointStore

    exp = configs.with_overrides(configs.get(config_name), overrides)
    store = CheckpointStore(checkpoint_dir)
    names = [f"{config_name}_{i + 1}" for i in range(len(pt_paths))]
    clobbered = [n for n in names if n in store.manifest]
    if clobbered and not force:
        raise ValueError(
            f"members already exist in {checkpoint_dir}: "
            f"{', '.join(clobbered)}; pass force=True / --force to overwrite")
    for name, path in zip(names, pt_paths):
        model = load_reference_checkpoint(path, exp.model)
        m = re.search(r"_(\d+\.\d+)\.pt$", path)
        store.save_params(name, model, valid_loss=float(m.group(1)) if m
                          else 0.0, imported=True)
    return names


def _golden_demo(exp, data_root: str, checkpoint_dir: str,
                 demo_clips: Optional[Sequence[str]], n_demo: int, *,
                 impl: str, device) -> Dict:
    """robot_demo: the calibrated serving probabilities of real clips, the
    numbers robot_demo.py:616-622 prints."""
    from ..models import build_model
    from ..pipelines import load_real_data
    from ..serve import StreamingPredictor
    from ..train.checkpoint import CheckpointStore

    store = CheckpointStore(checkpoint_dir)
    names = store.best_members(exp.name)
    if not names:
        raise ValueError(f"no '{exp.name}*' members in {checkpoint_dir}")
    members = [store.restore_params(n, build_model(exp, device=device))
               for n in names]
    samples, _, ctx = load_real_data(exp, data_root)
    by_name = {ctx["names"][int(s["name_idx"])]: s for s in samples}
    clips = list(demo_clips) if demo_clips else sorted(by_name)[:n_demo]
    missing = [c for c in clips if c not in by_name]
    if missing:
        raise ValueError(f"demo clips not in the corpus: {missing} "
                         f"(have e.g. {sorted(by_name)[:5]})")
    sp = StreamingPredictor(members, exp.thresholds, impl=impl,
                            dtype=exp.train.compute_dtype)
    return {
        "members": names,
        "clips": {c: sp.emotions(by_name[c], exp.emotion_names)
                  for c in clips},
        "reference_expected": GOLDEN_DEMO_EXPECTED,
        "note": ("reference_expected is robot_demo.py:643-649's recorded "
                 "output for its demo files under its trained ensemble: "
                 "comparable only when running those clips with the "
                 "imported reference checkpoints"),
    }


def run_acceptance(
    config_name: str,
    data_root: str,
    *,
    checkpoint_dir: str,
    torch_ckpts: Optional[Sequence[str]] = None,
    demo_clips: Optional[Sequence[str]] = None,
    n_demo: int = 2,
    overrides: Optional[Dict] = None,
    sweep_thresholds: bool = False,
    force: bool = False,
    quiet: bool = True,
    train_from_scratch: bool = False,
    epochs: Optional[int] = None,
    impl: Optional[str] = None,
    device=None,
) -> Dict:
    """The whole acceptance flow; returns the report (module docstring).
    `overrides` exists for fixture-scale tests: real runs use the
    reference's dimensions as they are.

    `train_from_scratch`: in place of imported checkpoints, the
    reference's own protocol end to end (k-fold training on the real tree
    with its fold carving, plateau LR and save guard, then its ensemble
    eval), reporting each fold's best valid loss next to the reference's
    recorded ones (REFERENCE_FOLD_LOSSES); `epochs` caps the training
    (smoke runs; None: the config's budget).  `impl` (default the
    config's) and `device` (default the card) are the evaluation's and the
    golden demo's."""
    from .. import configs
    from ..data.validate import validate_tree
    from ..utils.device import resolve_device

    if train_from_scratch and torch_ckpts:
        raise ValueError(
            "--train-from-scratch trains the ensemble itself; it cannot be "
            "combined with --torch-ckpts (pick one evidence path)")

    exp = configs.with_overrides(configs.get(config_name), overrides)
    impl = impl or exp.model.attn_impl
    device = resolve_device(device)
    report: Dict = {"config": config_name, "data_root": data_root,
                    "checkpoint_dir": checkpoint_dir}

    report["data_check"] = validate_tree(config_name, data_root)
    if not report["data_check"]["ok"]:
        report["ok"] = False
        return report

    if torch_ckpts:
        report["imported_members"] = import_torch_members(
            config_name, torch_ckpts, checkpoint_dir, overrides=overrides,
            force=force)

    robot = configs.family(config_name) == "robot_demo"

    def golden_demo():
        return _golden_demo(exp, data_root, checkpoint_dir, demo_clips,
                            n_demo, impl=impl, device=device)

    if train_from_scratch:
        from ..pipelines import run_experiment

        res = run_experiment(
            config_name, synthetic_data=False, data_root=data_root,
            checkpoint_dir=checkpoint_dir, epochs=epochs, quiet=quiet,
            overrides=overrides, sweep_thresholds=sweep_thresholds,
            impl=impl, device=device)
        report["trained"] = {
            "fold_best_valid_losses": [
                round(min(s.valid_loss for s in h), 4) if h else None
                for h in res.fold_histories],
            "epochs_ran": [len(h) for h in res.fold_histories],
            "reference_expected": REFERENCE_FOLD_LOSSES.get(
                configs.family(config_name)),
            "note": ("reference_expected are the reference's recorded best "
                     "valid losses (its checkpoint file names) for its run "
                     "on the full corpus: comparable only at the "
                     "reference's dims and epochs on the real tree"),
        }
        if res.report is not None:
            report["metrics"] = res.report
        if res.sweep is not None:
            report["sweep"] = {k: v for k, v in res.sweep.items()
                               if k != "joint"}
        if robot:
            # the trained members are in the store now: the robot family's
            # acceptance artifact is the golden demo on top of them
            report["golden_demo"] = golden_demo()
        report["ok"] = True
        return report

    if robot:
        # the robot corpus has no held-out test split (the reference trains
        # on all clips and demos on files, robot_demo.py:594-640): its
        # acceptance artifact is the golden demo
        report["golden_demo"] = golden_demo()
    else:
        from ..pipelines import run_experiment

        res = run_experiment(
            config_name, synthetic_data=False, data_root=data_root,
            checkpoint_dir=checkpoint_dir, epochs=0, quiet=quiet,
            overrides=overrides, sweep_thresholds=sweep_thresholds,
            impl=impl, device=device)
        report["metrics"] = res.report
        if res.sweep is not None:
            report["sweep"] = {k: v for k, v in res.sweep.items()
                               if k != "joint"}
    report["ok"] = True
    return report


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="multimodal_emotion_processing_tpu_torch acceptance",
        description="real-corpus acceptance flow (docs/REAL_DATA.md)")
    ap.add_argument("config")
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--checkpoint-dir", required=True,
                    help="store with trained members, or the import "
                         "destination when --torch-ckpts is given")
    ap.add_argument("--torch-ckpts", nargs="+", default=None,
                    help="reference .pt files to import as the ensemble")
    ap.add_argument("--train-from-scratch", action="store_true",
                    help="k-fold train on the real tree (the reference's "
                         "protocol) instead of importing checkpoints; reports "
                         "the folds' best valid losses next to the "
                         "reference's recorded ones")
    ap.add_argument("--epochs", type=int, default=None,
                    help="cap the training epochs (smoke runs); default: the "
                         "config's")
    ap.add_argument("--demo-clips", nargs="+", default=None,
                    help="robot_demo: clip names for the golden-demo block")
    ap.add_argument("--sweep-thresholds", action="store_true")
    ap.add_argument("--force", action="store_true",
                    help="overwrite existing imported members")
    ap.add_argument("--impl", choices=["xla", "flash", "pallas",
                                       "pallas_fused"], default=None,
                    help="attention implementation (default: the config's)")
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    ap.add_argument("--set", dest="set", action="append", default=[],
                    metavar="model.X=V|train.X=V",
                    help="config overrides (fixture-scale smoke runs; a real "
                         "acceptance run uses the reference's dims)")
    ap.add_argument("-o", "--out", default=None)
    args = ap.parse_args(argv)
    from ..cli import parse_overrides

    report = run_acceptance(
        args.config, args.data_root, checkpoint_dir=args.checkpoint_dir,
        torch_ckpts=args.torch_ckpts, demo_clips=args.demo_clips,
        overrides=parse_overrides(args.set) if args.set else None,
        sweep_thresholds=args.sweep_thresholds, force=args.force,
        quiet=False, train_from_scratch=args.train_from_scratch,
        epochs=args.epochs, impl=args.impl, device=args.device)
    line = json.dumps(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0 if report.get("ok") else 1
