"""Cost of the learning-rate sweep against one run per learning rate.

    python -m multimodal_emotion_processing_tpu_torch.bench.sweep_cost
        [--config C] [--lrs ...] [--epochs E] [--n N] [--device cpu]

An A/B on the same split and epochs, each side once:
  A = train/sweep.run_lr_sweep(lrs): every candidate in lockstep, one
      captured step of all candidates per replay;
  B = the sum of train/device_epochs.fit_fully_compiled, one run per
      learning rate (the strongest one-at-a-time baseline: each run
      already replays captured steps with its controllers on the device).

Both sides include their captures (the user's cost of trying k learning
rates) and end with a fetch of their results.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="mosei_trans")
    ap.add_argument("--lrs", default="1e-3,5e-4,2e-4,1e-4")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--n", type=int, default=512,
                    help="synthetic samples (pairs for mosei_trans); 1/8 "
                         "of the flattened samples validate")
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    from .. import configs
    from ..data.synthetic import synthetic_dataset
    from ..train.device_epochs import fit_fully_compiled
    from ..train.sweep import run_lr_sweep

    lrs = [float(x) for x in args.lrs.split(",")]
    exp = configs.get(args.config)
    samples = synthetic_dataset(args.config, exp.model, n=args.n, seed=0)
    flat = [s for u in samples for s in (u if isinstance(u, list) else [u])]
    n_va = max(len(flat) // 8, exp.train.batch_size)
    valid, train = flat[:n_va], flat[n_va:]
    dup = exp.train.rdrop_kl

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    log(f"[{args.config}] {len(train)} train / {len(valid)} valid, "
        f"{len(lrs)} lrs x {args.epochs} epochs")
    t0 = time.perf_counter()
    res = run_lr_sweep(train, valid, exp, exp.train, lrs=lrs,
                       epochs=args.epochs, duplicate=dup, device=args.device)
    t_sweep = time.perf_counter() - t0   # run_lr_sweep fetches its results
    log(f"sweep (lockstep, captures included): {t_sweep:.1f}s; winner "
        f"lr={res.members[res.winner].lr:g}")
    t_seq = 0.0
    seq_best = []
    for lr in lrs:
        tcfg = dataclasses.replace(exp.train, lr=lr)
        t0 = time.perf_counter()
        _, _, _, _, best_loss = fit_fully_compiled(
            exp, tcfg, train, valid, epochs=args.epochs, duplicate=dup,
            device=args.device)
        t_seq += time.perf_counter() - t0
        seq_best.append(best_loss)
        log(f"one run lr={lr:g}: cumulative {t_seq:.1f}s "
            f"(best {best_loss:.4f})")
    print(json.dumps({
        "config": args.config, "lrs": lrs, "epochs": args.epochs,
        "train": len(train), "valid": len(valid),
        "sweep_s": t_sweep, "sequential_s": t_seq,
        "speedup": t_seq / t_sweep,
        "sweep_best": [m.best_valid_loss for m in res.members],
        "sequential_best": seq_best}))


if __name__ == "__main__":
    main()
