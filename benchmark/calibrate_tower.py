"""Readings that set `moonlight_trans.eval`'s limits, on the card, one
process for all seeds (the kernels build once).

    python3 benchmark/calibrate_tower.py --seeds 1,2,3 [--seconds S] [--faults N]

For each seed: set-up, a window of `--seconds`, and the numbers the run
compares (the program against the plain reference); for the first
`--faults` seeds also the control (the reference with the routed
experts' inputs rounded to fp8 e4m3 and the members' products in TF32,
in the program's place) and each fault of drivers/tower_eval.FAULTS
planted in the reference, in the program's place.  Besides the compared
numbers, each reading gives the tokens' errors of the hidden states
(`tower_eval.row_errors`) at quantiles over all compared tokens, the
share of them above a few thresholds, and quantiles over the tokens that
chose as the reference did and over those that did not (`rows`).  One JSON line per seed
on standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") != os.path.dirname(
                            os.path.abspath(__file__))]


def _rows(prog, ref):
    import numpy as np

    from benchmark.drivers.tower_eval import flipped, row_errors

    out = prog["outputs"]
    e = np.concatenate([row_errors(h, r).numpy() for h, r in
                        zip(out["hidden"], ref["hidden"])])
    f = np.concatenate([flipped(c, r).numpy() for c, r in
                        zip(out["choices"], ref["choices"])])
    rows = {q: float(np.quantile(e, x)) for q, x in
            (("p50", 0.5), ("p90", 0.9), ("p99", 0.99), ("max", 1.0))}
    rows.update({f"over_{tau:g}": float((e > tau).mean())
                 for tau in (0.02, 0.05, 0.1)})
    if (~f).any():
        rows["agreed_p99"] = float(np.quantile(e[~f], 0.99))
    if f.any():
        rows["flipped_min"] = float(e[f].min())
        rows["flipped_p10"] = float(np.quantile(e[f], 0.1))
    return rows


def readings(cell, seed: int, seconds: float, faults: bool):
    import torch

    from benchmark.core import device as card
    from benchmark.core.harness import Context
    from benchmark.core.trace import Tracer

    card.set_float32(False)
    ctx = Context(cell, seed, "cuda")
    mod = cell.driver()
    program = mod.Cell(ctx)
    win = mod.window(program, seconds, Tracer("cuda", False, dict))
    prog = program.outputs()
    program.release()
    del program
    gc.collect()
    torch.cuda.empty_cache()
    ref = mod.reference(ctx, prog)
    out = {"rate": win.metrics, "program": mod.compare(prog, ref),
           "rows": {"program": _rows(prog, ref)},
           "lengths": [int(prog["inputs"]["arrays"]["n_tokens"][p])
                       for p in prog["inputs"]["pairs"]]}
    if not faults:
        return out
    ctl = mod.reference(ctx, prog, tf32=True)
    out["control"] = mod.compare({**prog, "outputs": ctl}, ref)
    out["rows"]["control"] = _rows({"outputs": ctl}, ref)
    for fault in mod.FAULTS:
        bad = mod.reference(ctx, prog, fault=fault)
        out[fault] = mod.compare({**prog, "outputs": bad}, ref)
        out["rows"][fault] = _rows({"outputs": bad}, ref)
    return out


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--faults", type=int, default=0,
                    help="the control and the faults for this many seeds")
    args = ap.parse_args(argv)

    from benchmark.core import device as card
    from benchmark.core import spec

    card.require_cards(1)
    cell = spec.Cell("moonlight_trans.eval")
    card.log(f"[calibrate {cell.name}] card: {card.power_line()}")
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = readings(cell, seed, args.seconds, i < args.faults)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "seconds": round(time.perf_counter() - t, 3),
                          **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
