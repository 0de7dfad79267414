"""Readings that set a cell's correctness limits and its fixed rate, on
the card, in one process (set-up is long, so the seeds share it where
they can).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds S]
        [--control] [--faults] [--rates R1,R2,...]

For each seed: set-up, a window of `--seconds`, and the numbers the run
compares (the program against the plain reference).  `--control` adds
the control: the reference itself in the program's place, computed with
TF32 on, the nearest precision below the configuration's float32.
`--faults` adds the faults planted in the reference that a training cell
must catch (half of each batch left out, the mean over the rest).
`--rates` (the open-loop cell) sweeps the offered rate after one set-up:
each rate's window, answered share, tail and backlog.  One JSON line per
reading on standard output.
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


def readings(cell, seed: int, seconds: float, *, control: bool, faults: bool):
    """{"program": {...}, "control": {...}, "half_batch": {...}} of one
    seed: each the compared numbers against the f32 reference."""
    import torch

    from benchmark.core import device as card
    from benchmark.core.harness import Context
    from benchmark.core.trace import Tracer

    card.set_float32(False)
    ctx = Context(cell, seed, "cuda")
    mod = cell.driver()
    program = mod.Cell(ctx)
    mod.window(program, seconds, Tracer("cuda", False, dict))
    prog = program.outputs()
    program.release()
    del program
    gc.collect()
    torch.cuda.empty_cache()
    ref = mod.reference(ctx, prog, tf32=False)
    out = {"program": mod.compare(prog, ref)}
    if control:
        ctl = mod.reference(ctx, prog, tf32=True)
        out["control"] = mod.compare({**prog, "outputs": ctl}, ref)
    if faults:
        bad = mod.reference(ctx, prog, tf32=False, fault="half_batch")
        out["half_batch"] = mod.compare({**prog, "outputs": bad}, ref)
    return out


def sweep(cell, seed: int, seconds: float, rates):
    """One set-up, then a window at each offered rate."""
    from benchmark.core import device as card
    from benchmark.core.harness import Context
    from benchmark.core.trace import Tracer

    card.set_float32(False)
    ctx = Context(cell, seed, "cuda")
    mod = cell.driver()
    program = mod.Cell(ctx)
    for rate in rates:
        win = mod.window(program, seconds, Tracer("cuda", False, dict),
                         rate=rate)
        print(json.dumps({"rate": rate, **win.metrics, **win.work,
                          "attempted": win.attempted, "failed": win.failed}),
              flush=True)
    program.release()


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--rates", default="")
    args = ap.parse_args(argv)

    from benchmark.core import device as card
    from benchmark.core import spec

    card.require_cards(1)
    cell = spec.Cell(args.workload)
    card.log(f"[calibrate {cell.name}] card: {card.power_line()}")
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.rates:
        sweep(cell, seeds[0], args.seconds,
              [float(r) for r in args.rates.split(",")])
        return 0
    for seed in seeds:
        t = time.perf_counter()
        out = readings(cell, seed, args.seconds, control=args.control,
                       faults=args.faults)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "seconds": round(time.perf_counter() - t, 3),
                          **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
