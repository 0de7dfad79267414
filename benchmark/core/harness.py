"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With `--trace 0` the result's metrics are the cell's end-to-end metrics,
timed by the host's clock; with `--trace 1` its per-layer metrics, read
by `metrics/<name>.py` from the window's counts and from one traced
stretch inside it.  The last lines on standard error, and the result's
last key `checks`, give each number compared with the reference beside
its limit.  Without the CUDA cards the cell asks for, or with JAX or the
JAX package loaded once the window has closed, the run fails and prints
no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import sys
import time
from typing import Dict, Optional

import torch

from . import device as card
from . import port, spec
from .trace import Tracer, TraceSummary


@dataclasses.dataclass
class Window:
    """What a driver's measured window gives back: its end-to-end metrics
    by name (host clock, over the whole window), the wall and the work
    counted outside the traced stretch (the whole window when nothing is
    traced), which the per-layer readers divide, and the requests (or
    steps, or batches) attempted and failed."""
    metrics: Dict[str, float]
    wall_s: float
    work: Dict[str, float]
    attempted: int
    failed: int


@dataclasses.dataclass
class Record:
    """What a per-layer reader reads: the cell, its configuration, the
    window's counts, and the traced stretch (None when nothing was
    traced)."""
    cell: str
    model: object            # the port's ModelConfig as run
    config: dict             # the configuration file
    window_s: float
    work: Dict[str, float]
    trace: Optional[TraceSummary]


class Context:
    """A driver's view of the run: the cell's configuration and traffic,
    the seed, the device, and the benchmark-made weights."""

    def __init__(self, cell: spec.Cell, seed: int, device, overrides=None,
                 t0: Optional[float] = None):
        overrides = overrides or {}
        self.t0 = time.perf_counter() if t0 is None else t0
        self.cell = cell
        self.seed = int(seed)
        self.device = torch.device(device)
        doc = dict(cell.config)
        for section in ("model", "train"):
            doc[section] = {**doc[section], **overrides.get(section, {})}
        self.config = doc
        self.params = {**cell.traffic, **overrides.get("traffic", {})}
        self.exp = port.experiment(doc)
        self.m = self.exp.model
        self.impl = doc["impl"]
        self.dtype = doc["compute_dtype"]
        self.reference_model = doc["reference"]

    def mark(self, what: str) -> None:
        """Log how far set-up has come (seconds since the process began)."""
        card.log(f"[{self.cell.name}] set-up: {what} at "
                 f"{time.perf_counter() - self.t0:.3f} s")

    def seed_for(self, tag: str) -> int:
        return spec.sub_seed(self.seed, tag)

    def weights(self, tag: str) -> Dict[str, torch.Tensor]:
        from ..reference.models import param_shapes
        from ..reference.weights import make_weights

        return make_weights(param_shapes(self.reference_model, self.m),
                            self.seed_for("weights/" + tag), self.device)

    def member(self, tag: str):
        """(a port model holding the weights of `tag`, those weights)."""
        from multimodal_emotion_processing_tpu_torch.models import build_model

        w = self.weights(tag)
        model = build_model(self.exp, device=self.device, seed=0)
        port.load_weights(model, w)
        return model.eval(), w

    def reference_forward(self):
        """f(weights, batch) -> logits of the plain reference model."""
        from ..reference import models

        return lambda p, batch: models.forward(self.reference_model, p,
                                               self.m, batch)


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def run(cell: spec.Cell, *, seed: int, seconds: float, trace: bool, device,
        t0: float, overrides=None):
    """(result dict, check lines) of one run on `device`; `overrides`
    ({"model": {...}, "train": {...}, "traffic": {...}}) shrink a cell for
    the CPU tests."""
    dev = torch.device(device)
    tf32 = cell.config.get("tf32", {})
    if tf32.get("matmul") or tf32.get("cudnn"):
        raise ValueError("the configurations run float32 with TF32 off")
    card.set_float32(False)
    ctx = Context(cell, seed, dev, overrides, t0)
    ctx.mark("imports")
    if dev.type == "cuda":
        torch.empty(1, device=dev)          # the CUDA context
        torch.cuda.reset_peak_memory_stats(dev)
        ctx.mark("the card's context")
    tracer = Tracer(dev, trace, port.kernel_counters)
    mod = cell.driver()
    program = mod.Cell(ctx)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    # what set-up made lives to the end: the collector need not scan it
    # again in every full collection inside the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    card.log(f"[{cell.name}] set-up {setup_s:.3f} s; window {seconds} s, "
             f"seed {seed}, trace {int(trace)}")
    win: Window = mod.window(program, seconds, tracer)
    bad = port.forbidden_modules(sys.modules)
    if bad:
        raise port.NotInCheckout(f"modules the benchmark must not load are "
                                 f"loaded: {bad}")
    device_info = card.describe(dev, cell.chips)
    prog = program.outputs()
    program.release()
    del program
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = mod.reference(ctx, prog, tf32=False)
    values = mod.compare(prog, ref)
    checks = {k: {"value": float(v), "limit": float(cell.limits[k])}
              for k, v in values.items()}
    correct = (win.failed == 0 and bool(checks) and all(
        _finite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()))

    units = spec.metric_units(cell.end_to_end + cell.per_layer)
    metrics = {}
    if not trace:
        values = {**win.metrics, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        rec = Record(cell=cell.name, model=ctx.m, config=ctx.config,
                     window_s=win.wall_s, work=win.work, trace=tracer.summary)
        for m in cell.per_layer:
            v = cell.reader(m["name"]).read(rec)
            if v is None:
                card.log(f"[{cell.name}] {m['name']}: nothing to read")
                continue
            metrics[m["name"]] = {"value": float(v), "unit": units[m["name"]]}
    result = {"correct": correct, "attempted": int(win.attempted),
              "failed": int(win.failed), "metrics": metrics,
              "device": device_info}
    if trace and tracer.summary is not None:
        s = tracer.summary
        result["device"]["busy_s"] = s.busy_s
        result["device"]["window_s"] = s.window_s
        top = sorted(s.ops.items(), key=lambda kv: -kv[1][0])[:10]
        result["breakdown"] = {
            "device_ops": [[name, sec] for name, (sec, _) in top],
            "idle_gaps": [[name, sec] for name, sec in s.gaps]}
    result["checks"] = checks
    lines = [f"check {k} {c['value']!r} limit {c['limit']!r}"
             for k, c in checks.items()]
    return result, lines


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.Cell(args.workload)
    try:
        card.require_cards(cell.chips)
        port.import_port()
    except (card.NoCard, port.NotInCheckout) as e:
        card.log(f"benchmark: {e}")
        return 2
    card.log(f"[{cell.name}] card: {card.power_line()}; "
             f"{torch.cuda.device_count()} device(s), torch {torch.__version__}")
    try:
        result, lines = run(cell, seed=args.seed, seconds=args.seconds,
                            trace=bool(args.trace), device="cuda", t0=t0)
    except port.NotInCheckout as e:
        card.log(f"benchmark: {e}")
        return 2
    for line in lines:
        card.log(line)
    print(json.dumps(result), flush=True)
    return 0
