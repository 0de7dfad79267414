"""Ensemble evaluation driver: `eval.ensemble.Ensemble.predict_all` of the
configuration's members over a host `Batcher` of a seeded test split,
one pass after another, each pass's combined logits fetched to the host.

Set-up makes the split on the device and copies it to the host, builds
the members from the benchmark's weights and the Ensemble at the
configuration's impl, and runs one pass (it captures the batch shape's
program and stacks the Batcher).  The window runs passes until the first
pass end past `--seconds`; a `--trace 1` run traces its passes 2 to 4.

End to end: `eval_samples_per_s`, pairs scored over the window's wall.
The comparison takes `check_rows` (pass, row) positions drawn from the
seed over the window's passes and holds their logits against the plain
reference's mean of the members.
"""

from __future__ import annotations

import time
from collections import Counter

import numpy as np
import torch

from ..core.harness import Window
from ..reference import synthetic

# a --trace 1 run traces the window's passes 2 to 4
TRACED_PASSES = 3


class Cell:
    def __init__(self, ctx):
        from multimodal_emotion_processing_tpu_torch.data.loader import Batcher
        from multimodal_emotion_processing_tpu_torch.eval.ensemble import Ensemble

        self.ctx = ctx
        p = ctx.params
        n, bs = int(p["n_pairs"]), ctx.exp.train.batch_size
        self.arrays = synthetic.mosei_pairs(ctx.m, n, ctx.seed_for("data"),
                                            ctx.device)
        self.loader = Batcher(synthetic.as_samples(self.arrays,
                                                   synthetic.MOSEI_KEYS),
                              bs, shuffle=False)
        members, self.weights = [], []
        ctx.mark(f"{n} pairs made")
        for i in range(int(ctx.config["members"])):
            model, w = ctx.member(f"member{i + 1}")
            members.append(model)
            self.weights.append(w)
        self.ensemble = Ensemble(members, combine="mean", impl=ctx.impl,
                                 dtype=ctx.dtype)
        self.batches_per_pass = -(-n // bs)
        self.logits = []
        ctx.mark("members built")
        self.ensemble.predict_all(self.loader)

    def outputs(self):
        rng = np.random.default_rng(self.ctx.seed_for("check"))
        n_rows = len(self.logits[0])
        k = min(int(self.ctx.params["check_rows"]), n_rows * len(self.logits))
        picks = rng.choice(n_rows * len(self.logits), size=k, replace=False)
        passes, rows = np.divmod(picks, n_rows)
        got = np.stack([self.logits[p][r] for p, r in zip(passes, rows)])
        return {"inputs": {"weights": self.weights, "arrays": self.arrays,
                           "rows": rows},
                "outputs": {"logits": got}}

    def release(self):
        self.ensemble = self.loader = None


def window(cell: Cell, seconds: float, tracer) -> Window:
    bs = cell.ctx.exp.train.batch_size
    members = int(cell.ctx.config["members"])
    t0 = time.perf_counter()
    deadline = t0 + seconds
    traced = 0
    while True:
        if len(cell.logits) == 1:
            tracer.start()
        cell.logits.append(cell.ensemble.predict_all(cell.loader))
        if tracer.active:
            traced += len(cell.logits[-1])
        if len(cell.logits) == 1 + TRACED_PASSES:
            tracer.stop({"forward": Counter({bs: members * TRACED_PASSES
                                             * cell.batches_per_pass})})
        if time.perf_counter() - tracer.overhead_s >= deadline:
            break
    if tracer.active:       # a window too short for the traced passes
        n = len(cell.logits) - 1
        tracer.stop({"forward": Counter({bs: members * n
                                         * cell.batches_per_pass})})
    wall = time.perf_counter() - t0 - tracer.overhead_s
    scored = sum(len(x) for x in cell.logits)
    failed = int(sum((~np.isfinite(x)).any(axis=1).sum() for x in cell.logits))
    # the per-layer readers divide the counts outside the traced passes
    stretch = tracer.summary.window_s if tracer.summary else 0.0
    return Window(metrics={"eval_samples_per_s": scored / wall},
                  wall_s=wall - stretch,
                  work={"samples": scored - traced,
                        "forwards": (scored - traced) * members,
                        "passes": len(cell.logits), "members": members},
                  attempted=scored, failed=failed)


def reference(ctx, prog, *, tf32: bool = False, fault=None):
    """The members' mean logits of the plain reference on the compared
    rows, in blocks of 64."""
    from ..core import device as card

    inputs = prog["inputs"]
    rows = np.unique(inputs["rows"])
    fwd = ctx.reference_forward()
    out = {}
    card.set_float32(tf32)
    try:
        with torch.no_grad():
            for start in range(0, len(rows), 64):
                idx = rows[start:start + 64]
                batch = {k: torch.as_tensor(inputs["arrays"][k][idx]).to(ctx.device)
                         for k in synthetic.MOSEI_KEYS}
                lg = torch.stack([fwd(w, batch) for w in inputs["weights"]])
                for r, v in zip(idx, lg.mean(dim=0).cpu().numpy()):
                    out[int(r)] = v
    finally:
        card.set_float32(False)
    return {"logits": np.stack([out[int(r)] for r in inputs["rows"]])}


def compare(prog, ref) -> dict:
    """logit_err: the largest |logit − ref| over the compared rows, over
    max(1, the largest |ref|)."""
    got, want = prog["outputs"]["logits"], ref["logits"]
    return {"logit_err": float(np.abs(got - want).max()
                               / max(1.0, float(np.abs(want).max())))}
