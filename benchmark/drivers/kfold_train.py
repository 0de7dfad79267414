"""Training driver: the port's k-fold bagged experiment, member after
member, each member one `Trainer.fit` fed from the host.

Set-up makes `n_folds x fold_size` seeded pairs on the device and copies
them to the host, shuffles them once and carves contiguous folds
(`train.kfold.contiguous_folds`), builds one `engine.Trainer` with a
`CheckpointStore` under `TMPDIR` wired as `train.kfold.run_kfold` wires it
(`save_best` from the checkpoint callback, `save_last` after every epoch),
and member 1's state from the benchmark's weights.  That state takes its
first `check_steps` optimizer steps in set-up, through the same Trainer's
captured step and host feed the window uses (a fit of one batch, then a
fit of the next batches with one valid batch, which also warms the eval
step), and the same state object then trains on in the window.  The
reference follows those first steps.

The window trains member after member, `epochs_per_member` epochs each:
the epoch at which the job's early stop (patience 9) ended a member on
this data, fixed, so every seed does the same work; the stop cannot fire
sooner.  Member i trains on fold i mod n_folds from seed + i, with the
loaders of `pipelines.run_experiment` (a shuffled train Batcher, an
ordered valid one).  The window ends at the first epoch end past
`--seconds`, from the fit's log callback.  `run_kfold` itself builds
every member's state inside, so the loop is spelled out here with its
parts.

End to end: `train_samples_per_s`, pairs trained in the window over its
wall, valid passes, checkpoint saves and member boundaries included.
"""

from __future__ import annotations

import random
import shutil
import tempfile
import time
from collections import Counter

import numpy as np
import torch

from ..core import port
from ..core.harness import Window
from ..reference import synthetic, training


class _Deadline(Exception):
    pass


class Cell:
    def __init__(self, ctx):
        from multimodal_emotion_processing_tpu_torch.data.loader import Batcher
        from multimodal_emotion_processing_tpu_torch.train import engine, kfold
        from multimodal_emotion_processing_tpu_torch.train.checkpoint import (
            CheckpointStore)

        self.ctx = ctx
        p, tcfg = ctx.params, ctx.exp.train
        self.epochs = int(p["epochs_per_member"])
        self.trace_epoch = int(p["trace_epoch"])
        n = tcfg.n_folds * tcfg.fold_size
        arrays = synthetic.mosei_pairs(ctx.m, n, ctx.seed_for("data"),
                                       ctx.device)
        samples = synthetic.as_samples(arrays, synthetic.MOSEI_KEYS)
        ctx.mark(f"{n} pairs made")
        random.Random(ctx.seed_for("shuffle")).shuffle(samples)
        self.samples = samples
        self.folds = kfold.contiguous_folds(n, tcfg.n_folds, tcfg.fold_size)
        self.loader_seed = ctx.seed_for("loader")
        self.Batcher = Batcher
        self.dir = tempfile.mkdtemp(prefix="bench-ckpt-")
        self.store = CheckpointStore(self.dir)
        self.current = {"name": None}
        self.check_losses = []
        self.armed = False
        self.log = None
        self.trainer = engine.Trainer(
            ctx.exp, tcfg, impl=ctx.impl, device=ctx.device,
            checkpoint_cb=self._save_best, log_cb=self._log)

        # member 1: its state from the benchmark's weights, its first steps
        self.weights = ctx.weights("member1")
        state = engine.init_state(ctx.exp.model, tcfg, tcfg.seed,
                                  device=ctx.device)
        port.load_weights(state.model, self.weights)
        train, valid = self._split(0)
        k, bs = int(p["check_steps"]), tcfg.batch_size
        self.check_batches = [list(Batcher(train[i * bs:(i + 1) * bs], bs,
                                           shuffle=False)())[0]
                              for i in range(k)]
        names = list(self.weights)
        params = dict(state.model.named_parameters())
        opt_index = {id(t): i for i, t in enumerate(state.optimizer.params)}
        self.fit(train[:bs], [], state)
        # Adam's first moment after one step is (1 - β1)·g, in float32
        c1 = float(np.float32(1.0 - training.B1))
        self.first_grad = {n: (state.optimizer.mu[opt_index[id(params[n])]]
                               / c1).cpu() for n in names}
        self.fit(train[bs:k * bs], valid[:bs], state)
        self.change = {n: (params[n].detach() - self.weights[n]).cpu()
                       for n in names}
        ctx.mark("member 1's first steps")
        self.state1 = state
        self.member1 = self._loaders(train, valid)
        self.valid_steps = -(-len(valid) // bs)
        self.store.save_last("warmup", state, 0, {})

    def _split(self, i):
        valid_sl, train_ranges = self.folds[i % len(self.folds)]
        return ([self.samples[j] for r in train_ranges for j in r],
                self.samples[valid_sl])

    def _loaders(self, train, valid):
        bs = self.ctx.exp.train.batch_size
        return (self.Batcher(train, bs, seed=self.loader_seed),
                self.Batcher(valid, bs, shuffle=False))

    def fit(self, train, valid, state):
        """A set-up fit of one epoch over these samples, in order."""
        bs = self.ctx.exp.train.batch_size
        _, hist = self.trainer.fit(
            self.Batcher(train, bs, shuffle=False),
            (self.Batcher(valid, bs, shuffle=False) if valid
             else (lambda: iter(()))), state=state, epochs=1)
        self.check_losses += list(hist[0].step_losses)

    def _save_best(self, state, epoch, valid_loss):
        if self.armed:
            self.store.save_best(self.current["name"], state, epoch, valid_loss)

    def _save_last(self, state, epoch, plateau, stopper):
        import dataclasses

        self.store.save_last(self.current["name"], state, epoch, {
            "plateau": dataclasses.asdict(plateau),
            "stopper": dataclasses.asdict(stopper)})

    def _log(self, epoch, stats):
        if self.log is not None:
            self.log(epoch, stats)

    def outputs(self):
        return {"inputs": {"weights": self.weights,
                           "batches": self.check_batches},
                "outputs": {"losses": self.check_losses,
                            "first_grad": self.first_grad,
                            "change": self.change}}

    def release(self):
        for name in ("trainer", "state1", "member1", "samples", "store"):
            setattr(self, name, None)
        shutil.rmtree(self.dir, ignore_errors=True)


def window(cell: Cell, seconds: float, tracer) -> Window:
    from ..core import device as card

    tcfg = cell.ctx.exp.train
    stats, member = [], {"i": 0}
    traced = []
    t_end = {}
    t0 = time.perf_counter()
    deadline = t0 + seconds
    last = [t0]

    def log(epoch, s):
        now = time.perf_counter()
        card.log(f"[train] member {member['i'] + 1} epoch {epoch + 1}: "
                 f"{s.steps} steps in {s.seconds:.4f} s, "
                 f"{now - last[0] - s.seconds:.4f} s outside since the last")
        last[0] = now
        stats.append(s)
        if tracer.active:
            # the stretch: the saves after epoch trace_epoch - 1, then
            # epoch trace_epoch, its train and valid steps, of member 1
            b = tcfg.batch_size
            tracer.stop({"forward": Counter({b: s.steps + cell.valid_steps}),
                         "backward": Counter({b: s.steps})})
            traced.append(s)
        now = time.perf_counter()
        if now - tracer.overhead_s >= deadline:
            t_end["t"] = now
            raise _Deadline
        if member["i"] == 0 and epoch == cell.trace_epoch - 1:
            tracer.start()

    cell.log = log
    cell.armed = True
    try:
        i = 0
        while True:
            member["i"] = i
            cell.current["name"] = f"member_{i + 1}"
            if i == 0:
                (train_loader, valid_loader), state = cell.member1, cell.state1
            else:
                train_loader, valid_loader = cell._loaders(*cell._split(i))
                state = None
            cell.trainer.fit(train_loader, valid_loader, state=state,
                             epochs=cell.epochs, seed=tcfg.seed + i,
                             last_cb=cell._save_last)
            i += 1
    except _Deadline:
        pass
    wall = t_end["t"] - t0 - tracer.overhead_s
    samples = sum(s.samples for s in stats)
    failed = sum(1 for s in stats for x in s.step_losses if not np.isfinite(x))
    # the per-layer readers divide the counts outside the traced stretch
    kept = [s for s in stats if not any(s is t for t in traced)]
    stretch = tracer.summary.window_s if traced else 0.0
    return Window(
        metrics={"train_samples_per_s": samples / wall},
        wall_s=wall - stretch,
        work={"samples": sum(s.samples for s in kept),
              "steps": sum(s.steps for s in kept), "epochs": len(kept),
              "members": member["i"] + 1,
              "epoch_seconds": sum(s.seconds for s in kept)},
        attempted=sum(s.steps for s in stats), failed=failed)


def reference(ctx, prog, *, tf32: bool = False, fault=None):
    """The reference's first steps from the same weights and batches:
    each step's loss, the clipped first gradient, the change after the
    last step.  `fault="half_batch"`: the loss over the first half of each
    batch only (a fault the comparison must catch)."""
    from ..core import device as card

    inputs = prog["inputs"]
    tcfg = ctx.exp.train
    batches = [{k: torch.as_tensor(np.asarray(v)).to(ctx.device)
                for k, v in b.items()} for b in inputs["batches"]]
    keep = tcfg.batch_size // 2 if fault == "half_batch" else None
    card.set_float32(tf32)
    try:
        losses, g1, change = training.train_steps(
            ctx.reference_forward(), inputs["weights"], batches, lr=tcfg.lr,
            clip=tcfg.grad_clip, weight_decay=tcfg.weight_decay,
            keep_rows=keep)
    finally:
        card.set_float32(False)
    return {"losses": losses, "first_grad": {k: v.cpu() for k, v in g1.items()},
            "change": {k: v.cpu() for k, v in change.items()}}


def _norms(d):
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def compare(prog, ref) -> dict:
    """loss_gap: the first step's |loss − ref| / |ref|.  grad_gap: the
    worst leaf's |‖g‖ − ‖g_ref‖| over max(‖g_ref‖, the median leaf's
    ‖g_ref‖), g the clipped first gradient.  change_worst and change_gap:
    the worst and the median leaf's |‖Δ‖ − ‖Δ_ref‖| over max(‖Δ_ref‖, the
    median leaf's ‖Δ_ref‖), Δ the change after the last step, over the
    leaves whose reference gradient is at least a thousandth of the
    median leaf's (a leaf with none, as a terminal block's score gate,
    moves by the decay alone).

    The worst leaf catches a leaf left unmoved or moved double; the
    median leaf is steady from seed to seed.  AdamW's first steps move
    each weight by about the learning rate whatever its gradient's size,
    so the kernels' rounding of gradients near zero moves a few leaves'
    later changes, and the later steps' losses, by far more than any
    step's own error on some seeds: the worst leaf's limit leaves room
    for that, and only the first step's loss is compared (PERF.md §2)."""
    out = prog["outputs"]
    loss_gap = abs(out["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    gp, gr = _norms(out["first_grad"]), _norms(ref["first_grad"])
    gmed = float(np.median(list(gr.values())))
    grad_gap = max(abs(gp[k] - gr[k]) / max(gr[k], gmed) for k in gr)
    cp, cr = _norms(out["change"]), _norms(ref["change"])
    moving = [k for k in cr if gr[k] >= 1e-3 * gmed]
    cmed = float(np.median([cr[k] for k in moving]))
    gaps = [abs(cp[k] - cr[k]) / max(cr[k], cmed) for k in moving]
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_worst": float(max(gaps)),
            "change_gap": float(np.median(gaps))}
