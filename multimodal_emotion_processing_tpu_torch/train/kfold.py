"""k-fold bagging driver (train/kfold.py of the JAX package): the
reference's one-model-per-contiguous-fold scheme (cmu-mosei/run.py:422-444:
shuffle once, carve k fixed-size validation folds, train one model on the
complement of each; realformer uses 20 % folds, others/realformer.py:366-386).
The members train one after another.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, List, Optional, Sequence, Tuple

from . import engine, schedule
from .checkpoint import CheckpointStore


def contiguous_folds(n: int, k: int, fold_size: Optional[int] = None
                     ) -> List[Tuple[slice, List[range]]]:
    """Fold i validates on a contiguous slice and trains on the rest.

    With `fold_size` (the reference's explicit 4096/6720/744 carvings),
    fold i validates [i*size, (i+1)*size) when k folds of it fit in n.
    Otherwise the boundaries follow the realformer script's fractional
    carving `int(n * i/k)` (others/realformer.py:368-386): the LAST fold's
    validation runs to n, so the tail samples are validated, and folds can
    differ by one sample when k does not divide n."""
    if fold_size is not None and fold_size * k <= n:
        bounds = [i * fold_size for i in range(k + 1)]
    else:
        # int(n * (i/k)) reproduces the reference's int(n*0.2*i): i/k
        # rounds to the same double as its 0.2/0.4/... literals
        bounds = [int(n * (i / k)) for i in range(k)] + [n]
    out = []
    for i in range(k):
        lo, hi = bounds[i], bounds[i + 1]
        out.append((slice(lo, hi), [range(0, lo), range(hi, n)]))
    return out


def run_kfold(
    samples: Sequence,
    make_loaders: Callable,
    cfg,
    tcfg,
    *,
    store: Optional[CheckpointStore] = None,
    name_prefix: str = "model",
    fold_size: Optional[int] = None,
    epochs: Optional[int] = None,
    impl: str = "xla",
    shuffle_seed: int = 0,
    log_cb: Optional[Callable] = None,
    resume: bool = False,
    seeds_per_fold: int = 1,
    device=None,
    transfer_dtype=None,
    scan_steps: int = 1,
    accum_steps: int = 1,
    profile_dir: Optional[str] = None,
    mesh=None,
    tp: bool = False,
):
    """Train tcfg.n_folds * seeds_per_fold members of ModelConfig `cfg` (or
    an ExperimentConfig) on `device` ("cuda" unless "cpu" is asked for).
    `make_loaders(train_samples, valid_samples)` -> (train_loader,
    valid_loader), zero-arg callables; `log_cb(name, epoch, stats)`.

    Returns a list of (final TrainState, history) per member; the best
    checkpoints go to `store` under '{name_prefix}_{i+1}'.  Member i trains
    fold i % tcfg.n_folds from init seed tcfg.seed + i, so the first
    n_folds members are those of a seeds_per_fold=1 run and extra seeds
    only extend the bagged ensemble.

    With a store, every epoch also persists a resume point (the full train
    state and the plateau and early-stop schedule); `resume=True` restarts
    an interrupted run: finished members are skipped (their best
    checkpoints stay valid) and an interrupted one continues after its
    last finished epoch with parameters, optimizer, dropout generator, LR
    and counters restored.  The loaders' epoch order restarts from their
    own seed, so with shuffling off the resumed run equals the
    uninterrupted one bit for bit.  `transfer_dtype`, `scan_steps` and
    `accum_steps` are the Trainer's (engine.Trainer): the wire format,
    steps replayed back to back from one copy, gradient accumulation;
    so is `profile_dir` (each member's fit traces its first epoch after
    the captures), and so are `mesh` and `tp` (parallel/mesh.make_mesh:
    every rank trains every member on its rows; rank 0 alone writes the
    store, each checkpoint gathered whole)."""
    if seeds_per_fold < 1:
        raise ValueError(f"seeds_per_fold must be >= 1, got {seeds_per_fold}")
    samples = list(samples)
    random.Random(shuffle_seed).shuffle(samples)  # once, before carving
    current = {"name": None}

    def last_cb(state, epoch, plateau, stopper):
        store.save_last(current["name"], state, epoch, {
            "plateau": dataclasses.asdict(plateau),
            "stopper": dataclasses.asdict(stopper),
        })

    trainer = engine.Trainer(
        cfg, tcfg, impl=impl, device=device, transfer_dtype=transfer_dtype,
        scan_steps=scan_steps, accum_steps=accum_steps,
        profile_dir=profile_dir, mesh=mesh, tp=tp,
        checkpoint_cb=(lambda state, epoch, vl:
                       store.save_best(current["name"], state, epoch, vl))
        if store is not None else None,
        log_cb=(lambda e, s: log_cb(current["name"], e, s)) if log_cb else None)
    folds = contiguous_folds(len(samples), tcfg.n_folds, fold_size)
    n_epochs = tcfg.epochs if epochs is None else epochs
    results = []
    for i in range(tcfg.n_folds * seeds_per_fold):
        valid_sl, train_ranges = folds[i % tcfg.n_folds]
        name = f"{name_prefix}_{i + 1}"
        current["name"] = name
        if resume and store is not None and store.is_done(name):
            results.append((None, []))
            continue
        valid = samples[valid_sl]
        train = [samples[j] for r in train_ranges for j in r]
        train_loader, valid_loader = make_loaders(train, valid)
        state = None
        start_epoch = 0
        plateau = stopper = None
        if resume and store is not None:
            restored = store.restore_last(
                name, engine.init_state(trainer.cfg, tcfg, tcfg.seed + i,
                                        device=trainer.device))
            if restored is not None:
                state, entry = restored
                start_epoch = entry["epoch"] + 1
                sched = entry.get("schedule", {})
                if "plateau" in sched:
                    plateau = schedule.PlateauState(**sched["plateau"])
                if "stopper" in sched:
                    stopper = schedule.EarlyStop(**sched["stopper"])
        state, history = trainer.fit(
            train_loader, valid_loader, epochs=epochs, seed=tcfg.seed + i,
            state=state, start_epoch=start_epoch, plateau=plateau,
            stopper=stopper, last_cb=last_cb if store is not None else None)
        # an eval-only pass (epochs=0) must not mark the member trained: a
        # later resume would skip it and report partial checkpoints as done
        if store is not None and n_epochs > 0 and trainer.writer:
            store.mark_done(name)
        results.append((state, history))
    return results
