"""The k-fold members in lockstep (train/vmap_kfold.py of the JAX package,
whose members ride a `vmap` axis).

The reference trains its 4-5 bagged models one after another
(cmu-mosei/run.py:422-444), and each is far too small to fill the card.
Here all k·S members (k folds, S seeds a fold) step together: one captured
CUDA graph per step holds every member's step in turn
(train/device_epochs.Lockstep; the port has no `vmap` over members, since
`torch.func.vmap` cannot trace the ctypes kernels), so a step of all
members is one replay, with semantics kept:

  * each member sees only its own fold's train and valid split
    (contiguous equal folds, so every member has the same step count);
  * each member's plateau LR and early stop run on its own valid losses;
  * a member that has stopped is masked: its parameters, moments, count,
    learning rate and controllers stay as they were (JAX's fold keeps
    riding its vmap instead; only its best mattered there), so its final
    state and its history are the sequential driver's; the run ends when
    every member has stopped.

Two feeds: host-fed (the folds' loaders, their batches copied into the
step's static buffers, `scan_steps` of them at a time) and device-resident
(one staged set, each member's rows gathered on the card through its own
index rows).  `run_kfold_fully_compiled` adds the on-device controllers of
device_epochs.fit_fully_compiled: every epoch launched without a host
round trip.

On a ('data', 'model') mesh (`mesh`, `tp`; parallel/mesh.make_mesh) every
rank runs every member, each member placed as the sequential driver places
one (`place_state`: replicated, or with `tp` sharded by `tp_param_spec`,
JAX's `_tp_place`).  A member's batch is its fold's global batch, of which
each rank computes its own rows (host-fed: `local_rows` of the loaders'
batches; device-resident: the staged set whole on every rank, each rank
gathering its slice, R-Drop's duplicate pairs kept whole on a rank), and
its loss and gradients, and its eval loss, are summed over 'data' inside
the step (one all-reduce of the flat gradient buffer a member a step,
`DataParallel.reduce`).  So every rank's plateau LR, early stop, `active`
mask and best parameters are the same, bit for bit.  Rank 0 alone writes
the store and logs; a tensor-parallel member is gathered whole first
(`WholeState`), and the best parameters come back whole on every rank.
On NCCL the steps stay captured, collectives inside; on gloo with CUDA
tensors they run eagerly.
"""

from __future__ import annotations

import dataclasses
import math
import random
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..utils.logging import profile_trace
from . import engine, schedule
from .checkpoint import CheckpointStore
from .device_epochs import (DeviceControl, EpochLauncher, Lockstep,
                            device_reads, epoch_permutation,
                            padded_eval_indices, shuffle_rows, stage_dataset)
from .engine import EpochStats, StepBuffer, chunks, set_learning_rate
from .kfold import contiguous_folds


def _whole(state, sd) -> dict:
    """A device copy of the state dict `sd` of `state`'s model, whole: a
    tensor-parallel member's shards gathered over 'model' (a collective:
    every rank of the axis calls it)."""
    if not state.spec or state.parallel is None:
        return {k: v.detach().clone() for k, v in sd.items()}
    from torch.distributed.tensor import Replicate

    from ..parallel.mesh import gather_tensor

    group = state.parallel.model_group
    return {k: gather_tensor(v.detach(), state.spec.get(k, Replicate()),
                             group).clone()
            for k, v in sd.items()}


def _params(state) -> dict:
    """A device copy of the member's state dict, whole."""
    return _whole(state, state.model.state_dict())


def _mark_done(store, name_prefix: str, m: int, n_epochs: int) -> None:
    """Every member recorded as finished, as the sequential driver records
    its members (an eval-only run marks none)."""
    if store is not None and n_epochs > 0:
        for i in range(m):
            store.mark_done(f"{name_prefix}_{i + 1}")


class _OnMesh:
    """What the lockstep does differently on a mesh: placing the members,
    this rank's rows, who writes the store, and whether the programs are
    captured.  Without a mesh every answer is the single device's."""

    def __init__(self, mesh, tp: bool, tcfg, name: str):
        from ..parallel.mesh import DATA, captured_on, is_rank0

        if tp and mesh is None:
            raise ValueError("tp=True requires a mesh with a 'model' axis")
        self.mesh, self.tp = mesh, tp
        self.part = (1, 0)
        self.writer = True
        self.captured = captured_on(mesh, name)
        if mesh is None:
            return
        n = mesh.shape[DATA]
        if tcfg.batch_size % n:
            raise ValueError(
                f"batch_size ({tcfg.batch_size}) must divide the data axis "
                f"({n}): each rank computes an equal share of every global "
                "batch, R-Drop's duplicate pairs whole")
        self.part = (n, mesh.index(DATA))
        self.writer = is_rank0()

    def place(self, states) -> None:
        if self.mesh is not None:
            from ..parallel.mesh import place_state

            for st in states:
                place_state(st, self.mesh, tp=self.tp)

    def saveable(self, state):
        """`state` as the store takes it: gathered whole under tp (every
        rank builds it: a collective)."""
        if self.tp:
            from ..parallel.mesh import WholeState

            return WholeState(state)
        return state


def _carve(samples, tcfg, fold_size, shuffle_seed, seeds_per_fold):
    """JAX's carving: one shuffle, contiguous folds of equal size."""
    if seeds_per_fold < 1:
        raise ValueError(f"seeds_per_fold must be >= 1, got {seeds_per_fold}")
    samples = list(samples)
    random.Random(shuffle_seed).shuffle(samples)
    folds = contiguous_folds(len(samples), tcfg.n_folds, fold_size)
    splits = [([samples[j] for r in tr for j in r], samples[va])
              for va, tr in folds]
    sizes = {(len(t), len(v)) for t, v in splits}
    if len(sizes) != 1:
        raise ValueError(f"fold sizes misaligned: {sizes}")
    return samples, folds, splits


def _index_rows(folds, m: int, k: int, device):
    """(train_idx (m, n_tr), valid ids (m, n_va) numpy): member i's rows
    are fold i % k's."""
    train_np = np.stack([np.concatenate([np.arange(r.start, r.stop)
                                         for r in tr])
                         for _, tr in folds]).astype(np.int64)[np.arange(m) % k]
    valid_np = np.stack([np.arange(va.start, va.stop)
                         for va, _ in folds]).astype(np.int64)[np.arange(m) % k]
    return torch.from_numpy(train_np).to(device), valid_np


def _host_feed(loader, device, wire, k: int, mesh=None):
    """One epoch of `loader` (zipped fold iterators of numpy batches) as
    lists of k device batch dicts, with the real samples of each fold
    counted from the host's sample weights; on a mesh each batch cut to
    this rank's rows (`local_rows`)."""
    from ..data.loader import cast_for_transfer, prefetch_to_device, to_device
    from ..parallel.mesh import local_rows

    counts = [0] * k

    def merged():
        for batches in loader:
            out = {}
            for f, b in enumerate(batches):
                w = b.get("sample_weight")
                counts[f] += (int(np.asarray(w).sum()) if w is not None
                              else int(b["label"].shape[0]))
                out.update({f"{f}/{key}": v for key, v in b.items()})
            yield out

    if device.type == "cuda":
        it = prefetch_to_device(merged(), device=device, size=2,
                                transfer_dtype=wire, mesh=mesh)
    else:
        it = (to_device(local_rows(cast_for_transfer(b, wire), mesh)
                        if mesh is not None else cast_for_transfer(b, wire),
                        device) for b in merged())

    def split(d):
        groups = [{} for _ in range(k)]
        for name, v in d.items():
            f, _, key = name.partition("/")
            groups[int(f)][key] = v
        return groups

    return (split(d) for d in it), counts


def run_kfold_vmapped(
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
    log_cb=None,
    scan_steps: int = 1,
    device_resident: bool = False,
    duplicate: bool = False,
    seeds_per_fold: int = 1,
    resume: bool = False,
    transfer_dtype=None,
    device=None,
    info: Optional[dict] = None,
    profile_dir: Optional[str] = None,
    mesh=None,
    tp: bool = False,
):
    """k·S members of ModelConfig `cfg` (or an ExperimentConfig) in
    lockstep on `device` ("cuda" unless "cpu" is asked for), with
    kfold.run_kfold's carving and checkpoint contract (best checkpoints
    '{name_prefix}_{i+1}').  Returns (member states, histories[m],
    best_params[m] (state dicts on the device), best_losses[m]), the bests
    captured at each member's own save or stop.

    `seeds_per_fold`: member i trains fold i % k from init seed tcfg.seed
    + i, so the first k members are a seeds_per_fold=1 run's; host-fed, a
    fold's seed replicas share its batch stream, device-resident each
    draws its own shuffle.

    `scan_steps`: host-fed, that many steps' batches are copied to the
    card together and their replays launched back to back (the same math
    as 1); device-resident mode ignores it (its steps read the card
    already).

    `device_resident`: the samples staged on the card once
    (device_epochs.stage_dataset, in `transfer_dtype`'s wire format, int8
    included), every member's shuffle drawn there
    (`epoch_permutation(shuffle_seed + 20903, epoch)`, one row a member),
    train epochs dropping the final partial batch, eval covering every
    sample through zero-weight rows; `make_loaders` is unused.
    `duplicate` repeats each row as the R-Drop loaders do (train and
    valid).

    `resume`: with a store, every epoch saves each member's resume point
    under its own name, in the sequential driver's format plus its stop
    flag, best loss and history (JAX keeps one stacked point; here the
    store reads the same whichever driver wrote it); resume=True continues
    every member from the newest epoch all of them saved, and a finished
    run trains nothing.  Device-resident, the epoch-keyed shuffles make the
    resumed run bit-equal to the uninterrupted one; host-fed loaders
    restart their own order (kfold.run_kfold's caveat).

    `transfer_dtype`: host-fed batches and the staged set travel in that
    wire format; int8 only device-resident (host-fed it would need
    per-fold scales; the sequential driver carries it).

    `info`, where given, receives the staging's seconds and bytes
    ("staging_s", "staged_bytes"; device-resident only).

    `profile_dir`: a torch.profiler trace (utils/logging.profile_trace) of
    every member's train and eval steps in the first epoch after the
    captures, counted from the run's start epoch (Trainer.fit's rule).

    `mesh` (parallel/mesh.make_mesh) and `tp`: the members on a ('data',
    'model') mesh (module docstring); the same math as one device.
    batch_size must divide the data axis; `tp=True` needs a mesh.  Every
    rank reads the store on resume; rank 0 alone writes it."""
    from ..data.loader import resolve_transfer_dtype
    from ..utils.device import resolve_device

    name = "run_kfold_vmapped"
    on = _OnMesh(mesh, tp, tcfg, name)
    wire = resolve_transfer_dtype(transfer_dtype)
    if wire == "int8" and not device_resident:
        raise ValueError(
            "int8 wire composes with the vmapped driver only in "
            "device_resident mode (per-sample staging scales); host-fed "
            "(k, B, ...) stacks would quantize per fold — use "
            "float16/bfloat16 here or the sequential driver for int8")
    k = tcfg.n_folds
    samples, folds, splits = _carve(samples, tcfg, fold_size, shuffle_seed,
                                    seeds_per_fold)
    m = k * seeds_per_fold
    dev = mesh.device if mesh is not None else resolve_device(device)
    states = [engine.init_state(cfg, tcfg, tcfg.seed + i, device=dev)
              for i in range(m)]
    bs = tcfg.batch_size
    rows = bs * (2 if duplicate else 1)
    if device_resident:
        data, _ = stage_dataset(samples, transfer_dtype=wire, device=dev,
                                info=info)
        train_idx, valid_np = _index_rows(folds, m, k, dev)
        n_tr = int(train_idx.shape[1])
        n_steps = n_tr // bs
        if n_steps == 0:
            raise ValueError(f"device_resident needs >= {bs} train samples "
                             f"per fold, have {n_tr}")
        ev_idx, ev_w = padded_eval_indices(valid_np, bs)
        n_ev = ev_idx.shape[1] // bs
        train_read, eval_read, rowids = device_reads(
            data, data, train_idx, torch.from_numpy(ev_idx).to(dev),
            torch.from_numpy(ev_w).to(dev), batch_size=bs,
            duplicate=duplicate, eval_duplicate=duplicate, part=on.part)
        loaders = None
    else:
        loaders = [make_loaders(t, v) for t, v in splits]

        def steps_of(loader, n):
            per = getattr(loader, "steps_per_epoch", None)
            return per() if per is not None else -(-n // bs)

        n_steps = steps_of(loaders[0][0], len(splits[0][0]))
        n_ev = steps_of(loaders[0][1], len(splits[0][1]))
        bufs = {}

        def host_read(kind):
            def read(_):
                b = bufs[kind].read()
                return [{key: v[i % k] for key, v in b.items()}
                        for i in range(m)]
            return read

        train_read, eval_read = host_read("train"), host_read("eval")

    plateaus = [schedule.PlateauState(lr=tcfg.lr, factor=tcfg.plateau_factor,
                                      patience=tcfg.plateau_patience)
                for _ in range(m)]
    stoppers = [schedule.EarlyStop(patience=tcfg.early_stop,
                                   save_guard=tcfg.save_guard)
                for _ in range(m)]
    stopped = [False] * m
    frozen = [None] * m   # a stopped member's dropout generator state
    histories: List[List[EpochStats]] = [[] for _ in range(m)]
    best_params: List = [None] * m
    best_losses: List[float] = [math.inf] * m
    n_epochs = tcfg.epochs if epochs is None else epochs
    names = [f"{name_prefix}_{i + 1}" for i in range(m)]
    start_epoch = 0
    if resume:
        if store is None:
            raise ValueError("resume=True requires a checkpoint store")
        if all(store.is_done(nm) for nm in names):
            # a finished run trains nothing, as the sequential driver's
            for i, nm in enumerate(names):
                best_params[i] = {key: v.to(dev) for key, v in
                                  store.restore_params(nm).items()}
                best_losses[i] = store.manifest[nm]["valid_loss"]
            return states, histories, best_params, best_losses
        have = [store.last_epochs(nm) for nm in names]
        if any(have):
            if not all(have):
                raise ValueError(
                    f"resume points for {sum(map(bool, have))} of this run's "
                    f"{m} members (n_folds x seeds_per_fold changed?)")
            # every member from the newest epoch they all have (a cut
            # between two members' saves leaves them one epoch apart)
            epoch = max(set.intersection(*(set(h) for h in have)),
                        default=None)
            if epoch is None:
                raise ValueError(f"the members' resume points share no "
                                 f"epoch: {have}")
            for i, nm in enumerate(names):
                _, entry = store.restore_last(nm, states[i], epoch=epoch)
                sched = entry["schedule"]
                if sched.get("members") != m:
                    raise ValueError(
                        f"resume point {nm!r} is of a run with "
                        f"{sched.get('members')} members, this run has {m} "
                        "(n_folds x seeds_per_fold changed?)")
                plateaus[i] = schedule.PlateauState(**sched["plateau"])
                stoppers[i] = schedule.EarlyStop(**sched["stopper"])
                stopped[i] = sched["stopped"]
                best_losses[i] = sched["best_loss"]
                histories[i] = [EpochStats(**e) for e in sched["history"]]
                if "params" in store.manifest.get(nm, {}):
                    best_params[i] = {key: v.to(dev) for key, v in
                                      store.restore_params(nm).items()}
                if stopped[i]:
                    frozen[i] = states[i].generator.get_state()
            start_epoch = epoch + 1
    # restored whole, then placed (a resumed tp member is sharded anew)
    on.place(states)
    ls = Lockstep(cfg, tcfg, states, impl=impl, device=dev,
                  train_read=train_read, eval_read=eval_read,
                  n_steps=n_steps, n_eval=n_ev, name=name,
                  captured=on.captured)
    for i in range(m):
        if stopped[i]:
            ls.set_active(i, False)
    # rank 0 alone writes and logs; every rank gathers a tp member whole
    writes = store if on.writer else None
    if not on.writer:
        log_cb = None

    def save_resume_points(epoch):
        """Each member's resume point under its own name, in the sequential
        driver's format (its plateau and stopper), with what the lockstep
        adds: whether it stopped, its best loss, its history (wall times
        and step losses kept out of the manifest) and the member count."""
        for i, nm in enumerate(names):
            gen = states[i].generator
            current = gen.get_state()
            if frozen[i] is not None:   # a stopped member's own generator
                gen.set_state(frozen[i])
            whole = on.saveable(states[i])
            gen.set_state(current)
            if writes is None:
                continue
            writes.save_last(nm, whole, epoch, {
                "plateau": dataclasses.asdict(plateaus[i]),
                "stopper": dataclasses.asdict(stoppers[i]),
                "stopped": stopped[i], "best_loss": float(best_losses[i]),
                "history": [{**dataclasses.asdict(e), "step_losses": ()}
                            for e in histories[i]],
                "members": m})

    def run_epoch(epoch):
        """Launch one epoch of every member's train and eval steps; their
        per-member means, sample counts, step losses and the wall."""
        t0 = time.perf_counter()
        if device_resident:
            perms = epoch_permutation(shuffle_seed + 20903, epoch, n_tr, dev,
                                      members=m)
            shuffle_rows(rowids, train_idx, perms, duplicate)
            ls.train(n_steps)
            ls.evaluate(n_ev)
            tr_m, va_m = (x.cpu().tolist() for x in ls.means())
            counts = [n_steps * rows] * k
            step_losses = ls.train_losses[:, :n_steps].cpu().tolist()
        else:
            ls.t.zero_()
            ls.j.zero_()
            for kind, idx, run in (("train", 0, ls.steps),
                                   ("eval", 1, ls.eval_batches)):
                feed, fold_counts = _host_feed(
                    zip(*[pair[idx]() for pair in loaders]), dev, wire, k,
                    mesh)
                if kind == "train":
                    counts = fold_counts
                for group in chunks(feed, scan_steps):
                    if kind not in bufs:
                        bufs[kind] = StepBuffer(group[0][0], scan_steps, k,
                                                dev)
                    bufs[kind].load(group)
                    run(len(group))
            step_losses = ls.train_losses[:, :n_steps].cpu().tolist()
            va_rows = ls.eval_losses[:, :n_ev].cpu().tolist()
            # the sequential Trainer's epoch means: Python sums of the
            # per-batch losses
            tr_m = [sum(r) / max(len(r), 1) for r in step_losses]
            va_m = [sum(r) / max(len(r), 1) for r in va_rows]
        return tr_m, va_m, counts, step_losses, time.perf_counter() - t0

    profile_epoch = (start_epoch + 1 if n_epochs - start_epoch > 1
                     else start_epoch)
    for epoch in range(start_epoch, n_epochs):
        if all(stopped):
            break
        with profile_trace(profile_dir if epoch == profile_epoch else None,
                           name="lockstep"):
            tr_m, va_m, counts, step_losses, dt = run_epoch(epoch)
        ls.sync_steps()
        for i in range(m):
            if stopped[i]:
                continue
            stats = EpochStats(tr_m[i], va_m[i], n_steps, counts[i % k], dt,
                               step_losses=tuple(step_losses[i]))
            histories[i].append(stats)
            if log_cb:
                log_cb(f"{name_prefix}_{i + 1}", epoch, stats)
            set_learning_rate(states[i], plateaus[i].step(va_m[i]))
            save, stop = stoppers[i].step(va_m[i])
            if save:
                best_params[i] = _params(states[i])
                best_losses[i] = va_m[i]
                if store is not None:
                    whole = on.saveable(states[i])
                    if writes is not None:
                        writes.save_best(f"{name_prefix}_{i + 1}", whole,
                                         epoch, va_m[i])
            if stop:
                stopped[i] = True
                ls.set_active(i, False)
                frozen[i] = ls.generator_states()[i]
                if best_params[i] is None:
                    # the guard never passed: the stop-time parameters
                    best_params[i] = _params(states[i])
                    best_losses[i] = va_m[i]
        if store is not None:
            save_resume_points(epoch)
    ls.restore_generators(frozen)
    # members that ran out of epochs without a save: their final states
    for i in range(m):
        if best_params[i] is None:
            best_params[i] = _params(states[i])
            best_losses[i] = (histories[i][-1].valid_loss if histories[i]
                              else math.inf)
    _mark_done(writes, name_prefix, m, n_epochs)
    return states, histories, best_params, best_losses


def run_kfold_fully_compiled(
    samples: Sequence,
    cfg,
    tcfg,
    *,
    fold_size: Optional[int] = None,
    epochs: Optional[int] = None,
    impl: str = "xla",
    shuffle_seed: int = 0,
    duplicate: bool = False,
    store: Optional[CheckpointStore] = None,
    name_prefix: str = "model",
    log_cb=None,
    seeds_per_fold: int = 1,
    transfer_dtype=None,
    device=None,
    info: Optional[dict] = None,
    profile_dir: Optional[str] = None,
    mesh=None,
    tp: bool = False,
):
    """Every fold and every epoch launched without a host round trip: the
    device-resident lockstep of `run_kfold_vmapped` with the per-member
    controllers on the device (device_epochs.DeviceControl: plateau LR,
    early stop with the save guard's quirk, the best parameters kept on
    the card: saved at a save, at the stop where the guard never passed,
    the final ones where a member ran out of epochs without a save), the
    epochs launched by device_epochs.EpochLauncher until every member has
    stopped.  The same math, shuffles and controller trajectory as
    run_kfold_vmapped(device_resident=True).  `store` members are saved
    parameters-only at the end (the ensemble's path); only guard-passed
    saves become members.  Returns what run_kfold_vmapped returns; a
    member's history holds its own epochs (up to its stop).  `info`, where
    given, receives the staging's seconds and bytes, the epochs launched
    and the masked ones, which ran after every member had stopped and
    changed nothing ("staging_s", "staged_bytes", "epochs_launched",
    "masked_epochs").  `profile_dir`: one torch.profiler trace of the
    whole run, from the first launch to the controllers' final read (the
    run has no epoch boundary to pick one at).

    `mesh` and `tp`: as run_kfold_vmapped's.  Every rank launches the same
    epochs (`EpochLauncher(deterministic=True)`: the controllers read the
    reduced losses, and the stop is read from synchronised flags only);
    the best parameters come back whole, and rank 0 alone saves them."""
    from ..utils.device import resolve_device

    name = "run_kfold_fully_compiled"
    on = _OnMesh(mesh, tp, tcfg, name)
    k = tcfg.n_folds
    samples, folds, _ = _carve(samples, tcfg, fold_size, shuffle_seed,
                               seeds_per_fold)
    m = k * seeds_per_fold
    dev = mesh.device if mesh is not None else resolve_device(device)
    bs = tcfg.batch_size
    rows = bs * (2 if duplicate else 1)
    data, _ = stage_dataset(samples, transfer_dtype=transfer_dtype,
                            device=dev, info=info)
    train_idx, valid_np = _index_rows(folds, m, k, dev)
    n_tr = int(train_idx.shape[1])
    n_steps = n_tr // bs
    if n_steps == 0:
        raise ValueError(f"fully-compiled k-fold needs >= {bs} train "
                         f"samples per fold, have {n_tr}")
    ev_idx, ev_w = padded_eval_indices(valid_np, bs)
    n_ev = ev_idx.shape[1] // bs
    train_read, eval_read, rowids = device_reads(
        data, data, train_idx, torch.from_numpy(ev_idx).to(dev),
        torch.from_numpy(ev_w).to(dev), batch_size=bs, duplicate=duplicate,
        eval_duplicate=duplicate, part=on.part)
    n_epochs = tcfg.epochs if epochs is None else epochs
    states = [engine.init_state(cfg, tcfg, tcfg.seed + i, device=dev)
              for i in range(m)]
    on.place(states)
    ls = Lockstep(cfg, tcfg, states, impl=impl, device=dev,
                  train_read=train_read, eval_read=eval_read,
                  n_steps=n_steps, n_eval=n_ev, name=name,
                  captured=on.captured)
    control = DeviceControl(ls, tcfg, [tcfg.lr] * m, n_epochs)
    launcher = EpochLauncher(control, n_epochs,
                             deterministic=mesh is not None)
    t0 = time.perf_counter()
    with profile_trace(profile_dir, name="one_dispatch"):
        for epoch in range(n_epochs):
            if not launcher.go(epoch):
                break
            perms = epoch_permutation(shuffle_seed + 20903, epoch, n_tr, dev,
                                      members=m)
            shuffle_rows(rowids, train_idx, perms, duplicate)
            ls.train(n_steps)
            ls.evaluate(n_ev)
            control.step(epoch)
            launcher.record(epoch)
        res = control.finish()
    dt = time.perf_counter() - t0
    control.freeze_generators(res, launcher.generators)
    launcher.report(info)
    active = res["hist_active"]
    n_live = int(active.any(axis=1).sum())
    histories: List[List[EpochStats]] = [[] for _ in range(m)]
    for e in range(n_live):
        for i in range(m):
            if not active[e, i]:
                continue
            stats = EpochStats(float(res["hist_tr"][e, i]),
                               float(res["hist_va"][e, i]), n_steps,
                               n_steps * rows, dt / max(n_live, 1))
            histories[i].append(stats)
            if log_cb and on.writer:
                log_cb(f"{name_prefix}_{i + 1}", e, stats)
    has_best = res["saved_any"] | res["stopped"]
    best_params, best_losses = [], []
    for i in range(m):
        if has_best[i]:
            best_params.append(control.best[i] if mesh is None
                               else _whole(states[i], control.best[i]))
            best_losses.append(float(res["best_loss"][i]))
        else:   # out of epochs without a save: the final parameters
            best_params.append(_params(states[i]))
            best_losses.append(float(res["last_va"][i]) if n_live
                               else math.inf)
        # only guard-passed saves become store members; the stop-time and
        # final fallbacks ride the return value only
        if store is not None and on.writer and res["saved_any"][i]:
            store.save_params(f"{name_prefix}_{i + 1}", best_params[i],
                              valid_loss=best_losses[i],
                              epoch=int(res["best_epoch"][i]), imported=False)
    _mark_done(store if on.writer else None, name_prefix, m, n_epochs)
    return states, histories, best_params, best_losses


__all__ = ["run_kfold_vmapped", "run_kfold_fully_compiled"]
