"""Device-resident epochs (train/device_epochs.py of the JAX package): stage
the whole dataset on the card once, gather every batch there, and run each
step as one replay of a captured CUDA graph.

The reference re-ships every batch host to device every step
(cmu-mosei/run.py:361-363), and the port's host-fed Trainer pays the
batch's gather, pinning and copy plus every kernel's launch on the host;
on the card its training idles most of the time.  Here the dataset moves
once (`stage_dataset`: struct-of-arrays, optionally in a wire format),
each epoch draws its shuffle on the device (`epoch_permutation`), and a
step gathers its rows from the staged arrays through a device-side step
index (`gather_rows`), so a replay needs no input from the host.

Members step in lockstep (`Lockstep`): one captured train program per
step holds every member's step in turn (the port has no `vmap`: the
ctypes kernels cannot be traced by `torch.func.vmap`), each masked by its
member's `active` flag (engine.Optimizer.step), so a stopped member's
state stays as it was.  `fit_device_resident` and `fit_fully_compiled`
are the one-member drivers; train/vmap_kfold.py and train/sweep.py run k
folds or the sweep's candidates the same way.

Semantics against train/engine.Trainer:
  * the step, the dropout stream, the loss and R-Drop's adjacent
    duplicates are the same (`engine.member_step`);
  * the shuffle is `epoch_permutation` (`torch.randperm` from an explicit
    generator seeded by (key seed, epoch)) rather than the Batcher's numpy
    one: the same distribution, other draws, as JAX's device path draws
    `jax.random.permutation`;
  * train epochs drop the final partial batch (static shapes); eval covers
    every sample through zero-weight rows, and an epoch's losses are the
    f32 means of its per-batch losses, as JAX's are.

`fit_fully_compiled` runs the host's plateau and early-stop controllers on
the device (`controller_step`, `DeviceControl`) and launches every epoch
without waiting for the last: the host learns that the member has stopped
from a non-blocking copy of its flag into pinned memory and stops
launching; an epoch already in flight then changes nothing, as JAX's
`lax.cond` skip does.

On a mesh (train/vmap_kfold.py with `mesh=`) each member's state is placed
by parallel/mesh.place_state, so its step and eval loss are summed over
'data' inside the programs (`member_step`, `eval_loss(parallel=)`); the
staged set is whole on every rank and each rank gathers its own rows of
every global batch (`device_reads(part=)`).  The controllers then read the
same reduced losses on every rank.  On NCCL the collectives sit inside the
captured programs; gloo drives its collectives from the host, so with CUDA
tensors the programs run eagerly (`Lockstep(captured=False)`).
`EpochLauncher(deterministic=True)` decides from synchronised flags only,
so that every rank launches the same epochs.
"""

from __future__ import annotations

import math
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..serve.graphs import GraphedFunction
from . import engine, schedule
from .engine import EpochStats, eval_loss, member_step, set_learning_rate


def epoch_permutation(key_seed: int, epoch: int, n: int, device,
                      members: Optional[int] = None) -> torch.Tensor:
    """The shuffle of one epoch on `device`: a random permutation of n from an
    explicit generator seeded from numpy's SeedSequence((key_seed,
    epoch)); with `members`, a (members, n) stack of that many draws in
    turn.  The one place the device drivers shuffle: fit_device_resident
    and fit_fully_compiled key it by seed + 777, the k-fold drivers by
    shuffle_seed + 20903, the sweep by seed + s + 777 for its seed s
    (JAX's keys)."""
    device = torch.device(device)
    gseed = int(np.random.SeedSequence((key_seed, epoch)).generate_state(1)[0])
    g = torch.Generator(device=device).manual_seed(gseed)
    if members is None:
        return torch.randperm(n, generator=g, device=device)
    return torch.stack([torch.randperm(n, generator=g, device=device)
                        for _ in range(members)])


def stage_dataset(samples, *, pad_to_multiple: Optional[int] = None,
                  transfer_dtype=None, device=None,
                  info: Optional[dict] = None):
    """Stack the samples struct-of-arrays and copy them to `device` ("cuda"
    unless "cpu" is asked for) once.  With `pad_to_multiple`, zero rows and
    a `sample_weight` vector are appended so unshuffled slicing covers
    every sample in static-shape batches (the weighted loss ignores the
    padding, as data/loader.Batcher's padded final batch).
    `transfer_dtype` ("float16", "bfloat16" or "int8") stages the f32
    leaves in that wire format (data/loader.cast_for_transfer): half the
    bytes, or under int8 a quarter of the features' with per-sample
    '<key>__wire_scale' vectors that ride through `gather_rows` like any
    leaf; the steps restore f32 (engine.upcast_wire).  `info`, where
    given, adds the staging's seconds and bytes to its "staging_s" and
    "staged_bytes".  Returns (data dict of device tensors, n_real)."""
    from ..data.loader import cast_for_transfer, resolve_transfer_dtype
    from ..utils.device import resolve_device

    t0 = time.perf_counter()
    samples = list(samples)
    if not samples:
        raise ValueError("empty sample list")
    soa = {k: np.stack([np.asarray(s[k]) for s in samples])
           for k in samples[0]}
    n = len(samples)
    if pad_to_multiple:
        m = -(-n // pad_to_multiple) * pad_to_multiple
        if m != n:
            soa = {k: np.concatenate(
                [v, np.zeros((m - n,) + v.shape[1:], v.dtype)])
                for k, v in soa.items()}
        w = np.zeros(m, np.float32)
        w[:n] = 1.0
        soa["sample_weight"] = w
    soa = cast_for_transfer(soa, resolve_transfer_dtype(transfer_dtype))
    dev = resolve_device(device)
    data = {k: (v if torch.is_tensor(v) else torch.from_numpy(v)).to(dev)
            for k, v in soa.items()}
    if info is not None:
        info["staging_s"] = (info.get("staging_s", 0.0)
                             + time.perf_counter() - t0)
        info["staged_bytes"] = info.get("staged_bytes", 0) + staged_bytes(data)
    return data, n


def staged_bytes(data) -> int:
    return sum(v.numel() * v.element_size() for v in data.values())


def gather_rows(data, idx: torch.Tensor):
    """The device gather: `idx` (..., rows) row ids into a staged dict ->
    a batch dict whose leaves carry idx's leading axes."""
    flat = idx.reshape(-1)
    return {k: v.index_select(0, flat).reshape(tuple(idx.shape)
                                               + tuple(v.shape[1:]))
            for k, v in data.items()}


def padded_eval_indices(idx: np.ndarray, bs: int):
    """Pad per-member eval index rows (k, n) to a batch-size multiple with
    row-0 ids carrying weight 0 (the weighted loss ignores them, as
    data/loader.Batcher's padded final batch).  Returns (ev_idx int64,
    ev_w float32)."""
    k, n = idx.shape
    m = -(-n // bs) * bs
    ev_idx = np.concatenate([idx, np.zeros((k, m - n), np.int64)],
                            axis=1).astype(np.int64)
    ev_w = np.concatenate([np.ones((k, n), np.float32),
                           np.zeros((k, m - n), np.float32)], axis=1)
    return ev_idx, ev_w


class Lockstep:
    """m members (TrainStates) stepped together.  One captured train
    program holds every member's step in turn and one eval program every
    member's eval loss of a batch (serve/graphs.GraphedFunction; plain
    calls on the CPU).  `train_read(t)` and `eval_read(j)`, called inside
    the programs with the device-side step and batch indices, give the m
    members' batches; every replay writes its losses into
    `train_losses[:, t]` or `eval_losses[:, j]` and advances its index.
    `active` (m,) bool on the device masks each member's optimizer step:
    a member whose flag is False keeps its parameters, moments and
    count.  A member placed on a mesh (`state.parallel`) steps and
    evaluates on its rank's rows, its losses summed over 'data'.
    `captured=False` calls the programs' functions eagerly (a gloo mesh
    over CUDA tensors: its collectives run on the host)."""

    def __init__(self, cfg, tcfg, states, *, impl: str, device,
                 train_read: Callable, eval_read: Callable, n_steps: int,
                 n_eval: int, name: str, accum_steps: int = 1,
                 captured: bool = True):
        dev = torch.device(device)
        m = len(states)
        self.states = states
        self.captured = captured
        self.active = torch.ones(m, dtype=torch.bool, device=dev)
        self.train_losses = torch.zeros(m, max(n_steps, 1), device=dev)
        self.eval_losses = torch.zeros(m, max(n_eval, 1), device=dev)
        self.t = torch.zeros((), dtype=torch.int64, device=dev)
        self.j = torch.zeros((), dtype=torch.int64, device=dev)
        self.n_steps, self.n_eval = n_steps, n_eval

        def train_body():
            batches = train_read(self.t)
            losses = torch.stack([
                member_step(st, tcfg, b, impl=impl, accum_steps=accum_steps,
                            active=self.active[i])
                for i, (st, b) in enumerate(zip(states, batches))])
            self.train_losses.index_copy_(1, self.t.view(1), losses.view(m, 1))
            self.t.add_(1)
            return losses

        def eval_body():
            batches = eval_read(self.j)
            losses = torch.stack([eval_loss(st.model, tcfg, b, impl=impl,
                                            parallel=st.parallel)
                                  for st, b in zip(states, batches)])
            self.eval_losses.index_copy_(1, self.j.view(1), losses.view(m, 1))
            self.j.add_(1)
            return losses

        self.train_program = GraphedFunction(
            train_body, dev, name=f"{name}.train_step[{impl}]",
            generators=[st.generator for st in states
                        if st.generator is not None])
        self.eval_program = GraphedFunction(
            eval_body, dev, name=f"{name}.eval_step[{impl}]")

    def train(self, n: int) -> None:
        """Launch `n` train steps from step index 0, without waiting."""
        self.t.zero_()
        self.steps(n)

    def steps(self, n: int) -> None:
        """Launch `n` more train steps (host-fed chunks)."""
        call = self.train_program if self.captured else self.train_program.fn
        for _ in range(n):
            call()

    def sync_steps(self) -> None:
        """Each state's host step counter from its optimizer's device
        count (a masked step counts nothing): one read per member."""
        for st in self.states:
            st.step = st.optimizer.count

    def generator_states(self) -> list:
        """Each member's dropout generator state (read on the host).  A
        masked step still draws its masks, so a driver keeps the state a
        member had when it stopped and gives it back at the end
        (`restore_generators`): the stopped member's whole state is then
        the one it stopped with."""
        return [None if st.generator is None else st.generator.get_state()
                for st in self.states]

    def restore_generators(self, saved) -> None:
        for st, g in zip(self.states, saved):
            if g is not None:
                st.generator.set_state(g)

    def evaluate(self, n: int) -> None:
        """Launch `n` eval batches from batch index 0, without waiting."""
        self.j.zero_()
        self.eval_batches(n)

    def eval_batches(self, n: int) -> None:
        call = self.eval_program if self.captured else self.eval_program.fn
        for _ in range(n):
            call()

    def means(self):
        """(train, valid) per-member f32 means of this epoch's losses, on
        the device."""
        return (self.train_losses[:, :self.n_steps].mean(dim=1),
                self.eval_losses[:, :self.n_eval].mean(dim=1))

    def set_active(self, i: int, flag: bool) -> None:
        self.active[i] = flag


def device_reads(train_data, valid_data, train_idx: torch.Tensor,
                 ev_idx: torch.Tensor, ev_w: torch.Tensor, *, batch_size: int,
                 duplicate: bool, eval_duplicate: bool, part=(1, 0)):
    """(train_read, eval_read, rowids) for a Lockstep over staged data:
    member i's step t gathers rows rowids[i, t·rows : (t+1)·rows] of
    `train_data` (rowids is refilled each epoch: `shuffle_rows`); its eval
    batch j gathers ev_idx[i, j·bs : (j+1)·bs] of `valid_data` with the
    weights ev_w (both repeated row by row under `eval_duplicate`).
    `part` (n, p): each read keeps the p-th of n equal slices of those
    rows, a data-parallel rank's rows of the global batch (the caller
    keeps R-Drop's duplicate pairs whole: bs divisible by n)."""
    dev = train_idx.device
    bs = batch_size
    rows = bs * (2 if duplicate else 1)
    m = train_idx.shape[0]
    n, p = part
    rowids = torch.empty((m, train_idx.shape[1] * (2 if duplicate else 1)),
                         dtype=torch.int64, device=dev)
    ar_rows = torch.arange(rows // n, device=dev) + p * (rows // n)
    # this rank's eval rows, as positions in the undoubled batch
    ev_rows = bs * (2 if eval_duplicate else 1) // n
    ar_ev = ((torch.arange(ev_rows, device=dev) + p * ev_rows)
             // (2 if eval_duplicate else 1))

    def train_read(t):
        at = t * rows + ar_rows
        return [gather_rows(train_data, rowids[i].index_select(0, at))
                for i in range(m)]

    def eval_read(j):
        at = j * bs + ar_ev
        out = []
        for i in range(m):
            idx = ev_idx[i].index_select(0, at)
            w = ev_w[i].index_select(0, at)
            batch = gather_rows(valid_data, idx)
            batch["sample_weight"] = w
            out.append(batch)
        return out

    return train_read, eval_read, rowids


def shuffle_rows(rowids: torch.Tensor, train_idx: torch.Tensor,
                 perms: torch.Tensor, duplicate: bool) -> None:
    """rowids[i] = train_idx[i][perms[i]], each id twice in adjacent rows
    under `duplicate` (R-Drop); in place, on the device."""
    ids = train_idx.gather(1, perms)
    rowids.copy_(ids.repeat_interleave(2, dim=1) if duplicate else ids)


def controller_step(va, ctrl, tcfg, *, active=None):
    """One on-device ReduceLROnPlateau + EarlyStop update (JAX
    `device_epochs.controller_step`), for a (k,) vector of members.
    Replicates schedule.{PlateauState,EarlyStop}.step, the save guard's
    quirk included (a new minimum that fails the guard still advances the
    stop counter).  The loss comparisons run in f32 (the host's run in
    f64), so a valid loss within f32 rounding of a threshold could decide
    otherwise; the learning rate keeps the dtype it comes in.

    `ctrl` = (lr, plateau_best, plateau_bad, stop_best, stop_bad);
    `active` masks members whose stopper is frozen (None: all active; the
    plateau steps for every member, as JAX's does).  Returns (new ctrl,
    save, stop_now)."""
    lr, pb, pbad, eb, ebad = ctrl
    if active is None:
        active = torch.ones_like(va, dtype=torch.bool)
    improved = va < pb * (1.0 - 1e-4)
    pb = torch.where(improved, va, pb)
    pbad = torch.where(improved, torch.zeros_like(pbad), pbad + 1)
    reduce_ = ~improved & (pbad > tcfg.plateau_patience)
    lr = torch.where(reduce_, lr * tcfg.plateau_factor, lr)
    pbad = torch.where(reduce_, torch.zeros_like(pbad), pbad)
    is_min = va <= eb
    eb = torch.where(active & is_min, va, eb)
    passes = (torch.ones_like(active) if tcfg.save_guard is None
              else va > tcfg.save_guard)   # in f32, as JAX's
    save = active & is_min & passes
    ebad = torch.where(save, torch.zeros_like(ebad),
                       torch.where(active, ebad + 1, ebad))
    stop_now = active & ~save & (ebad >= tcfg.early_stop)
    return (lr, pb, pbad, eb, ebad), save, stop_now


class DeviceControl:
    """The plateau and early-stop controllers of m members, their best
    parameters and their history, all on the device (the carry of JAX's
    fully compiled drivers).  `step(epoch)` reads the Lockstep's epoch
    means, runs `controller_step` and freezes every member that was
    stopped before the epoch: its plateau state, learning rate, stopper
    and best stay as they were, so an epoch run after every member stopped
    changes nothing (JAX's `lax.cond` skip).  The learning rate is kept in
    f64, as the host's plateau keeps it, and handed to each optimizer's f32
    `lr_t`; the losses, bests and history keep the dtype of the Lockstep's
    losses (f32, as JAX's; f64 where a test runs the members in f64)."""

    def __init__(self, lockstep: Lockstep, tcfg, lrs: Sequence[float],
                 n_epochs: int):
        dev = lockstep.active.device
        m = len(lockstep.states)
        self.ls, self.tcfg = lockstep, tcfg
        fl = dict(dtype=lockstep.eval_losses.dtype, device=dev)
        self.lr = torch.tensor([float(x) for x in lrs], dtype=torch.float64,
                               device=dev)
        self.pb = torch.full((m,), math.inf, **fl)
        self.pbad = torch.zeros(m, dtype=torch.int32, device=dev)
        self.eb = torch.full((m,), math.inf, **fl)
        self.ebad = torch.zeros(m, dtype=torch.int32, device=dev)
        self.stopped = torch.zeros(m, dtype=torch.bool, device=dev)
        self.best_loss = torch.full((m,), math.inf, **fl)
        self.best_epoch = torch.full((m,), -1, dtype=torch.int64, device=dev)
        self.saved_any = torch.zeros(m, dtype=torch.bool, device=dev)
        self.last_va = torch.full((m,), math.nan, **fl)
        self.hist_tr = torch.zeros(n_epochs, m, **fl)
        self.hist_va = torch.zeros(n_epochs, m, **fl)
        self.hist_active = torch.zeros(n_epochs, m, dtype=torch.bool,
                                       device=dev)
        self.best = [{k: v.detach().clone()
                      for k, v in st.model.state_dict().items()}
                     for st in lockstep.states]
        if any(not v.is_floating_point() for b in self.best for v in b.values()):
            raise TypeError("DeviceControl keeps floating-point states only")
        for st, lr in zip(lockstep.states, lrs):
            set_learning_rate(st, lr)

    @torch.no_grad()
    def step(self, epoch: int) -> None:
        ls, tcfg = self.ls, self.tcfg
        tr, va = ls.means()
        act = ls.active.clone()
        (lr, pb, pbad, eb, ebad), save, stop_now = controller_step(
            va, (self.lr, self.pb, self.pbad, self.eb, self.ebad), tcfg,
            active=act)
        # a stopped member's plateau freezes too: its whole state is the
        # sequential driver's at its stop
        for cur, new in ((self.lr, lr), (self.pb, pb), (self.pbad, pbad)):
            cur.copy_(torch.where(act, new, cur))
        self.eb.copy_(eb)
        self.ebad.copy_(ebad)
        saving = save.to(torch.float32)
        for i, st in enumerate(ls.states):
            for k, v in st.model.state_dict().items():
                self.best[i][k].lerp_(v, saving[i])
        self.best_loss.copy_(torch.where(save, va, self.best_loss))
        self.best_epoch.copy_(torch.where(save, torch.full_like(
            self.best_epoch, epoch), self.best_epoch))
        self.saved_any |= save
        # the guard never passed: the stop-time parameters
        fallback = stop_now & ~self.saved_any
        falling = fallback.to(torch.float32)
        for i, st in enumerate(ls.states):
            for k, v in st.model.state_dict().items():
                self.best[i][k].lerp_(v, falling[i])
        self.best_loss.copy_(torch.where(fallback, va, self.best_loss))
        self.stopped |= stop_now
        self.last_va.copy_(torch.where(act, va, self.last_va))
        self.hist_tr[epoch].copy_(tr)
        self.hist_va[epoch].copy_(va)
        self.hist_active[epoch].copy_(act)
        ls.active.copy_(~self.stopped)
        for i, st in enumerate(ls.states):
            st.optimizer.lr_t.copy_(self.lr[i])

    def finish(self):
        """Fetch the history and the controllers' results to the host
        (one synchronisation) and give every optimizer the host value of
        its last learning rate.  Returns a dict of numpy arrays."""
        out = {k: getattr(self, k).cpu().numpy() for k in (
            "hist_tr", "hist_va", "hist_active", "best_loss", "best_epoch",
            "saved_any", "stopped", "last_va", "lr")}
        for st, lr in zip(self.ls.states, out["lr"]):
            st.optimizer.lr = float(lr)   # the f32 tensor keeps its value
        self.ls.sync_steps()
        return out

    def freeze_generators(self, res, generators) -> None:
        """Give each stopped member the dropout generator state it had after
        its last trained epoch (`generators`: the members' states at the
        start of every launched epoch)."""
        ls = self.ls
        saved = [None] * len(ls.states)
        for i in range(len(ls.states)):
            live = np.flatnonzero(res["hist_active"][:, i])
            if res["stopped"][i] and len(live) and live[-1] + 1 < len(generators):
                saved[i] = generators[live[-1] + 1][i]
        ls.restore_generators(saved)


class EpochLauncher:
    """Launches epochs of a DeviceControl'ed Lockstep without waiting for
    them: after each epoch a non-blocking copy of the `stopped` flags into
    pinned memory and an event.  `go(epoch)` says whether to launch the
    epoch: it reads the flags of every finished epoch (polled by event),
    and before launching epoch e waits for epoch e - 2 (the card still has
    e - 1 queued), so at most one epoch runs after the last member
    stopped, and that one changes nothing (DeviceControl).

    `deterministic` (the ranks of a mesh): on a CUDA device read only the
    flags of epoch e - 2 and earlier, which `go` waits for, and never
    poll, so that every rank launches the same epochs whatever its timing
    (a rank that stopped on an early poll would leave the others waiting
    in the next epoch's collectives).  The one epoch after the last stop
    then always runs, masked."""

    LEAD = 2

    def __init__(self, control: DeviceControl, n_epochs: int, *,
                 deterministic: bool = False):
        self.control = control
        self.deterministic = deterministic
        dev = control.stopped.device
        m = control.stopped.shape[0]
        pin = dev.type == "cuda"
        self.flags = torch.zeros((n_epochs, m), dtype=torch.bool,
                                 pin_memory=pin)
        self.events = []
        self.cuda = pin
        self.stop_epoch = None   # first epoch after which all had stopped
        self.launched = 0
        self.generators = []     # the members' generator states, per epoch

    def _read(self, e: int) -> None:
        if self.stop_epoch is None and bool(self.flags[e].all()):
            self.stop_epoch = e

    def go(self, epoch: int) -> bool:
        if self.cuda:
            for e, ev in enumerate(self.events):
                if e <= epoch - self.LEAD:
                    ev.synchronize()
                    self._read(e)
                elif not self.deterministic and ev.query():
                    self._read(e)
        else:   # the CPU has run every recorded epoch: the same on every rank
            for e in range(len(self.events)):
                self._read(e)
        if self.stop_epoch is None:
            self.generators.append(self.control.ls.generator_states())
        return self.stop_epoch is None

    def record(self, epoch: int) -> None:
        self.flags[epoch].copy_(self.control.stopped, non_blocking=True)
        ev = torch.cuda.Event() if self.cuda else None
        if ev is not None:
            ev.record()
        self.events.append(ev)
        self.launched = epoch + 1

    def report(self, info: Optional[dict]) -> None:
        """Into `info` (where given): the epochs launched and the masked
        ones."""
        if info is not None:
            info.update(epochs_launched=self.launched,
                        masked_epochs=self.masked_epochs())

    def masked_epochs(self) -> int:
        """Epochs that ran after every member had stopped."""
        for e in range(len(self.events)):
            self._read(e)
        if self.stop_epoch is None:
            return 0
        return self.launched - (self.stop_epoch + 1)


def _single_reads(train_data, valid_data, n_train: int, n_padded: int,
                  tcfg, duplicate: bool):
    """The one-member reads: train rows over all of `train_data`, eval
    batches over all of `valid_data` (padded, with its sample weights), or
    none where `valid_data` is None."""
    dev = train_data[next(iter(train_data))].device
    train_idx = torch.arange(n_train, device=dev).view(1, -1)
    ev_idx = torch.arange(n_padded, device=dev).view(1, -1)
    ev_w = (torch.ones(1, n_padded, device=dev) if valid_data is None
            else valid_data["sample_weight"].float().view(1, -1))
    reads = device_reads(train_data, valid_data, train_idx, ev_idx, ev_w,
                         batch_size=tcfg.batch_size, duplicate=duplicate,
                         eval_duplicate=False)
    return reads, train_idx


def make_train_epoch(cfg, tcfg, n_real: int, *, impl: str = "xla",
                     duplicate: bool = False):
    """One train epoch over a staged set of `n_real` samples: the device
    shuffle (`epoch_permutation(key_seed, epoch)`), then n_real // batch
    steps, each gathering its batch from the staged data and replaying the
    captured step (the final partial batch is dropped).  `duplicate`
    repeats each drawn sample in two adjacent rows (R-Drop).  Returns
    epoch_fn(state, data, key_seed, epoch) -> the (steps,) losses on the
    device; one Lockstep per (state, data) pair it is called with."""
    bs = tcfg.batch_size
    n_steps = n_real // bs
    if n_steps == 0:
        raise ValueError(f"need >= {bs} samples, have {n_real}")
    built = {}

    def epoch_fn(state, data, key_seed: int, epoch: int):
        key = (id(state), id(data))
        if key not in built:
            dev = data[next(iter(data))].device
            (tr, _, rowids), train_idx = _single_reads(
                data, None, n_real, bs, tcfg, duplicate)
            ls = Lockstep(cfg, tcfg, [state], impl=impl, device=dev,
                          train_read=tr, eval_read=lambda j: [],
                          n_steps=n_steps, n_eval=0, name="train_epoch")
            built[key] = (ls, rowids, train_idx)
        ls, rowids, train_idx = built[key]
        perm = epoch_permutation(key_seed, epoch, n_real, train_idx.device)
        shuffle_rows(rowids, train_idx, perm.view(1, -1), duplicate)
        ls.train(n_steps)
        return ls.train_losses[0, :n_steps].clone()

    return epoch_fn


def make_eval_epoch(cfg, tcfg, n_padded: int, *, impl: str = "xla",
                    duplicate: bool = False):
    """One eval epoch over a `stage_dataset(..., pad_to_multiple=batch)`
    set: unshuffled contiguous batches, each one replay of the captured
    eval step.  Returns epoch_fn(model, data) -> the (batches,) weighted
    losses on the device, equal to the host path's per-batch losses on the
    same parameters.  `duplicate` repeats every row (an eval loader built
    with R-Drop's duplication)."""
    bs = tcfg.batch_size
    if n_padded % bs:
        raise ValueError(f"staged eval set ({n_padded}) not a multiple of "
                         f"batch_size ({bs}): stage with pad_to_multiple")
    n_ev = n_padded // bs
    built = {}

    def epoch_fn(model, data):
        key = (id(model), id(data))
        if key not in built:
            dev = data[next(iter(data))].device
            ev_idx = torch.arange(n_padded, device=dev).view(1, -1)
            ev_w = data["sample_weight"].float().view(1, -1)
            _, er, _ = device_reads(data, data, ev_idx, ev_idx, ev_w,
                                    batch_size=bs, duplicate=False,
                                    eval_duplicate=duplicate)
            holder = _ModelOnly(model)
            built[key] = Lockstep(cfg, tcfg, [holder], impl=impl, device=dev,
                                  train_read=lambda t: [],
                                  eval_read=er, n_steps=0, n_eval=n_ev,
                                  name="eval_epoch")
        ls = built[key]
        ls.evaluate(n_ev)
        return ls.eval_losses[0, :n_ev].clone()

    return epoch_fn


class _ModelOnly:
    """A model standing where an eval-only Lockstep wants a state."""

    def __init__(self, model):
        self.model = model
        self.generator = None
        self.step = 0
        self.parallel = None


def _stage_pair(train_samples, valid_samples, tcfg, transfer_dtype, device,
                info):
    train_data, n_train = stage_dataset(train_samples, device=device,
                                        transfer_dtype=transfer_dtype,
                                        info=info)
    valid_data, _ = stage_dataset(valid_samples, device=device,
                                  pad_to_multiple=tcfg.batch_size,
                                  transfer_dtype=transfer_dtype, info=info)
    return train_data, n_train, valid_data


def fit_device_resident(
    cfg, tcfg, train_samples, valid_samples, *,
    epochs: Optional[int] = None, impl: str = "xla", seed: Optional[int] = None,
    duplicate: bool = False, checkpoint_cb=None, log_cb=None,
    transfer_dtype=None, device=None, info: Optional[dict] = None,
):
    """Trainer.fit's epoch driver (plateau LR, early stop with the save
    guard, best-checkpoint callback) over data staged on `device` ("cuda"
    unless "cpu" is asked for): every step a replay, the losses fetched
    once an epoch.  `info`, where given, receives the staging's seconds
    and bytes ("staging_s", "staged_bytes").  Returns (final TrainState,
    [EpochStats])."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    sd = tcfg.seed if seed is None else seed
    train_data, n_train, valid_data = _stage_pair(
        train_samples, valid_samples, tcfg, transfer_dtype, dev, info)
    bs = tcfg.batch_size
    rows = bs * (2 if duplicate else 1)
    n_steps = n_train // bs
    if n_steps == 0:
        raise ValueError(f"need >= {bs} samples, have {n_train}")
    n_padded = int(valid_data["sample_weight"].shape[0])
    n_ev = n_padded // bs
    state = engine.init_state(cfg, tcfg, sd, device=dev)
    (tr_read, ev_read, rowids), train_idx = _single_reads(
        train_data, valid_data, n_train, n_padded, tcfg, duplicate)
    ls = Lockstep(cfg, tcfg, [state], impl=impl, device=dev,
                  train_read=tr_read, eval_read=ev_read, n_steps=n_steps,
                  n_eval=n_ev, name="fit_device_resident")
    plateau = schedule.PlateauState(lr=tcfg.lr, factor=tcfg.plateau_factor,
                                    patience=tcfg.plateau_patience)
    stopper = schedule.EarlyStop(patience=tcfg.early_stop,
                                 save_guard=tcfg.save_guard)
    history = []
    for epoch in range(tcfg.epochs if epochs is None else epochs):
        t0 = time.perf_counter()
        perm = epoch_permutation(sd + 777, epoch, n_train, dev)
        shuffle_rows(rowids, train_idx, perm.view(1, -1), duplicate)
        ls.train(n_steps)
        ls.evaluate(n_ev)
        tr, va = (float(x) for x in torch.stack(ls.means()).view(-1).cpu())
        stats = EpochStats(
            train_loss=tr, valid_loss=va, steps=n_steps,
            # rows count R-Drop's duplicates, as the host Batcher's do
            samples=n_steps * rows, seconds=time.perf_counter() - t0,
            step_losses=tuple(ls.train_losses[0, :n_steps].cpu().tolist()))
        history.append(stats)
        if log_cb:
            log_cb(epoch, stats)
        set_learning_rate(state, plateau.step(stats.valid_loss))
        save, stop = stopper.step(stats.valid_loss)
        if save and checkpoint_cb:
            checkpoint_cb(state, epoch, stats.valid_loss)
        if stop:
            break
    ls.sync_steps()
    return state, history


def fit_fully_compiled(
    cfg, tcfg, train_samples, valid_samples, *,
    epochs: Optional[int] = None, impl: str = "xla",
    seed: Optional[int] = None, duplicate: bool = False,
    transfer_dtype=None, device=None, info: Optional[dict] = None,
):
    """The whole run without a host round trip between epochs: every
    epoch's replays and the on-device controllers (`DeviceControl`:
    ReduceLROnPlateau with its 1e-4 relative threshold, the early stop with
    the save guard's quirk, the best parameters kept on the device) are
    launched back to back (`EpochLauncher`).  The same math, shuffle keys
    and steps as fit_device_resident.

    Returns (final TrainState, [EpochStats] trimmed at the stop epoch,
    best state dict, best epoch, best valid loss).  `info`, where given,
    receives the staging's seconds and bytes, the epochs launched and how
    many of them ran after the stop and changed nothing ("staging_s",
    "staged_bytes", "epochs_launched", "masked_epochs")."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    sd = tcfg.seed if seed is None else seed
    train_data, n_train, valid_data = _stage_pair(
        train_samples, valid_samples, tcfg, transfer_dtype, dev, info)
    bs = tcfg.batch_size
    rows = bs * (2 if duplicate else 1)
    n_steps = n_train // bs
    if n_steps == 0:
        raise ValueError(f"need >= {bs} samples, have {n_train}")
    n_padded = int(valid_data["sample_weight"].shape[0])
    n_ev = n_padded // bs
    n_epochs = tcfg.epochs if epochs is None else epochs
    state = engine.init_state(cfg, tcfg, sd, device=dev)
    (tr_read, ev_read, rowids), train_idx = _single_reads(
        train_data, valid_data, n_train, n_padded, tcfg, duplicate)
    ls = Lockstep(cfg, tcfg, [state], impl=impl, device=dev,
                  train_read=tr_read, eval_read=ev_read, n_steps=n_steps,
                  n_eval=n_ev, name="fit_fully_compiled")
    control = DeviceControl(ls, tcfg, [tcfg.lr], n_epochs)
    launcher = EpochLauncher(control, n_epochs)
    t0 = time.perf_counter()
    for epoch in range(n_epochs):
        if not launcher.go(epoch):
            break
        perm = epoch_permutation(sd + 777, epoch, n_train, dev)
        shuffle_rows(rowids, train_idx, perm.view(1, -1), duplicate)
        ls.train(n_steps)
        ls.evaluate(n_ev)
        control.step(epoch)
        launcher.record(epoch)
    res = control.finish()
    dt = time.perf_counter() - t0
    control.freeze_generators(res, launcher.generators)
    launcher.report(info)
    live = res["hist_active"][:, 0]
    n_live = int(live.sum())
    history = [EpochStats(float(res["hist_tr"][e, 0]),
                          float(res["hist_va"][e, 0]), n_steps,
                          n_steps * rows, dt / max(n_live, 1))
               for e in range(len(live)) if live[e]]
    best_epoch = int(res["best_epoch"][0])
    # the loss of the last saved epoch (a minimum that fails the guard
    # moves the stopper's best but is never saved: the reference's quirk)
    best_loss = (float(res["hist_va"][best_epoch, 0]) if best_epoch >= 0
                 else math.inf)
    return state, history, control.best[0], best_epoch, best_loss


__all__ = ["epoch_permutation", "stage_dataset", "gather_rows",
           "padded_eval_indices", "Lockstep", "controller_step",
           "DeviceControl", "EpochLauncher", "make_train_epoch",
           "make_eval_epoch", "fit_device_resident", "fit_fully_compiled"]
