"""The learning-rate sweep (train/sweep.py of the JAX package): every
(learning rate x weight decay x seed) candidate trains in one run, its
members in lockstep.

The reference tunes nothing programmatically: its learning rate is a
hand-edited constant (`LR = 1e-3`, cmu-mosei/run.py:33), and trying
another value means re-running the whole fold loop.  These models leave
most of the card idle, so the candidates step together, as the k-fold
members do (train/vmap_kfold.py): one captured CUDA graph per step holds
every candidate's step (train/device_epochs.Lockstep), with the
per-candidate plateau LR, early stop and best tracking on the device
(device_epochs.DeviceControl) and every epoch launched without a host
round trip.

The member layout is JAX's, for clean ablations:

  * candidates are the (lr x wd) grid (wd optional: AdamW's decay is a
    0-d tensor of the optimizer, as the LR is); member i trains candidate
    i // seeds_per_lr from init seed tcfg.seed + (i % seeds_per_lr):
    candidates share init seeds and per-epoch shuffles, so two members
    that differ in one hyperparameter see the same batches from the same
    weights;
  * every member trains on the same train and valid split;
  * the controllers are the reference's (plateau x0.1 with the 1e-4
    relative threshold, early stop with the save guard's quirk, best
    checkpoint), and the sweep ranks by best validation loss;
  * a seeds_per_lr=1 member with lr == tcfg.lr follows
    device_epochs.fit_fully_compiled's trajectory (the same init, shuffle
    keys and steps).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Sequence

import torch

from . import engine
from .device_epochs import (DeviceControl, EpochLauncher, Lockstep,
                            device_reads, epoch_permutation,
                            shuffle_rows, stage_dataset)
from .engine import EpochStats


@dataclasses.dataclass
class SweepMember:
    lr: float
    wd: float
    seed: int
    best_valid_loss: float
    best_epoch: int          # -1 when the guard never passed
    stop_epoch: int          # the last epoch the member trained
    history: List[EpochStats]
    best_params: dict        # state dict on the device


@dataclasses.dataclass
class SweepResult:
    members: List[SweepMember]
    winner: int              # index into members (lowest best_valid_loss)
    seconds: float

    def table(self):
        """Rows sorted best-first: (rank, lr, wd, seed, best_valid_loss,
        best_epoch, stop_epoch)."""
        order = sorted(range(len(self.members)),
                       key=lambda i: self.members[i].best_valid_loss)
        return [{"rank": r + 1, "lr": self.members[i].lr,
                 "wd": self.members[i].wd,
                 "seed": self.members[i].seed,
                 "best_valid_loss": self.members[i].best_valid_loss,
                 "best_epoch": self.members[i].best_epoch,
                 "stop_epoch": self.members[i].stop_epoch}
                for r, i in enumerate(order)]


def run_lr_sweep(
    train_samples: Sequence,
    valid_samples: Sequence,
    cfg,
    tcfg,
    *,
    lrs: Sequence[float],
    wds: Optional[Sequence[float]] = None,
    seeds_per_lr: int = 1,
    epochs: Optional[int] = None,
    impl: str = "xla",
    duplicate: bool = False,
    log_cb=None,
    transfer_dtype=None,
    device=None,
) -> SweepResult:
    """Train len(lrs) * len(wds or [default]) * seeds_per_lr candidates of
    ModelConfig `cfg` (or an ExperimentConfig) together on `device`
    ("cuda" unless "cpu" is asked for) and rank them by best validation
    loss: the datasets staged once (device_epochs.stage_dataset, in
    `transfer_dtype`'s wire format), the controllers on the device.

    `wds`: AdamW weight-decay candidates; the grid becomes (lr x wd x
    seed).  Adam configs carry but ignore it (engine.Optimizer)."""
    from ..utils.device import resolve_device

    lrs = [float(x) for x in lrs]
    if not lrs:
        raise ValueError("lrs must be non-empty")
    if seeds_per_lr < 1:
        raise ValueError(f"seeds_per_lr must be >= 1, got {seeds_per_lr}")
    S = seeds_per_lr
    default_wd = getattr(tcfg, "weight_decay", 0.01)
    cands = [(lr, float(wd)) for lr in lrs
             for wd in (wds if wds else [default_wd])]
    m = len(cands) * S
    member_lrs = [cands[i // S][0] for i in range(m)]
    member_wds = [cands[i // S][1] for i in range(m)]
    member_seeds = [tcfg.seed + (i % S) for i in range(m)]
    dev = resolve_device(device)
    bs = tcfg.batch_size
    rows = bs * (2 if duplicate else 1)
    train_data, n_train = stage_dataset(list(train_samples), device=dev,
                                        transfer_dtype=transfer_dtype)
    n_steps = n_train // bs
    if n_steps == 0:
        raise ValueError(f"sweep needs >= {bs} train samples, have {n_train}")
    valid_data, _ = stage_dataset(list(valid_samples), pad_to_multiple=bs,
                                  transfer_dtype=transfer_dtype, device=dev)
    n_padded = int(valid_data["sample_weight"].shape[0])
    n_ev = n_padded // bs
    train_idx = torch.arange(n_train, device=dev).view(1, -1).repeat(m, 1)
    ev_idx = torch.arange(n_padded, device=dev).view(1, -1).repeat(m, 1)
    ev_w = valid_data["sample_weight"].float().view(1, -1).repeat(m, 1)
    train_read, eval_read, rowids = device_reads(
        train_data, valid_data, train_idx, ev_idx, ev_w, batch_size=bs,
        duplicate=duplicate, eval_duplicate=duplicate)
    n_epochs = tcfg.epochs if epochs is None else epochs
    states = [engine.init_state(cfg, tcfg, s, device=dev)
              for s in member_seeds]
    if wds:
        for st, wd in zip(states, member_wds):
            st.optimizer.set_weight_decay(wd)
    ls = Lockstep(cfg, tcfg, states, impl=impl, device=dev,
                  train_read=train_read, eval_read=eval_read,
                  n_steps=n_steps, n_eval=n_ev, name="run_lr_sweep")
    control = DeviceControl(ls, tcfg, member_lrs, n_epochs)
    launcher = EpochLauncher(control, n_epochs)
    t0 = time.perf_counter()
    for epoch in range(n_epochs):
        if not launcher.go(epoch):
            break
        # per-seed shuffles, the single run's keys (seed + 777), shared by
        # every candidate of that seed
        perms = torch.stack([epoch_permutation(tcfg.seed + s + 777, epoch,
                                               n_train, dev)
                             for s in range(S)])
        shuffle_rows(rowids, train_idx,
                     perms[torch.arange(m, device=dev) % S], duplicate)
        ls.train(n_steps)
        ls.evaluate(n_ev)
        control.step(epoch)
        launcher.record(epoch)
    res = control.finish()
    dt = time.perf_counter() - t0
    control.freeze_generators(res, launcher.generators)
    active = res["hist_active"]
    n_live = int(active.any(axis=1).sum())
    has_best = res["saved_any"] | res["stopped"]
    members: List[SweepMember] = []
    for i in range(m):
        hist, stop_epoch = [], -1
        for e in range(n_live):
            if not active[e, i]:
                continue
            stats = EpochStats(float(res["hist_tr"][e, i]),
                               float(res["hist_va"][e, i]), n_steps,
                               n_steps * rows, dt / max(n_live, 1))
            hist.append(stats)
            stop_epoch = e
            if log_cb:
                tag = f"lr{member_lrs[i]:g}"
                if wds:
                    tag += f"_wd{member_wds[i]:g}"
                log_cb(f"{tag}_s{member_seeds[i]}", e, stats)
        if has_best[i]:
            params_i, loss_i = control.best[i], float(res["best_loss"][i])
        else:   # out of epochs without a save: the final parameters
            params_i = {k: v.detach().clone()
                        for k, v in states[i].model.state_dict().items()}
            loss_i = float(res["last_va"][i]) if n_live else math.inf
        members.append(SweepMember(
            lr=member_lrs[i], wd=member_wds[i], seed=member_seeds[i],
            best_valid_loss=loss_i, best_epoch=int(res["best_epoch"][i]),
            stop_epoch=stop_epoch, history=hist, best_params=params_i))
    winner = min(range(m), key=lambda i: members[i].best_valid_loss)
    return SweepResult(members=members, winner=winner, seconds=dt)


__all__ = ["run_lr_sweep", "SweepResult", "SweepMember"]
