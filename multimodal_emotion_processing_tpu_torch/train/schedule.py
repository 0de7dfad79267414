"""Host-side LR control mirroring torch.optim.lr_scheduler.ReduceLROnPlateau
(mode='min', threshold=1e-4 rel, cooldown=0) — the schedule used by every
reference trainer (cmu-mosei/run.py:399 etc.) — plus the early-stop counter.
The port's copy of train/schedule.py of the JAX package, line for line.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass
class PlateauState:
    lr: float
    factor: float = 0.1
    patience: int = 4
    threshold: float = 1e-4
    best: float = math.inf
    num_bad: int = 0

    def step(self, metric: float) -> float:
        """Feed one epoch's valid loss; returns the (possibly reduced) LR."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr *= self.factor
                self.num_bad = 0
        return self.lr


@dataclasses.dataclass
class EarlyStop:
    """Best-checkpoint bookkeeping + patience counter (cmu-mosei/run.py:413-419).

    `save_guard`: when set, a new best only saves (and resets the counter) if
    valid_loss > guard — reference quirk: a new min that fails the guard still
    increments the stop counter (the `and` at cmu-mosei/run.py:413).
    """

    patience: int
    save_guard: Optional[float] = None
    best: float = math.inf
    bad: int = 0

    def step(self, valid_loss: float):
        """Returns (should_save, should_stop)."""
        is_min = valid_loss <= self.best
        if is_min:
            self.best = valid_loss
        if is_min and (self.save_guard is None or valid_loss > self.save_guard):
            self.bad = 0
            return True, False
        self.bad += 1
        return False, self.bad >= self.patience
