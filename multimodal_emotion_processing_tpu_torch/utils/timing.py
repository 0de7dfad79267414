"""The one best-of-windows timer of the port's measurement entry points
(utils/timing.py of the JAX package, its contract).

The window: one warm call, then `reps` windows of `steps` back-to-back
calls each, every window ended by fetching one element of the last
result to the host (`.item()`), which cannot return before the device has
computed it; the best window's milliseconds per call are returned, and
`all_windows` receives every window (for a median).

On a card the functions timed here are captured programs
(serve/graphs.GraphedFunction, the Trainer's steps, the Ensemble's
forward): their first call is the eager call plus the capture
(graphs.GraphedFunction._capture), so the warm call takes it and the
timed windows hold replays only.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch


def fetch_one(x) -> float:
    """One element of the first tensor in `x` (a tensor, or a tuple, list
    or dict holding tensors) as a host float: a synchronisation on the
    computation that wrote it."""
    if isinstance(x, dict):
        x = next(iter(x.values()))
    while isinstance(x, (tuple, list)):
        x = x[0]
    if isinstance(x, dict):
        return fetch_one(x)
    if not torch.is_tensor(x):
        raise TypeError(f"fetch_one: no tensor to fetch in {type(x).__name__}")
    return float(x.reshape(-1)[0].item())


def best_window_ms(fn: Callable, *args, steps: int = 20, reps: int = 4,
                   sync_pick: Optional[Callable] = None,
                   all_windows: Optional[list] = None) -> float:
    """Milliseconds per `fn(*args)` call, best of `reps` windows.

    `sync_pick` maps fn's return value to what is fetched (default: the
    value itself; `fetch_one` takes the first tensor of a tuple, list or
    dict).  `all_windows`: a list that receives every window's ms/call."""
    pick = sync_pick if sync_pick is not None else (lambda o: o)
    fetch_one(pick(fn(*args)))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = None
        for _ in range(steps):
            out = fn(*args)
        fetch_one(pick(out))
        ms = (time.perf_counter() - t0) * 1e3 / steps
        if all_windows is not None:
            all_windows.append(ms)
        best = min(best, ms)
    return best
