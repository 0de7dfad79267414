"""Arithmetic the per-layer readers share: the model's FLOPs against the
configuration's peak, and a kernel's bound time against its device time
in the traced stretch."""

from __future__ import annotations

from typing import Callable, Iterable, Optional

from ..reference import flops, profile, roofline
from . import device as card


def peak_flops(rec) -> float:
    return float(rec.config["peak"]["tflops"]) * 1e12


def mfu(rec, units: float, flops_per_unit: float) -> Optional[float]:
    """% of the peak: `units` (samples, or member-forwards) of
    `flops_per_unit` FLOPs each over the window's wall."""
    if rec.window_s <= 0 or units <= 0:
        return None
    return 100.0 * units * flops_per_unit / rec.window_s / peak_flops(rec)


def forward_flops(rec) -> float:
    return flops.forward_flops_per_sample(rec.model)


def grids(m) -> int:
    return 2 if m.head == "concat_trans" else 1


def block_calls(m):
    """(Lq, Lkv, has S_prev, emits S) of each block call of one grid
    forward: every stream's chain of n_layers blocks, the last emitting
    no S."""
    for lq, lkv in roofline.stream_shapes(m):
        for i in range(m.n_layers):
            yield lq, lkv, i > 0, i < m.n_layers - 1


def kernel_share(rec, needles: Iterable[str], counters: Iterable[str],
                 kind: str, bound_ms: Callable[[int, int, int, bool, bool], float]
                 ) -> Optional[float]:
    """% of the roofline: the least time of every launch in the traced
    stretch over the kernels' device time there.  The launches are the
    program's counters, and the stretch's `kind` passes ("forward" or
    "backward", by batch size) fix which were made; where the two
    disagree, or the trace holds more launches than were made, the
    reader has nothing it can trust and returns None.  The profiler may
    drop a record (one in 4,608 in one traced run): up to a thousandth of
    the launches may be missing from the trace, and the bound is then
    taken over the traced share of them.  `bound_ms(B, Lq, Lkv,
    has_sprev, emit)` is one launch's bound."""
    t = rec.trace
    if t is None:
        return None
    seconds, events = 0.0, 0
    for needle in needles:
        s, n = profile.matching(t.ops, needle)
        seconds, events = seconds + s, events + n
    counters = list(counters)
    launches = sum(t.launches.get(c, 0) for c in counters)
    if seconds <= 0 or events == 0:
        return None
    per_pass = list(block_calls(rec.model)) * grids(rec.model)
    passes = t.passes.get(kind, {})
    expected = sum(passes.values()) * len(per_pass) * len(counters)
    if not (launches == expected and expected - expected // 1000
            <= events <= expected):
        card.log(f"[{rec.cell}] {list(needles)}: {events} launches traced, "
                 f"{launches} counted, {expected} expected: not read")
        return None
    if events < expected:
        card.log(f"[{rec.cell}] {list(needles)}: {expected - events} of "
                 f"{expected} launches missing from the trace")
    total_ms = sum(n * sum(bound_ms(b, *call) for call in per_pass)
                   for b, n in passes.items()) * events / expected
    return 100.0 * total_ms / 1e3 / seconds


def idle_share(rec) -> Optional[float]:
    t = rec.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
