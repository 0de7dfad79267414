"""The arithmetic of a profiled window: device busy time as the union of
the device's intervals (kernels, copies, fills), the idle gaps between
them, and device time by operation name.

`busy_union` is the arithmetic of `chip_smoke.py:5148` `EpochProfile.stop`
(intervals sorted by start, overlaps counted once), frozen here.  Events
are plain (name, start_ns, end_ns) tuples, so none of this needs the
profiler or the card.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

Event = Tuple[str, int, int]


def busy_union(spans: Sequence[Tuple[int, int]]) -> int:
    """Nanoseconds covered by at least one (start, end) span."""
    busy_ns, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy_ns += b - a
            end = b
        elif b > end:
            busy_ns += b - end
            end = b
    return busy_ns


def idle_gaps(spans: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The (start, end) stretches between the merged busy intervals."""
    gaps, end = [], None
    for a, b in sorted(spans):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    return gaps


def by_name(events: Sequence[Event]) -> Dict[str, Tuple[float, int]]:
    """Operation name -> (device seconds, count)."""
    out: Dict[str, list] = defaultdict(lambda: [0, 0])
    for name, a, b in events:
        out[name][0] += b - a
        out[name][1] += 1
    return {k: (v[0] / 1e9, v[1]) for k, v in out.items()}


def matching(ops: Dict[str, Tuple[float, int]], needle: str
             ) -> Tuple[float, int]:
    """(seconds, count) summed over the operations whose name holds
    `needle` (a kernel's template instances share its function name)."""
    s, n = 0.0, 0
    for name, (sec, cnt) in ops.items():
        if needle in name:
            s += sec
            n += cnt
    return s, n


def label_gaps(gaps: Sequence[Tuple[int, int]], host: Sequence[Event],
               top: int = 10) -> List[Tuple[str, float]]:
    """The `top` longest gaps, each named by what the host was doing: the
    shortest host event (a CUDA runtime call, in a device-only trace)
    that covers the gap's middle, or the host event that overlaps it
    most, else "no host call recorded"."""
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (a + b) // 2
        covering = [e for e in host if e[1] <= mid <= e[2]]
        if covering:
            name = min(covering, key=lambda e: e[2] - e[1])[0]
        else:
            overlap = [(min(b, e[2]) - max(a, e[1]), e[0]) for e in host
                       if e[1] < b and e[2] > a]
            name = max(overlap)[1] if overlap else "no host call recorded"
        out.append((name, (b - a) / 1e9))
    return out
