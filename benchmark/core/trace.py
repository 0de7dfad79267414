"""The traced stretch of a `--trace 1` run: torch.profiler over device
activity only (as `chip_smoke.py:5148` `EpochProfile` traces), entered
and left after a synchronisation, so that no device work crosses its
edges; the program's kernel launch counters read at both edges.  The
host's operators are not recorded, which would slow a host-bound cell;
the CUDA runtime calls that come with the device activity name the idle
gaps.  What comes out is plain numbers and names (`TraceSummary`); the
per-layer readers in `metrics/` take them from there, and the drivers
leave the stretch out of the counts those readers divide."""

from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..reference import profile as arith


@dataclasses.dataclass
class TraceSummary:
    window_s: float                      # host wall of the traced stretch
    busy_s: float                        # union of the device's intervals
    ops: Dict[str, Tuple[float, int]]    # device op -> (seconds, count)
    gaps: List[Tuple[str, float]]        # longest idle gaps, by runtime call
    launches: Dict[str, int]             # kernel -> launches in the stretch
    passes: Dict[str, Counter]           # "forward"/"backward" -> {B: n}


class Tracer:
    """`start()` and `stop(...)` mark the traced stretch; both do nothing
    when tracing is off, and only the first stretch is kept."""

    def __init__(self, device, enabled: bool,
                 counters: Callable[[], Dict[str, int]]):
        self.device = torch.device(device)
        self.enabled = enabled
        self.counters = counters
        self.summary: Optional[TraceSummary] = None
        self._prof = None
        # host seconds spent starting the profiler and reading its trace,
        # which a driver takes off its window's wall
        self.overhead_s = 0.0

    @property
    def active(self) -> bool:
        return self._prof is not None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        if not self.enabled or self._prof is not None or self.summary:
            return
        from torch.profiler import ProfilerActivity, profile

        t = time.perf_counter()
        acts = ([ProfilerActivity.CUDA] if self.device.type == "cuda"
                else [ProfilerActivity.CPU])
        self._sync()
        self._before = dict(self.counters())
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        self.overhead_s += self._t0 - t

    def stop(self, passes: Dict[str, Counter]) -> None:
        """`passes`: the member-forwards (and backwards) of the stretch by
        batch size, which the kernels' readers expect to find launched."""
        if self._prof is None:
            return
        from torch.autograd import DeviceType

        self._sync()
        t = time.perf_counter()
        wall = t - self._t0
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        after = self.counters()
        device, host = [], []
        for e in prof.profiler.kineto_results.events():
            item = (e.name(), e.start_ns(), e.end_ns())
            if e.device_type() == DeviceType.CUDA:
                device.append(item)
            elif e.device_type() == DeviceType.CPU:
                host.append(item)
        del prof
        spans = [(a, b) for _, a, b in device]
        self.summary = TraceSummary(
            window_s=wall, busy_s=arith.busy_union(spans) / 1e9,
            ops=arith.by_name(device),
            gaps=arith.label_gaps(arith.idle_gaps(spans), host),
            launches={k: after[k] - self._before.get(k, 0) for k in after},
            passes={k: Counter(v) for k, v in passes.items()})
        self.overhead_s += time.perf_counter() - t
