"""One captured CUDA-graph program per input shape: the port's counterpart
of `jax.jit` for the serving and ensemble computations and for the train
and eval steps of the whole-run drivers (train/device_epochs.py,
train/vmap_kfold.py, train/sweep.py).

`GraphedFunction(fn, device)` is called like `fn`, with a pytree (tuple,
list, dict) of tensors.  On a CUDA device each new key (the pytree's
structure and every leaf's shape and dtype) gets static input buffers on
the device, one eager call on a side stream (it loads every kernel library
and module and creates the cuBLAS workspace before the capture, and its
outputs are the first call's answer), then one capture into a
`torch.cuda.CUDAGraph` on a side stream.
Every later call of that key copies its inputs into the static buffers (a
host tensor, best pinned, in one host-to-device copy each) and replays the
graph: one launch.  The outputs of a replay are the graph's static tensors:
the caller copies them out before the next call.  One caller at a time.

A failed capture raises, naming the function and the key; nothing falls
back to eager.  The capture runs in "thread_local" mode, so that another
thread's CUDA calls (`data.loader.prefetch_to_device` pins and copies
batches while the consumer captures) cannot break it, and with the
garbage collector off: a collection inside the capture that frees
another graph (one held in a reference cycle) makes a CUDA call that a
capture forbids and invalidates it (`tools/graph_capture_probe.py`
turns each guard off and counts the failed captures).
Kernel launches recorded during a capture run nothing and are not counted
(`ops.cuda_binding.capture_ledger`, keyed by the capture stream, so that a
backward kernel that autograd launches from its own device thread lands
there too); every replay adds them to the counts.

A step that draws dropout masks names its `torch.Generator`s
(`generators=`): each is registered with every graph the function
captures, so that a replay draws from the generator's offset at that
moment and advances it by what the eager call would have drawn (this
needs `torch.cuda.CUDAGraph.register_generator_state`, which PyTorch
2.11.0+cu128 has; an older PyTorch fails the capture).  State
that a step updates (parameters, moments, counters) is updated in place by
the captured kernels; a function that takes no arguments reads its inputs
from buffers its caller keeps.

On the CPU, which only the tests ask for, a call is a plain call of `fn`;
so is every call while NaN debugging is on
(utils/logging.enable_nan_debugging, `--debug-nans`): autograd's anomaly
mode cannot run inside a CUDA graph.
"""

from __future__ import annotations

import gc
from collections import Counter
from typing import Callable, Dict, Sequence

import torch
from torch.utils import _pytree as pytree

from ..ops.cuda_binding import capture_ledger, credit
from ..utils import spans
from ..utils.logging import nan_debugging_enabled


class _Program:
    __slots__ = ("graph", "inputs", "outputs", "ledger")

    def __init__(self, graph, inputs, outputs, ledger):
        self.graph, self.inputs = graph, inputs
        self.outputs, self.ledger = outputs, ledger


def _describe(key) -> str:
    spec, leaves = key
    return (f"{spec}; leaves " + ", ".join(
        f"{tuple(shape)} {str(dtype).removeprefix('torch.')}"
        for shape, dtype in leaves))


class GraphedFunction:
    """`fn` compiled once per input key into a CUDA graph on `device`;
    `fn` itself stays reachable as `.fn` (the eager path).  `captures`
    counts the graphs captured, `replays` the calls served by a replay,
    `capture_ms` the host time of each key's first call (the eager call
    and the capture): the interval of its `graph.capture` span
    (utils/spans.py)."""

    def __init__(self, fn: Callable, device, *, name: str = "",
                 generators: Sequence[torch.Generator] = ()):
        self.fn = fn
        self.generators = tuple(generators)
        self.device = torch.device(device)
        self.name = name or getattr(fn, "__qualname__", "fn")
        self.captures = 0
        self.replays = 0
        self.capture_ms = []
        self._programs: Dict = {}
        self._pool = None   # one memory pool for this function's graphs

    def stats(self) -> dict:
        return {"name": self.name, "keys": len(self._programs),
                "captures": self.captures, "replays": self.replays,
                "capture_ms": list(self.capture_ms)}

    def launches_per_replay(self) -> Counter:
        """Kernel name -> the launches that one replay credits, for a
        function captured at one key."""
        if len(self._programs) != 1:
            raise ValueError(f"{self.name}: {len(self._programs)} captured "
                             "keys, expected one")
        (prog,) = self._programs.values()
        out: Counter = Counter()
        for (kernel, counter, _), n in prog.ledger.items():
            if counter == "launches":
                out[kernel.name] += n
        return out

    def __call__(self, *args):
        if self.device.type != "cuda" or nan_debugging_enabled():
            return self.fn(*args)
        leaves, spec = pytree.tree_flatten(args)
        if not all(torch.is_tensor(t) for t in leaves):
            raise TypeError(f"{self.name}: a graphed call takes tensors only")
        key = (spec, tuple((tuple(t.shape), t.dtype) for t in leaves))
        prog = self._programs.get(key)
        if prog is None:
            return self._capture(key, leaves, spec)
        for dst, src in zip(prog.inputs, leaves):
            dst.copy_(src, non_blocking=True)
        prog.graph.replay()
        credit(prog.ledger)
        self.replays += 1
        return prog.outputs

    def _capture(self, key, leaves, spec):
        with spans.timed("graph.capture") as sp:
            sp.attr("name", self.name)
            first = self._capture_key(key, leaves, spec)
        self.capture_ms.append((sp.end - sp.start) / 1e6)
        return first

    def _capture_key(self, key, leaves, spec):
        inputs = [torch.empty(t.shape, dtype=t.dtype, device=self.device)
                  for t in leaves]
        for dst, src in zip(inputs, leaves):
            dst.copy_(src, non_blocking=True)
        args = pytree.tree_unflatten(inputs, spec)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            first = self.fn(*args)      # eager: its launches ran, and count
        current.wait_stream(side)
        for t in pytree.tree_leaves(first):
            if torch.is_tensor(t) and t.device.type == "cuda":
                t.record_stream(current)
        # not torch.cuda.graph: its enter also synchronizes the device and
        # empties the allocators' caches, which the streams' ordering makes
        # unneeded here and which later allocations pay for again
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        capture = torch.cuda.Stream(self.device)
        capture.wait_stream(current)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with capture_ledger(capture) as ledger, torch.cuda.stream(capture):
                graph.capture_begin(pool=self._pool,
                                    capture_error_mode="thread_local")
                try:
                    outputs = self.fn(*args)
                finally:
                    graph.capture_end()
        except Exception as e:
            raise RuntimeError(f"{self.name}: the CUDA graph capture failed "
                               f"for key {_describe(key)}") from e
        finally:
            if collecting:
                gc.enable()
        current.wait_stream(capture)
        if self._pool is None:
            self._pool = graph.pool()
        self._programs[key] = _Program(graph, inputs, outputs, ledger)
        self.captures += 1
        return first
