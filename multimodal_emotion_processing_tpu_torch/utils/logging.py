"""Run logs: one CSV of epoch losses per member (the reference's txt
channel, cmu-mosei/run.py:394-396,411-412), mirrored to TensorBoard
scalars (its SummaryWriter channel) when `torch.utils.tensorboard`
imports; a profiler trace around a stretch of a run, with the host spans
(`profile_trace`); NaN debugging (`enable_nan_debugging`).
utils/logging.py of the JAX package."""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
import weakref
from typing import Optional

from . import spans


class RunLogger:
    """Writes `<dir>/<name>.csv` with epoch,train_loss,valid_loss,
    samples_per_sec and mirrors the losses to TensorBoard when available."""

    def __init__(self, log_dir: str, name: str, *, tensorboard: bool = True):
        """TensorBoard mirrors by default, as the reference always writes
        its scalars beside the txt log (cmu-mosei/run.py:397,408); without
        an importable writer the log is the CSV alone."""
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}.csv")
        self.name = name
        with open(self.path, "w") as f:
            f.write("epoch,train_loss,valid_loss,samples_per_sec\n")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    def log_epoch(self, epoch: int, stats) -> None:
        with open(self.path, "a") as f:
            f.write(f"{epoch + 1},{stats.train_loss:.6f},{stats.valid_loss:.6f},"
                    f"{stats.samples_per_sec:.2f}\n")
        if self._tb is not None:
            self._tb.add_scalars(self.name, {"train_loss": stats.train_loss,
                                             "valid_loss": stats.valid_loss}, epoch)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str], name: str = "trace"):
    """A torch.profiler trace of the enclosed work (CPU activity, and the
    CUDA kernels and copies where a card is present), written on exit as
    a Chrome / Perfetto trace `<log_dir>/<name>_<pid>_<ns>.pt.trace.json`
    (JAX's `jax.profiler` trace directory); a no-op when `log_dir` is
    None.  Yields the path the trace is written to.

    The span recorder (utils/spans.py) is on for the stretch, unless
    something else turned it on before, and its spans join the trace as
    "X" events of category "span" on their threads' tracks, their
    attributes, id and parent under `args`: the host's layers and the
    card's kernels on one timeline."""
    if log_dir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"{name}_{os.getpid()}_{time.time_ns()}.pt.trace.json")
    recording = not spans.enabled()
    if recording:
        spans.enable()
    try:
        with profile(activities=activities) as prof:
            yield path
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        drained = spans.drain()["spans"] if recording else []
        if recording:
            spans.disable()
    prof.export_chrome_trace(path)
    if drained:
        _add_spans(path, drained)


def _add_spans(path: str, drained) -> None:
    """Append the drained spans to the Chrome trace at `path`, on its
    clock: the events' `ts` are microseconds past `baseTimeNanoseconds`."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    for n, a, b, i, p, tid, attrs in drained:
        doc["traceEvents"].append({
            "ph": "X", "cat": "span", "name": n, "pid": pid, "tid": tid,
            "ts": (a - base) / 1e3, "dur": (b - a) / 1e3,
            "args": {**(attrs or {}), "id": i, "parent": p}})
    with open(path, "w") as f:
        json.dump(doc, f)


class _NanDebugging:
    """The process-wide state of `enable_nan_debugging`: the two global
    module hooks and the modules' names."""

    hooks: tuple = ()
    names: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def nan_debugging_enabled() -> bool:
    return bool(_NanDebugging.hooks)


def _name_modules(module, args) -> None:
    """Forward pre-hook: the first module called in a forward (the root)
    names itself and every submodule, as `<root class>.<attribute path>`."""
    if module in _NanDebugging.names:
        return
    root = type(module).__name__
    for path, sub in module.named_modules():
        _NanDebugging.names.setdefault(sub, f"{root}.{path}" if path else root)


def _check_finite(module, args, output) -> None:
    import torch

    outs = output if isinstance(output, (tuple, list)) else (output,)
    for t in outs:
        if (torch.is_tensor(t) and t.is_floating_point()
                and not bool(torch.isfinite(t).all())):
            name = _NanDebugging.names.get(module, type(module).__name__)
            raise FloatingPointError(
                f"--debug-nans: module {name} ({type(module).__name__}) "
                f"produced a non-finite output of shape {tuple(t.shape)}")


def enable_nan_debugging(enable: bool = True) -> None:
    """Fail on the first non-finite value (JAX's jax_debug_nans): in the
    forward, hooks on every module raise a `FloatingPointError` naming the
    first module whose output holds a NaN or an infinity; in the backward,
    autograd's anomaly mode (`set_detect_anomaly(True, check_nan=True)`)
    raises at the first function that returns a NaN and names it.  Anomaly
    mode cannot run inside a CUDA graph, so while this is on every captured
    program (serve/graphs.GraphedFunction: the Trainer's and the drivers'
    steps, the ensemble) runs eagerly; one line on stderr says so.
    `enable=False` removes the hooks and turns anomaly mode off."""
    import torch
    from torch.nn.modules import module as nn_module

    for h in _NanDebugging.hooks:
        h.remove()
    _NanDebugging.hooks = ()
    torch.autograd.set_detect_anomaly(enable, check_nan=enable)
    if not enable:
        return
    _NanDebugging.hooks = (
        nn_module.register_module_forward_pre_hook(_name_modules),
        nn_module.register_module_forward_hook(_check_finite))
    print("(--debug-nans: module outputs checked for NaN/inf, autograd "
          "anomaly mode on; the Trainer's and the drivers' steps and every "
          "other captured CUDA-graph program run eagerly, as anomaly mode "
          "cannot run inside a graph)", file=sys.stderr, flush=True)
