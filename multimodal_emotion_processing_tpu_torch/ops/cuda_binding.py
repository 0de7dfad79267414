"""What every hand-written attention kernel's wrapper shares: the ctypes
binding of a `csrc/<library>.cu` function with its launch counter, and the
checks a wrapper makes before it hands pointers to a kernel.

Every kernel takes its pointers, then B, H, Lq, Lkv, dh and is_bf16 as
ints, then the CUDA stream, and returns a cudaError_t as int (0 when it was
launched).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from collections import Counter
from typing import Optional

import torch

MAX_HEAD_DIM = 256


def needs_grad(*tensors) -> bool:
    """Whether autograd would record a graph through any of `tensors`."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def check_qkv(name, q, k, v, mask, n_heads):
    """Validate a kernel call's q, k, v and mask; returns (b, lq, lkv, dh,
    mask as contiguous f32 or None)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}")
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: expected (B, L, D)")
    b, lq, d = q.shape
    lkv = k.shape[1]
    if k.shape[0] != b or k.shape[2] != d or d % n_heads:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do "
                         f"not share (B, D) with D divisible by {n_heads}")
    dh = d // n_heads
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"head width {dh} outside 1..{MAX_HEAD_DIM}")
    for tname, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{tname} is {t.dtype} on {t.device}; q is "
                             f"{q.dtype} on {q.device}")
    if mask is not None:
        if tuple(mask.shape) != (b, lkv) or mask.device != q.device:
            raise ValueError(f"mask {tuple(mask.shape)} on {mask.device}: "
                             f"expected ({b}, {lkv}) on {q.device}")
        mask = mask.to(torch.float32).contiguous()
    return b, lq, lkv, dh, mask


def check_like(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device:
        raise ValueError(f"{name} is {tuple(t.shape)} {t.dtype} on {t.device}:"
                         f" expected {tuple(shape)} {dtype} on {device}")
    return t.contiguous()


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# the capture ledgers, keyed by the raw handle of the stream being
# captured: a kernel launched on that stream from any thread (autograd runs
# a captured backward on its own device thread, on the forward's stream)
# adds to that capture's ledger
_ledgers: dict = {}
_ledgers_lock = threading.Lock()


def _handle(stream) -> int:
    return stream if isinstance(stream, int) else stream.cuda_stream


@contextlib.contextmanager
def capture_ledger(stream):
    """While the block runs, a kernel launched on `stream` (a
    `torch.cuda.Stream` or its raw handle), from whichever thread, adds to
    the yielded Counter instead of to its counts: a launch recorded into a
    CUDA graph runs nothing until the graph is replayed.  `credit(ledger)`
    adds one replay's launches to the counts."""
    handle = _handle(stream)
    ledger: Counter = Counter()
    with _ledgers_lock:
        outer = _ledgers.get(handle)
        _ledgers[handle] = ledger
    try:
        yield ledger
    finally:
        with _ledgers_lock:
            if outer is None:
                del _ledgers[handle]
            else:
                _ledgers[handle] = outer


def credit(ledger: Counter, times: int = 1) -> None:
    """Add `times` replays of a captured graph's launches to the counts."""
    for (kernel, counter, key), n in ledger.items():
        kernel._add(counter, key, n * times)


class Kernel:
    """ctypes binding of one kernel of csrc/<library>.cu.  `launches`
    counts the launches of this kernel that ran on the device: one for each
    eager launch through this wrapper, and for a launch recorded into a
    CUDA graph (serve/graphs.py) none at capture and one at every replay of
    that graph (`capture_ledger`, `credit`).  Nothing else changes it
    except `reset()`; a subclass's own counters follow the same rule."""

    name = ""
    library = ""
    n_pointers = 0

    def __init__(self):
        self.launches = 0
        self._lock = threading.Lock()
        self._fn = None

    def reset(self) -> None:
        with self._lock:
            self.launches = 0

    def _add(self, counter: str, key, n: int) -> None:
        with self._lock:
            if key is None:
                setattr(self, counter, getattr(self, counter) + n)
            else:
                getattr(self, counter)[key] += n

    def _count(self, counter: str = "launches", key=None,
               stream: Optional[int] = None) -> None:
        """One launch on `counter` (`getattr(self, counter)[key]` where a
        key is given), or into the ledger of the capture that `stream` (the
        launch stream; by default this thread's current one) belongs to."""
        ledger = None
        if _ledgers:
            if stream is None:
                stream = launch_stream(torch.device("cuda"))
            ledger = _ledgers.get(stream)
        if ledger is not None:
            with _ledgers_lock:
                ledger[(self, counter, key)] += 1
        else:
            self._add(counter, key, 1)

    def _bind(self):
        if self._fn is None:
            from ..utils import native

            fn = getattr(native.load(self.library), self.name)
            # pointers, then B, H, Lq, Lkv, dh, is_bf16, then the stream
            fn.argtypes = ([ctypes.c_void_p] * self.n_pointers
                           + [ctypes.c_int] * 6 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def _launch(self, device, pointers, dims, is_bf16: bool,
                stream: Optional[int] = None) -> None:
        """Launch on `device`'s current stream (or `stream`, taken once by
        a caller that launches several kernels) and count.  The device is
        made current only when it is not already."""
        fn = self._bind()
        if stream is None:
            stream = launch_stream(device)
        current = torch.cuda.current_device()
        if device.index is None or device.index == current:
            rc = fn(*pointers, *dims, int(is_bf16), stream)
        else:
            with torch.cuda.device(device):
                rc = fn(*pointers, *dims, int(is_bf16), stream)
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed with CUDA error {rc}")
        self._count(stream=stream)


_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def launch_stream(device) -> int:
    """The raw handle of `device`'s current CUDA stream, through the binding
    that PyTorch's generated code uses where this build has one (it builds
    no Stream object), else `torch.cuda.current_stream`."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream
