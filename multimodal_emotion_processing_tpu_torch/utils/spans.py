"""Host spans: the port's one span recorder, off by default.

A span is a named stretch of host work on one thread: its start and end
(`time.perf_counter_ns`), its own id, its parent's id (the innermost span
open on the same thread, or one passed across threads), the thread's
native id (`threading.get_native_id`, the id torch.profiler's host events
carry), and optional small attributes (a request id, a bucket, rows,
bytes).  The layers open spans where their work happens: `train.*` in
train/engine.py, `feed.*` in data/loader.py, `ckpt.*` in
train/checkpoint.py, `eval.pass` in eval/ensemble.py, `graph.capture` in
serve/graphs.py, `serve.*` and `stream.request` in serve/server.py and
serve/stream.py.

While the recorder is off, `span()` returns one shared no-op context
manager: a call site pays the test of one module flag, and nothing is
built or stored.  While it is on (`enable`), each closed span is one
tuple `(name, start, end, id, parent, thread, attrs)` in an in-memory
list of at most CAPACITY; past that, spans are counted as dropped.
Nothing is written until `drain()`, which returns the spans with their
times on the profiler's Unix-nanosecond clock (through the anchor pair
that `enable` took), the dropped count, and each thread's pthread id
(the CUDA runtime calls of a device trace name their thread by its low
32 bits), and clears the list.

`timed()` is `span()` for a site that needs the interval itself
(`EpochStats.seconds`, `GraphedFunction.capture_ms`): it reads the clock
whether or not the recorder is on, so one pair of readings feeds both.

`utils/logging.profile_trace` turns the recorder on for its stretch and
writes the spans into its Chrome trace; the benchmark turns it on around
the measured window of a traced run.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, Iterable, Optional, Tuple

#: spans kept between two drains; the rest are counted as dropped
CAPACITY = 1 << 20

_on = False
_spans: list = []
_dropped = 0
_anchor: Tuple[int, int] = (0, 0)     # (time.time_ns(), perf_counter_ns())
_ids = itertools.count(1)
_local = threading.local()
_threads: Dict[int, int] = {}         # native id -> pthread id
_lock = threading.Lock()


class _Noop:
    """The span while the recorder is off."""

    __slots__ = ()
    id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def attr(self, key: str, value: Any) -> None:
        pass


NOOP = _Noop()


def _thread() -> list:
    """This thread's [open spans, native id, adopted parent]."""
    try:
        return _local.state
    except AttributeError:
        state = _local.state = [[], threading.get_native_id(), None]
        _threads[state[1]] = threading.get_ident()
        return state


def _record(item: tuple) -> None:
    global _dropped
    if len(_spans) < CAPACITY:
        _spans.append(item)
    else:
        with _lock:
            _dropped += 1


class Span:
    """One span: a context manager on the thread that opens it.  `attr`
    adds an attribute; `start` and `end` are its clock readings."""

    __slots__ = ("name", "parent", "attrs", "id", "start", "end", "_live",
                 "_tid")

    def __init__(self, name: str, parent: Optional[int], live: bool):
        self.name, self.parent, self.attrs = name, parent, None
        self.id, self._live, self.start, self.end = None, live, 0, 0

    def attr(self, key: str, value: Any) -> None:
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    def __enter__(self):
        if self._live:
            state = _thread()
            if self.parent is None:
                self.parent = state[0][-1].id if state[0] else state[2]
            self.id = next(_ids)
            self._tid = state[1]
            state[0].append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        if self._live:
            _thread()[0].pop()
            if _on:
                _record((self.name, self.start, self.end, self.id,
                         self.parent, self._tid, self.attrs))
        return False

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


def span(name: str, parent: Optional[int] = None):
    """A span of the enclosed work, or the shared no-op while the recorder
    is off.  `parent`: a span id from another thread (`current()` there);
    by default the innermost span open on this thread."""
    if not _on:
        return NOOP
    return Span(name, parent, True)


def timed(name: str) -> Span:
    """A span that reads the clock even while the recorder is off, for a
    caller that keeps the interval (`.seconds`, `.start`, `.end`)."""
    return Span(name, None, _on)


def waited(name: str, items: Iterable):
    """The items of `items`, each wait for the next one inside a span
    `name` (the consumer's side of a feed); closing it closes `items`."""
    it = iter(items)
    try:
        while True:
            with span(name):
                try:
                    item = next(it)
                except StopIteration:
                    return
            yield item
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()


def current() -> Optional[int]:
    """The id of the innermost span open on this thread (or the parent it
    adopted), to pass to another thread; None while off."""
    if not _on:
        return None
    state = _thread()
    return state[0][-1].id if state[0] else state[2]


def adopt(parent: Optional[int]) -> None:
    """This thread's spans opened with no span open above them take
    `parent` (a feed thread adopts the span open when its feed began)."""
    if _on:
        _thread()[2] = parent


def enabled() -> bool:
    return _on


def stamp() -> Optional[Tuple[int, int]]:
    """(a fresh request id, now) while on, for a span that another thread
    closes (`emit`); None while off."""
    if not _on:
        return None
    return next(_ids), time.perf_counter_ns()


def emit(name: str, start: int, end: int, parent: Optional[int] = None,
         attrs: Optional[Dict[str, Any]] = None) -> None:
    """Record a span whose clock readings were taken already (a request's
    wait, stamped at submit), on this thread."""
    if _on:
        _record((name, start, end, next(_ids), parent, _thread()[1], attrs))


def enable() -> None:
    """Turn the recorder on, reading the anchor pair (time.time_ns(),
    time.perf_counter_ns()) that `drain` converts times through."""
    global _on, _anchor
    _anchor = (time.time_ns(), time.perf_counter_ns())
    _on = True


def disable() -> None:
    global _on
    _on = False


def drain() -> dict:
    """{"spans": the spans recorded since the last drain, each time on the
    Unix-nanosecond clock; "dropped": the spans past CAPACITY; "threads":
    native id -> pthread id of every thread that opened a span; "anchor":
    the pair the times were converted through}.  Clears the list; call it
    once the work it covers has stopped."""
    global _spans, _dropped
    with _lock:
        items, _spans = _spans, []
        dropped, _dropped = _dropped, 0
    dropped += max(0, len(items) - CAPACITY)
    unix, perf = _anchor
    shift = unix - perf
    return {"spans": [(n, a + shift, b + shift, i, p, t, attrs)
                      for n, a, b, i, p, t, attrs in items[:CAPACITY]],
            "dropped": dropped, "threads": dict(_threads),
            "anchor": _anchor}
