"""The port's spans and counters: where the host's time goes inside the
program, on ``time.perf_counter_ns``.

Counters are always on, one dict increment under a lock each::

    trace.count("engine.leaf_tables")
    trace.counter("engine.leaf_tables")     # -> int, 0 if never counted
    trace.counters()                        # a snapshot of every counter
    trace.reset_counters("thundering_")     # drop those with the prefix

Spans are off by default.  Off, ``span`` returns one shared object that
does nothing: no clock, no lock, no allocation, no CUDA event.  On, each
span appends one ``Span`` to an in-memory list when it closes, with its
thread, its parent (the innermost span open on the same thread) and an
optional ``key`` that ties spans of one unit of work across threads (a
lease's ``lo``, a train step)::

    trace.enable()
    with trace.span("train.update", key=step, device=dev):
        ...
    trace.disable()
    for s in trace.drain():                 # clears the list
        print(s.name, s.thread, s.parent, s.key, s.ms, s.device_ms)

A span given a CUDA ``device`` also records a pair of timing events on
that device's current stream; ``drain`` waits for them and fills
``device_ms``.  The module imports nothing of the package, so any module
of the port can use it.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional, Tuple, Union

_counters: Dict[str, int] = {}
_counters_lock = threading.Lock()
_records: List["Span"] = []
_on = False
_ids = itertools.count(1)
_local = threading.local()


# ---------------------------------------------------------------------------
# Counters
# ---------------------------------------------------------------------------

def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (from any thread)."""
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + n


def counter(name: str) -> int:
    """The value of counter ``name`` (0 if never counted)."""
    return _counters.get(name, 0)


def counters() -> Dict[str, int]:
    """A snapshot of every counter."""
    return dict(_counters)


def reset_counters(prefix: Union[str, Tuple[str, ...]] = "") -> None:
    """Drop the counters whose name starts with ``prefix`` (a string or a
    tuple of them; "" drops all)."""
    with _counters_lock:
        for name in [k for k in _counters if k.startswith(prefix)]:
            del _counters[name]


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

def _stack() -> List["Span"]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One span: ``name``, ``thread`` (its thread's name), ``id``,
    ``parent`` (id of the innermost span open on the same thread when it
    opened, else None), ``key``, ``start_ns`` / ``end_ns`` on
    ``time.perf_counter_ns`` and, for a span timed on a card, ``device_ms``
    once drained.  ``key`` may be set inside the span (a lease's ``lo`` is
    known only after the lease)."""

    __slots__ = ("name", "thread", "id", "parent", "key", "start_ns",
                 "end_ns", "device_ms", "_events")

    def __init__(self, name: str, key: Any, events):
        self.name, self.key, self._events = name, key, events
        self.id = next(_ids)
        self.parent: Optional[int] = None
        self.thread = ""
        self.start_ns = self.end_ns = 0
        self.device_ms: Optional[float] = None

    def __enter__(self) -> "Span":
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        self.thread = threading.current_thread().name
        stack.append(self)
        if self._events is not None:
            self._events[0].record(self._events[2])
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[1].record(self._events[2])
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:         # a span closed out of nesting order
            stack.remove(self)
        _records.append(self)       # atomic under the interpreter lock
        return False

    @property
    def ms(self) -> float:
        """The span's host time, ms."""
        return (self.end_ns - self.start_ns) * 1e-6

    def _resolve(self) -> None:
        if self._events is not None:
            start, end, _ = self._events
            end.synchronize()
            self.device_ms = start.elapsed_time(end)
            self._events = None

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, thread={self.thread!r}, id={self.id}, "
                f"parent={self.parent}, key={self.key!r}, ms={self.ms:.4f}, "
                f"device_ms={self.device_ms})")


class _Off:
    """The span of a disabled tracer: one shared object doing nothing."""

    __slots__ = ()
    key = property(lambda self: None, lambda self, value: None)

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def _events(device):
    """(start, end, stream) timing events on ``device``'s current stream,
    or None off a card."""
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        return None
    stream = torch.cuda.current_stream(device)
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True), stream)


def span(name: str, key: Any = None, device=None):
    """A context manager timing its block as span ``name``; ``device``,
    the device the block's work runs on, adds CUDA events on a card."""
    if not _on:
        return _OFF
    return Span(name, key, None if device is None else _events(device))


def enable() -> None:
    """Record spans from now on (every thread)."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording spans; those recorded stay until ``drain``."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def drain() -> List[Span]:
    """The closed spans recorded so far, in closing order, with
    ``device_ms`` resolved; the list is cleared."""
    n = len(_records)
    out = _records[:n]
    del _records[:n]            # spans closing meanwhile stay for later
    for s in out:
        s._resolve()
    return out
