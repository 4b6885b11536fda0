"""Spans and counters inside the port, on the profiler's clock.

``span(name, unit=None)`` marks a stretch of host time in one layer of
the program (every name starts with ``spgan.``).  While tracing is off,
the default, a span is one flag check that returns a shared no-op context
manager: no allocation and no call into torch.profiler, whose
``record_function`` costs more than the smaller spans it would mark.

While tracing is on (``enable()`` .. ``disable()``) each span appends a
record to an in-memory list (name, start and end, the index of the span
it opened inside on the same thread, its unit and thread) and opens
``torch.profiler.record_function(name)``, so a running profiler holds the
same span in its host timeline.  ``unit`` is the batch or iteration the
span belongs to; a span given none takes its parent's.

Stamps are ``time.perf_counter_ns()``; ``records()`` exports them on the
Unix-ns clock of ``time.time_ns()``, the clock of a profiler event's
``start_ns()``, through the offset between the two taken at ``enable()``.

Counters always count: ``count(name, n)`` is a dictionary add under the
tracer's lock, so threads may count at once (`to_uint8` on batch slices
in worker threads), and ``counters()`` returns them (the kernel
wrappers' launches, the engine's batches, the training step's
iterations).
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List

import torch

_NULL = contextlib.nullcontext()
_on = False
_offset = 0          # time.time_ns() - time.perf_counter_ns() at enable()
_spans: List[list] = []  # [name, start, end, parent, unit, thread], perf ns
_lock = threading.Lock()
_open = threading.local()  # .stack: indices of the thread's open spans
_counts: Dict[str, int] = {}


class _Span:
    __slots__ = ("name", "unit", "rec", "fn")

    def __init__(self, name: str, unit):
        self.name, self.unit = name, unit

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        parent = stack[-1] if stack else -1
        unit = self.unit
        if unit is None and parent >= 0:
            unit = _spans[parent][4]
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        # stamped inside the profiler's copy, as close to its ends as can be
        self.rec = [self.name, time.perf_counter_ns(), None, parent, unit,
                    threading.get_ident()]
        with _lock:
            stack.append(len(_spans))
            _spans.append(self.rec)
        return self

    def __exit__(self, *exc):
        self.rec[2] = time.perf_counter_ns()
        _open.stack.pop()
        self.fn.__exit__(*exc)
        return False


def span(name: str, unit=None):
    """A context manager around one stretch of a layer's host time: a
    record while tracing is on, the shared no-op otherwise."""
    if not _on:
        return _NULL
    return _Span(name, unit)


def enable() -> int:
    """Start recording spans; the instant, in Unix ns."""
    global _on, _offset
    _offset = time.time_ns() - time.perf_counter_ns()
    _on = True
    return time.perf_counter_ns() + _offset


def disable() -> int:
    """Stop recording spans (those open still record their end); the
    instant, in Unix ns."""
    global _on
    _on = False
    return time.perf_counter_ns() + _offset


def records() -> List[dict]:
    """Every span recorded since the last reset, in the order opened:
    name, start_ns and end_ns (Unix ns; end None while open), parent (an
    index into this list, -1 for none), unit and thread."""
    with _lock:
        spans = [list(r) for r in _spans]
    return [{"name": n, "start_ns": s + _offset,
             "end_ns": None if e is None else e + _offset,
             "parent": p, "unit": u, "thread": t}
            for n, s, e, p, u, t in spans]


def reset() -> None:
    """Drop every span record and zero every counter.  Call it with no
    span open."""
    with _lock:
        _spans.clear()
        _counts.clear()


def count(name: str, n: int = 1) -> int:
    """Add n to a counter; its new value.  Threads may count at once."""
    with _lock:
        _counts[name] = v = _counts.get(name, 0) + n
    return v


def counters() -> Dict[str, int]:
    with _lock:
        return dict(_counts)
