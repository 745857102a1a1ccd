"""Spans at the port's layer boundaries, on ``torch.profiler``'s timeline.

``span(name)`` is a context manager around a block of host work; it nests
under the span that encloses it on the same thread.  Recording is on while
``torch.profiler`` runs, or from ``enable()`` to ``disable()``; it is off by
default, and then ``span`` costs one flag check: no clock reading, no torch
call.  ``span(name, timed=True)`` also gives the block's host seconds, as
``seconds`` on the object it returns, on or off: a caller that keeps its
own time of a block (``Renderer.phase_s``) takes it from the span's two
clock readings, so the two never disagree.

On, a span records ``(name, parent, start_ns, end_ns)`` on
``time.perf_counter_ns``, at most ``CAP`` records a process; ``parent`` is
the index of the enclosing span's record (-1 for none), ``end_ns`` is None
while the span is open, and the counter ``spans.dropped`` counts the spans
that did not fit (a reader of a window that holds it has lost spans).  The
records are integers in one array (names by their index in a table), so
that a long recording adds no objects for Python's garbage collector to
walk.  While the profiler runs, a span also opens a user-scope record
function of the same name (what ``torch.profiler.record_function(name)``
opens, through torch's direct binding, a few microseconds where the Python
wrapper takes tens): it shows in the profiler's trace as a
``user_annotation`` on the host timeline and a ``gpu_user_annotation`` over
the device work it launched, so the profiler's Chrome trace is its exporter
and shares its clock.  ``count(name, n)`` adds to a counter, on or off: its
callers (the trace routes called ``with_stats``) run off the timed path.
``snapshot()`` returns the records and counters, ``reset()`` clears them.
Nothing here waits on the device.
"""

from __future__ import annotations

import contextlib
import threading
import time
from array import array

import torch
import torch.autograd.profiler as _profiler

CAP = 1 << 18

_enabled = False
_epoch = 0
_records = array("q")  # name index, parent, start_ns, end_ns (-1: open)
_names: list = []
_name_index: dict = {}
_counters: dict = {}
_local = threading.local()
_clock = time.perf_counter_ns
_OFF = contextlib.nullcontext()


def _annotate(name: str):
    """Open the profiler's annotation ``name``; returns its handle."""
    return torch.autograd._record_function_with_args_enter(name)


def _close(handle) -> None:
    torch.autograd._record_function_with_args_exit(handle)


class _Timer:
    """An unrecorded timed span: the block's host seconds alone."""
    __slots__ = ("start", "seconds")

    def __enter__(self):
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        self.seconds = (_clock() - self.start) * 1e-9
        return False


class _Span:
    __slots__ = ("name", "epoch", "idx", "handle", "start", "seconds")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        top = stack[-1] if stack else None
        parent = top.idx if top is not None and top.epoch == _epoch else -1
        self.epoch, self.idx, self.handle = _epoch, -1, None
        stack.append(self)
        if len(_records) < 4 * CAP:
            name = _name_index.get(self.name)
            if name is None:
                name = _name_index[self.name] = len(_names)
                _names.append(self.name)
            self.idx = len(_records) // 4
            _records.extend((name, parent, -1, -1))
        else:
            count("spans.dropped", 1)
        # The clock readings enclose the annotation, next to it: most of
        # what the profiler spends opening and closing one lies between its
        # own two stamps, so inside both.
        self.start = _clock()
        if self.idx >= 0:
            _records[4 * self.idx + 2] = self.start
        if _profiler._is_profiler_enabled:
            self.handle = _annotate(self.name)
        return self

    def __exit__(self, *exc):
        if self.handle is not None:
            _close(self.handle)
        end = _clock()
        self.seconds = (end - self.start) * 1e-9
        if self.idx >= 0 and self.epoch == _epoch:
            _records[4 * self.idx + 3] = end
        _local.stack.pop()
        return False


def span(name: str, timed: bool = False):
    """A context manager that records the block as the span ``name``; with
    ``timed``, whose ``seconds`` holds the block's host seconds after it."""
    if _enabled or _profiler._is_profiler_enabled:
        return _Span(name)
    return _Timer() if timed else _OFF


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name``, whether or not spans are recording."""
    _counters[name] = _counters.get(name, 0) + int(n)


def snapshot() -> dict:
    """``{"spans": [(name, parent, start_ns, end_ns), ...], "counters":
    {name: count}}``, copies of what was recorded since the last reset."""
    r = _records
    spans = [(_names[r[i]], r[i + 1], r[i + 2], r[i + 3] if r[i + 3] >= 0 else None)
             for i in range(0, len(r), 4)]
    return {"spans": spans, "counters": dict(_counters)}


def reset() -> None:
    """Clear the records and counters; spans open now record nothing more."""
    global _epoch
    _epoch += 1
    del _records[:]
    _counters.clear()
