"""Spans: named intervals of the port's host work, one API for every layer.

``span(name)`` is a context manager around a piece of work (the names, by
layer, are listed in PERF.md §3). Off, as by default, it returns one shared
context that does nothing: two flag tests, no allocation, no clock read, no
device call.

Recording is on between ``start()`` and ``stop()``, and while a torch
profiler runs (so a profiled window carries the program's spans with no
switch of its own). Each span that closes then appends ``(name, thread id,
depth, t0_ns, t1_ns)`` to the process's record: depth counts the spans open
around it on its thread, and the times are ``time.perf_counter_ns()``, the
host clock a profiler window is anchored to. ``recorded()`` reads the record
so far; ``stop()`` returns it and ends recording; ``start()`` begins a new
one. While a profiler runs, a span also opens
``torch.profiler.record_function(name)``, which the profiler keeps as a
range when it records CPU activity (``chip_smoke.py`` reads the train
stages so); with CUDA activity alone it keeps nothing.

Event mode (``timed``) is for per-stage device times: inside its block,
each span the calling thread opens also marks its two edges with CUDA
events on the current stream (on the card) or host clock readings (on the
CPU); ``DFANERF_DEBUG_HIER_T``'s ``[hier:t]`` line is built from them.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Iterator, List, Tuple

import torch
from torch.autograd import profiler as _profiler

Span = Tuple[str, int, int, int, int]  # name, thread id, depth, t0 ns, t1 ns
Mark = Tuple[str, int, object, object]  # name, depth, start edge, end edge (event mode)


class _Off:
    """The shared span of recording off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()

_record: List[Span] = []
_started = False
_timing = 0     # threads inside a ``timed`` block
_on = False     # _started or _timing: spans are not OFF
_lock = threading.Lock()
_thread = threading.local()  # depth; marks and cuda inside ``timed``


def span(name: str):
    """A context manager around the work named ``name`` (see the module
    docstring)."""
    if not (_on or _profiler._is_profiler_enabled):
        return OFF
    return _Span(name)


class _Span:
    __slots__ = ("name", "depth", "t0", "edge0", "ranged")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        local = _thread
        self.depth = getattr(local, "depth", 0)
        local.depth = self.depth + 1
        marks = getattr(local, "marks", None)
        self.edge0 = None if marks is None else _edge(local.cuda)
        self.ranged = None
        if _profiler._is_profiler_enabled:
            self.ranged = _profiler.record_function(self.name)
            self.ranged.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.ranged is not None:
            self.ranged.__exit__(*exc)
        local = _thread
        local.depth = self.depth
        marks = getattr(local, "marks", None)
        if marks is not None and self.edge0 is not None:
            marks.append((self.name, self.depth, self.edge0, _edge(local.cuda)))
        if _started or _profiler._is_profiler_enabled:
            _record.append((self.name, threading.get_ident(), self.depth, self.t0, t1))
        return False


def _set_on():
    global _on
    _on = _started or _timing > 0


def start() -> None:
    """Begin a new record: every span that closes from now on is kept."""
    global _record, _started
    with _lock:
        _record = []
        _started = True
        _set_on()


def stop() -> List[Span]:
    """End recording; return the record, in the order the spans closed."""
    global _record, _started
    with _lock:
        out, _record = _record, []
        _started = False
        _set_on()
    return out


def recorded() -> List[Span]:
    """The record so far (spans recorded while a profiler ran included),
    without ending it."""
    return list(_record)


def _edge(cuda: bool):
    if cuda:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter_ns()


def elapsed_ms(a, b) -> float:
    """Milliseconds from edge ``a`` to the later edge ``b`` of event mode
    (CUDA events: waits for ``b``)."""
    if isinstance(a, int):
        return (b - a) * 1e-6
    b.synchronize()
    return a.elapsed_time(b)


@contextmanager
def timed(cuda: bool) -> Iterator[List[Mark]]:
    """Event mode for this thread's spans inside the block: yields the list
    that receives (name, depth, start edge, end edge) of each span as it
    closes; edges are CUDA events recorded on the current stream when
    ``cuda``, else ``perf_counter_ns`` readings (``elapsed_ms`` reads
    them)."""
    global _timing
    local = _thread
    marks: List[Mark] = []
    outer = getattr(local, "marks", None), getattr(local, "cuda", False)
    local.marks, local.cuda = marks, cuda
    with _lock:
        _timing += 1
        _set_on()
    try:
        yield marks
    finally:
        with _lock:
            _timing -= 1
            _set_on()
        local.marks, local.cuda = outer
