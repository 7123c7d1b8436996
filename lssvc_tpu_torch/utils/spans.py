"""Spans of the port's frame loops: one in-process recorder.

A span is a named interval of one thread's work at a layer boundary
(the serving drivers, the models' stages, the entropy coder, and each
place where the host waits for the card or for the worker).  Each record
holds its name, its id, the id of the span that caused it (the enclosing
span on its thread, or for a worker's outermost span the span that
submitted the work), the id of its frame, its thread, its start and end
on `time.perf_counter_ns`, and for a frame span the thread's CPU time at
both (`time.thread_time_ns`; None elsewhere: that clock is a system
call, which costs far more than the rest of a span).

  * `span(name)`: a context manager.  While the recorder is off it is a
    shared no-op object, one check.  `wait(name, on_card)`: a wait for the
    card, a span only where there is a card to wait for.
  * `frame(name)`: a frame's outermost span (`lssvc.p.encode`,
    `lssvc.p.decode`, `lssvc.i.encode`, `lssvc.i.decode`); it takes a
    fresh frame id, which every span of the frame carries, on any thread.
  * `Span(name)`: a span made whether the recorder is on or not; it goes
    to the ring only while the recorder is on (the decoders keep their
    stage spans and fold their `--decoding_profiling` dicts from them).
  * `carry(fn)`: made on the submitting thread at `pool.submit` time, it
    hands the frame id and the submitting span to the worker that runs
    `fn`.

The recorder is on while a `torch.profiler` session records (its active
steps; a schedule's warm-up steps do not record) and after `enable()`.
Records go to a ring of `CAPACITY` records, the oldest dropped and
counted past it; `snapshot()` returns them, `clear()` empties it.  While
the profiler records, each span is also a `record_function` range, so the
program's spans sit on the device trace's clock beside the kernels they
launch, and the profiler's own export carries them.

No span synchronises, copies or allocates on the device: spans change
nothing that runs.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import torch.autograd.profiler as _profiler

# records kept; a traced GOP of the two-layer decoder holds about 2,000
CAPACITY = 1 << 16

_enabled = False
_ring: collections.deque = collections.deque(maxlen=CAPACITY)
_appended = 0
_lock = threading.Lock()
_span_ids = itertools.count(1)
_frame_ids = itertools.count(1)
# per thread: `stack` (the open spans), `frame` (the frame id), `origin`
# (a carried submitting span's id)
_tls = threading.local()


def enable(on: bool = True) -> None:
    """Record every span from now on (`enable(False)`: only while the
    profiler records)."""
    global _enabled
    _enabled = bool(on)


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class Span:
    """One span, open or ended (module docstring)."""

    __slots__ = ("name", "id", "parent", "frame", "thread", "start_ns",
                 "end_ns", "cpu_start_ns", "cpu_end_ns", "_new_frame",
                 "_saved", "_range", "_to_ring")

    def __init__(self, name, new_frame=False):
        self.name = name
        self._new_frame = new_frame
        self.cpu_start_ns = self.cpu_end_ns = None

    def __enter__(self):
        tls = _tls
        stack = getattr(tls, "stack", None)
        if stack is None:
            stack = tls.stack = []
            tls.frame = tls.origin = None
        self.id = next(_span_ids)
        self.parent = stack[-1].id if stack else tls.origin
        self.thread = threading.get_ident()
        if self._new_frame:
            self._saved = tls.frame
            tls.frame = next(_frame_ids)
        self.frame = tls.frame
        profiling = _profiler._is_profiler_enabled
        self._to_ring = _enabled or profiling
        self._range = None
        if profiling:
            self._range = _profiler.record_function(self.name)
            self._range.__enter__()
        stack.append(self)
        if self._new_frame:
            self.cpu_start_ns = time.thread_time_ns()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _appended
        self.end_ns = time.perf_counter_ns()
        if self._new_frame:
            self.cpu_end_ns = time.thread_time_ns()
        tls = _tls
        tls.stack.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        if self._to_ring:
            with _lock:
                _ring.append(self)
                _appended += 1
        if self._new_frame:
            tls.frame = self._saved
        return False

    def record(self) -> dict:
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "frame": self.frame, "thread": self.thread,
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "cpu_start_ns": self.cpu_start_ns,
                "cpu_end_ns": self.cpu_end_ns}

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def span(name: str):
    """A span of the current thread (module docstring)."""
    if _enabled or _profiler._is_profiler_enabled:
        return Span(name)
    return _NOOP


def wait(name: str, on_card: bool):
    """`span(name)` (a `lssvc.wait.*`) where the host waits for the card
    (`on_card`), else the shared no-op object."""
    if on_card and (_enabled or _profiler._is_profiler_enabled):
        return Span(name)
    return _NOOP


def frame(name: str):
    """A frame's outermost span (module docstring)."""
    if _enabled or _profiler._is_profiler_enabled:
        return Span(name, new_frame=True)
    return _NOOP


def carry(fn):
    """`fn` for a worker: its spans carry the current frame id, and its
    outermost ones name the current span as their parent.  Made on the
    submitting thread; `fn` itself while no span is open there."""
    stack = getattr(_tls, "stack", None)
    if not stack:
        return fn
    frame_id, origin = _tls.frame, stack[-1].id

    def carried(*args, **kwargs):
        tls = _tls
        if getattr(tls, "stack", None) is None:
            tls.stack = []
            tls.frame = tls.origin = None
        saved = (tls.frame, tls.origin)
        tls.frame, tls.origin = frame_id, origin
        try:
            return fn(*args, **kwargs)
        finally:
            tls.frame, tls.origin = saved

    return carried


def snapshot() -> dict:
    """{"spans": the ring's records (dicts, in the order they ended),
    "dropped": the records dropped past `CAPACITY` since the last
    `clear()`}."""
    with _lock:
        spans = list(_ring)
        dropped = _appended - len(spans)
    return {"spans": [s.record() for s in spans], "dropped": dropped}


def clear() -> None:
    global _appended
    with _lock:
        _ring.clear()
        _appended = 0
