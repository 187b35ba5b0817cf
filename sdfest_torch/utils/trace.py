"""Spans and device marks of the port: where a call's host time and its
device time go, on the host's clock.

Off by default.  ``with trace.recording() as rec:`` turns it on in this
process, and ``rec`` holds what was recorded once the block has closed::

    with trace.recording() as rec:
        for frame in frames:
            pipe(frame.depth, frame.mask)
    rec.spans   # Span(id, name, start_ns, end_ns, parent, call, kind)
    rec.marks   # Mark(name, t_ns, span, call, graph), sorted by time

Off, an instrumented site costs one test of the module's ``on``: no clock
read, no CUDA event, no ``record_function``, no graph node.

- *Spans* (:func:`span`) carry a name, start and end on
  ``time.perf_counter_ns()``, the id of the span they opened in, and the
  id of their call: the outermost ``call`` span gives its id to every span
  inside it.  They are kept in a ring of :data:`CAPACITY` (the oldest
  dropped and counted in ``rec.dropped``; eager marks in a ring of their
  own, ``rec.dropped_marks``), so tracing can stay on.
- *Marks* (:func:`mark`) are timing ``torch.cuda.Event``s on the current
  stream, resolved after one ``synchronize()`` when the recording closes
  and put on the host's clock between two anchors (an event and a host
  read at the recording's start and end; ``rec.drift_ns`` is how far the
  device's clock and the host's part over the recording).  Outside a graph
  a mark takes an event from a pool; in a body that a graph captures
  (:func:`capturing`) it is an ``external`` event node, which every replay
  rewrites, so it is read from the graph's last replay (``Mark.graph``).
- While a ``torch.profiler`` records, each span is also a
  ``record_function`` range: the profiler's trace shows the program's
  spans beside the kernels.

One thread drives the program while a recording is open.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

# spans (and eager marks) a recording keeps before it drops the oldest
CAPACITY = 1 << 16
# added to the key of a graph captured while recording: its nodes hold marks
KEY = "trace.marks"

on = False
_rec: Optional["Record"] = None
_pool: List = []  # timing events of closed recordings, to reuse


class Span(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int  # the id of the span it opened in, 0 at the top
    call: int  # the id of its outermost ``call`` span, 0 outside calls
    kind: str = ""


class Mark(NamedTuple):
    name: str
    t_ns: int  # when the device reached it, on the host's clock
    span: int  # the innermost span open at the mark (at the replay)
    call: int
    graph: int  # 0 for an eager mark, else the number of its graph


class Record:
    """What one recording holds; ``marks`` and ``drift_ns`` are filled
    when it closes."""

    def __init__(self, device: Optional[torch.device]):
        self.spans: collections.deque = collections.deque(maxlen=CAPACITY)
        self.dropped = 0
        self.dropped_marks = 0
        self.marks: List[Mark] = []
        self.drift_ns = 0
        self.device = device
        self._open: List[Tuple[int, int]] = []  # (id, call) of open spans
        self._next = 1
        self._eager: collections.deque = collections.deque(maxlen=CAPACITY)
        self._replays: Dict[int, Tuple[int, int, int, list]] = {}
        self._capture: Optional[list] = None
        self._anchors: List[Tuple[object, int]] = []

    def _where(self) -> Tuple[int, int]:
        return self._open[-1] if self._open else (0, 0)

    def _anchor(self) -> None:
        """An event and the host's clock at one instant: the middle of the
        host's ``record`` call on an idle device (an event recorded and
        waited for first takes the path's first-use costs)."""
        stream = torch.cuda.current_stream(self.device)
        for _ in range(2):
            torch.cuda.synchronize(self.device)
            event = torch.cuda.Event(enable_timing=True)
            before = time.perf_counter_ns()
            event.record(stream)
            after = time.perf_counter_ns()
        torch.cuda.synchronize(self.device)
        self._anchors.append((event, (before + after) // 2))

    def _close(self) -> None:
        """Resolve every mark onto the host's clock (after the closing
        anchor's synchronize)."""
        if self.device is None:
            return
        self._anchor()
        (a0, h0), (a1, h1) = self._anchors
        device_ns = a0.elapsed_time(a1) * 1e6
        self.drift_ns = int(h1 - h0 - device_ns)
        scale = (h1 - h0) / device_ns if device_ns > 0 else 1.0
        host = lambda e: h0 + int(a0.elapsed_time(e) * 1e6 * scale)
        marks = [Mark(name, host(e), s, c, 0)
                 for name, e, s, c in self._eager]
        _pool.extend(e for _, e, _, _ in self._eager)
        for number, s, c, graph_marks in self._replays.values():
            marks += [Mark(name, host(e), s, c, number)
                      for name, e in graph_marks]
        self.marks = sorted(marks, key=lambda m: m.t_ns)
        self._eager.clear()
        self._replays.clear()


class _Span:
    """A span's context; ``seconds`` is its duration after it closes.  With
    ``marks`` it records ``<name>.begin`` and ``<name>.end`` too."""

    __slots__ = ("name", "kind", "marks", "rec", "where", "start_ns",
                 "end_ns", "_range")

    def __init__(self, name: str, kind: str = "", marks: bool = False):
        self.name, self.kind, self.marks = name, kind, marks

    def __enter__(self) -> "_Span":
        rec = self.rec = _rec if on else None
        if rec is not None:
            parent, call = rec._where()
            sid, rec._next = rec._next, rec._next + 1
            if not call and self.name == "call":
                call = sid
            self.where = (sid, parent, call)
            rec._open.append((sid, call))
            self._range = None
            if torch.autograd.profiler._is_profiler_enabled:
                self._range = torch.profiler.record_function(self.name)
                self._range.__enter__()
            if self.marks:
                mark(self.name + ".begin")
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        rec = self.rec
        if rec is None:
            return
        if self.marks:
            mark(self.name + ".end")
        if self._range is not None:
            self._range.__exit__(*exc)
        rec._open.pop()
        if len(rec.spans) == rec.spans.maxlen:
            rec.dropped += 1
        sid, parent, call = self.where
        rec.spans.append(Span(sid, self.name, self.start_ns, self.end_ns,
                              parent, call, self.kind))

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


_OFF = contextlib.nullcontext()


def span(name: str, kind: str = "", marks: bool = False):
    """A span around a ``with`` block (nothing when off)."""
    return _Span(name, kind, marks) if on else _OFF


def timed(name: str) -> _Span:
    """A span that reads the clock when off too, for a caller that keeps
    the duration (``.seconds``)."""
    return _Span(name)


def call(kind: str):
    """Decorate an entry point as a call: a ``call`` span of ``kind``
    with the marks ``call.begin`` and ``call.end`` around its work."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not on:
                return fn(*args, **kwargs)
            with _Span("call", kind, marks=True):
                return fn(*args, **kwargs)
        return traced
    return wrap


def mark(name: str) -> None:
    """A device mark on the current stream (nothing off the card)."""
    if not on or _rec.device is None:
        return
    rec = _rec
    if torch.cuda.is_current_stream_capturing():
        if rec._capture is not None:
            event = torch.cuda.Event(enable_timing=True, external=True)
            event.record()
            rec._capture.append((name, event))
        return
    event = _pool.pop() if _pool else torch.cuda.Event(enable_timing=True)
    event.record()
    if len(rec._eager) == rec._eager.maxlen:
        rec.dropped_marks += 1
    rec._eager.append((name, event, *rec._where()))


@contextlib.contextmanager
def capturing():
    """Collect the marks of a body being captured into the list this
    yields (empty when off); :func:`replayed` reads them per replay."""
    marks: list = []
    rec = _rec if on else None
    if rec is None:
        yield marks
        return
    saved, rec._capture = rec._capture, marks
    try:
        yield marks
    finally:
        rec._capture = saved


def replayed(marks: list) -> None:
    """A graph holding ``marks`` was just launched: its marks now time
    this replay, in the innermost open span and call."""
    if on and marks:
        rec = _rec
        number = rec._replays.get(id(marks), (len(rec._replays) + 1,))[0]
        rec._replays[id(marks)] = (number, *rec._where(), marks)


@contextlib.contextmanager
def recording():
    """Turn tracing on inside the block; yields the :class:`Record`.
    Marks go to the current CUDA device (none without CUDA)."""
    global on, _rec
    if on:
        raise RuntimeError("a trace recording is already open")
    device = (torch.device("cuda", torch.cuda.current_device())
              if torch.cuda.is_available() else None)
    rec = Record(device)
    if device is not None:
        rec._anchor()
    _rec, on = rec, True
    try:
        yield rec
    finally:
        on, _rec = False, None
        rec._close()
