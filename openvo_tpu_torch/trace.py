"""The port's own trace: spans and counters at the API's boundaries and the
device's stage times inside a captured step, all on the host clock
(``time.perf_counter_ns``), kept in memory.

Records go into one bounded ring (:data:`CAPACITY`; the oldest go first,
:func:`dropped` counts them) and :func:`records` hands them out. A
:class:`Record` is

- a span (``ovo.*``): a stretch of host time, its enclosing span
  (``parent``) and the API call it belongs to (``call``: every span of one
  ``update`` or one ``stream`` call shares the id of its outermost span);
- a counter (``ovo.fallback``, ``ovo.library_builds``): ``start == end``,
  its increment in ``n``;
- a device segment (``dev.*``): ``dev.step``, a captured step's device
  interval from its graph's first node to its last, its parent the
  ``ovo.launch`` span that replayed the graph; and one record a stage,
  ``dev.<stage>``, from the mark before it to its own mark, its parent the
  ``dev.step``.

Recording is on while :func:`enable` is in effect or while
``torch.profiler`` records (one read of the profiler's module flag), so a
profiled window is recorded without a call here. Off, :func:`span` hands
back one shared null context and :func:`count` returns at once: no
allocation and no clock read. The spans of a graph's capture and of the
kernel library's load are recorded even when off (``always=True``): they
happen once per graph and per process, in set-up, before any window.

Why not ``torch.profiler.record_function``: the profiler mirrors its
ranges onto the device's timeline, where they would count as device
operations, so the program's spans stay out of the profiler.

Device marks: while a captured step (``_graph.CapturedStep``) is being
captured, ``_graph.mark(stage)`` records a timing CUDA event on the
capture stream, which becomes an event-record node of the graph; each mark
ends the stage it names, begun at the mark before it. After a replay the
events hold that replay's device times. They are read only while
recording, and never with a wait while off: at a point where the program
knows the replay is done (:func:`settle`, after the sync it already
makes), else before the graph's next replay (:func:`launched`), else in
:func:`records`; a replay's marks in one native call (``csrc/events.cu``).
An anchor places them on the host clock: a timing event recorded on a
stream that runs nothing else, with the host clock read right after; a
mark's host time is the anchor's plus the events' elapsed time.
:func:`settle` takes a new anchor after a sync once the last is 100 ms
old.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import itertools
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler

CAPACITY = 2 ** 16
ANCHOR_NS = 100_000_000   # an anchor's life: the card's clock and the
                          # host's drift apart by microseconds in a second


class Record(NamedTuple):
    name: str
    start: int     # perf_counter_ns
    end: int
    id: int
    parent: int    # the enclosing record's id, -1 at the top
    call: int      # the API call's id (its outermost span's), -1 none
    n: int = 0     # a counter's increment


_NOT_READY = 600   # cudaErrorNotReady


class Marks:
    """A captured graph's stage marks: the stages' names, their timing
    events, and the events' raw handles behind a slot for the anchor's,
    for one native read a replay (``csrc/events.cu``)."""

    def __init__(self, marks):
        self.stages = [stage for stage, _ in marks]
        self.events = [event for _, event in marks]
        self.handles = (ctypes.c_void_p * (len(marks) + 1))(
            None, *(e.cuda_event for e in self.events))
        self.ms = (ctypes.c_float * len(marks))()


class _Trace:
    """The process's trace (one, :data:`_T`)."""

    def __init__(self):
        self.ring = collections.deque(maxlen=CAPACITY)
        self.added = 0
        self.ids = itertools.count()
        self.local = threading.local()   # each thread's open spans
        self.on = False
        self.pending = collections.deque()   # replays whose marks are unread
        self.anchors = {}    # card index -> (event, host ns)
        self.streams = {}    # card index -> the stream the anchors run on

    def stack(self) -> list:
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack

    def add(self, name, start, end, parent, call, n=0) -> int:
        rid = next(self.ids)
        self.ring.append((name, start, end, rid, parent, call, n))
        self.added += 1
        return rid

    def anchor(self, device, fresh: bool):
        """``device``'s anchor: the last one, or (where there is none,
        or it is :data:`ANCHOR_NS` old and ``fresh``) a new one, recorded
        on the card's anchor stream and waited for (the stream is idle: a
        few microseconds), so that it is done before any mark read
        against it."""
        index = device.index
        if index is None:
            index = torch.cuda.current_device()
        last = self.anchors.get(index)
        if last is not None and not (
                fresh and time.perf_counter_ns() - last[1] > ANCHOR_NS):
            return last
        stream = self.streams.get(index)
        if stream is None:
            stream = self.streams[index] = torch.cuda.Stream(index)
        event = torch.cuda.Event(enable_timing=True)
        event.record(stream)
        self.anchors[index] = new = (event, time.perf_counter_ns())
        event.synchronize()
        return new

    def read(self, wait: bool) -> None:
        """Turn the queued replays' marks into records, oldest first; with
        ``wait`` false only those whose device work is done."""
        from openvo_tpu_torch import _build

        while self.pending:
            marks, (anchor, ns), parent, call = self.pending[0]
            if wait:
                marks.events[-1].synchronize()
            marks.handles[0] = anchor.cuda_event
            err = _build.library().ovo_event_times(
                marks.handles, len(marks.handles), marks.ms)
            if err == _NOT_READY and not wait:
                return
            _build.check_launch(err, "event_times")
            self.pending.popleft()
            t = [ns + round(ms * 1e6) for ms in marks.ms]
            sid = self.add("dev.step", t[0], t[-1], parent, call)
            for stage, a, b in zip(marks.stages[1:], t, t[1:]):
                self.add("dev." + stage, a, b, sid, call)


_T = _Trace()


def recording() -> bool:
    """Whether spans and counters are recorded now."""
    return _T.on or _profiler._is_profiler_enabled


def enable() -> None:
    """Record from now on, until :func:`disable`."""
    _T.on = True


def disable() -> None:
    """Stop recording (a running ``torch.profiler`` still records)."""
    _T.on = False


class _Span:
    __slots__ = ("name", "start", "id", "parent", "call")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        stack = _T.stack()
        self.id = next(_T.ids)
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.parent, self.call = -1, self.id
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _T.stack().pop()
        _T.ring.append((self.name, self.start, end, self.id, self.parent,
                        self.call, 0))
        _T.added += 1
        return False


_NULL = contextlib.nullcontext()


def span(name: str, always: bool = False):
    """A context that records the stretch of host time it encloses as a
    span named ``name``, nested in the span open around it; while not
    recording (unless ``always``) the shared null context."""
    if not (always or recording()):
        return _NULL
    return _Span(name)


def count(name: str, n: int = 1, always: bool = False) -> None:
    """Record counter ``name`` going up by ``n``, in the span open around
    it."""
    if not (always or recording()):
        return
    t = time.perf_counter_ns()
    stack = _T.stack()
    parent, call = (stack[-1].id, stack[-1].call) if stack else (-1, -1)
    _T.add(name, t, t, parent, call, n)


def launched(marks, device) -> None:
    """Just before a captured step's graph with ``marks`` (:class:`Marks`,
    or None) is replayed on ``device``, inside its ``ovo.launch``
    span: its last replay's marks are read first, since the replay
    records the events anew (waiting for them only while recording;
    while off, marks not done yet are let go), and, while recording, this
    replay's are queued, with the anchor they will be read against."""
    if not marks:
        return
    on = recording()
    if _T.pending and any(p[0] is marks for p in _T.pending):
        _T.read(wait=on)
        if not on:
            _T.pending = collections.deque(p for p in _T.pending
                                           if p[0] is not marks)
    if not on:
        return
    stack = _T.stack()
    parent, call = (stack[-1].id, stack[-1].call) if stack else (-1, -1)
    _T.pending.append((marks, _T.anchor(device, False), parent, call))


def settle(device) -> None:
    """After a sync the program makes on ``device``: read the marks of the
    replays that are done and, while recording on the card, take a new
    anchor once the last is :data:`ANCHOR_NS` old (while off, drop it)."""
    if _T.pending:
        _T.read(wait=False)
    if not recording():
        if _T.anchors:
            _T.anchors.clear()
    elif device.type == "cuda":
        _T.anchor(device, True)


def records() -> list[Record]:
    """Every record the ring holds, oldest first (the marks of replays
    not read yet are read first, waiting for their device work)."""
    _T.read(wait=True)
    return [Record._make(r) for r in _T.ring]


def dropped() -> int:
    """Records the ring let go since the last :func:`clear`."""
    return _T.added - len(_T.ring)


def clear() -> None:
    """Forget every record, queued mark and anchor."""
    _T.ring.clear()
    _T.pending.clear()
    _T.added = 0
    _T.anchors.clear()
