"""The port's own spans: where the train step's and the loader's time goes.

:class:`span` marks a stage of the program (``step.forward``,
``loader.wait``, ...). It records only while a ``torch.profiler`` records
on the calling thread (``--profile-steps``, the benchmark's traced run);
otherwise it costs a flag check and records nothing. While it records it
also opens a record function named ``speecht.<name>`` (torch's fast one:
an operator in torch traces, beside the kernels it launches, with no range
of its own on the device's timeline), and appends a :class:`Span` to the
process-wide :data:`LOG` when it closes.

The times are ``time.time_ns()``, the Unix-epoch clock the profiler's
events are stamped in. The loader's thread is not seen by a profiler
started on the main thread, so it cannot ask whether to record: it
stamps its stages with the same clock, and the consumer moves them into
the log with :meth:`SpanLog.add` when it takes the batch, while recording
(``data/pipeline.py``).

The log is bounded: past :data:`CAPACITY` spans it drops the oldest and
counts them (``dropped``, ``dropped_until_ns``), so a reader can tell a
window it holds whole from one it lost the start of.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import torch
from torch._C._profiler import _RecordFunctionFast

PREFIX = "speecht."
# a 51-s benchmark window holds ~420 steps of ~4 main-thread and ~4 loader
# spans; four times that
CAPACITY = 16384


class Span(NamedTuple):
    name: str
    thread: int  # threading.get_native_id(): the thread id torch traces show
    start_ns: int
    end_ns: int
    id: int
    parent: int | None  # the span open on the same thread when this one opened
    batch: int | None  # the loader's sequence number of the batch, where known


class SpanLog:
    """A bounded in-memory log of spans, oldest dropped first."""

    def __init__(self, capacity: int = CAPACITY):
        self._spans: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self.dropped = 0
        self.dropped_until_ns = None  # the latest end of a dropped span

    def new_id(self) -> int:
        with self._lock:
            return next(self._ids)

    def add(self, name: str, thread: int, start_ns: int, end_ns: int,
            parent: int | None = None, batch: int | None = None,
            span_id: int | None = None) -> int:
        """Appends a span; returns its id."""
        if span_id is None:
            span_id = self.new_id()
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                old = self._spans[0]
                self.dropped += 1
                self.dropped_until_ns = max(self.dropped_until_ns or old.end_ns, old.end_ns)
            self._spans.append(Span(name, thread, start_ns, end_ns, span_id, parent, batch))
        return span_id

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)


LOG = SpanLog()
_open = threading.local()  # .stack: ids of this thread's open spans


def recording() -> bool:
    """Whether a ``torch.profiler`` records on the calling thread."""
    return torch.autograd._profiler_enabled()


class span:
    """``with span("step.forward"):`` -- one stage of the program.

    ``clock=True`` stamps ``start_ns``/``end_ns`` even when nothing
    records, for a caller that uses the duration itself (``seconds``).
    ``batch`` may be set inside the block, once the batch is known.
    """

    __slots__ = ("name", "batch", "clock", "start_ns", "end_ns", "_id", "_parent", "_rf")

    def __init__(self, name: str, batch: int | None = None, clock: bool = False):
        self.name, self.batch, self.clock = name, batch, clock
        self._rf = None

    def __enter__(self) -> "span":
        if recording():
            stack = _stack()
            self._parent = stack[-1] if stack else None
            self._id = LOG.new_id()
            stack.append(self._id)
            self._rf = _RecordFunctionFast(PREFIX + self.name)
            self._rf.__enter__()
            self.start_ns = time.time_ns()
        elif self.clock:
            self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self._rf is None:
            if self.clock:
                self.end_ns = time.time_ns()
            return False
        self.end_ns = time.time_ns()
        self._rf.__exit__(*exc)
        self._rf = None
        _stack().pop()
        LOG.add(self.name, threading.get_native_id(), self.start_ns, self.end_ns,
                self._parent, self.batch, span_id=self._id)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


def add_to_chrome_trace(path: str, first_id: int) -> int:
    """Writes into the Chrome trace at ``path`` the spans of other threads
    that the log gained from id ``first_id`` on (the loader's, which the
    profiler of this thread does not see; this thread's spans are in the
    trace already, as operators). Returns how many it wrote."""
    me = threading.get_native_id()
    added = [s for s in LOG.spans() if s.id >= first_id and s.thread != me]
    if not added:
        return 0
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    for s in added:
        args = {"id": s.id, "parent": s.parent}
        if s.batch is not None:
            args["batch"] = s.batch
        trace["traceEvents"].append({
            "ph": "X", "cat": "user_annotation", "name": PREFIX + s.name,
            "pid": os.getpid(), "tid": s.thread, "ts": (s.start_ns - base) / 1e3,
            "dur": (s.end_ns - s.start_ns) / 1e3, "args": args,
        })
    with open(path, "w") as f:
        json.dump(trace, f)
    return len(added)
