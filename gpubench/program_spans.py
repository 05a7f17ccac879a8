"""The port's own spans (``speecht_tpu_torch/telemetry.py``), read after a
traced run and cut to the trace's ``window`` span.

The port logs a span for each stage of its train step (``step.forward``,
``step.backward``, ``step.optimizer``, on the train loop's thread) and of
its loader (``loader.produce`` with ``loader.build`` and ``loader.h2d``
inside it, ``loader.put`` on the loader's thread; ``loader.wait`` on the
loop's), on the profiler's clock. The loop's spans are also operators
in the trace (``speecht.<name>``); the median gap between each and its
log entry is the two clocks' offset, which is taken off every span.

A device activity belongs to a stage when the operator that launched it
(the trace links the two by the operator's correlation id) started inside
one of the stage's spans. The runtime calls (``cudaLaunchKernel``, ...)
count their correlation ids apart, so they are not read. The loader's
thread is not seen by a profiler started on the loop's thread, so its
copies are linked to no operator and belong to no stage. The device idles
under a span while it runs nothing and that span is the innermost open on
the loop's thread.

:func:`read` returns None where the run has no trace, where the program
logs no spans (a port without ``telemetry``), where the log holds no span
in the window, or where the log dropped spans inside it.
"""

from __future__ import annotations

import bisect
import functools
import statistics

PREFIX = "speecht."
STAGES = ("step.forward", "step.backward", "step.optimizer")


def read(ctx):
    """The run's :class:`ProgramSpans`, or None; computed once a trace."""
    trace = ctx.result.trace
    if trace is None or not ctx.result.steps:
        return None
    cached = getattr(trace, "_program_spans", False)
    if cached is False:
        cached = _load(trace, len(ctx.result.steps))
        trace._program_spans = cached
    return cached


def _load(trace, steps: int):
    try:
        from speecht_tpu_torch import telemetry
    except ImportError:
        return None
    log = telemetry.LOG
    spans = log.spans()
    offset = clock_offset(trace, spans)
    if log.dropped_until_ns is not None and log.dropped_until_ns + offset > trace.start_ns:
        return None
    return ProgramSpans.of(trace, spans, offset, steps)


def clock_offset(trace, spans) -> int:
    """The median of (trace's start - log's start) over the log's spans
    that the trace holds as operators; 0 where there are none. A span is
    logged and opens its operator under the same condition (a profiler
    records), so the trace's last n spans of a name are the log's last n
    of it, in order, whatever the offset."""
    logged: dict = {}
    for s in spans:
        logged.setdefault(s.name, []).append(s.start_ns)
    traced: dict = {}
    for name, start, _end, _thread, _corr in trace._ops:
        if name.startswith(PREFIX) and name[len(PREFIX):] in logged:
            traced.setdefault(name[len(PREFIX):], []).append(start)
    gaps = []
    for name, starts in traced.items():
        n = min(len(starts), len(logged[name]))
        gaps += [t - s for t, s in zip(sorted(starts)[-n:], sorted(logged[name])[-n:])]
    return int(statistics.median(gaps)) if gaps else 0


def union_ns(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def innermost(spans) -> list:
    """[(start, end, name)], disjoint and in order: each stretch of one
    thread's properly nested spans labelled with the innermost open."""
    edges = sorted({s for s, _e, _n in spans} | {e for _s, e, _n in spans})
    label = [None] * max(len(edges) - 1, 0)
    # outer spans first (earlier start, then longer), so inner ones overwrite
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        for k in range(bisect.bisect_left(edges, s), bisect.bisect_left(edges, e)):
            label[k] = name
    return [(edges[k], edges[k + 1], n) for k, n in enumerate(label) if n is not None]


def overlap_by_label(intervals: list, segments: list) -> dict:
    """{label: time shared with ``intervals``} for sorted lists of disjoint
    (start, end) intervals and (start, end, label) segments."""
    out, i, j = {}, 0, 0
    while i < len(intervals) and j < len(segments):
        lo = max(intervals[i][0], segments[j][0])
        hi = min(intervals[i][1], segments[j][1])
        if hi > lo:
            out[segments[j][2]] = out.get(segments[j][2], 0) + hi - lo
        if intervals[i][1] < segments[j][1]:
            i += 1
        else:
            j += 1
    return out


class ProgramSpans:
    """The log's spans in a traced window, on the trace's clock."""

    def __init__(self, trace, spans: list, steps: int):
        self.trace, self.spans, self.steps = trace, spans, steps
        self.window_ns = trace.end_ns - trace.start_ns
        # the loop's thread is the one its step's stages ran on
        self.loop_threads = {s.thread for s in spans if s.name in STAGES}

    @classmethod
    def of(cls, trace, spans: list, offset: int, steps: int):
        lo, hi = trace.start_ns, trace.end_ns
        inside = [s._replace(start_ns=s.start_ns + offset, end_ns=s.end_ns + offset)
                  for s in spans]
        inside = [s for s in inside if s.end_ns > lo and s.start_ns < hi]
        return cls(trace, inside, steps) if inside else None

    def clipped(self, name: str) -> list:
        lo, hi = self.trace.start_ns, self.trace.end_ns
        return [(max(s.start_ns, lo), min(s.end_ns, hi)) for s in self.spans if s.name == name]

    def busy_share(self, name: str) -> float:
        """The union of the spans named ``name`` over the window, in %."""
        return 100.0 * union_ns(self.clipped(name)) / self.window_ns

    def device_ms_per_step(self, stage: str):
        """Device time launched inside ``stage``'s spans, ms a step; None
        where the trace holds no device activity."""
        if self.device_by_stage is None:
            return None
        return self.device_by_stage.get(stage, 0) / 1e6 / self.steps

    def idle_share(self, name: str):
        """Window time in which the device ran nothing while ``name`` was
        the innermost span of the loop's thread, in %; None where the
        trace holds no device activity."""
        if self.idle_by_span is None:
            return None
        return 100.0 * self.idle_by_span.get(name, 0) / self.window_ns

    @functools.cached_property
    def idle_by_span(self):
        """{innermost span of the loop's thread (None: none open): idle ns}."""
        if not self.trace.device:
            return None
        edges = [self.trace.start_ns]
        for s, e in self.trace.busy():
            edges += [s, e]
        edges.append(self.trace.end_ns)
        idle = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        out = overlap_by_label(idle, innermost([(s.start_ns, s.end_ns, s.name)
                                                for s in self.spans
                                                if s.thread in self.loop_threads]))
        out[None] = sum(b - a for a, b in idle) - sum(out.values())
        return out

    @functools.cached_property
    def device_by_stage(self):
        """{stage: device ns launched inside its spans}."""
        if not self.trace.device:
            return None
        # each operator's start by its correlation id (0: linked to none);
        # the runtime calls (cudaLaunchKernel, cuLaunchKernelEx, ...)
        # number theirs apart
        launched = {corr: start for name, start, _end, _thread, corr in self.trace._ops
                    if corr and not name.startswith("cu")}
        stages = sorted((s.start_ns, s.end_ns, s.name) for s in self.spans
                        if s.name in STAGES)
        starts = [s[0] for s in stages]
        out = {}
        for _n, s, e, corr in self.trace.device:
            at = launched.get(corr)
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= stages[i][1]:
                out[stages[i][2]] = out.get(stages[i][2], 0) + (e - s)
        return out
