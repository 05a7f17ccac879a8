"""The traced run's reading of ``torch.profiler``: device intervals, the
benchmark's own host spans, and the device time of named operators.

The harness wraps the window in spans of its own (``record_function``):
``window`` around all of it, and inside it ``loader_wait`` around each
wait for the next batch, ``train_step`` around each call of the step and
``sync`` around the closing synchronise. They share the profiler's clock
with the device's kernels, copies and fills, so an idle stretch of the
device can be named by the span that was open on the host.
"""

from __future__ import annotations

import bisect
import re

import torch

PREFIX = "gpubench."
WINDOW = PREFIX + "window"
# device activities that are not kernels
NOT_KERNELS = ("Memcpy", "Memset")


def span(name: str):
    """A host span in the profiler's timeline."""
    return torch.profiler.record_function(PREFIX + name)


def start(device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


class Trace:
    """A stopped profiler's events, cut to the ``window`` span. Read from
    the profiler's raw events (no tree of Python objects), in ns."""

    def __init__(self, prof):
        cuda = torch.autograd.DeviceType.CUDA
        device, ops, window = [], [], None
        for ev in prof.profiler.kineto_results.events():
            name, start = ev.name(), ev.start_ns()
            end = start + ev.duration_ns()
            if ev.device_type() == cuda:
                if not name.startswith(PREFIX):
                    device.append((name, start, end, ev.linked_correlation_id()))
            elif name == WINDOW:
                window = (start, end)
            else:
                ops.append((name, start, end, ev.start_thread_id(), ev.correlation_id()))
        if window is None:
            raise RuntimeError("the trace holds no window span")
        self.start_ns, self.end_ns = window
        lo, hi = window
        self.device = sorted(((n, max(s, lo), min(e, hi), c) for n, s, e, c in device
                              if e > lo and s < hi), key=lambda d: d[1])
        self.spans = sorted(((n[len(PREFIX):], s, e) for n, s, e, _t, _c in ops
                             if n.startswith(PREFIX) and s < hi and e > lo),
                            key=lambda x: x[1])
        self._ops = ops

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def kernels(self) -> list:
        return [d for d in self.device if not d[0].startswith(NOT_KERNELS)]

    def kernel_s(self, names: tuple) -> float:
        """Seconds of the kernels whose demangled names hold one of
        ``names`` as a function name (``ns::name(`` or ``name<...>(``)."""
        pattern = re.compile(r"(^|[\s:])(" + "|".join(map(re.escape, names)) + r")[<(]")
        return sum(e - s for n, s, e, _c in self.device if pattern.search(n)) / 1e9

    def op_device_s(self, names: tuple) -> float:
        """Seconds of the device work launched inside the host operators
        named ``names`` (the launching operator, or one that encloses it on
        its thread, has one of the names)."""
        enclosing: dict = {}
        launched_by = {}
        for name, s, e, thread, corr in self._ops:
            launched_by[corr] = (thread, s)
            if name in names:
                enclosing.setdefault(thread, []).append((s, e))
        for spans in enclosing.values():
            spans.sort()
        total = 0
        for _n, s, e, corr in self.device:
            op = launched_by.get(corr)
            if op is None or op[0] not in enclosing:
                continue
            spans = enclosing[op[0]]
            # the named operators of one thread follow one another, so only
            # the last to start at or before the launch can enclose it
            i = bisect.bisect_right(spans, (op[1], float("inf"))) - 1
            if i >= 0 and op[1] <= spans[i][1]:
                total += e - s
        return total / 1e9

    def busy(self) -> list:
        """The union of the device's intervals in the window, merged."""
        merged = []
        for _n, s, e, _c in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def idle_gaps(self) -> list:
        """[(seconds, host span open at the gap's middle)] for every stretch
        of the window in which the device ran nothing."""
        edges = [self.start_ns]
        for s, e in self.busy():
            edges += [s, e]
        edges.append(self.end_ns)
        starts = [s[1] for s in self.spans]
        gaps = []
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid, name = (a + b) / 2, "host_other"
            i = bisect.bisect_right(starts, mid)
            for j in range(i - 1, max(-1, i - 64), -1):
                if self.spans[j][1] <= mid <= self.spans[j][2]:
                    name = self.spans[j][0]
                    break
            gaps.append(((b - a) / 1e9, name))
        return gaps

    def top_device_ops(self, n: int = 10) -> list:
        totals: dict = {}
        for name, s, e, _c in self.device:
            totals[name] = totals.get(name, 0.0) + (e - s) / 1e9
        return sorted(([k[:160], v] for k, v in totals.items()), key=lambda kv: -kv[1])[:n]
