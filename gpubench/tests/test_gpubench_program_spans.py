"""The readers of the port's own spans (``program_spans.py`` and the eight
metrics on it), on a small synthetic trace and span log with known
answers, and where they must read nothing."""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

import speecht_tpu_torch
from gpubench import manifest, program_spans
from gpubench.trace import Trace
from speecht_tpu_torch import telemetry

LOOP, LOADER = 7, 9
SKEW = 5  # the log's clock runs 5 ns behind the trace's

# (name, thread, start, end, batch), on the trace's clock
LOOP_SPANS = [
    ("step.optimizer", 500, 600),  # before the window
    ("loader.wait", 1000, 1050), ("step.forward", 1050, 1200),
    ("step.backward", 1200, 1600), ("step.optimizer", 1600, 1700),
    ("loader.wait", 1700, 1750), ("step.forward", 1750, 1800),
    ("step.backward", 1800, 1900), ("step.optimizer", 1900, 1990),
]
# (correlation id of the launching operator, its start, device start, end);
# None: the loader's copy, which no operator of the trace launched
LAUNCHES = [
    (1, 1060, 1100, 1150), (2, 1210, 1250, 1550), (3, 1610, 1620, 1640),
    (None, 1300, 1560, 1570),
    (5, 1760, 1760, 1790), (6, 1810, 1810, 1890), (7, 1905, 1950, 1960),
]
EXPECTED = {
    # ns over the window of 1,000 ns, in %
    "loader_busy_share.train": 20.0,  # produce [1000, 1100] and [1700, 1800]
    "loader_wait_share.train": 10.0,
    # ns over 2 steps, in ms
    "forward_device_ms.train": (50 + 30) / 2 / 1e6,
    "backward_device_ms.train": (300 + 80) / 2 / 1e6,
    "optimizer_device_ms.train": (20 + 10) / 2 / 1e6,
    # idle [1000, 1100] [1150, 1250] [1550, 1560] [1570, 1620] [1640, 1760]
    # [1790, 1810] [1890, 1950] [1960, 2000] by the loop's innermost span
    "forward_idle_share.train": 12.0,
    "backward_idle_share.train": 11.0,
    "optimizer_idle_share.train": 16.0,
}


def make_trace(device: bool = True) -> Trace:
    trace = Trace.__new__(Trace)
    trace.start_ns, trace.end_ns = 1000, 2000
    trace._ops = [("gpubench.window", 1000, 2000, 1, 0)]
    trace._ops += [(telemetry.PREFIX + n, s, e, 1, 0) for n, s, e in LOOP_SPANS]
    trace.device = []
    if device:
        for corr, at, s, e in LAUNCHES:
            if corr is not None:
                trace._ops.append((f"aten::op{corr}", at, at + 3, 1, corr))
            trace.device.append((f"kernel{corr}", s, e, corr or 0))
        # runtime calls, whose correlation ids are counted apart: these
        # share the loader copy's and the optimizer's, at a time that would
        # give both to the backward
        trace._ops += [("cudaLaunchKernel", 1300, 1303, 1, 0),
                       ("cudaLaunchKernel", 1300, 1303, 1, 3)]
        trace.device.sort(key=lambda d: d[1])  # as Trace keeps them
    trace.spans = []
    return trace


def fill(log: telemetry.SpanLog) -> None:
    for name, s, e in LOOP_SPANS:
        log.add(name, LOOP, s - SKEW, e - SKEW, batch=0 if name == "loader.wait" else None)
    for batch, (s, e, put_end) in enumerate([(900, 1100, 1700), (1700, 1800, 2100)]):
        parent = log.add("loader.produce", LOADER, s - SKEW, e - SKEW, batch=batch)
        log.add("loader.build", LOADER, s - SKEW, s + 10 - SKEW, parent, batch)
        log.add("loader.h2d", LOADER, e - 20 - SKEW, e - SKEW, parent, batch)
        log.add("loader.put", LOADER, e - SKEW, put_end - SKEW, batch=batch)


def ctx_of(trace, steps: int = 2):
    return SimpleNamespace(result=SimpleNamespace(trace=trace, steps=[None] * steps))


@pytest.fixture
def log(monkeypatch):
    log = telemetry.SpanLog()
    monkeypatch.setattr(telemetry, "LOG", log)
    return log


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_each_reader_on_a_known_trace(metric, log):
    fill(log)
    value = manifest.Manifest.load().reader(metric)(ctx_of(make_trace()))
    assert value == pytest.approx(EXPECTED[metric], rel=1e-9)


def test_the_clock_offset_is_read_from_the_loop_spans(log):
    fill(log)
    trace = make_trace()
    assert program_spans.clock_offset(trace, log.spans()) == SKEW
    spans = program_spans.read(ctx_of(trace))
    assert spans.idle_by_span[None] == 10  # after the last span, [1990, 2000]
    assert sum(spans.idle_by_span.values()) == 500
    assert spans.loop_threads == {LOOP}


def test_on_the_cpu_the_device_readers_read_nothing(log):
    fill(log)
    ctx = ctx_of(make_trace(device=False))
    bench = manifest.Manifest.load()
    for metric in EXPECTED:
        value = bench.reader(metric)(ctx)
        assert (value is None) == ("_device_ms" in metric or "_idle_share" in metric), metric
    assert bench.reader("loader_wait_share.train")(ctx) == pytest.approx(10.0)


@pytest.mark.parametrize("case", ["no trace", "no program spans", "none in the window",
                                  "dropped in the window", "no steps"])
def test_every_reader_reads_nothing(case, log, monkeypatch):
    trace = make_trace()
    steps = 2
    if case == "no trace":
        fill(log)
        trace = None
    elif case == "no program spans":
        # the port before its spans: no telemetry module to import
        monkeypatch.setitem(sys.modules, "speecht_tpu_torch.telemetry", None)
        monkeypatch.delattr(speecht_tpu_torch, "telemetry")
    elif case == "none in the window":
        # spans of another profiler's session
        trace._ops = [op for op in trace._ops if not op[0].startswith(telemetry.PREFIX)]
        log.add("step.forward", LOOP, 100, 200)
    elif case == "dropped in the window":
        small = telemetry.SpanLog(capacity=4)
        monkeypatch.setattr(telemetry, "LOG", small)
        fill(small)
        assert small.dropped_until_ns > 1000
    else:
        fill(log)
        steps = 0
    bench = manifest.Manifest.load()
    for metric in EXPECTED:
        assert bench.reader(metric)(ctx_of(trace, steps)) is None, metric


def test_dropped_spans_before_the_window_leave_it_whole(monkeypatch):
    small = telemetry.SpanLog(capacity=len(LOOP_SPANS) + 8)
    monkeypatch.setattr(telemetry, "LOG", small)
    small.add("step.forward", LOOP, 10, 20)  # dropped: long before the window
    small.add("step.backward", LOOP, 20, 30)
    fill(small)
    assert small.dropped == 2
    reader = manifest.Manifest.load().reader("backward_device_ms.train")
    assert reader(ctx_of(make_trace())) == pytest.approx(EXPECTED["backward_device_ms.train"])


def test_innermost_and_union():
    spans = [(0, 100, "a"), (10, 20, "b"), (20, 30, "c"), (15, 18, "d")]
    assert program_spans.innermost(spans) == [
        (0, 10, "a"), (10, 15, "b"), (15, 18, "d"), (18, 20, "b"), (20, 30, "c"), (30, 100, "a")]
    assert program_spans.union_ns([(5, 10), (0, 3), (8, 12), (12, 13)]) == 3 + 8
