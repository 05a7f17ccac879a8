"""The Conformer's module spans (``conformer.subsample``, ``conformer.ffn``,
``conformer.mhsa``, ``conformer.conv``, inside ``step.forward``: the
port's ``models/conformer.py``), read from a traced run's program spans
(``program_spans.py``) and cut to the window.

A device activity belongs to a module when the operator that launched it
started inside one of that module's spans, as ``program_spans`` gives the
stages theirs. The spans of the modules follow one another on the loop's
thread and never nest. The forward's spans alone: the autograd engine
runs the backward and does not split it by module.

:func:`device_ms_per_step` returns None where ``program_spans.read`` does,
and where the log holds no span of the module in the window (a model
without these spans, or a program that does not log them).
"""

from __future__ import annotations

import bisect

from gpubench import program_spans

MODULES = ("conformer.subsample", "conformer.ffn", "conformer.mhsa", "conformer.conv")


def device_ms_per_step(ctx, module: str):
    """Device time launched inside ``module``'s spans, ms a step of the
    window (both FFNs of a block for ``conformer.ffn``)."""
    spans = program_spans.read(ctx)
    if spans is None or not spans.trace.device:
        return None
    by_module = getattr(spans, "_device_by_module", None)
    if by_module is None:
        by_module = spans._device_by_module = _device_by_module(spans)
    if module not in by_module:
        return None
    return by_module[module] / 1e6 / spans.steps


def _device_by_module(spans) -> dict:
    """{module: device ns launched inside its spans}, with every module
    that has a span in the window (0 where it launched nothing)."""
    launched = {corr: start for name, start, _end, _thread, corr in spans.trace._ops
                if corr and not name.startswith("cu")}
    modules = sorted((s.start_ns, s.end_ns, s.name) for s in spans.spans
                     if s.name in MODULES)
    starts = [m[0] for m in modules]
    out = dict.fromkeys({m[2] for m in modules}, 0)
    for _n, s, e, corr in spans.trace.device:
        at = launched.get(corr)
        if at is None:
            continue
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and at <= modules[i][1]:
            out[modules[i][2]] += e - s
    return out
