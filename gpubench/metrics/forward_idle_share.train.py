"""``forward_idle_share.train``: the window time in which the device ran
nothing (the complement of the trace's busy union, as for
``device_idle_share.train``) while ``step.forward`` was the innermost
span open on the train loop's thread, over the window
(``program_spans.py``)."""

from gpubench import program_spans


def read(ctx):
    spans = program_spans.read(ctx)
    return None if spans is None else spans.idle_share("step.forward")
