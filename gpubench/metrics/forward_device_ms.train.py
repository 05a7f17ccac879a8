"""``forward_device_ms.train``: the device time of the work launched while
the train loop was in ``step.forward`` (by the start of each activity's
runtime event, on any thread but the loader's), per step of the window
(``program_spans.py``)."""

from gpubench import program_spans


def read(ctx):
    spans = program_spans.read(ctx)
    return None if spans is None else spans.device_ms_per_step("step.forward")
