"""``loader_wait_share.train``: the train loop's ``loader.wait`` spans
(the loader's blocking take and the batch's handover to the loop's
stream) over the window: the program's own twin of
``input_wait_share.train``."""

from gpubench import program_spans


def read(ctx):
    spans = program_spans.read(ctx)
    return None if spans is None else spans.busy_share("loader.wait")
