"""``loader_busy_share.train``: the union of the loader thread's
``loader.produce`` spans in the window (reading the samples, building the
batch, the bf16 cast, pin and copy's enqueue) over the window: how near
the loader is to setting the pace (100% is a loader that never waits on a
full queue)."""

from gpubench import program_spans


def read(ctx):
    spans = program_spans.read(ctx)
    return None if spans is None else spans.busy_share("loader.produce")
