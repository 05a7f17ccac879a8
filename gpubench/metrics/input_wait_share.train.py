"""``input_wait_share.train``: the share of the window the train loop
spent waiting for the loader's next batch (the benchmark's host span
around each ``next()`` on the ``PrefetchLoader`` iterator, every wait
however short)."""


def read(ctx):
    return 100.0 * ctx.result.loader_wait_s / ctx.result.window_s
