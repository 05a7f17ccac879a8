"""``device_idle_share.train``: the share of the traced window in which
the device ran nothing: the window less the union of its kernels, copies
and fills in the profiler's timeline."""


def read(ctx):
    trace = ctx.result.trace
    if trace is None or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
