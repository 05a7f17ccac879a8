"""``launches_per_step.train``: the kernels the profiler saw in the
window (copies and fills left out), per step."""


def read(ctx):
    trace = ctx.result.trace
    if trace is None or not ctx.result.steps:
        return None
    kernels = trace.kernels()
    return len(kernels) / len(ctx.result.steps) if kernels else None
