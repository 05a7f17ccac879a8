"""``host_syncs_per_step.train``: synchronizing CUDA operations inside the
train step calls of the window, as torch's sync debug mode reports them,
per step."""


def read(ctx):
    if ctx.result.syncs is None or not ctx.result.steps:
        return None
    return ctx.result.syncs / len(ctx.result.steps)
