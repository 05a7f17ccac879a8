"""``train_mfu``: the operations the window's steps need, over the window
and the card's dense bf16 peak. Counted from the rows' valid frames by the
architecture's ``train_flops_valid`` (``reference/__init__.py``), not from
what the kernels ran."""

from gpubench import manifest, yardstick


def read(ctx):
    ref = manifest.architecture(ctx.config)
    flops = sum(ref.train_flops_valid(ctx.config, s.seq_lengths) for s in ctx.result.steps)
    return 100.0 * flops / ctx.result.window_s / yardstick.PEAK_BF16_FLOPS
