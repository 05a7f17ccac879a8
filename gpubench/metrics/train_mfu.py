"""``train_mfu``: the operations the window's steps need, over the window
and the card's dense bf16 peak. Counted from the rows' valid frames
(``yardstick.train_flops_valid``: forward, weight gradients, input
gradients but the first layer's), not from what the kernels ran."""

from gpubench import yardstick


def read(ctx):
    flops = sum(yardstick.train_flops_valid(ctx.config, s.seq_lengths) for s in ctx.result.steps)
    return 100.0 * flops / ctx.result.window_s / yardstick.PEAK_BF16_FLOPS
