"""``conv_roofline.train``: the convolutions' operations at the padded
shapes as run (``yardstick.conv_flops_padded``: forward, weight gradients,
input gradients but the first layer's), over the card's dense bf16 peak,
as a share of the device time the profiler puts under
``aten::cudnn_convolution`` and ``aten::convolution_backward``."""

from gpubench import yardstick

OPS = ("aten::cudnn_convolution", "aten::convolution_backward")


def read(ctx):
    trace = ctx.result.trace
    if trace is None:
        return None
    seconds = trace.op_device_s(OPS)
    if seconds <= 0:
        return None
    least = sum(sum(yardstick.conv_flops_padded(ctx.config, len(s.seq_lengths), s.frames))
                for s in ctx.result.steps) / yardstick.PEAK_BF16_FLOPS
    return 100.0 * least / seconds
