"""``conv_roofline.train``: the convolutions' operations at the padded
shapes as run (the architecture's ``conv_flops_padded``: forward, weight
gradients, input gradients but the first layer's), over the card's dense
bf16 peak, as a share of the device time the profiler puts under
``aten::cudnn_convolution`` and ``aten::convolution_backward``. An
architecture that gives no ``conv_flops_padded`` reads nothing."""

from gpubench import manifest, yardstick

OPS = ("aten::cudnn_convolution", "aten::convolution_backward")


def read(ctx):
    trace = ctx.result.trace
    count = getattr(manifest.architecture(ctx.config), "conv_flops_padded", None)
    if trace is None or count is None:
        return None
    seconds = trace.op_device_s(OPS)
    if seconds <= 0:
        return None
    least = sum(sum(count(ctx.config, len(s.seq_lengths), s.frames))
                for s in ctx.result.steps) / yardstick.PEAK_BF16_FLOPS
    return 100.0 * least / seconds
