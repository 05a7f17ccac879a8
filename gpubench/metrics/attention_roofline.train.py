"""``attention_roofline.train``: the fused attention cores' operations at
the padded shapes as run (the architecture's ``attention_flops_padded``:
``QK^T`` and ``PV`` forward, ``dQ``, ``dK``, ``dV`` and ``dP`` backward),
over the card's dense bf16 peak, as a share of the device time the
profiler puts under the memory-efficient attention's forward and backward
operators. An architecture that gives no ``attention_flops_padded``, or a
run whose trace holds no such operator, reads nothing."""

from gpubench import manifest, yardstick

OPS = ("aten::_scaled_dot_product_efficient_attention",
       "aten::_scaled_dot_product_efficient_attention_backward")


def read(ctx):
    trace = ctx.result.trace
    count = getattr(manifest.architecture(ctx.config), "attention_flops_padded", None)
    if trace is None or count is None:
        return None
    seconds = trace.op_device_s(OPS)
    if seconds <= 0:
        return None
    least = sum(sum(count(ctx.config, len(s.seq_lengths), s.frames))
                for s in ctx.result.steps) / yardstick.PEAK_BF16_FLOPS
    return 100.0 * least / seconds
