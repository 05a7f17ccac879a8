"""``mhsa_forward_ms.train``: the device time of the work launched while the
train loop's forward was in ``conformer.mhsa``: the relative-position
self-attention modules (LayerNorm, the projections, the position term, the
fused attention core); per step of the window (``module_spans.py``). None
where the program logs no such span."""

from gpubench import module_spans


def read(ctx):
    return module_spans.device_ms_per_step(ctx, "conformer.mhsa")
