"""``ctc_roofline.train``: the CTC kernels' least time over their time.
Each step launches ``ctc_alpha_kernel`` (with its history) and
``ctc_beta_kernel`` once; the least time of a launch is the larger of its
operations over the float32 peak and its bytes, once, over the HBM rate
(``yardstick.ctc_alpha_bound_s``, ``ctc_beta_bound_s``), summed over the
window and divided by the two kernels' summed device time. The logit
lengths are the architecture's (``logit_lengths``, ``logit_frames``)."""

import numpy as np

from gpubench import manifest, yardstick

KERNELS = ("ctc_alpha_kernel", "ctc_beta_kernel")


def read(ctx):
    trace = ctx.result.trace
    if trace is None:
        return None
    seconds = trace.kernel_s(KERNELS)
    if seconds <= 0:
        return None
    ref = manifest.architecture(ctx.config)
    classes = ctx.config["num_classes"]
    least = 0.0
    for s in ctx.result.steps:
        logit_lengths = ref.logit_lengths(ctx.config, np.asarray(s.seq_lengths))
        frames = ref.logit_frames(ctx.config, s.frames)
        least += yardstick.ctc_alpha_bound_s(logit_lengths, s.label_lengths, frames,
                                             s.label_width, classes)
        least += yardstick.ctc_beta_bound_s(logit_lengths, s.label_lengths, frames, classes)
    return 100.0 * least / seconds
