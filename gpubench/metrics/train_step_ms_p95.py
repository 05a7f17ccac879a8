"""``train_step_ms_p95``: the 95th percentile of the gaps between
consecutive step completions (CUDA events recorded after each step, read
after the window), over every step of the window; the first gap runs from
the window's start."""

import numpy as np


def read(ctx):
    gaps = ctx.result.gaps_ms
    return float(np.percentile(gaps, 95)) if gaps else None
