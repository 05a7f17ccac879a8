"""``train_audio_s_per_s``: seconds of audio trained per second of the
window. Every row's valid frames of every step launched in the window,
times the hop over the sample rate; padding earns nothing. The window
ends at a synchronise, so every step counted has finished in it."""

import numpy as np


def read(ctx):
    frames = sum(int(np.asarray(s.seq_lengths).sum()) for s in ctx.result.steps)
    seconds = frames * ctx.config["hop"] / ctx.config["sample_rate"]
    return seconds / ctx.result.window_s
