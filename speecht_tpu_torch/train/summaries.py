"""Parameter histograms reduced on the device.

Counterpart of the parameter-histogram part of
``speecht_tpu/train/summaries.py`` (``device_histogram``,
``make_param_summarizer`` without images): at every checkpoint the
training loop writes one histogram per parameter. Min, max, sums and the
30 bucket counts are computed where the parameters live, and only those
(a few hundred floats) are read back, once, instead of the whole
parameter set. Tags are the JAX package's (``conv_i/kernel``,
``conv_i/bias``); a histogram does not depend on the kernel's layout.
"""

from __future__ import annotations

from typing import Callable

import torch

HIST_BINS = 30


def device_histogram(x: torch.Tensor, bins: int = HIST_BINS) -> torch.Tensor:
    """[5 + 2 * bins] float32 on ``x``'s device: min, max, num, sum,
    sum of squares, the bucket upper limits and the bucket counts, with
    the JAX package's binning (a constant tensor gets a unit-wide range,
    as ``np.histogram`` does)."""
    x = x.detach().float().reshape(-1)
    lo, hi = x.min(), x.max()
    span = torch.where(hi > lo, hi - lo, 1.0)
    lo_e = torch.where(hi > lo, lo, lo - 0.5)
    steps = torch.arange(1, bins + 1, dtype=torch.float32, device=x.device)
    edges = lo_e + span * steps / bins
    idx = torch.floor((x - lo_e) / span * bins).long().clamp(0, bins - 1)
    counts = torch.bincount(idx, minlength=bins).float()
    head = torch.stack(
        [lo, hi, torch.tensor(float(x.numel()), device=x.device), x.sum(), (x * x).sum()]
    )
    return torch.cat([head, edges, counts])


def unpack_histogram(row, bins: int = HIST_BINS) -> dict:
    """A host row of :func:`device_histogram` -> the writer's stats dict."""
    return {
        "min": row[0], "max": row[1], "num": row[2], "sum": row[3],
        "sum_squares": row[4],
        "bucket_limits": row[5: 5 + bins],
        "buckets": row[5 + bins: 5 + 2 * bins],
    }


def _tag(name: str) -> str:
    """``conv_i.weight`` -> ``conv_i/kernel``, ``conv_i.bias`` -> ``conv_i/bias``."""
    layer, _, leaf = name.rpartition(".")
    leaf = "kernel" if leaf == "weight" else leaf
    return f"{layer}/{leaf}" if layer else leaf


def make_param_summarizer() -> Callable:
    """params -> {tag: histogram stats} with one device -> host copy."""

    def summarize(params: dict[str, torch.Tensor]) -> dict[str, dict]:
        with torch.no_grad():
            rows = torch.stack([device_histogram(p) for p in params.values()])
        host = rows.cpu().double().numpy()
        return {_tag(name): unpack_histogram(row) for name, row in zip(params, host)}

    return summarize
