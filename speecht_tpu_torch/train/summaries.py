"""Device-side summary reduction: histograms and downsampled images.

Counterpart of ``speecht_tpu/train/summaries.py`` (``device_histogram``,
``device_image``, ``make_param_summarizer``,
``make_activation_summarizer``). Min, max, sums, the 30 bucket counts and
the images (strided downsamples to at most 256 x 256) are computed where
the tensors live, and only those are read back, in one copy, instead of
the whole parameter set. Tags are the JAX package's (``conv_i/kernel``,
``conv_i/bias``, ``activations/conv_i``, ``logits``). A histogram does
not depend on a tensor's layout; an image does, so each weight is shown
in JAX's ``[W, I, O]`` order.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

HIST_BINS = 30
IMAGE_MAX_HW = 256


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


def device_image(x2d: torch.Tensor, max_hw: int = IMAGE_MAX_HW) -> torch.Tensor:
    """Strided downsample of a 2-D tensor to at most ``max_hw`` per side."""
    h, w = x2d.shape
    sh = -(-h // max_hw)
    sw = -(-w // max_hw)
    return x2d.detach()[::sh, ::sw].float()


def _tag(name: str) -> str:
    """``conv_i.weight`` -> ``conv_i/kernel``, ``conv_i.bias`` -> ``conv_i/bias``."""
    layer, _, leaf = name.rpartition(".")
    leaf = "kernel" if leaf == "weight" else leaf
    return f"{layer}/{leaf}" if layer else leaf


def _param_image(p: torch.Tensor) -> torch.Tensor:
    """JAX's image of a leaf: ``[W, I, O]`` reshaped to ``[-1, O]`` (the
    port's ``[O, I, W]`` weight is permuted first), a vector as one row."""
    if p.dim() >= 2:
        p = p.permute(*reversed(range(p.dim())))
        return device_image(p.reshape(-1, p.shape[-1]))
    return device_image(p[None, :])


def _read_back(hist_rows: list, images: list) -> tuple[np.ndarray, list]:
    """One device -> host copy of the histogram rows and the images."""
    flat = torch.cat([torch.stack(hist_rows).reshape(-1)]
                     + [img.reshape(-1) for img in images])
    host = flat.cpu().double().numpy()
    n = len(hist_rows) * hist_rows[0].numel()
    rows = host[:n].reshape(len(hist_rows), -1)
    out, at = [], n
    for img in images:
        out.append(host[at: at + img.numel()].reshape(img.shape))
        at += img.numel()
    return rows, out


def make_param_summarizer(with_images: bool = False) -> Callable:
    """params -> ({tag: histogram stats}, {tag: image}) with one device ->
    host copy; the images (a 2-D float64 array per parameter) only with
    ``with_images``."""

    def summarize(params: dict[str, torch.Tensor]):
        with torch.no_grad():
            rows = [device_histogram(p) for p in params.values()]
            images = [_param_image(p) for p in params.values()] if with_images else []
        host_rows, host_images = _read_back(rows, images)
        tags = [_tag(name) for name in params]
        hists = {tag: unpack_histogram(row) for tag, row in zip(tags, host_rows)}
        return hists, dict(zip(tags, host_images))

    return summarize


def make_activation_summarizer(model) -> Callable:
    """(features, seq_lengths) -> ({tag: histogram stats}, {"logits": image}).

    Reruns the forward under ``no_grad`` on the summary batch with a
    forward hook on each of ``model.layer_names`` (Wav2Letter's ``conv_i``,
    whichever path conv_0 takes; the Conformer's front end and blocks):
    ``activations/<layer>`` histograms, the ``logits`` histogram and the
    ``[C, T]`` logits image of the first row (``logits[0].T``). A
    tensor-parallel rank gathers the column-parallel layer's channels.
    """

    def summarize(features: torch.Tensor, seq_lengths: torch.Tensor | None = None):
        outputs = {}
        hooks = [
            model.get_submodule(name).register_forward_hook(
                lambda _m, _inp, out, name=name: outputs.__setitem__(name, out)
            )
            for name in model.layer_names
        ]
        try:
            with torch.no_grad():
                logits = model(features, seq_lengths)
                split = model.split
                for name in model.layer_names:
                    if f"{name}.bias" in split.dims:  # a column-parallel shard
                        outputs[name] = split.mesh.all_gather(
                            outputs[name], "model", dim=1
                        )
                tags = [f"activations/{name}" for name in model.layer_names]
                rows = [device_histogram(outputs[name]) for name in model.layer_names]
                rows.append(device_histogram(logits))
                image = device_image(logits[0].T)
        finally:
            for h in hooks:
                h.remove()
        host_rows, (host_image,) = _read_back(rows, [image])
        hists = {tag: unpack_histogram(row)
                 for tag, row in zip(tags + ["logits"], host_rows)}
        return hists, {"logits": host_image}

    return summarize
