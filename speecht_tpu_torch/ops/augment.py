"""SpecAugment: time and frequency masking of training batches.

Counterpart of ``speecht_tpu/ops/augment.py``, with the same semantics:

- ``n_freq_masks`` masks of width U[0, freq_width] over the feature axis;
- ``n_time_masks`` masks of width U[0, floor(time_frac * valid_frames)],
  placed within each row's VALID frames and never on its padding;
- masked cells set to 0 (the mean of the normalised features).

Masks are drawn where the features live, from an explicit
``torch.Generator`` on that device: a few uniforms a row, no host
readback. :func:`make_augment_fn` seeds a fresh generator from (seed,
optimizer step, micro-batch), as the JAX package folds both counters into
its key, so every micro-batch sees fresh masks and the same triple gives
the same masks. The generator is Philox on the card and not threefry, so
the masks are not JAX's bits; the tests compare behaviour and statistics.
"""

from __future__ import annotations

import dataclasses

import torch


def _uniform_int(u: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    """Integers uniform on [0, high] from uniforms ``u`` in [0, 1)."""
    return torch.minimum((u * (high + 1).float()).floor().long(), high)


def _mask_axis(u: torch.Tensor, length: int, max_width, limit) -> torch.Tensor:
    """[B, length] boolean, True where masked: for each of the
    ``u.shape[1]`` masks a span of width U[0, max_width] starting at
    U[0, max(limit - width, 0)]. ``u`` [B, n_masks, 2] holds the uniforms;
    ``max_width`` and ``limit`` are [B] integer tensors."""
    pos = torch.arange(length, device=u.device)
    masked = torch.zeros(u.shape[0], length, dtype=torch.bool, device=u.device)
    for m in range(u.shape[1]):
        width = _uniform_int(u[:, m, 0], max_width.clamp(min=0))
        start = _uniform_int(u[:, m, 1], (limit - width).clamp(min=0))
        masked |= (pos >= start[:, None]) & (pos < (start + width)[:, None])
    return masked


def spec_augment(
    features: torch.Tensor,
    seq_lengths: torch.Tensor,
    generator: torch.Generator,
    n_freq_masks: int = 2,
    freq_width: int = 15,
    n_time_masks: int = 2,
    time_frac: float = 0.05,
) -> torch.Tensor:
    """SpecAugment of a padded ``[B, T, F]`` batch; ``generator`` lives on
    the features' device. Per-row independent masks; time-mask widths
    scale with each row's valid length."""
    B, T, F = features.shape
    device = features.device
    valid = seq_lengths.to(device=device, dtype=torch.long)
    u_freq = torch.rand(B, n_freq_masks, 2, generator=generator, device=device)
    u_time = torch.rand(B, n_time_masks, 2, generator=generator, device=device)
    f_mask = _mask_axis(
        u_freq, F,
        torch.full((B,), freq_width, dtype=torch.long, device=device),
        torch.full((B,), F, dtype=torch.long, device=device),
    )
    # float32 product truncated to an integer, as JAX's astype(int32)
    t_width = (time_frac * valid.float()).long()
    t_mask = _mask_axis(u_time, T, t_width, valid)
    t_mask &= torch.arange(T, device=device) < valid[:, None]  # never padding
    masked = t_mask[:, :, None] | f_mask[:, None, :]
    return features.masked_fill(masked, 0.0)


def fold_seed(seed: int, counter: int) -> int:
    """A 32-bit generator seed from (seed, counter), by the splitmix64
    finaliser. 32 bits because the CPU generator keeps only those; the
    counter is taken mod 2^32, as JAX's fold_in takes a uint32."""
    z = ((int(seed) % 2**32) << 32 | (int(counter) % 2**32)) + 0x9E3779B97F4A7C15
    z %= 2**64
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9 % 2**64
    z = (z ^ (z >> 27)) * 0x94D049BB133111EB % 2**64
    return (z ^ (z >> 31)) % 2**32


def make_augment_fn(
    n_freq_masks: int = 2,
    freq_width: int = 15,
    n_time_masks: int = 2,
    time_frac: float = 0.05,
    seed: int = 0,
):
    """(batch, step, micro) -> batch with SpecAugmented features.

    ``step`` (optimizer applies) and ``micro`` (the micro-batch's index in
    the metrics window) are host integers; the train step keeps both on
    the host (``train/step.py::make_train_step_acc``).
    """

    def augment(batch, step: int, micro: int):
        generator = torch.Generator(device=batch.features.device)
        generator.manual_seed(fold_seed(seed, int(step) * 1_000_003 + int(micro)))
        feats = spec_augment(
            batch.features,
            batch.seq_lengths,
            generator,
            n_freq_masks=n_freq_masks,
            freq_width=freq_width,
            n_time_masks=n_time_masks,
            time_frac=time_frac,
        )
        return dataclasses.replace(batch, features=feats)

    return augment
