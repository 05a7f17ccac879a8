"""Batched acoustic features in torch, on the batch's device.

Counterpart of ``speecht_tpu/data/features_tpu.py``: framing -> power
spectrum -> mel filterbank -> dB -> normalization (and for MFCCs the DCT
and the deltas) over a padded batch of raw audio, with every statistic the
host DSP (:mod:`speecht_tpu_torch.data.features`) takes per utterance (the
dB reference max, the top_db floor, the mean and std) taken under each
utterance's valid-frame mask, so a padded batch gives each utterance's own
features. Frames past an utterance's length come out 0; a padding row
(``num_samples == 0``: one "valid" frame of zeros) comes out NaN in that
frame, as in JAX.

It differs from the JAX version where the TPU forced a detour, not in what
it computes:

- Framing is one gather over ``[B, T, n_fft]`` indices that reflect at
  each utterance's own length by a modular fold (``_reflect_rows``'s
  arithmetic). JAX assembles interior frames from strided slices and
  gathers only the boundary frames because a TPU gather is slow; both give
  the fold's frames wherever a frame is valid, for utterances shorter than
  ``n_fft / 2`` too.
- The power spectrum is ``torch.fft.rfft`` of the windowed frames (cuFFT
  on the card); the TPU has no FFT, so JAX multiplies by a windowed-DFT
  matrix.

The mel, DCT and resample products run in IEEE float32 whatever the
process's TF32 setting (``ops.resample.float32_matmuls``), as JAX runs them
at ``Precision.HIGHEST``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from speecht_tpu_torch.data import features as host_features
from speecht_tpu_torch.ops import resample as resample_mod


@functools.lru_cache(maxsize=8)
def _hann(n_fft: int, device: torch.device) -> torch.Tensor:
    """The periodic Hann window [n_fft], float32, on ``device``."""
    window = host_features.hann_window(n_fft).astype(np.float32)
    return torch.from_numpy(window).to(device)


@functools.lru_cache(maxsize=8)
def _mel(sr: int, n_fft: int, device: torch.device) -> torch.Tensor:
    """The Slaney mel matrix [1 + n_fft//2, 128], float32, on ``device``."""
    fb = host_features.mel_filterbank(sr, n_fft, n_mels=128).T
    return torch.from_numpy(np.ascontiguousarray(fb, np.float32)).to(device)


@functools.lru_cache(maxsize=8)
def _dct(n_mfcc: int, n_mels: int, device: torch.device) -> torch.Tensor:
    """The orthonormal DCT-II matrix [n_mels, n_mfcc], float32, on ``device``."""
    basis = host_features.dct_basis(n_mfcc, n_mels).T
    return torch.from_numpy(np.ascontiguousarray(basis, np.float32)).to(device)


def num_frames(num_samples, hop_length: int = 160):
    """Frame count of a centred STFT: 1 + n_samples // hop."""
    return 1 + num_samples // hop_length


def _frame_batch(
    audio: torch.Tensor, num_samples: torch.Tensor, n_fft: int, hop_length: int
) -> torch.Tensor:
    """[B, S] -> [B, 1 + S // hop, n_fft] frames of each utterance's
    centred signal, reflected at its own length.

    Reflection is numpy's 'reflect' (no repeated edge sample) as a modular
    fold: position q folds into [0, 2n - 2) and reads min(q, 2n - 2 - q).
    n is clamped to 2, so a padding row (n = 0) reads its own zeros.
    """
    B, S = audio.shape
    T = 1 + S // hop_length
    device = audio.device
    q = (
        hop_length * torch.arange(T, device=device)[:, None]
        + torch.arange(n_fft, device=device)[None, :]
        - n_fft // 2
    )
    n = num_samples.to(torch.int64).clamp(min=2)[:, None, None]
    period = 2 * n - 2
    qm = torch.remainder(q[None], period)  # non-negative fold
    r = torch.minimum(qm, period - qm)  # [B, T, n_fft]
    return torch.gather(audio, 1, r.reshape(B, -1)).reshape(B, T, n_fft)


def _masked_moments(x: torch.Tensor, mask: torch.Tensor):
    """Mean and std of x [B, T, F] over the frames where mask [B, T, 1]."""
    m = mask.expand(x.shape).to(x.dtype)
    count = m.sum(dim=(1, 2), keepdim=True)
    mean = (x * m).sum(dim=(1, 2), keepdim=True) / count
    var = ((x - mean).square() * m).sum(dim=(1, 2), keepdim=True) / count
    return mean, var.sqrt()


def _log_mel(audio, num_samples, sr, n_fft, hop_length):
    """Frame -> power spectrum -> mel product -> log10 (ref 1.0), and the
    per-utterance masked peak both feature types take their dB floor from.

    Returns (log_spec [B, T, 128], peak [B, 1, 1], mask [B, T, 1],
    frame_lengths [B] int32).
    """
    frames = _frame_batch(audio.float(), num_samples, n_fft, hop_length)
    spec = torch.view_as_real(
        torch.fft.rfft(frames * _hann(n_fft, audio.device), n=n_fft)
    )
    power = spec.square().sum(-1)  # [B, T, 1 + n_fft//2]
    mel_power = power @ _mel(sr, n_fft, audio.device)

    frame_lengths = num_frames(num_samples, hop_length).to(torch.int32)
    t = torch.arange(mel_power.shape[1], device=audio.device)
    mask = (t[None, :] < frame_lengths[:, None])[..., None]  # [B, T, 1]

    log_spec = 10.0 * torch.log10(torch.clamp(mel_power, min=1e-10))
    masked_log = torch.where(mask, log_spec, -1e30)
    peak = masked_log.amax(dim=(1, 2), keepdim=True)
    return log_spec, peak, mask, frame_lengths


def batch_power_spectrogram(
    audio: torch.Tensor,
    num_samples: torch.Tensor,
    sr: int = 22050,
    n_fft: int = 512,
    hop_length: int = 160,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalized log-mel spectrogram of a padded batch.

    Args:
      audio: [B, S] float32 raw audio, zero-padded.
      num_samples: [B] integer valid sample counts.

    Returns:
      (features [B, T, 128] float32, frame_lengths [B] int32); frames past
      each utterance's length are 0.
    """
    with resample_mod.float32_matmuls():
        log_spec, peak, mask, frame_lengths = _log_mel(
            audio, num_samples, sr, n_fft, hop_length
        )
    # the reference is the utterance's max; floored at top_db = 80 below it
    log_spec = torch.clamp(log_spec - peak, min=-80.0)
    mean, std = _masked_moments(log_spec, mask)
    out = (log_spec - mean) / std
    return torch.where(mask, out, 0.0), frame_lengths


def _delta(x: torch.Tensor) -> torch.Tensor:
    """Regression deltas of width 9 along time with edge padding, as
    ``host_features.delta`` (float32 here, as in JAX)."""
    half = 4
    T = x.shape[1]
    edge = torch.arange(-half, T + half, device=x.device).clamp(0, T - 1)
    xp = x[:, edge]
    acc = torch.zeros_like(x)
    for i in range(1, half + 1):
        acc = acc + float(i) * (
            xp[:, half + i : half + i + T] - xp[:, half - i : half - i + T]
        )
    return acc / (2.0 * sum(i * i for i in range(1, half + 1)))


def _clamped(x: torch.Tensor, frame_lengths: torch.Tensor) -> torch.Tensor:
    """Each row's frames past its length replaced by its last valid frame,
    so the deltas see the utterance's own edge values."""
    idx = torch.minimum(
        torch.arange(x.shape[1], device=x.device)[None, :],
        frame_lengths[:, None].to(torch.int64) - 1,
    )
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))


def batch_mfccs(
    audio: torch.Tensor,
    num_samples: torch.Tensor,
    sr: int = 22050,
    n_mfcc: int = 13,
    n_fft: int = 512,
    hop_length: int = 160,
) -> tuple[torch.Tensor, torch.Tensor]:
    """MFCC + delta + delta-delta of a padded batch, [B, T, 3 * n_mfcc]."""
    with resample_mod.float32_matmuls():
        log_spec, peak, mask, frame_lengths = _log_mel(
            audio, num_samples, sr, n_fft, hop_length
        )
        # the reference stays 1.0; the floor is 80 dB below the peak
        log_spec = torch.maximum(log_spec, peak - 80.0)
        mfcc = log_spec @ _dct(n_mfcc, 128, audio.device)

    mfcc_c = _clamped(mfcc, frame_lengths)
    d1 = _delta(mfcc_c)
    # clamp again so the second delta sees edge values, not stale rows
    d2 = _delta(_clamped(d1, frame_lengths))

    def norm(x):
        mean, std = _masked_moments(x, mask)
        return (x - mean) / std

    out = torch.cat((norm(mfcc_c), norm(d1), norm(d2)), dim=-1)
    return torch.where(mask, out, 0.0), frame_lengths


def make_front_end(feature_type: str, wire_sr: int | None = None,
                   sr: int = 22050):
    """The raw-audio front end of every ``AudioBatch`` consumer:
    ``front_end(audio [B, S], num_samples [B]) -> (features, frame_lengths)``.

    It undoes the two wire conventions, as JAX's ``make_front_end``:

    - int16 audio (the loader's compact wire, ``pipeline.audio_to_int16``)
      becomes ``x / 32768``;
    - audio at ``wire_sr`` != ``sr`` is resampled by
      ``ops.resample.batch_resample`` first, and ``num_samples`` become
      ``out_count(num_samples)``.
    """
    if feature_type not in ("power", "mfcc"):
        raise ValueError("Feature type must be mfcc or power.")
    feature_fn = (
        batch_power_spectrogram if feature_type == "power" else batch_mfccs
    )
    resample = wire_sr is not None and wire_sr != sr

    def front_end(audio: torch.Tensor, num_samples: torch.Tensor):
        x = audio.float()
        if audio.dtype == torch.int16:
            x = x / 32768.0
        if resample:
            with resample_mod.float32_matmuls():
                x = resample_mod.batch_resample(x, wire_sr, sr)
            num_samples = resample_mod.out_count(num_samples, wire_sr, sr)
        return feature_fn(x, num_samples, sr=sr)

    return front_end
