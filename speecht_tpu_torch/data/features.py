"""Host-side (numpy) acoustic features: the DSP of ``preprocess``.

The port's own copy of ``speecht_tpu/data/features.py``, the same numpy
arithmetic line for line, so the same audio gives bit-equal features:

- ``calc_power_spectrogram``: mel power spectrogram (128 Slaney mel bands,
  n_fft 512, hop 160, periodic Hann window, centred frames with reflect
  padding) -> dB against the utterance's max -> mean 0 / std 1 -> [time,
  128];
- ``calc_mfccs``: 13 MFCCs (orthonormal DCT-II of the dB mel spectrogram
  against 1.0) with first and second regression deltas (width 9, edge
  padding), each block normalized -> [time, 39].

The batched torch counterpart that runs on the card is
:mod:`speecht_tpu_torch.data.features_device`.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Window / STFT
# ---------------------------------------------------------------------------


def hann_window(n: int) -> np.ndarray:
    """Periodic (DFT-even) Hann window, matching scipy's fftbins=True."""
    if n == 1:
        return np.ones(1)
    k = np.arange(n)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)


def frame_signal(y: np.ndarray, n_fft: int, hop_length: int) -> np.ndarray:
    """Center-pad (reflect) and slice into frames of length n_fft.

    Returns [n_frames, n_fft] with n_frames = 1 + len(y) // hop_length.
    """
    pad = n_fft // 2
    y_padded = np.pad(y, pad, mode="reflect")
    n_frames = 1 + len(y) // hop_length
    idx = (
        np.arange(n_fft)[None, :]
        + hop_length * np.arange(n_frames)[:, None]
    )
    return y_padded[idx]


def power_stft(y: np.ndarray, n_fft: int = 512, hop_length: int = 160) -> np.ndarray:
    """Power spectrogram |STFT|^2, shape [1 + n_fft//2, n_frames]."""
    frames = frame_signal(np.asarray(y, dtype=np.float64), n_fft, hop_length)
    window = hann_window(n_fft)
    spec = np.fft.rfft(frames * window[None, :], n=n_fft, axis=1)
    return (np.abs(spec) ** 2).T


# ---------------------------------------------------------------------------
# Mel filterbank (Slaney scale + Slaney area normalization)
# ---------------------------------------------------------------------------

_F_SP = 200.0 / 3  # linear region: mels per Hz below 1 kHz
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0  # log region step


def hz_to_mel(frequencies) -> np.ndarray:
    f = np.asanyarray(frequencies, dtype=np.float64)
    mels = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(f, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )
    return mels


def mel_to_hz(mels) -> np.ndarray:
    m = np.asanyarray(mels, dtype=np.float64)
    freqs = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    freqs = np.where(
        log_region,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (np.maximum(m, _MIN_LOG_MEL) - _MIN_LOG_MEL)),
        freqs,
    )
    return freqs


def mel_filterbank(
    sr: int, n_fft: int, n_mels: int = 128, fmin: float = 0.0, fmax: float | None = None
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, [n_mels, 1 + n_fft//2]."""
    if fmax is None:
        fmax = sr / 2.0
    fft_freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = mel_to_hz(
        np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    )
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney-style area normalization: each filter integrates to ~constant.
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights


# ---------------------------------------------------------------------------
# dB conversion / normalization
# ---------------------------------------------------------------------------


def power_to_db(
    S: np.ndarray, ref: float | None = None, amin: float = 1e-10, top_db: float = 80.0
) -> np.ndarray:
    """10*log10(S/ref), floored at (max - top_db).

    ``ref=None`` means ref = S.max() — the per-utterance global max the
    reference uses via ``ref=np.max`` (reference preprocessing.py:53).
    """
    S = np.asarray(S, dtype=np.float64)
    ref_value = float(S.max()) if ref is None else float(ref)
    log_spec = 10.0 * np.log10(np.maximum(amin, S))
    log_spec -= 10.0 * np.log10(np.maximum(amin, ref_value))
    if top_db is not None:
        log_spec = np.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def normalize(values: np.ndarray) -> np.ndarray:
    """Whole-array mean-0/std-1 normalization (reference preprocessing.py:29-33)."""
    return (values - np.mean(values)) / np.std(values)


# ---------------------------------------------------------------------------
# Public feature extractors (reference API shape)
# ---------------------------------------------------------------------------


def melspectrogram(
    audio_data: np.ndarray,
    samplerate: int,
    n_mels: int = 128,
    n_fft: int = 512,
    hop_length: int = 160,
) -> np.ndarray:
    """Mel power spectrogram [n_mels, n_frames]."""
    S = power_stft(audio_data, n_fft=n_fft, hop_length=hop_length)
    fb = mel_filterbank(samplerate, n_fft, n_mels=n_mels)
    return fb @ S


def calc_power_spectrogram(
    audio_data: np.ndarray,
    samplerate: int,
    n_mels: int = 128,
    n_fft: int = 512,
    hop_length: int = 160,
) -> np.ndarray:
    """Normalized log-mel power spectrogram, [time, n_mels].

    Mirrors reference preprocessing.py:36-58 numerics: mel power spectrogram
    -> power_to_db(ref=global max) -> mean0/std1 -> transpose.
    """
    S = melspectrogram(audio_data, samplerate, n_mels, n_fft, hop_length)
    log_S = power_to_db(S, ref=None)
    return normalize(log_S).T.astype(np.float32)


def dct_basis(n_filters: int, n_input: int) -> np.ndarray:
    """Orthonormal DCT-II basis, [n_filters, n_input]."""
    n = np.arange(n_input)
    k = np.arange(n_filters)[:, None]
    basis = np.cos(np.pi * k * (2 * n[None, :] + 1) / (2.0 * n_input))
    basis *= np.sqrt(2.0 / n_input)
    basis[0] *= np.sqrt(0.5)
    return basis


def delta(data: np.ndarray, width: int = 9, order: int = 1) -> np.ndarray:
    """Regression-window (HTK-style) delta features along the last axis.

    d[t] = sum_n n * (x[t+n] - x[t-n]) / (2 * sum_n n^2), n = 1..width//2,
    with edge padding. order=2 applies the operator twice.
    """
    half = width // 2
    n = np.arange(1, half + 1, dtype=np.float64)
    denom = 2.0 * np.sum(n**2)
    out = data.astype(np.float64)
    for _ in range(order):
        padded = np.pad(out, [(0, 0)] * (out.ndim - 1) + [(half, half)], mode="edge")
        acc = np.zeros_like(out)
        for i, coef in enumerate(n, start=1):
            acc += coef * (
                padded[..., half + i : padded.shape[-1] - half + i]
                - padded[..., half - i : padded.shape[-1] - half - i]
            )
        out = acc / denom
    return out


def calc_mfccs(
    audio_data: np.ndarray,
    samplerate: int,
    n_mfcc: int = 13,
    n_fft: int = 512,
    hop_length: int = 160,
) -> np.ndarray:
    """MFCC + delta + delta-delta features, [time, 3*n_mfcc].

    Mirrors reference preprocessing.py:61-84: 13 MFCCs (orthonormal DCT-II of
    the dB mel spectrogram, ref=1.0), 1st and 2nd order deltas, each block
    mean0/std1 normalized then concatenated.
    """
    S = melspectrogram(audio_data, samplerate, n_mels=128, n_fft=n_fft, hop_length=hop_length)
    log_S = power_to_db(S, ref=1.0)
    mfcc = dct_basis(n_mfcc, log_S.shape[0]) @ log_S
    d1 = delta(mfcc, order=1)
    d2 = delta(mfcc, order=2)
    out = np.concatenate(
        (normalize(mfcc), normalize(d1), normalize(d2)), axis=0
    )
    return out.T.astype(np.float32)


FEATURE_FUNCTIONS = {
    "power": calc_power_spectrogram,
    "mfcc": calc_mfccs,
}


def feature_size(feature_type: str) -> int:
    return {"power": 128, "mfcc": 39}[feature_type]
