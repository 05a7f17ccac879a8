"""Polyphase windowed-sinc resampling of padded batches, in torch.

Counterpart of ``speecht_tpu/ops/resample.py`` (the device resample of
``preprocess --device`` and ``evaluate --from-audio``). The filter is the
host resampler's (``native/speecht_native.cpp`` ``stt_resample``): the
same Kaiser-windowed sinc table, the same linear-interpolated tap
evaluation and the same rational polyphase decomposition, built in float64
numpy exactly as the JAX package builds it. For a ratio ``L/M`` (441/320
for 16 kHz -> 22.05 kHz) every block of ``L`` consecutive output samples
reads one ``P``-sample input window advanced by the hop ``M``:

    y[q*L + s] = sum_k  x[q*M + off(s) + k] * w[phase(s), k]

so a batch resample is a hop-``M`` framing followed by one
``[B*nq, P] @ [P, L]`` product. The product runs in true float32 (no TF32),
see :func:`float32_matmuls`: the host accumulates in float64, and reduced
precision passes corrupt the sinc tails.

:class:`StreamResampler` is the chunked host resampler of ``record
--streaming``: chunks in, exactly the samples ``native.resample`` gives
the whole signal out.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading

import numpy as np
import torch
import torch.nn.functional as F

# resampy kaiser_best-grade parameters: the defaults of SincFilter in
# native/speecht_native.cpp
_NUM_ZEROS = 64
_PRECISION = 512
_ROLLOFF = 0.9475937167399596
_BETA = 14.769656459379492

_MAX_L = 4096  # the rational-ratio cutoff of the native polyphase bank


def _bessel_i0(x: float) -> float:
    # the C series (bessel_i0 in speecht_native.cpp), term for term
    total, term = 1.0, 1.0
    x2 = x * x / 4.0
    for k in range(1, 64):
        term *= x2 / (k * k)
        total += term
        if term < 1e-18 * total:
            break
    return total


@functools.lru_cache(maxsize=1)
def _sinc_table() -> np.ndarray:
    """One-sided interpolated filter table, _PRECISION samples a zero crossing."""
    n = _NUM_ZEROS * _PRECISION + 1
    i = np.arange(n, dtype=np.float64)
    t = i / _PRECISION  # in zero crossings
    x = t / _NUM_ZEROS  # window argument in [0, 1]
    i0b = _bessel_i0(_BETA)
    win = np.array(
        [
            _bessel_i0(_BETA * math.sqrt(max(0.0, 1.0 - xx * xx))) / i0b
            for xx in x
        ]
    )
    arg = np.pi * _ROLLOFF * t
    sinc = np.ones(n)
    nz = t != 0.0
    sinc[nz] = np.sin(arg[nz]) / arg[nz]
    table = _ROLLOFF * sinc * win
    return np.concatenate([table, [0.0]])


def _filter_eval(t: np.ndarray) -> np.ndarray:
    """Linear-interpolated table lookup, as SincFilter::eval."""
    table = _sinc_table()
    a = np.abs(t) * _PRECISION
    i = a.astype(np.int64)
    frac = a - i
    ok = i < _NUM_ZEROS * _PRECISION
    ii = np.where(ok, i, 0)
    return np.where(ok, table[ii] * (1.0 - frac) + table[ii + 1] * frac, 0.0)


@functools.lru_cache(maxsize=8)
def _plan(sr_in: int, sr_out: int):
    """(L, M, P, left_pad, W2 [P, L] float32): the factors, the window
    length, the samples of left padding and the window-relative weights."""
    g = math.gcd(sr_in, sr_out)
    L, M = sr_out // g, sr_in // g
    if L > _MAX_L:
        raise ValueError(
            f"irrational-ish ratio {sr_in}->{sr_out} (L={L} > {_MAX_L}); "
            "resample on the host instead (native.resample)"
        )
    ratio = sr_out / sr_in
    scale = min(1.0, ratio)  # shrink the bandwidth when downsampling
    support = _NUM_ZEROS / scale
    start_off = -int(math.floor(support))
    ntaps = int(math.floor(support)) - start_off + 1
    # per-phase taps as Polyphase::build computes them, each weight
    # rounded to float32 as there
    r = np.arange(L, dtype=np.float64)[:, None]
    k = np.arange(ntaps, dtype=np.float64)[None, :]
    w = (scale * _filter_eval(scale * (start_off + k - r / L))).astype(
        np.float32
    )
    # output j = q*L + s reads window position p = (s*M)//L + k (window q
    # starts at input q*M + start_off)
    off = (np.arange(L) * M) // L
    phase = (np.arange(L) * M) % L
    P = int(off[-1]) + ntaps if L > 1 else ntaps
    W2 = np.zeros((P, L), np.float32)
    for s in range(L):
        W2[off[s] : off[s] + ntaps, s] = w[phase[s]]
    return L, M, P, -start_off, W2


@functools.lru_cache(maxsize=8)
def _weights(sr_in: int, sr_out: int, device: torch.device) -> torch.Tensor:
    """The plan's [P, L] weights on ``device``, copied there once."""
    return torch.from_numpy(_plan(sr_in, sr_out)[4]).to(device)


def is_rational(sr_in: int, sr_out: int) -> bool:
    """True when the ratio has a polyphase plan (L <= 4096), i.e. the
    batch resample applies; otherwise resample on the host."""
    g = math.gcd(sr_in, sr_out)
    return sr_out // g <= _MAX_L


def out_count(n_in, sr_in: int, sr_out: int):
    """Output length ceil(n_in * sr_out / sr_in), as ``stt_resample``.

    Works on Python ints, numpy arrays and integer tensors. The ceil is
    ``(n // M) * L + ceil((n % M) * L / M)``, whose intermediates stay
    below ``n * L / M + M * L``: a plain ``n * L`` overflows int32 at about
    five minutes of 16 kHz audio.
    """
    if sr_in == sr_out:
        return n_in
    g = math.gcd(sr_in, sr_out)
    L, M = sr_out // g, sr_in // g
    q, r = n_in // M, n_in % M
    return q * L + -(-(r * L) // M)


def input_bucket(sample_bucket: int, sr_in: int, sr_out: int) -> int:
    """The smallest input-sample bucket unit that is a multiple of the hop
    M (so the framing is a reshape) and resamples to at least
    ``sample_bucket`` output samples."""
    if sr_in == sr_out:
        return sample_bucket
    g = math.gcd(sr_in, sr_out)
    L, M = sr_out // g, sr_in // g
    return M * (-(-sample_bucket // L))


_PRECISION_LOCK = threading.Lock()


@contextlib.contextmanager
def float32_matmuls():
    """Run the body's float32 matmuls in IEEE float32 (no TF32), whatever
    the process-wide setting a caller chose, and restore it after.

    The JAX package runs the front end's products at
    ``Precision.HIGHEST``. The setting is process-wide, not per thread, so
    the bodies are serialised by a lock (a matmul reads it when it is
    launched, so the lock is held while launching, not while the card
    computes). Newer PyTorch has ``fp32_precision``; mixing it with the
    older ``allow_tf32`` makes reads of the older flag raise, so the newer
    one is used where it exists.
    """
    matmul = torch.backends.cuda.matmul
    name, value = (
        ("fp32_precision", "ieee")
        if hasattr(matmul, "fp32_precision")
        else ("allow_tf32", False)
    )
    with _PRECISION_LOCK:
        before = getattr(matmul, name)
        setattr(matmul, name, value)
        try:
            yield
        finally:
            setattr(matmul, name, before)


def batch_resample(audio: torch.Tensor, sr_in: int, sr_out: int) -> torch.Tensor:
    """Resample ``audio [B, S]`` (S % M == 0, float32) from sr_in to sr_out.

    Returns ``[B, S * L // M]``. Each row's valid length maps by
    :func:`out_count`; trailing padding zeros resample to zeros (the host
    resampler's edge clipping equals zero padding), so padded batches stay
    consistent. The caller holds :func:`float32_matmuls`.
    """
    if sr_in == sr_out:
        return audio
    B, S = audio.shape
    L, M, P, left_pad, _ = _plan(sr_in, sr_out)
    if S % M:
        raise ValueError(f"S={S} not a multiple of the polyphase hop {M}")
    nq = S // M
    # window q = padded[q*M : q*M + P]; the right padding covers the last
    # window
    n_sub = -(-(P + left_pad) // M)
    padded = F.pad(audio, (left_pad, (n_sub + 1) * M - left_pad))
    frames = padded.unfold(1, P, M)[:, :nq]  # [B, nq, P]
    y = frames.reshape(B * nq, P) @ _weights(sr_in, sr_out, audio.device)
    return y.reshape(B, nq * L)


class StreamResampler:
    """Streaming chunked resampler, sample-exact against the whole signal.

    Audio arrives in chunks of any size at ``sr_in`` and leaves at
    ``sr_out`` as EXACTLY the samples ``native.resample`` emits for the
    whole signal, by alignment and context:

    - the buffer is only ever trimmed to an input index that is a multiple
      of the polyphase hop ``M``, so the buffer's output grid is the
      global one (output ``j`` maps to input position ``j*M/L``; with
      ``s0 = c*M`` its local index is ``j - c*L`` and its phase ``j mod L``
      is kept);
    - ``guard`` input samples (more than the sinc kernel's half-width
      64/scale) of lookahead are held back until more audio arrives, and
      2x guard of emitted context stays behind the frontier, so every
      emitted sample had the kernel's full support on both sides.

    ``process(chunk)`` returns the newly available output samples (maybe
    none); ``flush()`` emits the rest, the right edge included.
    """

    def __init__(self, sr_in: int, sr_out: int):
        g = math.gcd(sr_in, sr_out)
        self.sr_in, self.sr_out = sr_in, sr_out
        self.L, self.M = sr_out // g, sr_in // g
        scale = min(1.0, sr_out / sr_in)
        self.guard = int(math.ceil(_NUM_ZEROS / scale)) + 8
        self._buf = np.zeros(0, np.float32)
        self._s0 = 0  # absolute input index of _buf[0]; a multiple of M
        self._emitted = 0  # output samples emitted so far
        self._flushed = False

    def _emit(self, out_hi: int) -> np.ndarray:
        from speecht_tpu_torch import native

        if out_hi <= self._emitted:
            return np.zeros(0, np.float32)
        y = native.resample(self._buf, self.sr_in, self.sr_out)
        base = self._s0 * self.L // self.M  # exact: s0 is a multiple of M
        out = y[self._emitted - base : out_hi - base]
        self._emitted = out_hi
        # keep 2x guard of context behind the next output's input
        # position, rounded down to a multiple of M (grid alignment)
        keep_from = (self._emitted * self.M) // self.L - 2 * self.guard
        keep_from -= keep_from % self.M
        if keep_from > self._s0:
            self._buf = self._buf[keep_from - self._s0 :]
            self._s0 = keep_from
        return out

    def process(self, chunk: np.ndarray) -> np.ndarray:
        if self._flushed:
            raise RuntimeError("StreamResampler already flushed")
        chunk = np.asarray(chunk, dtype=np.float32).ravel()
        if len(chunk):
            self._buf = np.concatenate([self._buf, chunk])
        s1 = self._s0 + len(self._buf)
        # outputs whose input position has the kernel's full right support
        out_hi = max(0, ((s1 - self.guard) * self.L) // self.M)
        return self._emit(out_hi)

    def flush(self) -> np.ndarray:
        """The remaining output, to the whole signal's output length."""
        self._flushed = True
        s1 = self._s0 + len(self._buf)
        return self._emit(int(out_count(s1, self.sr_in, self.sr_out)))
