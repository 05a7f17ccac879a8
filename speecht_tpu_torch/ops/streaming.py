"""Streaming (chunked) speech recognition: incremental features + decode.

Counterpart of ``speecht_tpu/ops/streaming.py``, ``record --streaming``'s
recognizer. Audio arrives in chunks; features are extracted incrementally
on the host (O(new frames) a chunk, numpy float64 as in JAX, through the
port's ``data/features`` copies of the window, the mel filterbank and the
DCT); the conv stack runs over a rolling window of a fixed size on the
model's device (``train/step.make_forward_step``), and only the window's
``[W//2, C]`` logits come back to the host. The transcript splits into a
**committed** part, logit frames whose whole receptive field to the right
has arrived, and a **tentative** tail that may still change. Committed
text is frozen once emitted and only grows, so partials never regress.

The offline features normalize per utterance (the dB reference is the
utterance's max; mean and std over all of it), which is not causal. Here
each frame's dB value is frozen with the running maximum when it arrives,
and mean and std are running sums over frozen values; they converge to
the offline ones as the utterance grows, and ``finalize()`` recomputes the
whole utterance offline for an exact final transcript.

Both feature types stream: 'power' (128 log-mel) and 'mfcc' (13 MFCCs +
delta + delta-delta = 39; the deltas reach 8 frames, well inside the
committed margin).
"""

from __future__ import annotations

import numpy as np
import torch

from speecht_tpu_torch import vocabulary
from speecht_tpu_torch.data import features as F
from speecht_tpu_torch.train import step as tstep

# right-context margin (input feature frames) before a logit frame is
# committed: the Wav2Letter receptive field is ~194 input frames (48-wide
# stride-2 conv + 7x 7-wide + 32-wide at rate 2), so a logit frame needs
# ~97 future input frames to be final; 112 adds margin and lane alignment
RIGHT_CONTEXT = 112

_DB_FLOOR = 80.0  # librosa top_db
_AMIN = 1e-10

# a logit row's standing value must come from a window pass in which the
# row had at least this many rows (= 2x input frames) of context on each
# side; 64 rows = 128 input frames, above both the ~97-frame one-sided
# receptive field and RIGHT_CONTEXT/2
MARGIN_ROWS = 64


def greedy_collapse(best_path: np.ndarray, prev: int = -1) -> list[int]:
    """Collapse repeats then drop blanks (host-side helper)."""
    return greedy_collapse_carry(best_path, prev)[0]


def greedy_collapse_carry(
    best_path: np.ndarray, prev: int = -1
) -> tuple[list[int], int]:
    """Collapse with carry: returns (ids, last raw char) so a later span can
    continue the collapse exactly where an earlier (committed) span ended."""
    out = []
    for c in best_path:
        c = int(c)
        if c != prev and c != vocabulary.BLANK_ID:
            out.append(c)
        prev = c
    return out, prev


class _RunningNorm:
    """Mean-0/std-1 over all scalars seen so far (O(new) updates)."""

    def __init__(self):
        self.n = 0.0
        self.total = 0.0
        self.sumsq = 0.0

    def update(self, values: np.ndarray):
        self.n += values.size
        self.total += float(values.sum())
        self.sumsq += float(np.square(values, dtype=np.float64).sum())

    def apply(self, values: np.ndarray) -> np.ndarray:
        if self.n == 0:
            return values
        mean = self.total / self.n
        var = max(self.sumsq / self.n - mean * mean, 0.0)
        std = np.sqrt(var) if var > 0 else 1.0
        return (values - mean) / std


class StreamingRecognizer:
    """Incremental recognition over raw-audio chunks (host features, the
    model on its own device)."""

    def __init__(
        self,
        model,
        sample_rate: int = 16000,
        feature_type: str = "power",
        window_frames: int = 512,
        hop_length: int = 160,
        n_fft: int = 512,
        debug_buffers: bool = False,
    ):
        if feature_type not in ("power", "mfcc"):
            raise ValueError(f"unsupported feature type {feature_type!r}")
        if window_frames % 2 or window_frames <= 4 * MARGIN_ROWS:
            raise ValueError(
                f"window_frames must be even and > {4 * MARGIN_ROWS} "
                f"(got {window_frames}): each full window seals its rows "
                "up to MARGIN_ROWS short of both edges, so smaller windows "
                "cannot advance the catch-up sweep"
            )
        expected = F.feature_size(feature_type)
        if model.config.input_size != expected:
            raise ValueError(
                f"model input_size {model.config.input_size} does not match "
                f"feature type {feature_type!r} ({expected} dims)"
            )
        self.model = model
        self.device = next(model.parameters()).device
        self.sample_rate = sample_rate
        self.feature_type = feature_type
        self.window_frames = window_frames
        self.hop = hop_length
        self.n_fft = n_fft
        self.input_size = model.config.input_size
        # keep the raw mel/log-mel history for parity inspection (tests);
        # a live stream must not accumulate them: nothing reads them after
        # they arrive, and an endless microphone stream would grow by
        # ~200 KB/s of float64 rows
        self._debug_buffers = debug_buffers
        self._dct = F.dct_basis(13, 128)
        self._fb = F.mel_filterbank(sample_rate, n_fft, n_mels=128)
        self._hann = F.hann_window(n_fft)

        self._forward_step = tstep.make_forward_step(model)
        self.reset()

    def _forward(self, window: np.ndarray) -> np.ndarray:
        """The model over ``window [1, T, F]`` on its device -> logits
        ``[T//2, C]`` on the host."""
        x = torch.from_numpy(window).to(self.device)
        return self._forward_step(x)[0].cpu().numpy()

    def reset(self):
        self._audio = np.zeros(0, dtype=np.float32)
        self._n_frames = 0  # mel frames extracted so far
        # debug-only histories (None unless debug_buffers=True)
        self._mel_power: np.ndarray | None = None  # [T, 128] raw power
        self._log_mel: np.ndarray | None = None  # [T, 128] 10*log10(power)
        self._db_max = -np.inf  # running max of the log-mel values
        # power path: frozen (floored, max-referenced) dB values + stats
        self._db: np.ndarray | None = None
        self._db_norm = _RunningNorm()
        # mfcc path: frozen cepstra + per-block stats over stable frames
        self._mfcc: np.ndarray | None = None  # [T, 13]
        self._mfcc_norm = _RunningNorm()
        self._d1_norm = _RunningNorm()
        self._d2_norm = _RunningNorm()
        self._d1_stable = 0  # frames whose delta is final (t <= T-5)
        self._d2_stable = 0  # frames whose delta-delta is final (t <= T-9)
        # decode state
        self._logits: np.ndarray | None = None  # [T//2, C]
        self._good_rows = 0  # rows sealed with full two-sided context
        self._frontier = 0  # committed logit frames
        self._committed_ids: list[int] = []
        self._committed_prev = -1

    # -- incremental feature extraction ------------------------------------

    def _extract_new_frames(self):
        """Mel power for frames not yet computed (full left/right context)."""
        have = self._n_frames
        # a frame t is exact once audio covers t*hop + n_fft//2 samples,
        # except frame 0, whose left-edge reflection reads sample index
        # n_fft//2 itself: at exactly n_fft//2 buffered samples the
        # reflected gather would index one past the buffer
        computable = max(
            0, (len(self._audio) - self.n_fft // 2) // self.hop + 1
        )
        if len(self._audio) == self.n_fft // 2:
            computable = 0
        if computable <= have:
            return
        # compute frames [have, computable) directly from their local audio
        # (O(new frames) per chunk): window positions with reflect padding
        # at the utterance start, full real context everywhere else
        t = np.arange(have, computable)[:, None]
        q = t * self.hop + np.arange(self.n_fft)[None, :] - self.n_fft // 2
        q = np.abs(q)  # numpy-'reflect' at the left edge
        frames = self._audio[q] * self._hann[None, :]
        spec = np.fft.rfft(frames, n=self.n_fft, axis=1)
        power = np.abs(spec) ** 2  # [n_new, 257]
        new_power = power @ self._fb.T  # [n_new, 128]
        new_log = 10.0 * np.log10(np.maximum(_AMIN, new_power))

        def grow(buf, new):
            return new if buf is None else np.concatenate([buf, new])

        self._n_frames = computable
        if self._debug_buffers:
            self._mel_power = grow(self._mel_power, new_power)
            self._log_mel = grow(self._log_mel, new_log)
        self._db_max = max(self._db_max, float(new_log.max()))

        if self.feature_type == "power":
            # frozen causal value: dB referenced to the running max (the
            # utterance's max offline) with the top_db floor, frozen when
            # it arrives so committed frames never shift
            v = np.maximum(new_log - self._db_max, -_DB_FLOOR).astype(
                np.float32
            )
            self._db = grow(self._db, v)
            self._db_norm.update(v)
        else:
            # MFCC: dB floor is global-max-relative (power_to_db top_db);
            # frozen with the running max
            floored = np.maximum(new_log, self._db_max - _DB_FLOOR)
            mf = (floored @ self._dct.T).astype(np.float32)  # [n_new, 13]
            self._mfcc = grow(self._mfcc, mf)
            self._mfcc_norm.update(mf)
            self._update_stable_delta_stats()

    def _delta_rows(self, s: int, e: int, order: int) -> np.ndarray:
        """delta(mfcc)[s:e] using real context; edge padding only engages at
        the true array boundaries (matching the offline F.delta)."""
        reach = 4 * order
        T = self._mfcc.shape[0]
        lo = max(0, s - reach)
        hi = min(T, e + reach)
        d = F.delta(self._mfcc[lo:hi].T, order=order).T
        return d[s - lo : e - lo]

    def _update_stable_delta_stats(self):
        """Fold newly *final* delta rows into the running block stats.

        d1[t] needs mfcc[t-4:t+5] (final once T >= t+5); d2[t] reaches
        mfcc[t+8]. Rows nearer the end are tentative (their offline value
        still depends on future frames via edge padding) and are excluded
        until they stabilize.
        """
        T = self._mfcc.shape[0]
        new_d1 = max(self._d1_stable, 0), max(T - 4, 0)
        if new_d1[1] > new_d1[0]:
            self._d1_norm.update(self._delta_rows(new_d1[0], new_d1[1], 1))
            self._d1_stable = new_d1[1]
        new_d2 = max(self._d2_stable, 0), max(T - 8, 0)
        if new_d2[1] > new_d2[0]:
            self._d2_norm.update(self._delta_rows(new_d2[0], new_d2[1], 2))
            self._d2_stable = new_d2[1]

    def _window_features(self, s: int, e: int) -> np.ndarray:
        """Normalized features for frames [s, e), O(e - s)."""
        if self.feature_type == "power":
            return self._db_norm.apply(self._db[s:e]).astype(np.float32)
        mf = self._mfcc_norm.apply(self._mfcc[s:e])
        d1 = self._d1_norm.apply(self._delta_rows(s, e, 1))
        d2 = self._d2_norm.apply(self._delta_rows(s, e, 2))
        return np.concatenate([mf, d1, d2], axis=1).astype(np.float32)

    def _run_window(self, ws: int):
        """Run the model over input frames [ws, ws+W) and merge the logits.

        ``ws`` must be even so the stride-2 output grid of the window stays
        in phase with the global logit grid. Rows below ``_good_rows`` are
        sealed (their standing value already has >=MARGIN_ROWS rows of
        context on each side) and are not overwritten; a full window seals
        its rows up to MARGIN_ROWS short of its end.
        """
        T = self._n_frames
        W = self.window_frames
        Wt = min(W, T - ws)
        feats = self._window_features(ws, ws + Wt)
        window = feats if Wt == W else np.pad(
            feats, ((0, W - Wt), (0, 0))
        )
        logits = self._forward(window[None])  # [W//2, C]
        valid_out = Wt // 2
        out_start = ws // 2
        total_out = T // 2
        C = logits.shape[-1]
        if self._logits is None or self._logits.shape[0] < total_out:
            grown = np.zeros((total_out, C), dtype=np.float32)
            if self._logits is not None:
                grown[: self._logits.shape[0]] = self._logits
            self._logits = grown
        lo = max(self._good_rows, out_start)
        hi = min(out_start + valid_out, total_out)
        if hi > lo:
            self._logits[lo:hi] = logits[lo - out_start : hi - out_start]
        if Wt == W:
            self._good_rows = max(
                self._good_rows, out_start + valid_out - MARGIN_ROWS
            )

    # -- public API ---------------------------------------------------------

    def accept_chunk(self, audio_chunk: np.ndarray) -> str:
        """Append audio; returns committed + tentative text."""
        self._audio = np.concatenate(
            [self._audio, np.asarray(audio_chunk, dtype=np.float32)]
        )
        self._extract_new_frames()
        if self._n_frames < 2:
            return ""

        W = self.window_frames
        T = self._n_frames
        # final (newest-audio) window start, even-aligned; when T-W is odd
        # the last frame waits for the next pass (its logit row does not
        # exist yet: total_out = T//2 is unchanged by one dangling frame)
        fs = max(0, T - W)
        fs -= fs % 2
        # catch-up: one chunk can advance the stream by more than a window
        # (bulk/file input); run intermediate full windows so every row the
        # frontier will cross has a value computed with real context, not
        # zeros or an edge-truncated pass
        while fs > 0 and self._good_rows < fs // 2 + MARGIN_ROWS:
            self._run_window(max(0, 2 * (self._good_rows - MARGIN_ROWS)))
        self._run_window(fs)
        total_out = T // 2

        # advance the commit frontier over logit frames whose full right
        # context (RIGHT_CONTEXT input frames) has arrived; committed ids
        # are frozen so the transcript never regresses
        new_frontier = max(self._frontier, (T - RIGHT_CONTEXT) // 2)
        new_frontier = min(new_frontier, total_out)
        if new_frontier > self._frontier:
            ids, self._committed_prev = greedy_collapse_carry(
                np.argmax(
                    self._logits[self._frontier : new_frontier], axis=-1
                ),
                self._committed_prev,
            )
            self._committed_ids.extend(ids)
            self._frontier = new_frontier
        return self.partial_text()

    def committed_text(self) -> str:
        """Transcript over frames with full right context; never regresses."""
        return vocabulary.ids_to_sentence(self._committed_ids)

    def partial_text(self) -> str:
        """Committed text plus the tentative tail (may still change)."""
        if self._logits is None or not len(self._logits):
            return self.committed_text()
        total_out = self._logits.shape[0]
        tentative, _ = greedy_collapse_carry(
            np.argmax(self._logits[self._frontier : total_out], axis=-1),
            self._committed_prev,
        )
        return vocabulary.ids_to_sentence(self._committed_ids + tentative)

    def partial_text_fused(
        self,
        lm,
        lm_weight: float = 0.8,
        word_count_weight: float = 0.0,
        valid_word_count_weight: float = 2.3,
        beam_width: int = 32,
    ) -> str:
        """Committed text + an LM-fused beam over the tentative tail.

        A narrow continuation-mode prefix beam
        (``native.ctc_beam_search_cont``) decodes the tentative logit span
        conditioned on the committed context: the committed complete
        words seed the LM history, the committed trailing word fragment
        prefixes the first word completed in the tail, and the greedy
        collapse carry crosses the boundary so repeats merge exactly as
        the committed path left them. The committed span itself is never
        re-decoded, so the committed text still never changes; only the
        tentative tail benefits from the LM, and as the utterance ends
        the fused partial converges to ``finalize(beam)``'s transcript.

        ``lm`` is a ``native.NGramLM`` (the port's); greedy partials remain the
        default (``partial_text``) when no LM is configured.
        """
        from speecht_tpu_torch import native

        if self._logits is None or not len(self._logits):
            return self.committed_text()
        total_out = self._logits.shape[0]
        tail = self._logits[self._frontier : total_out]
        if not len(tail):
            return self.committed_text()
        shifted = tail - tail.max(-1, keepdims=True)
        logp = shifted - np.log(np.exp(shifted).sum(-1, keepdims=True))
        prev = self._committed_prev
        mid_char = prev not in (-1, vocabulary.BLANK_ID)
        ids = native.ctc_beam_search_cont(
            logp.astype(np.float32),
            context_text=self.committed_text(),
            last_char_id=int(prev) if mid_char else -1,
            ended_in_blank=not mid_char,
            beam_width=beam_width,
            lm=lm,
            lm_weight=lm_weight,
            word_count_weight=word_count_weight,
            valid_word_count_weight=valid_word_count_weight,
            blank_id=vocabulary.BLANK_ID,
        )
        return vocabulary.ids_to_sentence(
            self._committed_ids + [int(x) for x in ids]
        )

    def finalize_logits(self) -> np.ndarray:
        """Exact offline logits [T//2, C] of the full buffered utterance."""
        if len(self._audio) < self.n_fft:
            return np.zeros((0, vocabulary.NUM_CLASSES), np.float32)
        if self.feature_type == "power":
            feats = F.calc_power_spectrogram(self._audio, self.sample_rate)
        else:
            feats = F.calc_mfccs(self._audio, self.sample_rate)
        T = feats.shape[0]
        W = self.window_frames
        pad_T = -(-T // W) * W
        padded = np.pad(feats, ((0, pad_T - T), (0, 0))).astype(np.float32)
        # the final pass runs the whole utterance in one shot, padded to a
        # window multiple so the shapes repeat
        logits = self._forward(padded[None])
        return logits[: T // 2]

    def finalize(self, beam=None, **weight_overrides) -> str:
        """Exact offline decode of the full buffered utterance.

        With ``beam`` (an ``ops.beam.BeamSearchDecoder``) the final
        transcript is decoded through its search (the host prefix beam, or
        with ``--device-beam`` the device beam on the model's device), the
        streaming twin of ``record --language-model``'s one-shot decode;
        greedy otherwise.
        """
        logits = self.finalize_logits()
        if not len(logits):
            return ""
        if beam is not None:
            shifted = logits - logits.max(-1, keepdims=True)
            logp = shifted - np.log(
                np.exp(shifted).sum(-1, keepdims=True)
            )
            emissions = logp[None].astype(np.float32)
            if beam.device_beam:
                emissions = torch.from_numpy(emissions).to(self.device)
            decoded, lengths = beam.decode_emissions(
                emissions,
                np.array([len(logp)], np.int32),
                **weight_overrides,
            )
            return vocabulary.ids_to_sentence(decoded[0, : lengths[0]])
        ids = greedy_collapse(np.argmax(logits, axis=-1))
        return vocabulary.ids_to_sentence(ids)
