"""Audio capture for ``record``: the microphone, with silence gating, or
audio files in its place.

Counterpart of ``speecht_tpu/record_utils.py``: a float32 mono stream at
16 kHz, an amplitude gate (0.03) to start, a stop after 30 silent chunks
in a row, then the post chain: normalize to a 0.5 peak, trim the silence
at both ends and pad 0.1 s of silence on each side.
:class:`FileAudioSource` (``record --audio-source``) feeds files through
the microphone's interface and post chain, decoding FLAC and resampling
with the port's own host library (``native.flac_decode``,
``native.resample``).

pyaudio (portaudio) is imported only when :class:`AudioRecorder` is
built; without it that raises the RuntimeError ``main`` prints as one
line. The post chain is numpy and needs no audio hardware.
"""

from __future__ import annotations

import contextlib

import numpy as np


def normalize_peak(audio: np.ndarray, maximum: float = 0.5) -> np.ndarray:
    """Scale so the absolute peak is ``maximum``."""
    peak = np.abs(audio).max()
    if peak == 0:
        return audio.astype(np.float32)
    return (audio * (maximum / peak)).astype(np.float32)


def trim_silence(audio: np.ndarray, threshold: float = 0.03) -> np.ndarray:
    """Trim the leading and trailing samples below ``threshold``."""
    loud = np.flatnonzero(np.abs(audio) > threshold)
    if len(loud) == 0:
        return audio[:0]
    return audio[loud[0] : loud[-1] + 1]


def add_silence(audio: np.ndarray, seconds: float, rate: int) -> np.ndarray:
    """Pad ``seconds`` of silence on both ends."""
    pad = np.zeros(int(seconds * rate), dtype=np.float32)
    return np.concatenate([pad, audio, pad])


def postprocess_recording(
    audio: np.ndarray, rate: int, threshold: float = 0.03
) -> np.ndarray:
    """normalize -> trim -> pad: the microphone's post chain."""
    audio = normalize_peak(np.asarray(audio, dtype=np.float32))
    audio = trim_silence(audio, threshold)
    return add_silence(audio, 0.1, rate)


class AudioSourceExhausted(Exception):
    """Raised by a file-backed audio source when all audio is consumed.

    The microphone never raises it (it has no end); ``record`` treats it
    as the microphone's ctrl-c: it finishes and returns.
    """


class FileAudioSource:
    """File-backed drop-in for :class:`AudioRecorder` (``--audio-source``).

    Feeds audio files through the microphone's interface: ``record()``
    gives one utterance a file, through the same normalize/trim/pad post
    chain, and ``open_input_stream()`` raw chunks of a fixed size for
    streaming, so ``record`` runs end to end without audio hardware. FLAC
    decodes through the port's native decoder; a file at another rate is
    sinc-resampled to ``rate``. A ``.npy`` file holds float32 samples at
    ``rate``.
    """

    def __init__(self, paths, rate: int = 16000, threshold: float = 0.03,
                 chunk_size: int = 1024):
        if isinstance(paths, str):
            paths = [paths]
        if not paths:
            raise ValueError("FileAudioSource needs at least one audio file")
        self.rate = rate
        self.threshold = threshold
        self.chunk_size = chunk_size
        self._paths = list(paths)
        self._next = 0

    def _load(self, path: str) -> np.ndarray:
        from speecht_tpu_torch import native

        if path.endswith(".npy"):
            audio = np.load(path).astype(np.float32)
            sr = self.rate
        else:
            audio, sr = native.flac_decode(path)
        if sr != self.rate:
            audio = native.resample(audio, sr, self.rate)
        return audio.astype(np.float32)

    def record(self) -> tuple[np.ndarray, int]:
        """Next file as one gated utterance; raises when files run out."""
        if self._next >= len(self._paths):
            raise AudioSourceExhausted()
        audio = self._load(self._paths[self._next])
        self._next += 1
        return postprocess_recording(audio, self.rate, self.threshold), 4

    @contextlib.contextmanager
    def open_input_stream(self):
        """Raw chunk reader over the concatenation of all files.

        The microphone stream's contract (``chunk_size`` float32 samples a
        call) except at the end: the last chunk comes short, not padded
        with zeros (silence appended there would add frames a microphone
        never gives), and the next call raises AudioSourceExhausted.
        """
        audio = np.concatenate([self._load(p) for p in self._paths])
        state = {"pos": 0}

        def read_chunk() -> np.ndarray:
            pos = state["pos"]
            if pos >= len(audio):
                raise AudioSourceExhausted()
            chunk = audio[pos : pos + self.chunk_size]
            state["pos"] = pos + self.chunk_size
            return chunk.astype(np.float32)

        yield read_chunk

    def terminate(self):
        pass


class AudioRecorder:
    """Silence-gated microphone recorder (requires pyaudio at runtime)."""

    def __init__(self, rate: int = 16000, threshold: float = 0.03,
                 chunk_size: int = 1024):
        try:
            import pyaudio
        except ImportError as e:
            raise RuntimeError(
                "record needs pyaudio (portaudio) for the microphone, and it "
                "is not installed; --audio-source FILE... reads audio files "
                "instead"
            ) from e
        self.rate = rate
        self.threshold = threshold
        self.chunk_size = chunk_size
        self._pyaudio_mod = pyaudio
        self._pyaudio = pyaudio.PyAudio()

    def is_silent(self, chunk: np.ndarray) -> bool:
        return float(np.max(chunk)) < self.threshold

    def record(self) -> tuple[np.ndarray, int]:
        """Block until an utterance is captured; returns (audio, sample_width)."""
        pa = self._pyaudio_mod
        stream = self._pyaudio.open(
            format=pa.paFloat32,
            channels=1,
            rate=self.rate,
            input=True,
            output=True,
            frames_per_buffer=self.chunk_size,
        )
        num_silent = 0
        snd_started = False
        chunks: list[np.ndarray] = []
        while True:
            data = np.frombuffer(
                stream.read(self.chunk_size), dtype=np.float32
            )
            chunks.append(data)
            silent = self.is_silent(data)
            if silent and snd_started:
                num_silent += 1
            elif not silent and not snd_started:
                snd_started = True
            if snd_started and num_silent > 30:
                break
        sample_width = self._pyaudio.get_sample_size(pa.paFloat32)
        stream.stop_stream()
        stream.close()
        audio = postprocess_recording(
            np.concatenate(chunks), self.rate, self.threshold
        )
        return audio, sample_width

    @contextlib.contextmanager
    def open_input_stream(self):
        """Raw ungated input stream (streaming transcription).

        Yields a ``read() -> np.ndarray`` callable that returns one
        ``chunk_size`` float32 chunk a call; the stream closes on exit.
        All of pyaudio's stream handling stays inside the recorder, so
        ``record()`` and the streaming path cannot drift apart.
        """
        pa = self._pyaudio_mod
        stream = self._pyaudio.open(
            format=pa.paFloat32,
            channels=1,
            rate=self.rate,
            input=True,
            frames_per_buffer=self.chunk_size,
        )
        try:
            yield lambda: np.frombuffer(
                stream.read(self.chunk_size), dtype=np.float32
            )
        finally:
            stream.stop_stream()
            stream.close()

    def terminate(self):
        self._pyaudio.terminate()
