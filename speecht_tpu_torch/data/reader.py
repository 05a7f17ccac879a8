"""Corpus reader: transcripts, the npz feature cache and the raw audio.

Counterpart of ``speecht_tpu/data/reader.py``:

- transcript dicts from recursive ``*.trans.txt`` scans (each line is
  ``<utterance-id> WORD WORD ...``);
- the cache directory names (``preprocessed-power`` for the power
  spectrogram, ``preprocessed`` for MFCCs) and one ``<utterance-id>.npz``
  per utterance with the keys ``audio_fragments`` and ``transcript``;
- :meth:`SpeechCorpusReader.store_samples` (``preprocess``): FLAC -> host
  DSP -> npz on a process pool; :meth:`store_samples_device`
  (``preprocess --device``): FLAC decoded on the host at its own rate,
  resample and DSP on the device in padded batches;
- :meth:`load_samples`: the cache, shuffled, through the native npz reader
  (``READ_CHUNK`` files a call on ``READ_THREADS`` threads; ``np.load``
  only for files of another layout; a looping shard that fits
  ``KEEP_BYTES`` is read once), one equal shard a data
  rank in a multi-process run (:func:`_equal_shard`), and
  :meth:`load_raw_samples`: the FLACs themselves (``--from-audio``),
  sharded alike.
"""

from __future__ import annotations

import fnmatch
import logging
import multiprocessing
import os
import queue
import random
import threading
from typing import Callable, Iterator

import numpy as np

from speecht_tpu_torch import native, vocabulary
from speecht_tpu_torch.data import features as F

log = logging.getLogger(__name__)

# The cache is read READ_CHUNK files at a time (a batch of B=64) on
# READ_THREADS native threads (``native.NpzReader``), the GIL handed back
# twice a chunk. Read a file at a time through ``npz_load_sample`` (the GIL
# handed back four times a file, its bytes copied four times), MFCC-39
# batches of 64 came at 84-99 ms a batch from a loader alone on the host of
# an H100 machine whose files sit on 9p, and at 25 ms read this way.
READ_CHUNK = 64
READ_THREADS = 4

# A training loop reads its shard pass after pass. When the shard's samples
# fit in this many bytes, the first pass keeps them (read-only) and every
# later pass comes from memory, as from a host's page cache at memory
# speed; a larger shard is read anew each pass. (4 GiB: 55 hours of
# MFCC-39 features, 17 of power-128.) On the H100 machine's host the page
# cache does not give that speed: its 9p files read at 0.4-1.4 GB/s, so a
# batch of MFCC-39 (17 MB) took 12-43 ms to read, beside a card that needs
# 31.5 ms for the step.
KEEP_BYTES = 4 << 30


def iglob_recursive(directory: str, file_pattern: str) -> Iterator[str]:
    """Recursively yield files under ``directory`` matching ``file_pattern``."""
    for root, _dirs, file_names in os.walk(directory):
        for filename in fnmatch.filter(file_names, file_pattern):
            yield os.path.join(root, filename)


def _equal_shard(files: list, shard_index: int, shard_count: int) -> list:
    """Shard ``shard_index``'s slice, truncated so every shard is the
    same length.

    The ranks build their batches in lockstep (``build_batch`` runs one
    collective a batch, ``parallel/mesh.py::sync_bucket_dims``), so a
    longer shard would leave its rank blocked in a collective its peers
    never join. The cost is at most ``shard_count - 1`` trailing files of
    the shuffled corpus.
    """
    per = len(files) // shard_count
    return files[shard_index::shard_count][:per]


def _resolve_feature_fn(feature_type) -> Callable:
    if callable(feature_type):
        return feature_type
    if feature_type not in F.FEATURE_FUNCTIONS:
        raise ValueError("Feature type must be mfcc or power.")
    return F.FEATURE_FUNCTIONS[feature_type]


def _audio_id(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def _load_and_transform(audio_file: str, feature_fn: Callable) -> np.ndarray:
    audio, samplerate = native.load_audio(audio_file)
    return feature_fn(audio, samplerate)


def _save(out_directory: str, audio_id: str, features, transcript) -> None:
    np.savez(
        os.path.join(out_directory, audio_id),
        audio_fragments=features,
        transcript=np.asarray(transcript, dtype=np.int64),
    )


def _transform_and_store(args) -> str | None:
    """Pool worker: decode, featurize and save one utterance; returns its
    error, or None."""
    audio_file, feature_fn, transcript, out_directory = args
    try:
        fragments = _load_and_transform(audio_file, feature_fn)
        _save(out_directory, _audio_id(audio_file), fragments, transcript)
        return None
    except Exception as e:  # noqa: BLE001 - collected and raised by the caller
        return f"{audio_file}: {type(e).__name__}: {e}"


def _raise_errors(errors: list[str]) -> None:
    if errors:
        raise RuntimeError(
            "An error occurred during preprocessing:\n" + "\n".join(errors[:10])
        )


def _flac_header_sample_rate(path: str) -> int | None:
    """Sample rate from a FLAC STREAMINFO header (21 bytes, no decode).

    The 4-byte ``fLaC`` magic, a 4-byte metadata block header whose block
    must be STREAMINFO (type 0), then its body with the 20-bit sample rate
    at body bytes 10-12. None for anything that does not parse.
    """
    try:
        with open(path, "rb") as f:
            head = f.read(21)
    except OSError:
        return None
    if len(head) < 21 or head[:4] != b"fLaC" or (head[4] & 0x7F) != 0:
        return None
    body = head[8:]
    sr = (body[10] << 12) | (body[11] << 4) | (body[12] >> 4)
    return sr or None


class SpeechCorpusReader:
    """Reads raw and preprocessed speech corpus files under ``data_directory``."""

    def __init__(self, data_directory: str):
        self._data_directory = data_directory
        self._transcript_dict_cache: dict[str, list[int]] | None = None

    @property
    def _transcript_dict(self) -> dict[str, list[int]]:
        if self._transcript_dict_cache is None:
            self._transcript_dict_cache = self._build_transcript()
        return self._transcript_dict_cache

    @staticmethod
    def _get_transcript_entries(transcript_directory: str):
        for transcript_file in iglob_recursive(
            transcript_directory, "*.trans.txt"
        ):
            with open(transcript_file) as f:
                for line in f:
                    line = line.rstrip("\n")
                    if line:
                        yield line.split(" ", 1)

    def _build_transcript(self) -> dict[str, list[int]]:
        return {
            entry[0]: vocabulary.sentence_to_ids(entry[1])
            for entry in self._get_transcript_entries(self._data_directory)
        }

    def _get_directory(self, feature_type, sub_directory: str) -> str:
        preprocess_directory = "preprocessed"
        if feature_type is F.calc_power_spectrogram or feature_type == "power":
            preprocess_directory += "-power"
        return os.path.join(
            self._data_directory, preprocess_directory, sub_directory
        )

    def _audio_files(self, directory: str) -> list[str]:
        return list(
            iglob_recursive(
                os.path.join(self._data_directory, directory), "*.flac"
            )
        )

    # -- store / generate ----------------------------------------------------

    def generate_samples(self, directory: str, feature_type):
        """Yield (audio_id, features, transcript), decoding the FLACs."""
        feature_fn = _resolve_feature_fn(feature_type)
        transcript_dict = self._transcript_dict
        for audio_file in self._audio_files(directory):
            audio_id = _audio_id(audio_file)
            fragments = _load_and_transform(audio_file, feature_fn)
            yield audio_id, fragments, transcript_dict[audio_id]

    def store_samples(
        self, directory: str, feature_type, num_workers: int = 0
    ) -> int:
        """Preprocess every FLAC under ``directory`` into the npz cache with
        the host DSP; returns the number of utterances stored.

        ``num_workers`` processes (0: one per core; 1: this process) run
        decode, resample, DSP and store. They are spawned, not forked, so
        they inherit no CUDA context and no thread of the caller. Errors
        are collected, the rest of the corpus completes, and one exception
        is raised at the end.
        """
        feature_fn = _resolve_feature_fn(feature_type)
        out_directory = self._get_directory(feature_type, directory)
        os.makedirs(out_directory, exist_ok=True)
        # built here, once: a library that cannot be built raises before
        # any worker starts
        native.build()
        transcript_dict = self._transcript_dict
        tasks = [
            (f, feature_fn, transcript_dict[_audio_id(f)], out_directory)
            for f in self._audio_files(directory)
        ]
        workers = num_workers or os.cpu_count() or 1
        if workers <= 1 or len(tasks) <= 1:
            errors = [e for e in map(_transform_and_store, tasks) if e]
        else:
            ctx = multiprocessing.get_context("spawn")
            with ctx.Pool(processes=min(workers, len(tasks))) as pool:
                errors = [e for e in pool.map(_transform_and_store, tasks) if e]
        _raise_errors(errors)
        return len(tasks)

    def store_samples_device(
        self,
        directory: str,
        feature_type: str,
        device,
        batch_size: int = 16,
        sample_bucket: int = 160 * 512,
        sample_rate: int = 22050,
        transfer_dtype: str = "bfloat16",
    ) -> int:
        """Preprocess every FLAC under ``directory`` with the DSP on
        ``device``; returns the number of utterances stored.

        The host decodes each file at its own rate and groups the audio
        into padded batches keyed on (rate, length in bucket units); the
        unit is ``input_bucket(sample_bucket)``, a multiple of the
        resample hop. A ratio with no polyphase plan (L > 4096) is
        resampled on the host and batched with the ``sample_rate`` files.
        A worker thread takes each batch through the upload (int16 on the
        bf16 wire), the front end of ``--from-audio``
        (``features_device.make_front_end``: resample to ``sample_rate``
        and the DSP), the download of the features (bf16 on the bf16
        wire, sliced to the batch's real frame count first) and the npz
        store, while this thread decodes the next batch. The cache layout
        is the host path's. Nothing is forked. Errors are collected and
        raised at the end.
        """
        import torch

        from speecht_tpu_torch.data import features_device
        from speecht_tpu_torch.data.pipeline import audio_to_int16
        from speecht_tpu_torch.ops import resample as resample_mod

        if feature_type not in ("power", "mfcc"):
            raise ValueError("Feature type must be mfcc or power.")
        device = torch.device(device)
        compact_wire = transfer_dtype == "bfloat16"
        out_directory = self._get_directory(feature_type, directory)
        os.makedirs(out_directory, exist_ok=True)
        transcript_dict = self._transcript_dict
        front_ends = {}
        errors: list[str] = []

        def process_batch(items, audio, num_samples, native_sr) -> None:
            if native_sr not in front_ends:
                front_ends[native_sr] = features_device.make_front_end(
                    feature_type, wire_sr=native_sr, sr=sample_rate
                )
            with torch.inference_mode():
                feats, frame_lengths = front_ends[native_sr](
                    torch.from_numpy(audio).to(device),
                    torch.from_numpy(num_samples).to(device),
                )
                # the frames that exist (1 + n // 160 at the cache rate):
                # the bucket's padded tail never crosses the wire
                n_out = resample_mod.out_count(
                    int(num_samples.max()), native_sr, sample_rate
                )
                feats = feats[:, : 1 + n_out // 160]
                if compact_wire:
                    feats = feats.to(torch.bfloat16)
                feats = feats.cpu().float().numpy()
                frame_lengths = frame_lengths.cpu().numpy()
            for i, (aid, _audio) in enumerate(items):
                try:
                    _save(out_directory, aid, feats[i, : frame_lengths[i]],
                          transcript_dict[aid])
                except Exception as e:  # noqa: BLE001 - collected
                    errors.append(f"{aid}: {e!r}")

        work: queue.Queue = queue.Queue(maxsize=2)
        failure: list[BaseException] = []

        def worker() -> None:
            while True:
                task = work.get()
                if task is None:
                    return
                try:
                    process_batch(*task)
                except BaseException as e:  # noqa: BLE001 - raised after join
                    failure.append(e)

        def flush(native_sr: int, n_units: int, items: list) -> None:
            S = n_units * resample_mod.input_bucket(
                sample_bucket, native_sr, sample_rate
            )
            audio = np.zeros((batch_size, S), np.float32)
            num_samples = np.zeros(batch_size, np.int32)
            for i, (_aid, a) in enumerate(items):
                audio[i, : len(a)] = a
                num_samples[i] = len(a)
            if compact_wire:
                audio = audio_to_int16(audio)
            work.put((items, audio, num_samples, native_sr))

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        pending: dict[tuple[int, int], list] = {}
        stored = 0
        try:
            for audio_file in self._audio_files(directory):
                aid = _audio_id(audio_file)
                if aid not in transcript_dict:
                    errors.append(f"{audio_file}: no transcript entry")
                    continue
                try:
                    audio, native_sr = native.load_audio(audio_file, sr=None)
                    if not resample_mod.is_rational(native_sr, sample_rate):
                        audio = native.resample(audio, native_sr, sample_rate)
                        native_sr = sample_rate
                except ValueError as e:
                    errors.append(f"{audio_file}: {e!r}")
                    continue
                stored += 1
                unit = resample_mod.input_bucket(
                    sample_bucket, native_sr, sample_rate
                )
                key = (native_sr, max(1, -(-len(audio) // unit)))
                pending.setdefault(key, []).append((aid, audio))
                if len(pending[key]) == batch_size:
                    flush(*key, pending.pop(key))
            for key, items in sorted(pending.items()):
                flush(*key, items)
        finally:
            work.put(None)
            thread.join()
        if failure:
            raise failure[0]
        _raise_errors(errors)
        return stored

    # -- raw audio -----------------------------------------------------------

    def probe_native_rate(self, directory: str) -> int | None:
        """The one sample rate of all FLACs under ``directory``, from their
        STREAMINFO headers (no decode); None for an empty directory, a
        header that does not parse, or a corpus of mixed rates (one wire
        rate would band-limit the other files through a host resample)."""
        rate: int | None = None
        for path in self._audio_files(directory):
            sr = _flac_header_sample_rate(path)
            if sr is None or (rate is not None and sr != rate):
                return None
            rate = sr
        return rate

    def load_raw_samples(
        self,
        directory: str,
        loop_infinitely: bool = False,
        limit_count: int = 0,
        seed: int | None = None,
        sample_rate: int = native.DEFAULT_SR,
        shard_index: int = 0,
        shard_count: int = 1,
    ):
        """Yield (raw audio float32 at ``sample_rate``, transcript int32)
        from the FLACs, shuffled, cut and sharded as :meth:`load_samples`
        does it."""
        files = sorted(self._audio_files(directory))
        if shard_count > 1 and seed is None:
            seed = 0  # every rank must agree on the permutation
        rng = random.Random(seed)
        rng.shuffle(files)
        if limit_count:
            files = files[:limit_count]
        if shard_count > 1:
            files = _equal_shard(files, shard_index, shard_count)
        transcript_dict = self._transcript_dict
        while True:
            for audio_file in files:
                audio, _sr = native.load_audio(audio_file, sr=sample_rate)
                yield audio, np.asarray(
                    transcript_dict[_audio_id(audio_file)], dtype=np.int32
                )
            if not loop_infinitely:
                break
            rng.shuffle(files)

    # -- the cache -----------------------------------------------------------

    def load_samples(
        self,
        directory: str,
        max_size=False,
        loop_infinitely: bool = False,
        limit_count: int = 0,
        feature_type: str = "mfcc",
        seed: int | None = None,
        shard_index: int = 0,
        shard_count: int = 1,
    ):
        """Yield (features [T, F] float32, transcript) from the cache.

        Files are shuffled with ``random.Random(seed)`` (``seed=None`` draws
        a fresh order), cut to ``limit_count`` when it is non-zero, and
        utterances longer than ``max_size`` frames are skipped with a
        warning. ``loop_infinitely`` reshuffles and starts over; its passes
        after the first come from memory when the shard's samples fit
        ``KEEP_BYTES`` (they are then read-only). The files are read
        ``READ_CHUNK`` at a time by a ``native.NpzReader`` of
        ``READ_THREADS`` threads (int32 transcripts); a file of another
        layout (a deflated entry, another dtype) by ``np.load``. A damaged
        file raises.

        ``shard_index``/``shard_count`` give each data rank a disjoint,
        equal slice of the (limited) list; sharding forces seed 0 when none
        is given, as every rank must shuffle alike.
        """
        load_directory = self._get_directory(feature_type, directory)
        if not os.path.exists(load_directory):
            raise ValueError(f"Directory {load_directory} does not exist")

        files = sorted(iglob_recursive(load_directory, "*.npz"))
        if shard_count > 1 and seed is None:
            seed = 0  # every rank must agree on the permutation
        rng = random.Random(seed)
        rng.shuffle(files)
        if limit_count:
            files = files[:limit_count]
        if shard_count > 1:
            files = _equal_shard(files, shard_index, shard_count)

        npz = native.NpzReader(READ_THREADS)

        def read(paths):
            for start in range(0, len(paths), READ_CHUNK):
                chunk = paths[start: start + READ_CHUNK]
                yield from zip(chunk, load_many(npz, chunk))

        # a looping shard whose samples fit KEEP_BYTES is read once
        kept: dict | None = {} if loop_infinitely else None
        kept_bytes = 0
        while True:
            if kept is not None and len(kept) == len(files):
                pairs = ((f, kept[f]) for f in files)
            else:
                pairs = read(files)
            for path, (features, transcript) in pairs:
                if kept is not None and path not in kept:
                    kept_bytes += features.nbytes + transcript.nbytes
                    if kept_bytes > KEEP_BYTES:
                        kept = None  # too large: every pass reads
                    else:
                        features.flags.writeable = False
                        transcript.flags.writeable = False
                        kept[path] = (features, transcript)
                if not max_size or features.shape[0] <= max_size:
                    yield features, transcript
                else:
                    log.warning("Audio snippet too long: %d", features.shape[0])
            if not loop_infinitely:
                break
            rng.shuffle(files)


def load_many(
    npz: native.NpzReader, paths: list[str]
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Cache files -> (features, transcript) each, in order: ``npz`` reads
    them all, ``np.load`` a file of another layout, and a damaged file
    raises when its turn comes."""
    for path, sample in zip(paths, npz.load(paths)):
        if isinstance(sample, native.NpzLayoutError):
            with np.load(path) as data:
                yield data["audio_fragments"], data["transcript"]
        elif isinstance(sample, Exception):
            raise sample
        else:
            yield sample


def load_sample(path: str) -> tuple[np.ndarray, np.ndarray]:
    """One cache file -> (features, transcript): the native reader, or
    ``np.load`` for a file of another layout than the one it reads."""
    try:
        return native.npz_load_sample(path)
    except native.NpzLayoutError:
        with np.load(path) as data:
            return data["audio_fragments"], data["transcript"]
