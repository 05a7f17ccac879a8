"""Host -> device input pipeline: bucketed padded batches + prefetch.

Counterpart of ``speecht_tpu/data/pipeline.py``:

- :func:`build_batch` pads features to the batch's longest utterance,
  rounded up to a time bucket, and labels to a width that is a function of
  that bucket, so the set of batch shapes stays small (in a multi-process
  run both widths are the maxima over the ranks,
  ``parallel/mesh.py::sync_bucket_dims``); :func:`single_batch`
  is ``record``'s batch of one without labels.
  :func:`build_audio_batch` does the same for raw audio (``--from-audio``),
  in samples, synced alike.
- :func:`batch_iterator` groups a sample generator into such batches,
  optionally by length (one process only).
- :class:`PrefetchLoader` builds batches on a host thread. Features are
  cast to the transfer dtype (bf16 by default) as they are copied into
  pinned memory, raw audio goes as int16 (:func:`audio_to_int16`), and the
  batch is copied to the card
  with ``non_blocking`` copies on a side stream, so the copy of batch N+1
  overlaps the compute of batch N. It counts its stalls (the consumer
  waiting on an empty queue) for the training loop's ``prefetch_stalls``
  scalars, and, while a profiler records, logs its stages as spans
  (``telemetry.py``): on its thread ``loader.produce`` (reading the
  samples, with ``loader.build`` and ``loader.h2d`` inside it) and
  ``loader.put`` (blocked on a full queue), and on the consumer's
  ``loader.wait``, each with the batch's sequence number.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from typing import Callable, Iterator

import numpy as np
import torch

from speecht_tpu_torch import telemetry, vocabulary
from speecht_tpu_torch.parallel import comm
from speecht_tpu_torch.parallel.mesh import sync_bucket_dims


@dataclasses.dataclass
class Batch:
    """One dense padded batch, as numpy arrays or as torch tensors."""

    features: np.ndarray  # [B, T, F] float32
    seq_lengths: np.ndarray  # [B] int32 (valid input frames; 0 = padding row)
    labels: np.ndarray  # [B, L] int32 padded with PAD_ID
    label_lengths: np.ndarray  # [B] int32


@dataclasses.dataclass
class AudioBatch:
    """One padded raw-audio batch for the device front end."""

    audio: np.ndarray  # [B, S] float32 zero-padded samples (int16 on the wire)
    num_samples: np.ndarray  # [B] int32 (0 = padding row)
    labels: np.ndarray  # [B, L] int32 padded with PAD_ID
    label_lengths: np.ndarray  # [B] int32


def round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple if multiple > 1 else n


def build_batch(
    samples: list[tuple[np.ndarray, np.ndarray]],
    time_bucket: int = 256,
    label_bucket: int | None = None,
    pad_to_batch: int = 0,
) -> Batch:
    """Assemble (features [T, F], transcript) pairs into a padded Batch.

    Time pads to the batch max rounded up to ``time_bucket``. The label
    width is ``max(T // 4, round_up(max_label, 32), 32)`` (T/4 is the CTC
    feasibility bound: S = 2L+1 states must fit in T/2 logit frames)
    unless ``label_bucket`` is given. ``pad_to_batch`` appends all-zero
    rows with ``seq_length`` 0, which the loss and the metrics skip.
    """
    n = len(samples)
    input_size = samples[0][0].shape[1]
    seq_lengths = np.array([s[0].shape[0] for s in samples], dtype=np.int32)
    label_lengths = np.array([len(s[1]) for s in samples], dtype=np.int32)

    T = round_up(int(seq_lengths.max()), time_bucket)
    if label_bucket is None:
        L = max(T // 4, round_up(int(label_lengths.max()), 32), 32)
    else:
        L = round_up(max(int(label_lengths.max()), 1), label_bucket)
    # multi-process: every rank pads this step's batch alike
    T, L = sync_bucket_dims(T, L)
    B = max(n, pad_to_batch)

    features = np.zeros((B, T, input_size), dtype=np.float32)
    labels = np.full((B, L), vocabulary.PAD_ID, dtype=np.int32)
    for i, (feat, transcript) in enumerate(samples):
        features[i, : feat.shape[0]] = feat
        labels[i, : len(transcript)] = np.asarray(transcript, dtype=np.int32)

    if B > n:
        seq_lengths = np.pad(seq_lengths, (0, B - n))
        label_lengths = np.pad(label_lengths, (0, B - n))

    return Batch(features, seq_lengths, labels, label_lengths)


def single_batch(features: np.ndarray, time_bucket: int = 128) -> Batch:
    """Batch of one without labels (``record``): time rounds up to a
    bucket, the label width is 1 and the label length 0."""
    return build_batch([(features, np.zeros(0, dtype=np.int32))],
                       time_bucket=time_bucket, label_bucket=1)


def build_audio_batch(
    samples: list[tuple[np.ndarray, np.ndarray]],
    sample_bucket: int = 160 * 256,
    label_bucket: int | None = None,
    pad_to_batch: int = 0,
) -> AudioBatch:
    """Assemble (raw audio, transcript) pairs into a padded AudioBatch.

    Sample counts pad up to ``sample_bucket`` (the feature hop times the
    frame bucket by default). The label width follows the frame bucket the
    samples imply (hop 160), and both widths are the maxima over the
    ranks, as in :func:`build_batch`.
    """
    n = len(samples)
    num_samples = np.array([len(s[0]) for s in samples], dtype=np.int32)
    label_lengths = np.array([len(s[1]) for s in samples], dtype=np.int32)
    S = round_up(int(num_samples.max()), sample_bucket)
    if label_bucket is None:
        L = max(S // 160 // 4, round_up(int(label_lengths.max()), 32), 32)
    else:
        L = round_up(max(int(label_lengths.max()), 1), label_bucket)
    # multi-process: every rank pads this step's batch alike
    S, L = sync_bucket_dims(S, L)
    B = max(n, pad_to_batch)

    audio = np.zeros((B, S), dtype=np.float32)
    labels = np.full((B, L), vocabulary.PAD_ID, dtype=np.int32)
    for i, (wav, transcript) in enumerate(samples):
        audio[i, : len(wav)] = wav
        labels[i, : len(transcript)] = np.asarray(transcript, dtype=np.int32)
    if B > n:
        num_samples = np.pad(num_samples, (0, B - n))
        label_lengths = np.pad(label_lengths, (0, B - n))
    return AudioBatch(audio, num_samples, labels, label_lengths)


def audio_to_int16(audio: np.ndarray) -> np.ndarray:
    """The int16 audio wire, the one quantisation every producer uses.

    Lossless for FLAC's 16-bit PCM (v / 32768 rounds back to v); a bf16
    audio wire's -48 dB noise floor would corrupt low-energy mel bins. The
    front end (``features_device.make_front_end``) undoes the scaling.
    """
    return np.clip(np.rint(audio * 32768.0), -32768, 32767).astype(np.int16)


def batch_iterator(
    sample_generator: Iterator,
    batch_size: int,
    time_bucket: int = 256,
    label_bucket: int | None = None,
    max_steps: int | None = None,
    drop_remainder: bool = False,
    group_by_length: bool = False,
    batch_builder: Callable = build_batch,
) -> Iterator:
    """Group a sample generator into padded batches.

    ``batch_builder`` is :func:`build_batch` (cached features) or
    :func:`build_audio_batch` (raw audio; ``time_bucket`` is then in
    samples). ``group_by_length`` collects samples into per-time-bucket
    bins and emits a batch when a bin fills; leftovers drain longest
    first. A partial last batch is padded to ``batch_size`` unless
    ``drop_remainder``. Iteration stops after ``max_steps`` batches.
    """
    steps = 0

    if group_by_length and comm.world_size() > 1:
        raise ValueError(
            "--group-by-length is not supported in multi-process runs: "
            "each process's bin-fill order (and so its batch count and "
            "shape sequence) depends on its own corpus shard, which "
            "breaks the lockstep the cross-process collectives require"
        )

    if not group_by_length:
        bucket: list = []
        for sample in sample_generator:
            bucket.append(sample)
            if len(bucket) == batch_size:
                yield batch_builder(bucket, time_bucket, label_bucket)
                bucket = []
                steps += 1
                if max_steps is not None and steps >= max_steps:
                    return
        if bucket and not drop_remainder:
            yield batch_builder(
                bucket, time_bucket, label_bucket, pad_to_batch=batch_size
            )
        return

    bins: dict[int, list] = {}
    for sample in sample_generator:
        key = round_up(max(len(sample[0]), 1), time_bucket)
        bins.setdefault(key, []).append(sample)
        if len(bins[key]) == batch_size:
            yield batch_builder(bins.pop(key), time_bucket, label_bucket)
            steps += 1
            if max_steps is not None and steps >= max_steps:
                return
    for key in sorted(bins, reverse=True):
        leftovers = bins[key]
        while leftovers:
            chunk, leftovers = leftovers[:batch_size], leftovers[batch_size:]
            if drop_remainder and len(chunk) < batch_size:
                continue
            yield batch_builder(
                chunk, time_bucket, label_bucket, pad_to_batch=batch_size
            )
            steps += 1
            if max_steps is not None and steps >= max_steps:
                return


_TRANSFER_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def to_device(
    batch,
    device: torch.device,
    transfer_dtype: str = "bfloat16",
    stream: torch.cuda.Stream | None = None,
):
    """Host numpy Batch or AudioBatch -> the same batch of tensors on
    ``device``.

    Features are cast to ``transfer_dtype`` on the host (round to nearest
    even, as the JAX package's ml_dtypes cast). Raw audio goes as int16
    (:func:`audio_to_int16`) on the bf16 wire, as JAX casts it, and as
    float32 on the float32 wire. For a CUDA device every array goes
    through pinned memory and a ``non_blocking`` copy on ``stream``; the
    caller orders its own stream after that copy.
    """
    arrays = {
        f.name: torch.from_numpy(getattr(batch, f.name))
        for f in dataclasses.fields(batch)
    }
    dtypes = {}
    if isinstance(batch, AudioBatch):
        if transfer_dtype == "bfloat16":
            arrays["audio"] = torch.from_numpy(audio_to_int16(batch.audio))
    else:
        dtypes["features"] = _TRANSFER_DTYPES[transfer_dtype]
    if device.type != "cuda":
        return type(batch)(
            **{k: v.to(device, dtypes.get(k)) for k, v in arrays.items()}
        )
    with torch.cuda.stream(stream):
        return type(batch)(
            **{
                k: _pinned(v, dtypes.get(k)).to(device, non_blocking=True)
                for k, v in arrays.items()
            }
        )


def _pinned(host: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """``host`` cast to ``dtype`` as it is copied into pinned memory: one
    pass over the batch, and no pageable copy of it in the transfer dtype."""
    out = torch.empty(host.shape, dtype=dtype or host.dtype, pin_memory=True)
    return out.copy_(host)


class PrefetchLoader:
    """Background-thread batch producer with device prefetch.

    Iterating yields ``(host_batch, device_batch)`` pairs: the numpy batch
    for the host-side metrics and its copy on ``device``. On a CUDA device
    the copy runs on a side stream; the consumer's stream waits for it
    (an event) before the batch is handed out, and the tensors are
    recorded on the consumer's stream so the allocator does not reuse
    them early.

    ``stall_count``/``stall_seconds`` add up, over the loader's lifetime,
    the waits of more than 2 ms for a batch that was not ready, the first
    batch of each pass excepted (the producer cannot be ahead yet), as the
    JAX package's loader counts them; a wait is the ``loader.wait`` span's
    clock reads.

    The producer stamps each batch's stages (``time.time_ns()``, a few
    reads a batch) into the item it queues: the batch's read, build and
    copy, and the put of the batch before it. The consumer moves them into
    ``telemetry.LOG`` as it takes the batch while a profiler records.
    Batches are numbered over the loader's life.
    """

    _SENTINEL = object()
    _QUEUE_CAPACITY = 4  # batches built ahead of the consumer

    def __init__(
        self,
        generator_factory: Callable[[], Iterator],
        batch_size: int,
        device: torch.device,
        time_bucket: int = 256,
        max_steps: int | None = None,
        group_by_length: bool = False,
        transfer_dtype: str = "bfloat16",
        batch_builder: Callable = build_batch,
    ):
        self._factory = generator_factory
        self._batch_builder = batch_builder
        self._batch_size = batch_size
        self._device = device
        self._time_bucket = time_bucket
        self._max_steps = max_steps
        self._group_by_length = group_by_length
        self._transfer_dtype = transfer_dtype
        self._sequence = itertools.count()
        self.stall_count = 0
        self.stall_seconds = 0.0

    def _worker(self, out_queue: queue.Queue, stop: threading.Event, errors):
        cuda = self._device.type == "cuda"
        stream = torch.cuda.Stream(self._device) if cuda else None
        build = [0, 0]

        def timed_builder(*args, **kwargs):
            build[0] = time.time_ns()
            out = self._batch_builder(*args, **kwargs)
            build[1] = time.time_ns()
            return out

        try:
            produce, last_put = time.time_ns(), None
            for host in batch_iterator(
                self._factory(),
                self._batch_size,
                self._time_bucket,
                max_steps=self._max_steps,
                group_by_length=self._group_by_length,
                batch_builder=timed_builder,
            ):
                if stop.is_set():
                    return
                seq = next(self._sequence)
                h2d = time.time_ns()
                dev = to_device(host, self._device, self._transfer_dtype, stream)
                ready = None
                if cuda:
                    ready = torch.cuda.Event()
                    ready.record(stream)
                put = time.time_ns()
                stages = (seq, produce, put, tuple(build), (h2d, put), last_put)
                out_queue.put((host, dev, ready, stages))
                produce = time.time_ns()
                last_put = (seq, put, produce)
                # an abandoned iteration (the put returned to the drain):
                # build no further batch. On several ranks a build is a
                # collective (sync_bucket_dims) that a peer stopped at
                # another step never joins, so it would never return
                if stop.is_set():
                    return
        except BaseException as e:  # re-raised in the consumer
            errors.append(e)
        finally:
            out_queue.put(self._SENTINEL)

    @staticmethod
    def _log_stages(stages: tuple, thread: int) -> None:
        """Logs a taken batch's stamped stages while a profiler records."""
        if not telemetry.recording():
            return
        seq, start, end, build, h2d, last_put = stages
        log = telemetry.LOG
        parent = log.add("loader.produce", thread, start, end, batch=seq)
        log.add("loader.build", thread, *build, parent, seq)
        log.add("loader.h2d", thread, *h2d, parent, seq)
        if last_put is not None:
            put_seq, put_start, put_end = last_put
            log.add("loader.put", thread, put_start, put_end, batch=put_seq)

    def __iter__(self):
        out_queue: queue.Queue = queue.Queue(maxsize=self._QUEUE_CAPACITY)
        stop = threading.Event()
        errors: list[BaseException] = []
        thread = threading.Thread(
            target=self._worker, args=(out_queue, stop, errors), daemon=True
        )
        thread.start()
        first = True
        try:
            while True:
                with telemetry.span("loader.wait", clock=True) as wait:
                    try:
                        item, behind = out_queue.get_nowait(), False
                    except queue.Empty:
                        item, behind = out_queue.get(), True
                    if item is not self._SENTINEL:
                        host, dev, ready, stages = item
                        wait.batch = stages[0]
                        if ready is not None:
                            current = torch.cuda.current_stream(self._device)
                            current.wait_event(ready)
                            for field in dataclasses.fields(dev):
                                getattr(dev, field.name).record_stream(current)
                if item is self._SENTINEL:
                    if errors:
                        raise errors[0]
                    return
                self._log_stages(stages, thread.native_id)
                if behind and wait.seconds > 0.002 and not first:
                    self.stall_count += 1
                    self.stall_seconds += wait.seconds
                first = False
                yield host, dev
        finally:
            # an abandoned iteration: unblock and retire the worker
            stop.set()
            while thread.is_alive():
                try:
                    out_queue.get_nowait()
                except queue.Empty:
                    thread.join(timeout=0.05)
