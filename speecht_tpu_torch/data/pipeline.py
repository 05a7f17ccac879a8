"""Host -> device input pipeline: bucketed padded batches + prefetch.

Counterpart of ``speecht_tpu/data/pipeline.py`` (single process):

- :func:`build_batch` pads features to the batch's longest utterance,
  rounded up to a time bucket, and labels to a width that is a function of
  that bucket, so the set of batch shapes stays small.
- :func:`batch_iterator` groups a sample generator into such batches,
  optionally by length.
- :class:`PrefetchLoader` builds batches on a host thread. Features are
  cast to the transfer dtype (bf16 by default), placed in pinned memory
  and copied to the card with ``non_blocking`` copies on a side stream,
  so the copy of batch N+1 overlaps the compute of batch N. It counts
  its stalls (the consumer waiting on an empty queue) for the training
  loop's ``prefetch_stalls`` scalars.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Iterator

import numpy as np
import torch

from speecht_tpu_torch import vocabulary


@dataclasses.dataclass
class Batch:
    """One dense padded batch, as numpy arrays or as torch tensors."""

    features: np.ndarray  # [B, T, F] float32
    seq_lengths: np.ndarray  # [B] int32 (valid input frames; 0 = padding row)
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


def batch_iterator(
    sample_generator: Iterator,
    batch_size: int,
    time_bucket: int = 256,
    label_bucket: int | None = None,
    max_steps: int | None = None,
    drop_remainder: bool = False,
    group_by_length: bool = False,
) -> Iterator[Batch]:
    """Group a sample generator into padded batches.

    ``group_by_length`` collects samples into per-time-bucket bins and
    emits a batch when a bin fills; leftovers drain longest first. A
    partial last batch is padded to ``batch_size`` unless
    ``drop_remainder``. Iteration stops after ``max_steps`` batches.
    """
    steps = 0

    if not group_by_length:
        bucket: list = []
        for sample in sample_generator:
            bucket.append(sample)
            if len(bucket) == batch_size:
                yield build_batch(bucket, time_bucket, label_bucket)
                bucket = []
                steps += 1
                if max_steps is not None and steps >= max_steps:
                    return
        if bucket and not drop_remainder:
            yield build_batch(
                bucket, time_bucket, label_bucket, pad_to_batch=batch_size
            )
        return

    bins: dict[int, list] = {}
    for sample in sample_generator:
        key = round_up(max(len(sample[0]), 1), time_bucket)
        bins.setdefault(key, []).append(sample)
        if len(bins[key]) == batch_size:
            yield build_batch(bins.pop(key), time_bucket, label_bucket)
            steps += 1
            if max_steps is not None and steps >= max_steps:
                return
    for key in sorted(bins, reverse=True):
        leftovers = bins[key]
        while leftovers:
            chunk, leftovers = leftovers[:batch_size], leftovers[batch_size:]
            if drop_remainder and len(chunk) < batch_size:
                continue
            yield build_batch(
                chunk, time_bucket, label_bucket, pad_to_batch=batch_size
            )
            steps += 1
            if max_steps is not None and steps >= max_steps:
                return


_TRANSFER_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def to_device(
    batch: Batch,
    device: torch.device,
    transfer_dtype: str = "bfloat16",
    stream: torch.cuda.Stream | None = None,
) -> Batch:
    """Host numpy Batch -> torch Batch on ``device``.

    Features are cast to ``transfer_dtype`` on the host (round to nearest
    even, as the JAX package's ml_dtypes cast). For a CUDA device every
    array goes through pinned memory and a ``non_blocking`` copy on
    ``stream``; the caller orders its own stream after that copy.
    """
    arrays = {
        "features": torch.from_numpy(batch.features).to(
            _TRANSFER_DTYPES[transfer_dtype]
        ),
        "seq_lengths": torch.from_numpy(batch.seq_lengths),
        "labels": torch.from_numpy(batch.labels),
        "label_lengths": torch.from_numpy(batch.label_lengths),
    }
    if device.type != "cuda":
        return Batch(**{k: v.to(device) for k, v in arrays.items()})
    with torch.cuda.stream(stream):
        return Batch(
            **{
                k: v.pin_memory().to(device, non_blocking=True)
                for k, v in arrays.items()
            }
        )


class PrefetchLoader:
    """Background-thread batch producer with device prefetch.

    Iterating yields ``(host_batch, device_batch)`` pairs: the numpy batch
    for the host-side metrics and its copy on ``device``. On a CUDA device
    the copy runs on a side stream; the consumer's stream waits for it
    (an event) before the batch is handed out, and the tensors are
    recorded on the consumer's stream so the allocator does not reuse
    them early.

    ``stall_count``/``stall_seconds`` add up, over the loader's lifetime,
    the waits of more than 2 ms for a batch, the first batch of each pass
    excepted (the producer cannot be ahead yet), as the JAX package's
    loader counts them.
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
    ):
        self._factory = generator_factory
        self._batch_size = batch_size
        self._device = device
        self._time_bucket = time_bucket
        self._max_steps = max_steps
        self._group_by_length = group_by_length
        self._transfer_dtype = transfer_dtype
        self.stall_count = 0
        self.stall_seconds = 0.0

    def _worker(self, out_queue: queue.Queue, stop: threading.Event, errors):
        cuda = self._device.type == "cuda"
        stream = torch.cuda.Stream(self._device) if cuda else None
        try:
            for host in batch_iterator(
                self._factory(),
                self._batch_size,
                self._time_bucket,
                max_steps=self._max_steps,
                group_by_length=self._group_by_length,
            ):
                if stop.is_set():
                    return
                dev = to_device(host, self._device, self._transfer_dtype, stream)
                ready = None
                if cuda:
                    ready = torch.cuda.Event()
                    ready.record(stream)
                out_queue.put((host, dev, ready))
        except BaseException as e:  # re-raised in the consumer
            errors.append(e)
        finally:
            out_queue.put(self._SENTINEL)

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
                try:
                    item = out_queue.get_nowait()
                except queue.Empty:
                    t0 = time.perf_counter()
                    item = out_queue.get()
                    waited = time.perf_counter() - t0
                    if waited > 0.002 and item is not self._SENTINEL and not first:
                        self.stall_count += 1
                        self.stall_seconds += waited
                first = False
                if item is self._SENTINEL:
                    if errors:
                        raise errors[0]
                    return
                host, dev, ready = item
                if ready is not None:
                    current = torch.cuda.current_stream(self._device)
                    current.wait_event(ready)
                    for field in dataclasses.fields(dev):
                        getattr(dev, field.name).record_stream(current)
                yield host, dev
        finally:
            # an abandoned iteration: unblock and retire the worker
            stop.set()
            while thread.is_alive():
                try:
                    out_queue.get_nowait()
                except queue.Empty:
                    thread.join(timeout=0.05)
