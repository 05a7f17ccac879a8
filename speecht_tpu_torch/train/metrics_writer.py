"""TensorBoard-compatible metrics writer (pure Python, no TF).

Copy of the scalar and raw-histogram part of
``speecht_tpu/train/metrics_writer.py``: the TFRecord event-file format

  record  := uint64 length | uint32 masked_crc32c(length) | payload
             | uint32 masked_crc32c(payload)
  payload := tensorflow.Event protobuf (hand-encoded wire format)

so ``evaluate`` writes ``eval_loss`` and ``train`` its scalars and
parameter histograms (from device-reduced stats, ``train/summaries.py``)
to ``log/<run>_<type>`` as the JAX package does. Image summaries are not
ported yet.
"""

from __future__ import annotations

import os
import socket
import struct
import time


def _crc32c_table():
    poly = 0x82F63B78
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        table.append(crc)
    return table


_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)) & 0xFFFFFFFF
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_double(num: int, value: float) -> bytes:
    return bytes([num << 3 | 1]) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return bytes([num << 3 | 5]) + struct.pack("<f", value)


def _field_varint(num: int, value: int) -> bytes:
    return bytes([num << 3 | 0]) + _varint(value)


def _field_bytes(num: int, value: bytes) -> bytes:
    return bytes([num << 3 | 2]) + _varint(len(value)) + value


def _packed_doubles(num: int, values) -> bytes:
    payload = b"".join(struct.pack("<d", float(v)) for v in values)
    return bytes([num << 3 | 2]) + _varint(len(payload)) + payload


def _histogram_proto_from_stats(
    mn, mx, num, total, sum_squares, bucket_limits, buckets
) -> bytes:
    """tensorflow.HistogramProto wire encoding from precomputed stats.

    Fields: 1=min 2=max 3=num 4=sum 5=sum_squares 6=bucket_limit[] 7=bucket[]
    """
    msg = _field_double(1, float(mn))
    msg += _field_double(2, float(mx))
    msg += _field_double(3, float(num))
    msg += _field_double(4, float(total))
    msg += _field_double(5, float(sum_squares))
    msg += _packed_doubles(6, bucket_limits)
    msg += _packed_doubles(7, buckets)
    return msg


def _event(
    wall_time: float,
    step: int = 0,
    file_version: str | None = None,
    scalars: dict[str, float] | None = None,
    raw_histograms: dict[str, dict] | None = None,
) -> bytes:
    # tensorflow.Event: 1=wall_time, 2=step, 3=file_version, 5=summary
    msg = _field_double(1, wall_time)
    if step:
        msg += _field_varint(2, step)
    if file_version is not None:
        msg += _field_bytes(3, file_version.encode())
    summary = b""
    for tag, value in (scalars or {}).items():
        # Summary.Value: 1=tag, 2=simple_value
        val = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
        summary += _field_bytes(1, val)
    for tag, st in (raw_histograms or {}).items():
        # Summary.Value: 1=tag, 5=histo
        histo = _histogram_proto_from_stats(
            st["min"], st["max"], st["num"], st["sum"], st["sum_squares"],
            st["bucket_limits"], st["buckets"],
        )
        summary += _field_bytes(1, _field_bytes(1, tag.encode()) + _field_bytes(5, histo))
    if summary:
        msg += _field_bytes(5, summary)
    return msg


class SummaryWriter:
    """Append-only TensorBoard event file writer."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = "events.out.tfevents.{:.0f}.{}".format(
            time.time(), socket.gethostname()
        )
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._write_record(_event(time.time(), file_version="brain.Event:2"))

    def _write_record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalars(self, step: int, scalars: dict[str, float]):
        self._write_record(_event(time.time(), step=step, scalars=scalars))

    def add_raw_histograms(self, step: int, stats: dict):
        """Histogram summaries from device-reduced stats: per tag a dict of
        min/max/num/sum/sum_squares/bucket_limits/buckets."""
        self._write_record(_event(time.time(), step=step, raw_histograms=stats))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()
