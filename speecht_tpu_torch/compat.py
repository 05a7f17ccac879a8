"""Reference-checkpoint compatibility: the reference's exported and released weights.

Counterpart of ``speecht_tpu/compat.py``, with its four functions
(``load_reference_export``, ``reference_name_to_param_path``,
``import_tf_checkpoint``, ``import_reference_weights``). They take and
return the port's state dicts (``conv_i.weight [O, I, W]``,
``conv_i.bias``) and raise the JAX package's exceptions with its
messages, whose shapes are in the reference's ``[W, I, O]`` layout.

The released ``best_run`` weights are a TF Saver checkpoint. The JAX
package reads them with ``tensorflow``, which the port does not have on
the card's machine, so :class:`TensorBundleReader` reads TF's V2 tensor
bundle itself, with numpy and ``struct``:

  <prefix>.index                    a LevelDB-format table: the key ""
                                    holds a BundleHeaderProto, every other
                                    key is a variable's name and holds its
                                    BundleEntryProto (dtype, shape,
                                    shard_id, offset, size)
  <prefix>.data-XXXXX-of-YYYYY      the tensors' bytes, little-endian

The table's 48-byte footer holds the metaindex and index block handles
and the magic ``0xdb4775248b80fb57``; each block ends with a 5-byte
trailer (compression type, masked CRC32C of the block and that byte),
which is checked. Keys are prefix-compressed between restart points.
Each tensor's bytes are checked against its own CRC32C
(BundleEntryProto field 6, masked as the blocks'), as TF's reader does;
the CRC runs in the port's C++ (``native.crc32c``, well under a second
for a model's ~100 MB of weights). Float32, float64, int32 and int64
tensors are read; a sliced (partitioned) variable, another dtype, a
compressed block, a bad CRC of a block or a tensor, or a V1 single-file
checkpoint raise ValueError that names what was found.
"""

from __future__ import annotations

import glob
import os
import re
import struct

import numpy as np
import torch

from speecht_tpu_torch import native
from speecht_tpu_torch.train.metrics_writer import mask_crc
from speecht_tpu_torch.weights import params_from_jax, params_to_jax

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_BYTES = 48
BLOCK_TRAILER_BYTES = 5

# tensorflow DataType enum -> numpy dtype (types.proto)
_DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 9: np.int64}
_DTYPE_NAMES = {
    1: "DT_FLOAT", 2: "DT_DOUBLE", 3: "DT_INT32", 4: "DT_UINT8",
    5: "DT_INT16", 6: "DT_INT8", 7: "DT_STRING", 9: "DT_INT64",
    10: "DT_BOOL", 14: "DT_BFLOAT16", 19: "DT_HALF",
}


def _varint(buf: bytes, at: int) -> tuple[int, int]:
    """(value, position after it) of the base-128 varint at ``at``."""
    value, shift = 0, 0
    while True:
        if at >= len(buf):
            raise ValueError("truncated varint in the checkpoint index")
        b = buf[at]
        at += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, at
        shift += 7


def _proto_fields(buf: bytes):
    """Yields (field number, wire type, value) of a protobuf message:
    an int for varint and fixed fields, bytes for length-delimited ones."""
    at = 0
    while at < len(buf):
        key, at = _varint(buf, at)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, at = _varint(buf, at)
        elif wire == 1:
            (value,) = struct.unpack_from("<Q", buf, at)
            at += 8
        elif wire == 2:
            n, at = _varint(buf, at)
            value = buf[at: at + n]
            at += n
        elif wire == 5:
            (value,) = struct.unpack_from("<I", buf, at)
            at += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, value


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


class BundleEntry:
    """A variable's BundleEntryProto."""

    def __init__(self, name: str, value: bytes):
        self.name = name
        self.dtype = 0
        self.shape: list[int] = []
        self.shard_id = 0
        self.offset = 0
        self.size = 0
        self.crc32c = 0  # masked
        self.sliced = False
        for field, _wire, v in _proto_fields(value):
            if field == 1:
                self.dtype = v
            elif field == 2:  # TensorShapeProto: repeated Dim dim = 2
                for f, _w, dim in _proto_fields(v):
                    if f == 2:
                        size = 0
                        for g, _w2, s in _proto_fields(dim):
                            if g == 1:
                                size = _signed64(s)
                        self.shape.append(size)
            elif field == 3:
                self.shard_id = v
            elif field == 4:
                self.offset = v
            elif field == 5:
                self.size = v
            elif field == 6:
                self.crc32c = v
            elif field == 7:
                self.sliced = True


class TensorBundleReader:
    """Reads a TF V2 checkpoint (``<prefix>.index`` + data shards)."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        index = prefix + ".index"
        if not os.path.exists(index):
            if os.path.isfile(prefix):
                raise ValueError(
                    f"{prefix} is a V1 (single-file) TF checkpoint; only V2 "
                    "tensor bundles (<prefix>.index + .data-*) are read"
                )
            raise FileNotFoundError(
                f"no TF checkpoint at {prefix} ({index} does not exist)"
            )
        with open(index, "rb") as f:
            self._table = f.read()
        self.num_shards = 1
        self.entries: dict[str, BundleEntry] = {}
        for key, value in self._table_items():
            if key == b"":  # BundleHeaderProto
                for field, _wire, v in _proto_fields(value):
                    if field == 1:
                        self.num_shards = v
            elif key[:1] == b"\x00":
                continue  # a slice of a partitioned variable (an encoded key)
            else:
                name = key.decode()
                self.entries[name] = BundleEntry(name, value)

    def _block(self, offset: int, size: int) -> bytes:
        end = offset + size
        if end + BLOCK_TRAILER_BYTES > len(self._table):
            raise ValueError(f"checkpoint index {self.prefix}.index is truncated")
        contents = self._table[offset:end]
        kind = self._table[end]
        (stored,) = struct.unpack_from("<I", self._table, end + 1)
        if mask_crc(native.crc32c(contents + bytes([kind]))) != stored:
            raise ValueError(
                f"checkpoint index {self.prefix}.index: block at {offset} "
                "fails its CRC32C check (the file is corrupt)"
            )
        if kind != 0:
            raise ValueError(
                f"checkpoint index {self.prefix}.index: block at {offset} is "
                f"compressed (type {kind}); only uncompressed tables are read"
            )
        return contents

    @staticmethod
    def _block_items(block: bytes):
        """(key, value) pairs of a table block: prefix-compressed keys,
        then the restart array and its count at the end."""
        (num_restarts,) = struct.unpack_from("<I", block, len(block) - 4)
        limit = len(block) - 4 - 4 * num_restarts
        at, key = 0, b""
        while at < limit:
            shared, at = _varint(block, at)
            non_shared, at = _varint(block, at)
            value_len, at = _varint(block, at)
            key = key[:shared] + block[at: at + non_shared]
            at += non_shared
            yield key, block[at: at + value_len]
            at += value_len

    def _table_items(self):
        if len(self._table) < FOOTER_BYTES:
            raise ValueError(f"checkpoint index {self.prefix}.index is truncated")
        footer = self._table[-FOOTER_BYTES:]
        lo, hi = struct.unpack_from("<II", footer, 40)
        if (hi << 32) | lo != TABLE_MAGIC:
            raise ValueError(
                f"{self.prefix}.index is not a TF checkpoint index (bad magic)"
            )
        _meta_offset, at = _varint(footer, 0)
        _meta_size, at = _varint(footer, at)
        index_offset, at = _varint(footer, at)
        index_size, at = _varint(footer, at)
        for _last_key, handle in self._block_items(
            self._block(index_offset, index_size)
        ):
            offset, at = _varint(handle, 0)
            size, _ = _varint(handle, at)
            yield from self._block_items(self._block(offset, size))

    def get_variable_to_shape_map(self) -> dict[str, list[int]]:
        return {name: list(e.shape) for name, e in self.entries.items()}

    def get_tensor(self, name: str) -> np.ndarray:
        e = self.entries[name]
        if e.sliced:
            raise ValueError(
                f"variable {name} is sliced (partitioned) in the checkpoint; "
                "sliced variables are not read"
            )
        if e.dtype not in _DTYPES:
            raise ValueError(
                f"variable {name} has dtype "
                f"{_DTYPE_NAMES.get(e.dtype, e.dtype)}; only "
                f"{', '.join(_DTYPE_NAMES[d] for d in _DTYPES)} are read"
            )
        shard = f"{self.prefix}.data-{e.shard_id:05d}-of-{self.num_shards:05d}"
        if not os.path.exists(shard):
            raise FileNotFoundError(
                f"checkpoint data shard {shard} (of variable {name}) does not exist"
            )
        dtype = np.dtype(_DTYPES[e.dtype]).newbyteorder("<")
        count = int(np.prod(e.shape, dtype=np.int64))
        if e.size != count * dtype.itemsize:
            raise ValueError(
                f"variable {name}: {e.size} bytes in the checkpoint for shape "
                f"{e.shape} of {_DTYPE_NAMES[e.dtype]}"
            )
        with open(shard, "rb") as f:
            f.seek(e.offset)
            data = f.read(e.size)
        if len(data) != e.size:
            raise ValueError(f"checkpoint data shard {shard} is truncated at {name}")
        computed = mask_crc(native.crc32c(data))
        if computed != e.crc32c:
            raise ValueError(
                f"variable {name} in checkpoint data shard {shard} fails its "
                f"CRC32C check: stored {e.crc32c:#010x}, computed {computed:#010x} "
                "(the file is corrupt)"
            )
        return np.frombuffer(data, dtype=dtype).astype(dtype.newbyteorder("=")).reshape(e.shape)


def latest_checkpoint(checkpoint_dir: str) -> str | None:
    """The prefix named by ``<dir>/checkpoint``'s ``model_checkpoint_path``
    (relative to the directory unless absolute), when its ``.index`` or a
    V1 file exists; else None, as ``tf.train.latest_checkpoint``."""
    try:
        with open(os.path.join(checkpoint_dir, "checkpoint")) as f:
            text = f.read()
    except OSError:
        return None
    m = re.search(r'^model_checkpoint_path:\s*"((?:[^"\\]|\\.)*)"', text, re.M)
    if not m:
        return None
    path = m.group(1)
    if not os.path.isabs(path):
        path = os.path.join(checkpoint_dir, path)
    if os.path.exists(path + ".index") or os.path.isfile(path):
        return path
    return None


def load_checkpoint(ckpt_dir_or_prefix: str) -> TensorBundleReader:
    """``tf.train.load_checkpoint``: a directory means its latest checkpoint."""
    path = ckpt_dir_or_prefix
    if os.path.isdir(path):
        path = latest_checkpoint(path)
        if path is None:
            raise ValueError(
                "Couldn't find 'checkpoint' file or checkpoints in given "
                f"directory {ckpt_dir_or_prefix}"
            )
    return TensorBundleReader(path)


def _strip_device_suffix(name: str) -> str:
    return name[:-2] if name.endswith(":0") else name


def load_reference_export(directory: str) -> dict[str, np.ndarray]:
    """Read a reference weight-export directory into {var_name: array}."""
    out: dict[str, np.ndarray] = {}
    for root, _dirs, files in os.walk(directory):
        for fname in files:
            if not fname.endswith(".npy"):
                continue
            path = os.path.join(root, fname)
            rel = os.path.relpath(path, directory)
            var_name = _strip_device_suffix(rel[: -len(".npy")])
            out[var_name.replace(os.sep, "/")] = np.load(path)
    return out


def reference_name_to_param_path(var_name: str) -> tuple[str, str] | None:
    """'convolution_layer_3/filters' -> ('conv_3', 'kernel'); None if N/A."""
    m = re.match(r"convolution_layer_(\d+)/(filters|bias)$", var_name)
    if not m:
        return None
    layer, kind = m.groups()
    return f"conv_{layer}", "kernel" if kind == "filters" else "bias"


def import_tf_checkpoint(
    params: dict[str, torch.Tensor], checkpoint_dir: str
) -> dict[str, torch.Tensor]:
    """The reference's released TF Saver checkpoint as a state dict.

    ``checkpoint_dir`` is a directory with a ``checkpoint`` file, or the
    checkpoint's prefix itself. Variables ``convolution_layer_<i>/filters``
    and ``.../bias`` map onto ``conv_<i>.weight``/``.bias``; every other
    variable is ignored. Raises KeyError when a layer is absent from
    ``params`` or fewer than 22 conv parameters were found, ValueError on
    a shape mismatch.
    """
    ckpt_path = latest_checkpoint(checkpoint_dir)
    if ckpt_path is None:
        # allow pointing at the checkpoint prefix itself
        ckpt_path = checkpoint_dir
    reader = load_checkpoint(ckpt_path)
    shapes = reader.get_variable_to_shape_map()

    new_params = params_to_jax(params)
    imported = 0
    for var_name in shapes:
        dest = reference_name_to_param_path(_strip_device_suffix(var_name))
        if dest is None:
            continue
        layer_name, leaf_name = dest
        if layer_name not in new_params:
            raise KeyError(
                f"reference layer {layer_name} not present in model params"
            )
        value = reader.get_tensor(var_name)
        current = new_params[layer_name][leaf_name]
        if tuple(current.shape) != tuple(value.shape):
            raise ValueError(
                f"shape mismatch for {layer_name}/{leaf_name}: "
                f"model {tuple(current.shape)} vs ckpt {tuple(value.shape)}"
            )
        new_params[layer_name][leaf_name] = np.asarray(value, np.float32)
        imported += 1
    if imported < 22:
        raise KeyError(
            f"checkpoint only provided {imported}/22 conv parameters"
        )
    return params_from_jax(new_params)


def is_tf_checkpoint_dir(directory: str) -> bool:
    """The JAX package's test for the released format: ``*.ckpt*`` files
    or a ``checkpoint`` file in ``directory``."""
    return bool(glob.glob(os.path.join(directory, "*.ckpt*"))) or os.path.exists(
        os.path.join(directory, "checkpoint")
    )


def import_reference_weights(
    params: dict[str, torch.Tensor], directory: str
) -> dict[str, torch.Tensor]:
    """A state dict with ``params``' values replaced from a reference export.

    Raises on missing layers or shape mismatches; extra non-conv variables
    in the export (optimizer slots etc.) are ignored. A directory holding a
    TF Saver checkpoint (the released best_run format) is detected and
    routed to :func:`import_tf_checkpoint`.
    """
    if is_tf_checkpoint_dir(directory):
        return import_tf_checkpoint(params, directory)
    exported = load_reference_export(directory)
    mapped: dict[tuple[str, str], np.ndarray] = {}
    for var_name, value in exported.items():
        dest = reference_name_to_param_path(var_name)
        if dest is not None:
            mapped[dest] = value

    new_params = params_to_jax(params)
    for layer_name, leaf_name in sorted(mapped):
        if layer_name not in new_params:
            raise KeyError(
                f"reference layer {layer_name} not present in model params"
            )
        value = mapped[(layer_name, leaf_name)]
        current = new_params[layer_name][leaf_name]
        if tuple(current.shape) != tuple(value.shape):
            raise ValueError(
                f"shape mismatch for {layer_name}/{leaf_name}: "
                f"model {tuple(current.shape)} vs export {tuple(value.shape)}"
            )
        new_params[layer_name][leaf_name] = np.asarray(
            value, dtype=np.float32
        )

    expected = {
        (f"conv_{i}", leaf)
        for i in range(11)
        for leaf in ("kernel", "bias")
    }
    missing = expected - set(mapped)
    if missing:
        raise KeyError(
            f"reference export is missing {sorted(missing)[:4]}..."
            if len(missing) > 4
            else f"reference export is missing {sorted(missing)}"
        )
    return params_from_jax(new_params)
