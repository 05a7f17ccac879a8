"""The port's host C++: audio decoding, the cache reader, the n-gram LM
and the CTC prefix beam search.

Counterpart of ``speecht_tpu/native/__init__.py`` less its edit distance:
:func:`flac_decode`, :func:`resample`, :func:`load_audio`,
:func:`npz_load_sample`, :class:`NpzReader`, :func:`lm_is_binary`,
:func:`lm_write_binary`, :class:`NGramLM`, :func:`ctc_beam_search`, :func:`ctc_beam_search_cont`
(the continuation search of streaming partials) and :func:`kenlm_dump`;
and :func:`crc32c`, which the JAX package leaves to tensorflow (the TF
checkpoint reader's check of each tensor, ``compat.py``).
The sources in this directory are the port's own copies of the JAX
package's ``speecht_native.cpp`` (FLAC and resampling), ``npz_reader.cpp``
(without its inflate branch), ``lm.h``, ``beam_search.cpp`` and
``kenlm_binary.cpp`` (the reader, the dump and the writer); built
with the same arithmetic flags (``-O3``, no ``-march=native``, no
``-ffast-math``) they decode and resample bit for bit as the JAX
package's library, and the same emissions give the same ids.

The library is compiled with ``g++`` at first use, never at import, into
``_build/libspeecht_host-<digest>.so`` inside the package, where
``<digest>`` hashes the sources, the header and the flags: an edited
source rebuilds and a built one is reused. Each build writes a file of its
own and renames it into place, so processes that build at the same moment
do not see each other's partial output. A failed build raises
RuntimeError with the compiler's output; there is no Python fallback.

The library is built with hidden visibility and exports only its ``stt_``
C functions, so it can share a process with the JAX package's
``libspeecht_native.so``. It is loaded with ``ctypes.CDLL``, which
releases the GIL during each call, so a thread pool of beams scales.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import weakref

import numpy as np

from speecht_tpu_torch.ops.cuda_build import BUILD_DIR

NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = (
    "beam_search.cpp", "kenlm_binary.cpp", "npz_reader.cpp", "speecht_native.cpp",
)
HEADERS = ("lm.h",)
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-fvisibility=hidden"]

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(NATIVE_DIR, name), "rb") as f:
            digest.update(f.read())
    return os.path.join(
        BUILD_DIR, f"libspeecht_host-{digest.hexdigest()[:16]}.so"
    )


def build() -> str:
    """Compile the library unless it is built; returns its path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [
        "g++", *CXX_FLAGS, "-o", tmp,
        *(os.path.join(NATIVE_DIR, s) for s in SOURCES),
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(
            "g++ not found: the port's host library is built from source "
            "at first use"
        ) from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"host library build failed:\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, path)
    return path


_P = ctypes.c_void_p
_SIGNATURES = {
    "stt_lm_load": ([ctypes.c_char_p, ctypes.c_char_p], _P),
    "stt_lm_free": ([_P], None),
    "stt_lm_order": ([_P], ctypes.c_int),
    "stt_lm_score_word": ([_P, ctypes.c_char_p, ctypes.c_char_p], ctypes.c_float),
    "stt_lm_has_word": ([_P, ctypes.c_char_p], ctypes.c_int),
    "stt_lm_score_sentence": (
        [
            _P,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ],
        None,
    ),
    "stt_lm_is_binary": ([ctypes.c_char_p], ctypes.c_int),
    "stt_lm_write_binary": (
        [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int],
        ctypes.c_int,
    ),
    "stt_free": ([_P], None),
    "stt_crc32c": ([_P, ctypes.c_size_t], ctypes.c_uint32),
    "stt_flac_decode_file": (
        [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
        ],
        ctypes.c_int,
    ),
    "stt_resample": (
        [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_double,
            ctypes.c_double,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
        ],
        ctypes.c_int,
    ),
    "stt_npz_load_sample": (
        [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),  # feature shape [2]
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_int64),
        ],
        ctypes.c_int,
    ),
    "stt_npz_reader_new": ([ctypes.c_int32], _P),
    "stt_npz_reader_free": ([_P], None),
    "stt_npz_reader_read": (
        [
            _P,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),  # codes [n]
            ctypes.POINTER(ctypes.c_int64),  # feature shapes [n, 2]
            ctypes.POINTER(ctypes.c_int64),  # transcript lengths [n]
        ],
        None,
    ),
    "stt_npz_reader_fill": ([_P, ctypes.POINTER(_P), ctypes.POINTER(_P)], None),
    "stt_kenlm_dump_open": ([ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32], _P),
    "stt_kenlm_dump_close": ([_P], None),
    "stt_kenlm_dump_order": ([_P], ctypes.c_int32),
    "stt_kenlm_dump_unigram_slots": ([_P], ctypes.c_int64),
    "stt_kenlm_dump_unigrams": (
        [_P, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)],
        ctypes.c_int32,
    ),
    "stt_kenlm_dump_table_count": ([_P, ctypes.c_int32], ctypes.c_int64),
    "stt_kenlm_dump_table": (
        [
            _P,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ],
        ctypes.c_int32,
    ),
    "stt_kenlm_dump_vocab_bytes": ([_P], ctypes.c_int64),
    "stt_kenlm_dump_vocab": ([_P, ctypes.c_char_p, ctypes.c_int64], ctypes.c_int32),
    "stt_ctc_beam_search": (
        [
            ctypes.POINTER(ctypes.c_float),  # log_probs
            ctypes.c_int64,  # T
            ctypes.c_int32,  # C
            ctypes.c_int32,  # blank_id
            ctypes.c_int32,  # beam_width
            _P,  # lm
            ctypes.c_float,  # lm_weight
            ctypes.c_float,  # word_count_weight
            ctypes.c_float,  # valid_word_count_weight
            ctypes.c_int32,  # prune_top_k
            ctypes.POINTER(ctypes.c_int32),  # out_ids
            ctypes.c_int32,  # out_capacity
        ],
        ctypes.c_int,
    ),
    "stt_ctc_beam_search_cont": (
        [
            ctypes.POINTER(ctypes.c_float),  # log_probs
            ctypes.c_int64,  # T
            ctypes.c_int32,  # C
            ctypes.c_int32,  # blank_id
            ctypes.c_int32,  # beam_width
            _P,  # lm
            ctypes.c_float,  # lm_weight
            ctypes.c_float,  # word_count_weight
            ctypes.c_float,  # valid_word_count_weight
            ctypes.c_int32,  # prune_top_k
            ctypes.c_char_p,  # context_text
            ctypes.c_int32,  # last_char_id
            ctypes.c_int32,  # ended_in_blank
            ctypes.POINTER(ctypes.c_int32),  # out_ids
            ctypes.c_int32,  # out_capacity
        ],
        ctypes.c_int,
    ),
}


def load() -> ctypes.CDLL:
    """Build the library if needed and load it (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
    return _lib


def lm_is_binary(path: str) -> bool:
    """True when ``path`` is a KenLM binary ("mmap lm ..." magic)."""
    return bool(load().stt_lm_is_binary(path.encode()))


def lm_write_binary(arpa_path: str, out_path: str) -> None:
    """Convert an ARPA model to KenLM's PROBING binary format; a file that
    cannot be read or written raises ValueError."""
    err = ctypes.create_string_buffer(512)
    rc = load().stt_lm_write_binary(
        arpa_path.encode(), out_path.encode(), err, len(err)
    )
    if rc != 0:
        raise ValueError(
            f"binary conversion failed: {err.value.decode(errors='replace')}"
        )


class NGramLM:
    """Backoff word LM + vocabulary trie (native handle).

    Accepts KenLM's ARPA source format or its PROBING binary format
    (``kenlm-model.binary``), told apart by the binary's magic. A file
    that cannot be read raises ValueError.
    """

    def __init__(self, model_path: str, vocab_path: str | None = None):
        lib = load()
        self._lib = lib
        self._handle = lib.stt_lm_load(
            model_path.encode(), (vocab_path or "").encode()
        )
        if not self._handle:
            raise ValueError(f"failed to load LM from {model_path}")

    @property
    def order(self) -> int:
        return self._lib.stt_lm_order(self._handle)

    def score_word(self, history: str, word: str) -> float:
        """log10 P(word | history words)."""
        return float(
            self._lib.stt_lm_score_word(
                self._handle, history.encode(), word.encode()
            )
        )

    def has_word(self, word: str) -> bool:
        return bool(self._lib.stt_lm_has_word(self._handle, word.encode()))

    def score_sentence(self, text: str) -> tuple[float, int, int]:
        """(sum of log10 P per word, #words, #valid words) for a sentence,
        with the beam's history (<s> and the last 4 words)."""
        lm_sum = ctypes.c_float()
        n_words = ctypes.c_int32()
        n_valid = ctypes.c_int32()
        self._lib.stt_lm_score_sentence(
            self._handle,
            text.encode(),
            ctypes.byref(lm_sum),
            ctypes.byref(n_words),
            ctypes.byref(n_valid),
        )
        return float(lm_sum.value), int(n_words.value), int(n_valid.value)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.stt_lm_free(handle)
            self._handle = None


def kenlm_dump(path: str) -> dict:
    """Dump a KenLM PROBING binary's raw tables for the device beam.

    Returns ``{"order", "words" (list, id order), "uni_prob", "uni_back"
    (float32 [slots]), "tables" {n: (key_lo u32, key_hi u32, prob f32,
    backoff f32)} for n in 2..order}``. The n-gram keys are KenLM's chained
    64-bit hashes of word-id sequences; the device beam recomputes the same
    hash from its word-id history (``ops/beam_device.py``), so no word
    sequence has to be recovered to probe them. A file that cannot be read
    raises ValueError.
    """
    lib = load()
    err = ctypes.create_string_buffer(512)
    h = lib.stt_kenlm_dump_open(path.encode(), err, len(err))
    if not h:
        raise ValueError(
            f"cannot read KenLM binary {path}: "
            f"{err.value.decode(errors='replace')}"
        )
    f32 = ctypes.POINTER(ctypes.c_float)
    u32 = ctypes.POINTER(ctypes.c_uint32)
    try:
        order = int(lib.stt_kenlm_dump_order(h))
        slots = int(lib.stt_kenlm_dump_unigram_slots(h))
        uni_prob = np.zeros(slots, np.float32)
        uni_back = np.zeros(slots, np.float32)
        lib.stt_kenlm_dump_unigrams(
            h, uni_prob.ctypes.data_as(f32), uni_back.ctypes.data_as(f32)
        )
        nbytes = int(lib.stt_kenlm_dump_vocab_bytes(h))
        buf = ctypes.create_string_buffer(max(nbytes, 1))
        if lib.stt_kenlm_dump_vocab(h, buf, nbytes) != 0:
            raise ValueError("vocab dump overflow")
        words = (
            buf.raw[:nbytes].decode(errors="replace").split("\0")[:-1]
            if nbytes
            else []
        )
        tables = {}
        for n in range(2, order + 1):
            cnt = int(lib.stt_kenlm_dump_table_count(h, n))
            lo = np.zeros(cnt, np.uint32)
            hi = np.zeros(cnt, np.uint32)
            prob = np.zeros(cnt, np.float32)
            back = np.zeros(cnt, np.float32)
            if cnt and lib.stt_kenlm_dump_table(
                h, n, lo.ctypes.data_as(u32), hi.ctypes.data_as(u32),
                prob.ctypes.data_as(f32), back.ctypes.data_as(f32),
            ) != 0:
                raise ValueError(f"table dump failed for order {n}")
            tables[n] = (lo, hi, prob, back)
        return {
            "order": order,
            "words": words,
            "uni_prob": uni_prob,
            "uni_back": uni_back,
            "tables": tables,
        }
    finally:
        lib.stt_kenlm_dump_close(h)


def _emissions(log_probs: np.ndarray, blank_id: int, beam_width: int) -> np.ndarray:
    log_probs = np.ascontiguousarray(log_probs, dtype=np.float32)
    if log_probs.ndim != 2:
        raise ValueError(f"log_probs must be [T, C], got {log_probs.shape}")
    if not 0 <= blank_id < log_probs.shape[1]:
        raise ValueError(f"blank_id {blank_id} is not a class of {log_probs.shape[1]}")
    if beam_width < 1:
        raise ValueError(f"beam_width must be at least 1, got {beam_width}")
    return log_probs


def ctc_beam_search(
    log_probs: np.ndarray,
    beam_width: int = 100,
    lm: NGramLM | None = None,
    lm_weight: float = 0.8,
    word_count_weight: float = 0.0,
    valid_word_count_weight: float = 2.3,
    blank_id: int = 28,
    prune_top_k: int = 8,
) -> np.ndarray:
    """Prefix beam search over [T, C] natural-log emissions -> decoded ids."""
    log_probs = _emissions(log_probs, blank_id, beam_width)
    T, C = log_probs.shape
    out = np.zeros(max(T, 1), dtype=np.int32)
    n = load().stt_ctc_beam_search(
        log_probs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        T,
        C,
        blank_id,
        beam_width,
        lm._handle if lm is not None else None,
        lm_weight,
        word_count_weight,
        valid_word_count_weight,
        prune_top_k,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(out),
    )
    return out[:n]


def ctc_beam_search_cont(
    log_probs: np.ndarray,
    context_text: str = "",
    last_char_id: int = -1,
    ended_in_blank: bool = True,
    beam_width: int = 100,
    lm: NGramLM | None = None,
    lm_weight: float = 0.8,
    word_count_weight: float = 0.0,
    valid_word_count_weight: float = 2.3,
    blank_id: int = 28,
    prune_top_k: int = 8,
) -> np.ndarray:
    """Continuation prefix beam over a tail of emissions.

    ``context_text``'s complete words seed the LM history and its trailing
    partial word prefixes the first word completed here;
    ``last_char_id``/``ended_in_blank`` carry the committed greedy path's
    CTC collapse state across the boundary. Returns only the tail's
    decoded ids (the caller owns the committed text). With no context it
    equals :func:`ctc_beam_search`. ``ops/streaming.py``'s LM-fused
    partials call it.
    """
    log_probs = _emissions(log_probs, blank_id, beam_width)
    T, C = log_probs.shape
    out = np.zeros(max(T, 1), dtype=np.int32)
    n = load().stt_ctc_beam_search_cont(
        log_probs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        T,
        C,
        blank_id,
        beam_width,
        lm._handle if lm is not None else None,
        lm_weight,
        word_count_weight,
        valid_word_count_weight,
        prune_top_k,
        context_text.encode(),
        last_char_id,
        1 if ended_in_blank else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(out),
    )
    return out[:n]


def crc32c(buf) -> int:
    """CRC32C (Castagnoli, unmasked) of a bytes-like buffer; the call
    releases the GIL."""
    data = np.frombuffer(buf, np.uint8)
    return int(load().stt_crc32c(data.ctypes.data, data.size))


def _take(lib, ptr, shape) -> np.ndarray:
    """Copy a buffer the library returned into numpy, then free it."""
    if all(shape):
        arr = np.ctypeslib.as_array(ptr, shape=shape).copy()
    else:  # an empty buffer may be a null pointer
        arr = np.zeros(shape, np.dtype(ptr._type_))
    lib.stt_free(ptr)
    return arr


def flac_decode(path: str) -> tuple[np.ndarray, int]:
    """Decode a FLAC file to mono float32 in [-1, 1) at its own rate."""
    lib = load()
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    sr = ctypes.c_int32()
    rc = lib.stt_flac_decode_file(
        path.encode(), ctypes.byref(out), ctypes.byref(n), ctypes.byref(sr)
    )
    if rc != 0:
        raise ValueError(f"FLAC decode failed for {path} (code {rc})")
    return _take(lib, out, (n.value,)), int(sr.value)


def resample(audio: np.ndarray, sr_in: float, sr_out: float) -> np.ndarray:
    """Windowed-sinc resample; output length ceil(n * sr_out / sr_in)."""
    lib = load()
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    out = ctypes.POINTER(ctypes.c_float)()
    n_out = ctypes.c_int64()
    rc = lib.stt_resample(
        audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(audio),
        float(sr_in),
        float(sr_out),
        ctypes.byref(out),
        ctypes.byref(n_out),
    )
    if rc != 0:
        raise ValueError(f"resample failed (code {rc})")
    return _take(lib, out, (n_out.value,))


DEFAULT_SR = 22050  # the rate of the feature cache (librosa.load's default)


def load_audio(path: str, sr: int | None = DEFAULT_SR) -> tuple[np.ndarray, int]:
    """Decode FLAC and resample to ``sr`` (None keeps the file's rate)."""
    audio, native_sr = flac_decode(path)
    if sr is None or sr == native_sr:
        return audio, native_sr
    return resample(audio, native_sr, sr), sr


class NpzLayoutError(ValueError):
    """A well-formed npz of a layout the native reader does not read (a
    deflated entry, big-endian or Fortran-order data, another dtype):
    ``np.load`` reads it."""


def npz_load_sample(path: str) -> tuple[np.ndarray, np.ndarray]:
    """One cache file -> (features float32 [T, F], transcript int32).

    Raises :class:`NpzLayoutError` for a file of another layout and
    ValueError for a file that cannot be read or is damaged. The call
    releases the GIL.
    """
    lib = load()
    feats = ctypes.POINTER(ctypes.c_float)()
    shape = (ctypes.c_int64 * 2)()
    transcript = ctypes.POINTER(ctypes.c_int32)()
    length = ctypes.c_int64()
    rc = lib.stt_npz_load_sample(
        path.encode(),
        ctypes.byref(feats),
        shape,
        ctypes.byref(transcript),
        ctypes.byref(length),
    )
    if rc == 1:
        raise NpzLayoutError(f"{path}: not the layout the native reader reads")
    if rc != 0:
        raise ValueError(f"npz load failed for {path} (code {rc})")
    return (
        _take(lib, feats, (shape[0], shape[1])),
        _take(lib, transcript, (length.value,)),
    )


class NpzReader:
    """Reads cache files many at a time, each into arrays of its own.

    ``load(paths)`` gives, for each path in order, (features float32 [T, F],
    transcript int32) or the error :func:`npz_load_sample` raises for it.
    The library's ``threads`` threads read and parse the files, into
    buffers the reader keeps from call to call, and then convert them into
    numpy arrays allocated here from the shapes read; the GIL is released
    once for each of the two phases. So a loader thread beside a training
    loop reads a batch of files in parallel and hands the loop's thread the
    GIL back twice a batch, not several times a file. One thread at a time
    uses a reader.
    """

    def __init__(self, threads: int):
        lib = load()
        self._lib = lib
        self._handle = lib.stt_npz_reader_new(threads)
        self._free = weakref.finalize(self, lib.stt_npz_reader_free, self._handle)

    def load(self, paths: list[str]) -> list:
        lib, n = self._lib, len(paths)
        codes = (ctypes.c_int32 * n)()
        shapes = (ctypes.c_int64 * (2 * n))()
        lengths = (ctypes.c_int64 * n)()
        lib.stt_npz_reader_read(
            self._handle, (ctypes.c_char_p * n)(*(p.encode() for p in paths)),
            n, codes, shapes, lengths,
        )
        feature_ptrs, transcript_ptrs = (_P * n)(), (_P * n)()
        out = []
        for i, (path, rc) in enumerate(zip(paths, codes)):
            if rc == 1:
                out.append(NpzLayoutError(
                    f"{path}: not the layout the native reader reads"))
            elif rc != 0:
                out.append(ValueError(f"npz load failed for {path} (code {rc})"))
            else:
                feats = np.empty((shapes[2 * i], shapes[2 * i + 1]), np.float32)
                transcript = np.empty(lengths[i], np.int32)
                feature_ptrs[i] = feats.ctypes.data
                transcript_ptrs[i] = transcript.ctypes.data
                out.append((feats, transcript))
        lib.stt_npz_reader_fill(self._handle, feature_ptrs, transcript_ptrs)
        return out

    def close(self) -> None:
        self._free()
