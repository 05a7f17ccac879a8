"""The port's host C++ for audio and the cache against the JAX package's.

FLAC files written by ``chip_smoke.write_flac`` (VERBATIM and FIXED
subframes of every order, several partition orders, 4- and 5-bit rice
parameters, the four stereo layouts, a file shorter than half an FFT
window, a file of more than 128 frames) decode bit-equal through
``speecht_tpu_torch.native.flac_decode`` and ``speecht_tpu.native.flac_decode``,
and equal to the written int16 / 32768 (stereo: the channels' mean).
``resample`` is bit-equal to the JAX package's (both built with -O3 and no
-ffast-math) on the polyphase path and on the direct path (L > 4096).
``npz_load_sample`` reads caches the JAX writer wrote bit-equal to
``np.load`` (the host DSP's column-major features included, which the JAX
package's reader leaves to ``np.load``); a deflated or otherwise foreign
layout raises
``NpzLayoutError`` and the reader takes ``np.load``; a damaged file
raises; a library that cannot be built raises through the reader.
"""

import os

import numpy as np
import pytest

import chip_smoke
from speecht_tpu import native as jnative
from speecht_tpu.data.reader import SpeechCorpusReader as JaxReader
from speecht_tpu_torch import native
from speecht_tpu_torch.data import reader

RNG_SEED = 0


def _pcm(n, seed=RNG_SEED, stereo=False):
    rng = np.random.RandomState(seed)
    mono = chip_smoke.synthetic_speech(rng, n, 16000)
    if not stereo:
        return mono
    other = np.clip(mono.astype(np.int64) // 2 + rng.randint(-900, 900, n),
                    -32768, 32767)
    return np.stack([mono, other], 1).astype(np.int16)


FLAC_CASES = {
    "verbatim": dict(subframe="verbatim"),
    "fixed0": dict(order=0),
    "fixed1": dict(order=1, partition_order=4),
    "fixed2": dict(order=2),
    "fixed3_5bit": dict(order=3, param_bits=5, partition_order=2),
    "fixed4_short_blocks": dict(order=4, block_size=1152, partition_order=3),
    "many_frames": dict(order=2, block_size=192),
}


@pytest.mark.parametrize("name", sorted(FLAC_CASES))
def test_flac_mono_bit_equal(tmp_path, name):
    pcm = _pcm(24011, seed=len(name))
    path = str(tmp_path / "a.flac")
    chip_smoke.write_flac(path, pcm, 16000, **FLAC_CASES[name])
    ours, sr = native.flac_decode(path)
    theirs, jsr = jnative.flac_decode(path)
    assert sr == jsr == 16000 and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours, pcm.astype(np.float32) / 32768)


@pytest.mark.parametrize(
    "stereo", ["independent", "left_side", "right_side", "mid_side"]
)
def test_flac_stereo_bit_equal(tmp_path, stereo):
    pcm = _pcm(9000, seed=3, stereo=True)
    path = str(tmp_path / "s.flac")
    chip_smoke.write_flac(path, pcm, 22050, stereo=stereo)
    ours, sr = native.flac_decode(path)
    theirs, _ = jnative.flac_decode(path)
    np.testing.assert_array_equal(ours, theirs)
    want = (pcm[:, 0].astype(np.float32) + pcm[:, 1].astype(np.float32)) * (
        np.float32(1 / 32768)
    ) / np.float32(2)
    assert sr == 22050
    np.testing.assert_array_equal(ours, want)


def test_flac_shorter_than_half_a_window(tmp_path):
    pcm = _pcm(100)
    path = str(tmp_path / "tiny.flac")
    chip_smoke.write_flac(path, pcm, 16000)
    ours, _ = native.flac_decode(path)
    np.testing.assert_array_equal(ours, jnative.flac_decode(path)[0])
    np.testing.assert_array_equal(ours, pcm.astype(np.float32) / 32768)
    audio, sr = native.load_audio(path)
    assert sr == native.DEFAULT_SR == 22050
    np.testing.assert_array_equal(audio, jnative.load_audio(path)[0])
    assert native.load_audio(path, sr=None)[1] == 16000


def test_flac_damaged_raises(tmp_path):
    path = str(tmp_path / "bad.flac")
    chip_smoke.write_flac(path, _pcm(5000), 16000)
    data = open(path, "rb").read()
    open(path, "wb").write(b"RIFF" + data[4:])
    with pytest.raises(ValueError, match="FLAC decode failed"):
        native.flac_decode(path)
    with pytest.raises(ValueError, match="FLAC decode failed"):
        native.flac_decode(str(tmp_path / "missing.flac"))


@pytest.mark.parametrize(
    "sr_in,sr_out",
    [(16000, 22050), (8000, 22050), (48000, 22050), (22050, 22050),
     (16000, 44101)],  # the last has L = 44101 > 4096: the direct path
)
def test_resample_bit_equal(sr_in, sr_out):
    x = _pcm(20000, seed=sr_in + sr_out).astype(np.float32) / 32768
    ours = native.resample(x, sr_in, sr_out)
    theirs = jnative.resample(x, sr_in, sr_out)
    assert len(ours) == -(-len(x) * sr_out // sr_in)
    np.testing.assert_array_equal(ours, theirs)


@pytest.fixture(scope="module")
def jax_cache(tmp_path_factory):
    """A cache written by the JAX package's ``store_samples``."""
    data = tmp_path_factory.mktemp("cache") / "data"
    chip_smoke.write_flac_corpus(
        str(data), "test", 4, seconds=(0.3, 0.9), letters=(5, 20)
    )
    JaxReader(str(data)).store_samples("test", "power", num_workers=1)
    return data / "preprocessed-power" / "test"


def test_npz_reader_bit_equal_on_jax_cache(jax_cache):
    """The host DSP's features are stored column-major (a transpose that
    np.savez keeps): the port's reader reads them, row-major."""
    files = sorted(os.listdir(jax_cache))
    assert len(files) == 4
    for name in files:
        feats, transcript = native.npz_load_sample(str(jax_cache / name))
        with np.load(jax_cache / name) as data:
            assert data["audio_fragments"].flags.f_contiguous
            np.testing.assert_array_equal(feats, data["audio_fragments"])
            np.testing.assert_array_equal(transcript, data["transcript"])
        assert feats.dtype == np.float32 and transcript.dtype == np.int32
        assert feats.flags.c_contiguous


@pytest.mark.parametrize("order", ["C", "F"])
def test_npz_reader_bit_equal_on_either_order(tmp_path, order):
    rng = np.random.RandomState(2)
    feats = np.asarray(rng.randn(37, 11).astype(np.float32), order=order)
    path = str(tmp_path / "u.npz")
    np.savez(path, audio_fragments=feats, transcript=np.arange(9))
    got, transcript = native.npz_load_sample(path)
    np.testing.assert_array_equal(got, feats)
    np.testing.assert_array_equal(transcript, np.arange(9))
    if order == "C":  # the JAX package's reader reads this layout too
        np.testing.assert_array_equal(got, jnative.npz_load_sample(path)[0])


def test_reader_reads_the_cache_natively(jax_cache, monkeypatch):
    calls = []
    read = native.NpzReader.load
    monkeypatch.setattr(
        native.NpzReader, "load", lambda r, ps: calls.append(ps) or read(r, ps)
    )
    samples = list(
        reader.SpeechCorpusReader(str(jax_cache.parent.parent)).load_samples(
            "test", feature_type="power", seed=0
        )
    )
    # the four files fit one chunk: one native call reads them
    assert len(calls) == 1 and len(samples) == len(calls[0]) == 4


def _write_layout(path: str, layout: str, rng) -> None:
    feats = rng.randn(int(rng.randint(1, 40)), 7).astype(np.float32)
    transcript = np.arange(int(rng.randint(0, 6)))
    if layout == "fortran":
        feats = np.asfortranarray(feats)
    if layout == "float64":
        feats = feats.astype(np.float64)
    if layout == "deflated":
        np.savez_compressed(path, audio_fragments=feats, transcript=transcript)
    elif layout == "no_transcript":
        np.savez(path, audio_fragments=feats)
    else:
        np.savez(path, audio_fragments=feats, transcript=transcript)
    if layout == "damaged":
        data = open(path, "rb").read()
        open(path, "wb").write(data[: len(data) // 2])


@pytest.mark.parametrize("seed,threads", [(0, 1), (1, 3), (2, 8)])
def test_npz_reader_matches_one_file_at_a_time(tmp_path, seed, threads):
    """One read of a mixed chunk gives, file for file, what
    ``npz_load_sample`` gives: the arrays, or the same error; and again
    with the reader's buffers reused for a shorter chunk."""
    rng = np.random.RandomState(seed)
    layouts = ["plain", "fortran", "float64", "deflated", "no_transcript",
               "damaged", "plain", "plain"]
    rng.shuffle(layouts)
    paths = []
    for i, layout in enumerate(layouts):
        paths.append(str(tmp_path / f"u{i}.npz"))
        _write_layout(paths[-1], layout, rng)
    paths.append(str(tmp_path / "missing.npz"))
    npz = native.NpzReader(threads)
    for chunk in (paths, paths[::-1][:5]):
        got = npz.load(chunk)
        assert len(got) == len(chunk)
        for path, sample in zip(chunk, got):
            try:
                want = native.npz_load_sample(path)
            except ValueError as e:
                assert type(sample) is type(e) and str(sample) == str(e)
                continue
            feats, transcript = sample
            np.testing.assert_array_equal(feats, want[0])
            np.testing.assert_array_equal(transcript, want[1])
            assert feats.dtype == np.float32 and transcript.dtype == np.int32
            # each sample owns its memory: none keeps the chunk's alive
            assert feats.flags.owndata and transcript.flags.owndata
    assert npz.load([]) == []
    npz.close()


def test_reader_chunks_keep_order_and_raise_in_turn(tmp_path):
    """Across chunks the reader yields the shuffled order, takes ``np.load``
    for another layout, and raises for a damaged file after the samples
    before it."""
    directory = tmp_path / "preprocessed" / "train"
    directory.mkdir(parents=True)
    rng = np.random.RandomState(3)
    n = reader.READ_CHUNK + 5
    for i in range(n):
        layout = "deflated" if i == 2 else "plain"
        _write_layout(str(directory / f"u{i:03d}.npz"), layout, rng)
    corpus = reader.SpeechCorpusReader(str(tmp_path))
    files = sorted(reader.iglob_recursive(str(directory), "*.npz"))
    order = list(files)
    import random
    random.Random(7).shuffle(order)
    got = list(corpus.load_samples("train", feature_type="mfcc", seed=7))
    assert len(got) == n
    for path, (feats, transcript) in zip(order, got):
        with np.load(path) as data:
            np.testing.assert_array_equal(feats, data["audio_fragments"])
            np.testing.assert_array_equal(transcript, data["transcript"])
    _write_layout(order[reader.READ_CHUNK + 1], "damaged", rng)
    taken = []
    with pytest.raises(ValueError, match="npz load failed"):
        for sample in corpus.load_samples("train", feature_type="mfcc", seed=7):
            taken.append(sample)
    assert len(taken) == reader.READ_CHUNK + 1


@pytest.mark.parametrize("fits", [True, False])
def test_looping_reader_keeps_a_shard_that_fits(tmp_path, monkeypatch, fits):
    """A looping shard that fits ``KEEP_BYTES`` is read once: later passes
    give the same samples, read-only, in each pass's shuffled order, with
    no read; a larger one is read every pass."""
    directory = tmp_path / "preprocessed" / "train"
    directory.mkdir(parents=True)
    rng = np.random.RandomState(4)
    n = reader.READ_CHUNK + 3
    for i in range(n):
        _write_layout(str(directory / f"u{i:03d}.npz"), "plain", rng)
    if not fits:
        monkeypatch.setattr(reader, "KEEP_BYTES", 4 * 1024)
    reads = []
    load = native.NpzReader.load
    monkeypatch.setattr(native.NpzReader, "load",
                        lambda r, ps: reads.append(len(ps)) or load(r, ps))
    looping = reader.SpeechCorpusReader(str(tmp_path)).load_samples(
        "train", feature_type="mfcc", seed=5, loop_infinitely=True)
    passes = [[next(looping) for _ in range(n)] for _ in range(3)]
    looping_reads = sum(reads)
    once = reader.SpeechCorpusReader(str(tmp_path)).load_samples(
        "train", feature_type="mfcc", seed=5)
    assert [(f.tobytes(), t.tobytes()) for f, t in passes[0]] == [
        (f.tobytes(), t.tobytes()) for f, t in once]
    by_content = {f.tobytes(): t.tobytes() for f, t in passes[0]}
    for later in passes[1:]:
        assert {f.tobytes(): t.tobytes() for f, t in later} == by_content
    assert [f.tobytes() for f, _ in passes[1]] != [f.tobytes() for f, _ in passes[0]]
    if fits:
        assert looping_reads == n  # the first pass alone
        assert all(f is g for (f, _), (g, _) in zip(
            sorted(passes[0], key=lambda s: s[0].tobytes()),
            sorted(passes[2], key=lambda s: s[0].tobytes())))
        assert not passes[2][0][0].flags.writeable
    else:
        assert looping_reads >= 2 * n + 1  # each pass reads
        assert passes[2][0][0].flags.writeable


@pytest.mark.parametrize(
    "layout", ["deflated", "big_endian", "float16", "fortran_transcript"]
)
def test_other_layouts_take_np_load(tmp_path, layout):
    rng = np.random.RandomState(1)
    feats = rng.randn(30, 8).astype(np.float32)
    transcript = np.array([3, 1, 4], np.int64)
    path = str(tmp_path / "u.npz")
    if layout == "deflated":
        np.savez_compressed(path, audio_fragments=feats, transcript=transcript)
    else:
        stored = {
            "big_endian": (feats.astype(">f4"), transcript),
            "float16": (feats.astype(np.float16), transcript),
            "fortran_transcript": (
                feats, np.asfortranarray(np.stack([transcript] * 2, 1))
            ),
        }[layout]
        np.savez(path, audio_fragments=stored[0], transcript=stored[1])
    with pytest.raises(native.NpzLayoutError):
        native.npz_load_sample(path)
    got, got_transcript = reader.load_sample(path)
    with np.load(path) as data:
        np.testing.assert_array_equal(got, data["audio_fragments"])
        np.testing.assert_array_equal(got_transcript, data["transcript"])


def test_damaged_cache_raises(tmp_path):
    path = str(tmp_path / "u.npz")
    np.savez(path, audio_fragments=np.ones((5, 4), np.float32),
             transcript=np.array([1, 2]))
    data = open(path, "rb").read()
    open(path, "wb").write(data[: len(data) // 2])
    with pytest.raises(ValueError, match="npz load failed") as info:
        reader.load_sample(path)
    assert not isinstance(info.value, native.NpzLayoutError)
    np.savez(path, audio_fragments=np.ones((5, 4), np.float32))
    with pytest.raises(ValueError, match="code -10"):
        reader.load_sample(path)


def test_library_that_cannot_build_raises_through_the_reader(
    tmp_path, monkeypatch
):
    path = str(tmp_path / "u.npz")
    np.savez(path, audio_fragments=np.ones((5, 4), np.float32),
             transcript=np.array([1, 2]))

    def broken():
        raise RuntimeError("host library build failed: (test)")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build", broken)
    with pytest.raises(RuntimeError, match="build failed"):
        reader.load_sample(path)


def test_audio_symbols_exported():
    lib = native.load()
    for name in ("stt_flac_decode_file", "stt_resample", "stt_npz_load_sample",
                 "stt_npz_reader_read", "stt_npz_reader_fill", "stt_free"):
        assert hasattr(lib, name)
    for name in ("st_flac_decode_file", "st_resample", "st_npz_load_sample",
                 "st_levenshtein_i32"):
        with pytest.raises(AttributeError):
            getattr(lib, name)
