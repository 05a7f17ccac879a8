"""Every entry point of the port's host C++ under ASan and UBSan.

The port of ``tools/native_sanitize_check.py``, for the port's own copies
of that C++ (``speecht_tpu_torch/native/``): it builds ``native.SOURCES``
with ``-O1 -g -fsanitize=address,undefined -fno-sanitize-recover=all``
into a temporary directory (never ``_build/``, whose ``-O3`` library stays
as it is), then runs the drive in a process of its own with the ASan
runtime preloaded (``LD_PRELOAD=$(g++ -print-file-name=libasan.so)``,
``ASAN_OPTIONS=detect_leaks=0``) and ``native.build`` pointed at the
sanitizer build for that process only. The drive imports no torch.

The drive calls every ``stt_`` function of ``native._SIGNATURES`` (it
counts the calls and fails if one was never made):

- FLAC decoding of the files given with ``--flac`` (the JAX tool reads a
  LibriSpeech fixture the repository does not hold), and ``load_audio``;
- resampling up and down, on the polyphase path and on the direct sum;
- the npz cache reader, on its layout and on ones it refuses, a file at a
  time and many in one call;
- ARPA and KenLM-binary LM loading, scoring, ``has_word``, the binary
  writer and the table dump, on the tool's own ARPA text;
- the prefix beam with and without the LM, and the continuation beam;
- ``stt_crc32c`` on lengths 0 through 17 and on 1 MB, against Python's;
- a fuzz pass over each parser of untrusted bytes: 40 mutated or
  truncated KenLM binaries (JAX's pass), FLACs and npz files, where a
  ValueError is allowed.

Any sanitizer report aborts the drive; the command prints ``ALL ASAN
CHECKS PASSED`` and exits 0 only when the drive ran to its end clean.

    python -m speecht_tpu_torch.tools.native_sanitize_check --flac A.flac [B.flac ...]

needs only the CPU and g++ with its sanitizer runtimes.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os
import subprocess
import sys
import tempfile

SANITIZE_FLAGS = ["-O1", "-g", "-std=c++17", "-fPIC", "-fvisibility=hidden",
                  "-fsanitize=address,undefined", "-fno-sanitize-recover=all"]
PASSED = "ALL ASAN CHECKS PASSED"
FUZZ_FILES = 40

ARPA = """\\data\\
ngram 1=9
ngram 2=5
ngram 3=2

\\1-grams:
-1.2\t<unk>
-0.6\t<s>\t-0.5
-0.7\t</s>
-0.8\ta\t-0.3
-1.1\tbird\t-0.2
-1.3\tsings\t-0.25
-1.0\ton\t-0.2
-1.5\troof\t-0.1
-1.6\tred\t-0.15

\\2-grams:
-0.2\t<s> a\t-0.1
-0.4\ta bird\t-0.2
-0.5\tbird sings\t-0.1
-0.6\tsings on
-0.7\ta red\t-0.05

\\3-grams:
-0.1\t<s> a bird
-0.3\ta bird sings

\\end\\
"""
VOCABULARY = "a\nbird\nsings\non\nroof\n"


def asan_runtime() -> str:
    """The path of g++'s ASan runtime; RuntimeError when g++ has none (it
    then names the bare file name back)."""
    path = subprocess.run(["g++", "-print-file-name=libasan.so"], capture_output=True,
                          text=True, check=True).stdout.strip()
    if not os.path.isabs(path) or not os.path.exists(path):
        raise RuntimeError(f"g++ has no ASan runtime (it names {path!r})")
    return path


def build(out_dir: str) -> str:
    """Compile ``native.SOURCES`` with the sanitizers into ``out_dir``,
    one g++ a source in parallel, then link; returns the library's path.
    A failed compile raises RuntimeError with its output."""
    from speecht_tpu_torch import native

    def compile_one(source):
        obj = os.path.join(out_dir, os.path.splitext(source)[0] + ".o")
        cmd = ["g++", *SANITIZE_FLAGS, "-c", "-o", obj, os.path.join(native.NATIVE_DIR, source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"sanitizer build failed:\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        return obj

    with concurrent.futures.ThreadPoolExecutor(len(native.SOURCES)) as pool:
        objects = list(pool.map(compile_one, native.SOURCES))
    lib = os.path.join(out_dir, "libspeecht_host_asan.so")
    cmd = ["g++", *SANITIZE_FLAGS, "-shared", "-o", lib, *objects]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"sanitizer link failed:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return lib


# -- the drive, in the process with the ASan runtime preloaded ----------------


def _count_calls(lib, names) -> dict:
    """Wraps each of ``names`` on the loaded library to count its calls."""
    calls = dict.fromkeys(names, 0)

    def wrap(name, fn):
        def counted(*args):
            calls[name] += 1
            return fn(*args)
        return counted

    for name in names:
        setattr(lib, name, wrap(name, getattr(lib, name)))
    return calls


def _mutants(rng, good: bytes, n: int):
    """``n`` copies of ``good`` with 1-5 random bytes replaced, 30% of
    them then truncated (the JAX tool's fuzz rule)."""
    for _ in range(n):
        data = bytearray(good)
        for _ in range(rng.randint(1, 6)):
            data[rng.randint(0, len(data))] = rng.randint(0, 256)
        if rng.rand() < 0.3:
            data = data[: rng.randint(8, len(data))]
        yield bytes(data)


def _log_probs(rng, T):
    import numpy as np

    logits = rng.randn(T, 29).astype(np.float32) * 3
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.log(p).astype(np.float32)


def drive(lib_path: str, flacs: list[str], work: str) -> None:
    """Calls every entry point of the library at ``lib_path``."""
    import numpy as np

    from speecht_tpu_torch import native
    from speecht_tpu_torch.train.metrics_writer import crc32c as python_crc32c

    native.build = lambda: lib_path  # this process only
    native._lib = None
    lib = native.load()
    calls = _count_calls(lib, native._SIGNATURES)
    rng = np.random.RandomState(0)

    def fuzz(name, good_files, parse):
        """FUZZ_FILES mutants, of each good file in turn, through ``parse``:
        a ValueError is allowed, a sanitizer report aborts the process."""
        path = os.path.join(work, f"fuzz-{name}")
        refused = 0
        for i in range(FUZZ_FILES):
            with open(good_files[i % len(good_files)], "rb") as f:
                (data,) = _mutants(rng, f.read(), 1)
            with open(path, "wb") as f:
                f.write(data)
            try:
                parse(path)
            except ValueError:
                refused += 1
        print(f"fuzz {name}: {FUZZ_FILES} mutated or truncated files of "
              f"{len(good_files)}, {refused} refused")

    # FLAC and resampling
    for path in flacs:
        audio, sr = native.flac_decode(path)
        resampled, _ = native.load_audio(path)
        print(f"flac {os.path.basename(path)}: {len(audio)} samples at {sr} Hz, "
              f"{len(resampled)} at {native.DEFAULT_SR}")
    signal = rng.randn(5000).astype(np.float32)
    for sr_in, sr_out in ((16000, 22050), (22050, 16000), (16000, 16000),
                          (44100, 8000), (16000, 12345.6)):
        out = native.resample(signal, sr_in, sr_out)
        print(f"resample {sr_in} -> {sr_out}: {len(out)} samples")
    try:
        native.resample(signal[:0], 16000, 22050)
    except ValueError:
        pass
    else:
        raise AssertionError("an empty resample did not raise")

    # the npz cache reader
    sample = os.path.join(work, "sample.npz")
    np.savez(sample, audio_fragments=rng.randn(50, 128).astype(np.float32),
             transcript=np.arange(7, dtype=np.int32))
    feats, transcript = native.npz_load_sample(sample)
    assert feats.shape == (50, 128) and transcript.tolist() == list(range(7))
    for name, writer in (("compressed", np.savez_compressed),
                         ("fortran", lambda p, **a: np.savez(
                             p, audio_fragments=np.asfortranarray(a["audio_fragments"]),
                             transcript=a["transcript"]))):
        path = os.path.join(work, f"{name}.npz")
        writer(path, audio_fragments=rng.randn(8, 3).astype(np.float64),
               transcript=np.arange(3, dtype=np.int64))
        try:
            native.npz_load_sample(path)
        except native.NpzLayoutError:
            pass
    # many files at a time, on threads: read, refused and missing ones mixed
    many = [sample, os.path.join(work, "compressed.npz"), sample,
            os.path.join(work, "fortran.npz"), os.path.join(work, "missing.npz")]
    npz = native.NpzReader(3)
    got = npz.load(many)
    assert [type(g).__name__ for g in got] == [
        "tuple", "NpzLayoutError", "tuple", "tuple", "ValueError"]
    assert (got[2][0] == feats).all() and npz.load([]) == []
    print("npz ok")

    # LMs: ARPA, the binary written from it, the table dump
    arpa = os.path.join(work, "model.arpa")
    vocab = os.path.join(work, "vocabulary")
    binary = os.path.join(work, "model.binary")
    with open(arpa, "w") as f:
        f.write(ARPA)
    with open(vocab, "w") as f:
        f.write(VOCABULARY)
    lm = native.NGramLM(arpa, vocab)
    native.lm_write_binary(arpa, binary)
    assert native.lm_is_binary(binary) and not native.lm_is_binary(arpa)
    blm = native.NGramLM(binary, vocab)
    for history, word in (("a", "bird"), ("<s> a", "bird"), ("bird", "sings"), ("", "roof"),
                          ("red", "nothing")):
        assert lm.score_word(history, word) == blm.score_word(history, word), (history, word)
    assert lm.has_word("bird") and not lm.has_word("red")
    print(f"lm ok: order {lm.order}, {lm.score_sentence('a bird sings on a red roof')}")
    try:
        native.lm_write_binary(os.path.join(work, "missing.arpa"), binary + ".x")
    except ValueError:
        pass
    else:
        raise AssertionError("a missing ARPA converted")
    dump = native.kenlm_dump(binary)
    print(f"kenlm dump ok: order {dump['order']}, {len(dump['words'])} words, "
          f"tables {sorted(dump['tables'])}")

    # the beams
    for trial in range(5):
        logp = _log_probs(rng, rng.randint(5, 120))
        native.ctc_beam_search(logp, beam_width=50, lm=blm, lm_weight=1.5,
                               word_count_weight=0.7, valid_word_count_weight=2.0)
        native.ctc_beam_search(logp, beam_width=30, lm=lm)
        native.ctc_beam_search(logp, beam_width=100, prune_top_k=0)
        native.ctc_beam_search_cont(logp, context_text="a bird si", last_char_id=8,
                                    ended_in_blank=False, beam_width=20, lm=lm)
        native.ctc_beam_search_cont(logp[:1], beam_width=8)
    native.ctc_beam_search(_log_probs(rng, 0), beam_width=4, lm=lm)
    print("beam ok")

    # CRC32C against the Python CRC
    for n in list(range(18)) + [1 << 20]:
        buf = rng.randint(0, 256, size=n).astype(np.uint8).tobytes()
        assert native.crc32c(buf) == python_crc32c(buf), n
    print("crc32c ok: lengths 0-17 and 1 MB")

    # fuzz each parser of untrusted bytes
    def parse_binary(path):
        native.NGramLM(path).score_word("a", "bird")
        native.kenlm_dump(path)

    fuzz("kenlm.binary", [binary], parse_binary)
    fuzz("flac", flacs, native.flac_decode)
    fuzz("npz", [sample], native.npz_load_sample)
    fuzz("npz_many", [sample], lambda p: npz.load([sample, p, p]))
    npz.close()

    del lm, blm
    never = sorted(name for name, n in calls.items() if not n)
    assert not never, f"entry points never called: {never}"
    assert "torch" not in sys.modules, "the drive imported torch"
    print(f"calls: {calls}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--flac", nargs="+", required=True, help="FLAC files to decode and fuzz")
    p.add_argument("--drive", metavar="LIB", help=argparse.SUPPRESS)
    p.add_argument("--work", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.drive:  # the process with the ASan runtime preloaded
        drive(args.drive, args.flac, args.work)
        print(PASSED, flush=True)
        return 0
    runtime = asan_runtime()
    with tempfile.TemporaryDirectory(prefix="stt_asan_") as tmp:
        lib = build(tmp)
        import speecht_tpu_torch

        package_root = os.path.dirname(os.path.dirname(speecht_tpu_torch.__file__))
        env = dict(os.environ, LD_PRELOAD=runtime, ASAN_OPTIONS="detect_leaks=0",
                   PYTHONPATH=os.pathsep.join(
                       p for p in (package_root, os.environ.get("PYTHONPATH")) if p))
        proc = subprocess.run(
            [sys.executable, "-m", "speecht_tpu_torch.tools.native_sanitize_check",
             "--drive", lib, "--work", tmp, "--flac", *map(os.path.abspath, args.flac)],
            env=env, capture_output=True, text=True)
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr)
    if proc.returncode != 0 or PASSED not in proc.stdout.splitlines():
        print(f"the sanitizer drive failed (exit {proc.returncode})", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
