"""The port's host library against the JAX package's: the n-gram LM.

Both packages' ``NGramLM`` load the same model files, the ARPA of
``test_beam.py`` and a synthetic trigram ARPA made from a numpy seed, as
ARPA sources and as KenLM binaries written by the JAX package's converter
(``native.lm_write_binary``, test-side only). ``order``, ``score_word``
over many histories (OOV words included), ``has_word`` with and without a
``vocabulary`` file and ``score_sentence`` must agree bit for bit: it is
the same C++ arithmetic on the same input. Both libraries live in this
one process. Also: the library's build cache, ``lm_is_binary``,
``find_lm_files``' preference for a binary, and unreadable models that
raise instead of crashing.
"""

import os
import shutil
import subprocess
import threading

import numpy as np
import pytest

from speecht_tpu import native as jnative
from speecht_tpu.ops import beam as jbeam
from speecht_tpu_torch import native
from speecht_tpu_torch.ops import beam
from test_beam import ARPA

LETTERS = np.array(list("abcdefghijklmnopqrstuvwxyz'"))


def _unique_rows(rng, n_words, count, width):
    rows = rng.randint(0, n_words, size=(2 * count, width))
    _, first = np.unique(rows, axis=0, return_index=True)
    return rows[np.sort(first)][:count]


def write_trigram_arpa(path, seed=0, n_words=300, n_bi=2000, n_tri=2000):
    """A seeded order-3 ARPA over random words; returns its words."""
    rng = np.random.RandomState(seed)
    words = set()
    while len(words) < n_words:
        words.add("".join(rng.choice(LETTERS, size=rng.randint(1, 8))))
    words = sorted(words)
    bi = _unique_rows(rng, n_words, n_bi, 2)
    tri = _unique_rows(rng, n_words, n_tri, 3)
    lines = ["\\data\\", f"ngram 1={n_words + 3}", f"ngram 2={len(bi)}",
             f"ngram 3={len(tri)}", "", "\\1-grams:",
             "-3.5\t<unk>", "-2.0\t<s>\t-0.4", "-2.1\t</s>"]
    for w, p, b in zip(words, -1.5 - 3 * rng.rand(n_words),
                       -0.1 - 0.4 * rng.rand(n_words)):
        lines.append(f"{p:.4f}\t{w}\t{b:.4f}")
    lines += ["", "\\2-grams:"]
    for (i, j), p, b in zip(bi, -0.5 - 3 * rng.rand(len(bi)),
                            -0.1 - 0.3 * rng.rand(len(bi))):
        lines.append(f"{p:.4f}\t{words[i]} {words[j]}\t{b:.4f}")
    lines += ["", "\\3-grams:"]
    for (i, j, k), p in zip(tri, -0.3 - 3 * rng.rand(len(tri))):
        lines.append(f"{p:.4f}\t{words[i]} {words[j]} {words[k]}")
    lines += ["", "\\end\\", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return words, bi, tri


@pytest.fixture(scope="module")
def lms(tmp_path_factory):
    """{name: (model path, vocabulary path, words)} for four models."""
    root = tmp_path_factory.mktemp("lms")
    tiny_words = ["the", "cat", "dog", "sat"]
    (root / "tiny.arpa").write_text(ARPA)
    (root / "tiny.vocabulary").write_text("\n".join(tiny_words) + "\n")
    words, _bi, _tri = write_trigram_arpa(str(root / "tri.arpa"))
    # half of the words in the vocabulary file, plus one the LM lacks
    (root / "tri.vocabulary").write_text("\n".join(words[::2] + ["zzzzzz"]) + "\n")
    out = {}
    for name, model_words in (("tiny", tiny_words), ("tri", words)):
        arpa = str(root / f"{name}.arpa")
        binary = str(root / f"{name}.binary")
        jnative.lm_write_binary(arpa, binary)
        vocab = str(root / f"{name}.vocabulary")
        out[f"{name} arpa"] = (arpa, vocab, model_words)
        out[f"{name} binary"] = (binary, vocab, model_words)
    return out


def _histories(words, rng, n):
    oov = ["xylophone", "qq", "a'b"]
    pool = list(words) + oov + ["<s>", "</s>", "<unk>"]
    out = [""]
    for _ in range(n):
        out.append(" ".join(rng.choice(pool, size=rng.randint(1, 6))))
    return out, pool


@pytest.mark.parametrize(
    "name", ["tiny arpa", "tiny binary", "tri arpa", "tri binary"]
)
def test_scores_match_jax_bit_for_bit(lms, name):
    model, vocab, words = lms[name]
    rng = np.random.RandomState(1)
    histories, pool = _histories(words, rng, 150)
    for vocab_path in (None, vocab):
        ours = native.NGramLM(model, vocab_path)
        theirs = jnative.NGramLM(model, vocab_path)
        assert ours.order == theirs.order
        for history in histories:
            for word in rng.choice(pool, size=8):
                assert ours.score_word(history, word) == theirs.score_word(
                    history, word
                ), (history, word)
        for word in pool + [w[:-1] for w in words[:50]] + ["", "ca", "cats"]:
            assert ours.has_word(word) == theirs.has_word(word), word
        for history in histories:
            assert ours.score_sentence(history) == theirs.score_sentence(
                history
            ), history


def test_trigram_model_uses_its_trigrams(lms):
    """The synthetic model's scores come from all three orders."""
    lm = native.NGramLM(lms["tri arpa"][0])
    assert lm.order == 3
    words, bi, tri = write_trigram_arpa(os.devnull)
    i, j, k = tri[0]
    context = f"{words[i]} {words[j]}"
    assert lm.score_word(context, words[k]) != lm.score_word(
        words[j], words[k]
    )


def test_lm_is_binary_and_binary_is_preferred(lms, tmp_path):
    arpa, _vocab, _words = lms["tiny arpa"]
    binary, _vocab, _words = lms["tiny binary"]
    assert native.lm_is_binary(binary) and not native.lm_is_binary(arpa)
    assert not native.lm_is_binary(str(tmp_path / "missing"))

    shutil.copy(arpa, tmp_path / "model.arpa")
    assert beam.find_lm_files(str(tmp_path)) == (
        str(tmp_path / "model.arpa"), None
    )
    (tmp_path / "vocabulary").write_text("the\n")
    shutil.copy(binary, tmp_path / "kenlm-model.binary")
    found = beam.find_lm_files(str(tmp_path))
    assert found == (
        str(tmp_path / "kenlm-model.binary"), str(tmp_path / "vocabulary")
    )
    assert found == jbeam.find_lm_files(str(tmp_path))
    assert beam.find_arpa_file(str(tmp_path)) == str(tmp_path / "model.arpa")
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no .binary or .arpa"):
        beam.find_lm_files(str(tmp_path / "empty"))


@pytest.mark.parametrize("keep", [0.2, 0.5, 0.9, 0.99])
def test_truncated_binary_raises(lms, tmp_path, keep):
    data = open(lms["tri binary"][0], "rb").read()
    bad = tmp_path / "cut.binary"
    bad.write_bytes(data[: int(len(data) * keep)])
    assert native.lm_is_binary(str(bad))
    with pytest.raises(ValueError, match="failed to load LM"):
        native.NGramLM(str(bad))


def test_missing_model_raises(tmp_path):
    with pytest.raises(ValueError, match="failed to load LM"):
        native.NGramLM(str(tmp_path / "missing.arpa"))


def test_library_builds_into_build_dir_and_is_reused(monkeypatch):
    path = native.build()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("libspeecht_host-")

    def no_compiler(*args, **kwargs):
        raise AssertionError("a built library was compiled again")

    monkeypatch.setattr(native.subprocess, "run", no_compiler)
    assert native.build() == path
    assert native.load() is native.load()


def test_library_exports_only_its_c_api():
    """Hidden visibility: the functions it exports are the ``stt_`` C API
    (besides the standard library's template instances), so it and the
    JAX package's library bind none of each other's code."""
    nm = shutil.which("nm")
    if nm is None:
        pytest.fail("nm (binutils) is needed to read the export table")
    out = subprocess.run(
        [nm, "-D", "--defined-only", native.build()],
        capture_output=True, text=True, check=True,
    ).stdout
    exported = [ln.split()[-1] for ln in out.splitlines() if " T " in ln]
    assert sorted(exported) == sorted(native._SIGNATURES)


def test_concurrent_builds_agree(tmp_path, monkeypatch):
    """Two builds into an empty directory at the same moment: each writes
    its own file and renames it into place, and both give one library."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    paths, errors = [], []

    def run():
        try:
            paths.append(native.build())
        except RuntimeError as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(set(paths)) == 1 and os.listdir(tmp_path) == [
        os.path.basename(paths[0])
    ]


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "src"
    bad.mkdir()
    for name in native.SOURCES + native.HEADERS:
        shutil.copy(os.path.join(native.NATIVE_DIR, name), bad / name)
    with open(bad / "beam_search.cpp", "a") as f:
        f.write("\nthis is not C++;\n")
    monkeypatch.setattr(native, "NATIVE_DIR", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="host library build failed") as e:
        native.build()
    assert "beam_search.cpp" in str(e.value) and "error" in str(e.value)
