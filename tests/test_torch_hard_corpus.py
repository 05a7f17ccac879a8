"""The hard corpus, its pilot and the search drill of the port on the CPU.

``speecht_tpu_torch/tools/hard_corpus.py`` against ``tools/hard_corpus.py``:
the lexicon, the sentences, the audio, the LM and the corpus's files are
the same for the same seed, bit for bit; ``n_test`` adds a test split
after dev and changes nothing before it. Then the pilot end to end on
``--device cpu`` at narrow width (3 steps in 3 segments, the last decode
with the LM and ``--device-beam``), ``hard_search_drill`` at 2
generations on the pilot's root (a process of its own, on the host beam:
its exit code and its PASS/FAIL line agree), its parsers against the JAX
tool's on the port's own ``search`` output, and its two gates at each
edge. At 3 steps nothing converges: the point is the control flow.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from speecht_tpu_torch.tools import hard_corpus, hard_search_drill

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = ["--base-channels", "16", "--wide-channels", "32", "--num-body-layers", "2"]
JAX_RECORD_KEYS = {"generations", "noise_std", "dev_utterances", "decode", "search_wall_s",
                   "seed", "best", "best_score_trajectory", "test_seed", "test_best"}


def _load(name, path):
    """A tool of ``tools/`` by path, registered under ``name`` (its
    dataclasses look their module up in ``sys.modules``)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_corpus():
    return _load("jax_hard_corpus", os.path.join(ROOT, "tools", "hard_corpus.py"))


@pytest.fixture(scope="module")
def jax_drill(tmp_path_factory):
    """``tools/hard_search_drill.py``, which enables JAX's compilation cache
    when imported: pointed at a temporary directory, the settings put back
    afterwards."""
    import jax

    names = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
             "jax_persistent_cache_min_entry_size_bytes")
    saved = {name: getattr(jax.config, name) for name in names}
    env = os.environ.get("SPEECHT_COMPILATION_CACHE")
    os.environ["SPEECHT_COMPILATION_CACHE"] = str(tmp_path_factory.mktemp("jax_cache"))
    try:
        yield _load("jax_hard_search_drill", os.path.join(ROOT, "tools", "hard_search_drill.py"))
    finally:
        for name, value in saved.items():
            jax.config.update(name, value)
        if env is None:
            os.environ.pop("SPEECHT_COMPILATION_CACHE", None)
        else:
            os.environ["SPEECHT_COMPILATION_CACHE"] = env


def test_lexicon_matches_jax(jax_corpus):
    ours, theirs = hard_corpus.build_lexicon(), jax_corpus.build_lexicon()
    assert ours.words == theirs.words and ours.probs == theirs.probs
    assert ours.pair_words == theirs.pair_words and ours.loner_words == theirs.loner_words
    assert len(ours.pair_words) == 28 and len(ours.loner_words) == 16


def test_sentences_and_audio_match_jax(jax_corpus):
    lex = hard_corpus.build_lexicon()
    for seed in range(3):
        a, b = np.random.RandomState(seed), np.random.RandomState(seed)
        sentence = hard_corpus.sample_sentence_hard(a, lex, 3.0)
        assert sentence == jax_corpus.sample_sentence_hard(b, jax_corpus.build_lexicon(), 3.0)
        hp = hard_corpus.HardParams(swap_prob=0.3)
        audio, swapped = hard_corpus.synth_utterance_hard(sentence, a, hp, return_truth=True)
        want, want_swapped = jax_corpus.synth_utterance_hard(
            sentence, b, jax_corpus.HardParams(swap_prob=0.3), return_truth=True)
        assert audio.dtype == want.dtype and audio.tobytes() == want.tobytes(), seed
        assert swapped == want_swapped
        assert a.randint(1 << 30) == b.randint(1 << 30)  # the same draws consumed


def test_lm_matches_jax(tmp_path, jax_corpus):
    ours = hard_corpus.write_lm_hard(str(tmp_path / "port"), hard_corpus.build_lexicon())
    theirs = jax_corpus.write_lm_hard(str(tmp_path / "jax"), jax_corpus.build_lexicon())
    for name in ("model.arpa", "vocabulary"):
        with open(os.path.join(ours, name), "rb") as a, open(os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read(), name


def _files(root):
    out = {}
    base = os.path.join(root, "data", "preprocessed-power")
    for split in sorted(os.listdir(base)):
        for name in sorted(os.listdir(os.path.join(base, split))):
            with np.load(os.path.join(base, split, name)) as z:
                out[f"{split}/{name}"] = {k: z[k] for k in z.files}
    return out


def _assert_files_equal(ours, theirs):
    assert list(ours) == list(theirs)
    for name, arrays in ours.items():
        assert sorted(arrays) == ["audio_fragments", "transcript"]
        for key, value in arrays.items():
            want = theirs[name][key]
            assert value.dtype == want.dtype and value.shape == want.shape, name
            assert value.tobytes() == want.tobytes(), f"{name}: {key} differs"


def test_corpus_matches_jax_and_the_test_split_follows_dev(tmp_path, jax_corpus):
    ours = hard_corpus.make_corpus_hard(str(tmp_path / "port"), 5, 3, hard_corpus.HardParams())
    theirs = jax_corpus.make_corpus_hard(str(tmp_path / "jax"), 5, 3, jax_corpus.HardParams())
    assert ours == theirs
    files = _files(tmp_path / "port")
    _assert_files_equal(files, _files(tmp_path / "jax"))
    assert "dev/hard-1000002.npz" in files and len(files) == 8
    assert all(a["audio_fragments"].shape[1] == 128 for a in files.values())

    hard_corpus.make_corpus_hard(str(tmp_path / "test"), 5, 3, hard_corpus.HardParams(),
                                 n_test=3)
    with_test = _files(tmp_path / "test")
    assert [n for n in with_test if n.startswith("test/")] == [
        "test/hard-2000000.npz", "test/hard-2000001.npz", "test/hard-2000002.npz"]
    _assert_files_equal({n: a for n, a in with_test.items() if not n.startswith("test/")},
                        files)
    for name in ("model.arpa", "vocabulary"):
        with open(tmp_path / "test" / "lm" / name, "rb") as a, \
                open(tmp_path / "port" / "lm" / name, "rb") as b:
            assert a.read() == b.read()


@pytest.fixture(scope="module")
def pilot_run(tmp_path_factory):
    """The pilot at narrow width on the CPU: 8 train, 4 dev and 4 test rows,
    3 steps in 3 segments; returns (root, exit code, result, output). On
    two torch threads, as the drill's process: the suite's workers share
    the machine's cores, and a thread a core in each worker oversubscribes
    them (the fixture took minutes in the whole suite, seconds alone)."""
    import contextlib
    import io

    import torch

    root = str(tmp_path_factory.mktemp("pilot"))
    args = hard_corpus.parse_args([
        "pilot", "--n-train", "8", "--n-dev", "4", "--n-test", "4", "--steps", "3",
        "--device", "cpu", "--keep", root, *WIDTHS])
    buf = io.StringIO()
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
            mp.setenv("SPEECHT_DEVICE_LM_CACHE", os.path.join(root, "device_lm"))
            code, result = hard_corpus.pilot(args)
    finally:
        torch.set_num_threads(threads)
    return root, code, result, buf.getvalue()


def test_pilot_end_to_end_on_cpu(pilot_run):
    root, code, result, out = pilot_run
    assert code == 0
    lines = out.splitlines()
    assert [ln.split(" (")[0] for ln in lines if ln.startswith("=== after segment")] == [
        "=== after segment 1/3", "=== after segment 2/3", "=== after segment 3/3"]
    assert [s["global_step"] for s in result["segments"]] == [1, 2, 3]
    for s in result["segments"]:  # the restores carry the learning rate
        assert s["learning_rate"] == pytest.approx(3e-4)
        assert s["interval_losses"] and s["dev"]["rows"] == 4
    for prefix in ("PILOT greedy : ['precise: LER ", "PILOT beam+LM: ['precise: LER ",
                   "PILOT greedy  held-out rates: LER ", "PILOT beam+LM held-out rates: LER "):
        assert any(ln.startswith(prefix) for ln in lines), prefix
    assert "gradient accumulation: 2 micro-batches per update" in out
    assert "SpecAugment on:" in out
    for key in ("greedy", "beam_lm"):
        assert result[key]["rows"] == 4 and 0 <= result[key]["wer"] <= 1
    assert result["corpus"]["lexicon_pairs"] == 28
    assert sorted(os.listdir(os.path.join(root, "data", "preprocessed-power"))) == [
        "dev", "test", "train"]


def _drill(root, *extra):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", "speecht_tpu_torch.tools.hard_search_drill", "--root", root,
         "--generations", "2", "--device", "cpu", *WIDTHS, *extra],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_search_drill_on_the_pilot_root(pilot_run, jax_drill):
    root = pilot_run[0]
    proc = _drill(root)
    out = proc.stdout
    lines = out.splitlines()
    failed = "FAIL hard-corpus search drill" in lines
    passed = any(ln.startswith("PASS hard-corpus search drill") for ln in lines)
    assert failed != passed, out[-3000:] + proc.stderr[-3000:]
    assert proc.returncode == (1 if failed else 0)
    assert any(ln.startswith("dev:  seed ") for ln in lines)
    assert any(ln.startswith("test: seed LER+WER ") for ln in lines)
    with open(os.path.join(root, "search_drill.json")) as f:
        record = json.load(f)
    assert set(record) == JAX_RECORD_KEYS
    assert record["decode"] == "host-beam" and record["dev_utterances"] == 128
    assert len(record["best_score_trajectory"]) == 3
    assert (record["seed"]["lm_weight"], record["seed"]["word_count_weight"],
            record["seed"]["valid_word_count_weight"]) == (1.0, 0.0, 0.0)

    # the parsers against the JAX tool's on this output
    ours = hard_search_drill.parse_candidates(out)
    assert len(ours) == 3 and ours == jax_drill.parse_candidates(out)
    coarse = "\n".join(ln for ln in lines if not ln.startswith("candidate-precise"))
    assert hard_search_drill.parse_candidates(coarse) == jax_drill.parse_candidates(coarse)
    assert [c["score"] for c in hard_search_drill.parse_candidates(coarse)] == [
        round(c["score"], 2) for c in ours]
    # the held-out rates against the JAX tool's reading of the CLI's line
    # (4 decimals): the test evaluate of the best candidate is the last
    from speecht_tpu_torch.tools import synthetic_convergence as sc

    last_eval = out[out.rindex("== held-out test evaluate: found weights =="):]
    ler, wer = sc.held_out_rates(last_eval)
    jax_ler, jax_wer = jax_drill.last_global_stats(last_eval)
    assert abs(ler - jax_ler) <= 5e-5 and abs(wer - jax_wer) <= 5e-5
    assert record["test_best"] == {"ler": ler, "wer": wer}


@pytest.mark.parametrize("case, args, want", [
    ("best above the seed on both", (-0.5, -0.4, (0.2, 0.3), (0.2, 0.29)), (True, True)),
    ("dev equal", (-0.5, -0.5, (0.2, 0.3), (0.1, 0.3)), (False, True)),
    ("dev one step up", (-0.5, -0.4999, (0.2, 0.3), (0.2, 0.3)), (True, False)),
    ("test equal", (-0.5, -0.4, (0.2, 0.3), (0.3, 0.2)), (True, False)),
    ("test below by 1e-9", (-0.5, -0.4, (0.2, 0.3), (0.2, 0.3 - 1e-9)), (True, True)),
    ("both worse", (-0.5, -0.6, (0.2, 0.3), (0.2, 0.31)), (False, False)),
])
def test_gates_at_each_edge(case, args, want):
    passed = hard_search_drill.gates(*args)
    assert list(passed) == ["dev improved", "test improved"]
    assert tuple(passed.values()) == want, case


def test_best_so_far_keeps_the_first_of_equal_scores():
    cands = [{"score": s, "lm_weight": w} for s, w in
             ((-0.5, 1.0), (-0.6, 2.0), (-0.4, 3.0), (-0.4, 4.0), (-0.45, 5.0))]
    best, trajectory = hard_search_drill.best_so_far(cands)
    assert best["lm_weight"] == 3.0
    assert trajectory == [-0.5, -0.5, -0.4, -0.4, -0.4]
