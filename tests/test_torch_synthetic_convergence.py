"""The port's hardware-validation drills (``speecht_tpu_torch/tools/``) on
the CPU.

The tone-speech corpus and its LM against ``tools/synthetic_convergence.py``
(the same files for the same seed), the JAX tool's four gates at each
edge, the held-out rates' independence of the order evaluate reads the
rows in, and both drills end to end at narrow width on ``--device cpu``:
at 4 steps nothing converges, so each must print its gate lines and fail.
The train-features drill's crash-save and relaunch run with the stop
requested in this process (the SIGTERM of a process of its own runs on
the card, in ``chip_smoke.py`` phase 5).
"""

import importlib.util
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from speecht_tpu_torch import training
from speecht_tpu_torch.metrics import EvalStatistics
from speecht_tpu_torch.tools import synthetic_convergence as sc
from speecht_tpu_torch.tools import synthetic_corpus, train_features_check

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = dict(base_channels=16, wide_channels=32, num_body_layers=2)
GATE_LINES = ("SYNTHETIC CONVERGENCE: ", "LM FUSION IMPROVES/HOLDS WER: ",
              "DEVICE BEAM == HOST BEAM: ", "RESCORE IMPROVES/HOLDS WER: ")


@pytest.fixture(scope="module")
def jax_tool(tmp_path_factory):
    """``tools/synthetic_convergence.py``, loaded by path. It enables JAX's
    compilation cache when imported: point it at a temporary directory,
    and put the settings back afterwards."""
    import jax

    names = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_compile_time_secs",
             "jax_persistent_cache_min_entry_size_bytes")
    saved = {name: getattr(jax.config, name) for name in names}
    env = os.environ.get("SPEECHT_COMPILATION_CACHE")
    os.environ["SPEECHT_COMPILATION_CACHE"] = str(tmp_path_factory.mktemp("jax_cache"))
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_synthetic_convergence", os.path.join(ROOT, "tools", "synthetic_convergence.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        yield module
    finally:
        for name, value in saved.items():
            jax.config.update(name, value)
        if env is None:
            os.environ.pop("SPEECHT_COMPILATION_CACHE", None)
        else:
            os.environ["SPEECHT_COMPILATION_CACHE"] = env


def _files(root):
    out = {}
    for split in ("train", "test"):
        d = os.path.join(root, "data", "preprocessed-power", split)
        for name in sorted(os.listdir(d)):
            with np.load(os.path.join(d, name)) as z:
                out[f"{split}/{name}"] = {k: z[k] for k in z.files}
    return out


def test_corpus_matches_jax(tmp_path, jax_tool):
    """The same file names, transcripts and features, bit for bit: both
    sides draw in the same order and the port's features are the JAX
    package's numpy arithmetic line for line."""
    synthetic_corpus.make_corpus(str(tmp_path / "port"), 6, 3, seed=0)
    jax_tool.make_corpus(str(tmp_path / "jax"), 6, 3, seed=0)
    ours, theirs = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert list(ours) == list(theirs)
    assert len(ours) == 9 and "test/synth-100002.npz" in ours
    for name, arrays in ours.items():
        assert sorted(arrays) == ["audio_fragments", "transcript"]
        for key, value in arrays.items():
            want = theirs[name][key]
            assert value.dtype == want.dtype and value.shape == want.shape, name
            assert value.tobytes() == want.tobytes(), f"{name}: {key} differs"
    frames = [a["audio_fragments"].shape[0] for a in ours.values()]
    assert all(a["audio_fragments"].shape[1] == 128 for a in ours.values())
    assert min(frames) >= 119 and max(frames) <= 543


def test_lm_matches_jax(tmp_path, jax_tool):
    ours = synthetic_corpus.write_lm(str(tmp_path / "port"))
    theirs = jax_tool.write_lm(str(tmp_path / "jax"))
    for name in ("model.arpa", "vocabulary"):
        with open(os.path.join(ours, name), "rb") as a, \
                open(os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read(), name


# (greedy, host LM, device beam, rescore) as (LER, WER); one edit in a
# row of 20 letters (or 4 words) of 40 rows moves a rate by 1/800 (1/160)
GOOD = ((0.01, 0.05), (0.01, 0.05), (0.01, 0.05), (0.01, 0.05))


@pytest.mark.parametrize("case, rates, failing", [
    ("all equal", GOOD, None),
    ("greedy LER 0.0499", ((0.0499, 0.2),) + ((0.0499, 0.2),) * 3, None),
    ("greedy LER 0.05", ((0.05, 0.2),) + ((0.05, 0.2),) * 3, "SYNTHETIC CONVERGENCE"),
    ("LM WER equal to greedy", ((0.02, 0.1), (0.03, 0.1), (0.03, 0.1), (0.02, 0.1)), None),
    ("LM WER above greedy", ((0.02, 0.1), (0.03, 0.1 + 1 / 160), (0.03, 0.1 + 1 / 160),
                             (0.02, 0.1)), "LM FUSION IMPROVES/HOLDS WER"),
    ("device LER one edit off", (GOOD[0], GOOD[1], (0.01 + 1 / 800, 0.05), GOOD[3]),
     "DEVICE BEAM == HOST BEAM"),
    ("device WER one edit off", (GOOD[0], GOOD[1], (0.01, 0.05 + 1 / 160), GOOD[3]),
     "DEVICE BEAM == HOST BEAM"),
    ("rescore WER above greedy", (GOOD[0], GOOD[1], GOOD[2], (0.01, 0.05 + 1 / 160)),
     "RESCORE IMPROVES/HOLDS WER"),
])
def test_gates_at_each_edge(case, rates, failing):
    passed = sc.gates(*rates)
    assert list(passed) == [line[:-2] for line in GATE_LINES]
    assert [name for name, ok in passed.items() if not ok] == (
        [failing] if failing else []), case


def _rows(pairs):
    return "".join(f"expected: {e}\ndecoded: {d}\nLED: 0\n" for e, d in pairs)


def test_held_out_rates_do_not_depend_on_the_row_order():
    """``EvalStatistics`` adds the rows' rates in the order read, which
    evaluate shuffles afresh each run: the same decodes in two orders give
    global rates a bit apart, which the device-beam gate's == would take
    for a difference. The drills' rates are the same in every order."""
    pairs = [("abcdefghij", "xbcdefghij"), ("abcdefghij", "xxcdefghij"),
             ("abcdefghij", "xxxdefghij"), ("ab cd", "ab cd")]
    forward, backward = EvalStatistics(), EvalStatistics()
    for e, d in pairs:
        forward.track_decoding(d, e)
    for e, d in reversed(pairs):
        backward.track_decoding(d, e)
    assert forward.global_letter_error_rate != backward.global_letter_error_rate
    ours = sc.held_out_rates(_rows(pairs))
    assert ours == sc.held_out_rates(_rows(reversed(pairs)))
    assert ours[0] == pytest.approx(forward.global_letter_error_rate)
    assert ours[1] == pytest.approx(forward.global_word_error_rate)
    # an empty decode is a row too
    assert sc.held_out_rates(_rows([("ab cd", "")])) == (1.0, 1.0)


def test_no_card_fails_before_the_corpus(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the drill would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sc.main(8, 4, root=str(tmp_path), **WIDTHS)
    assert not os.path.exists(tmp_path / "data")


def test_synthetic_convergence_cli_exits_1_when_a_gate_fails(tmp_path):
    """``python -m speecht_tpu_torch.tools.synthetic_convergence`` end to end
    at narrow width: 4 steps converge to nothing, so the greedy gate fails
    and the process exits 1 after printing all four gate lines."""
    env = dict(os.environ, OMP_NUM_THREADS="2", TMPDIR=str(tmp_path),
               SPEECHT_DEVICE_LM_CACHE=str(tmp_path / "device_lm"))
    proc = subprocess.run(
        [sys.executable, "-m", "speecht_tpu_torch.tools.synthetic_convergence",
         "8", "4", "--n-test", "4", "--device", "cpu", "--base-channels", "16",
         "--wide-channels", "32", "--num-body-layers", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 1, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    gate_lines = [ln for ln in lines if ln.startswith(GATE_LINES)]
    assert [ln.split(": ")[0] for ln in gate_lines] == [g[:-2] for g in GATE_LINES]
    assert "SYNTHETIC CONVERGENCE: FAIL" in lines
    for path in ("held-out greedy  LER: ", "held-out beam+LM LER: ",
                 "held-out rescore8 LER: "):
        assert any(ln.startswith(path) for ln in lines), path
    assert sum(ln.startswith("expected: ") for ln in lines) == 4 * 4
    assert not any(name.startswith("synth_") for name in os.listdir(tmp_path))


def test_train_features_drill_relaunches_and_fails_its_gate(tmp_path, monkeypatch, capsys):
    """The drill with ``--grad-accum 2`` at 4 global steps, an interval of 2:
    the stop is requested once the first interval has ended, the loop
    finishes step 3 and crash-saves it; the relaunch runs ``--max-steps
    4 - 3``, restores step 3, prints its interval line at 4 and saves 4;
    the optimizer's step goes on from the saved one. The LER gate fails."""
    monkeypatch.setenv("SPEECHT_DEVICE_LM_CACHE", str(tmp_path / "device_lm"))
    end_interval = training.Training._end_interval

    def stop_after_the_interval(self, *args):
        out = end_interval(self, *args)
        self._request_stop(signal.SIGTERM, None)
        return out

    def launch(argv, interval):
        assert interval == 2 and argv[argv.index("--max-steps") + 1] == "4"
        with monkeypatch.context() as m:
            m.setattr(training.Training, "_end_interval", stop_after_the_interval)
            _state, out = sc.run_cli(argv)
        return 0, out

    result = train_features_check.main(
        8, 4, n_test=4, device="cpu", root=str(tmp_path / "drill"), interval=2,
        launch=launch, **WIDTHS)
    out = capsys.readouterr().out
    facts = result["relaunch"]
    assert facts["crash_step"] == 3
    assert all(facts["checks"].values()), facts["checks"]
    assert facts["saved_optimizer_step"] == 1 and facts["final_optimizer_step"] == 1
    assert [step for step, _loss in facts["interval_losses"]] == [2, 4]
    assert facts["restored_learning_rate"] == pytest.approx(3e-4)
    assert "--max-steps 1" in out and "Restored model at step 3" in out
    assert "gradient accumulation: 2 micro-batches per update" in out
    assert "SpecAugment on: 2 freq masks (width <= 8)" in out
    assert "CRASH-SAVE AND RELAUNCH: PASS" in out
    assert "TRAIN FEATURES CHECK: FAIL" in out
    assert result["gates"] == {"CRASH-SAVE AND RELAUNCH": True,
                               "TRAIN FEATURES CHECK": False}
    assert not result["ok"] and result["rows"] == 4


def test_crash_save_outside_the_range_fails_the_relaunch_gate():
    """A first launch that ran to its end (no stop) leaves S = steps."""
    facts = train_features_check.relaunch_facts(
        0, "global step 2 learning rate 0.0003 step-time 0.1 average loss 9.0 "
        "perplexity inf\nDone training -- step limit reached\n",
        "", 4, 4, {"step": 2, "learning_rate": 3e-4}, {"step": 2}, 4, 2)
    assert not facts["checks"]["2 < S < 4"]
    assert not facts["checks"]["first launch stopped after the interval line"]
    assert facts["checks"]["first launch exits 0"]
