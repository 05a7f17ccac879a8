"""Whole runs of a tiny cell on the CPU: cells, mixes, configurations and
metrics found by name as files; the modules a run loads; and the faults
the comparison has to catch."""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest

from conftest import REPO, TINY_CONFIG, TINY_TRAFFIC, add_tiny_cell, copy_harness, write_json

# top-level modules no run may load: JAX, the package the port was ported
# from, and the repository's JAX-era measurement scripts
NOT_LOADED = {"jax", "jaxlib", "flax", "speecht_tpu", "bench", "chip_smoke", "tools"}

WRAPPER = """
import json, sys
from gpubench import run
code = run.main(sys.argv[1:], device="cpu")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
sys.exit(code)
"""


def run_copy(root: str, *argv: str):
    """A run of the copy at ``root`` in a process of its own; returns (exit
    code, result line, top-level modules loaded, stdout, stderr)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, REPO]), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", WRAPPER, *argv], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-2]) if proc.returncode == 0 else None
    modules = set(json.loads(lines[-1])) if lines else set()
    return proc.returncode, result, modules, proc.stdout, proc.stderr


def test_new_cell_mix_config_and_metric_are_found_by_name(tmp_path):
    root = str(tmp_path)
    package = copy_harness(root)
    add_tiny_cell(root, package, name="throwaway_cell")
    with open(os.path.join(package, "metrics", "throwaway_steps.py"), "w") as f:
        f.write("def read(ctx):\n    return float(len(ctx.result.steps))\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["end_to_end"].append({"name": "throwaway_steps", "unit": "steps", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["throwaway_cell"]})
    write_json(os.path.join(root, "BENCHMARK.json"), bench)
    before = {p: open(os.path.join(REPO, "gpubench", p), "rb").read()
              for p in ("run.py", "manifest.py", "kinds/train.py", "corpus.py")}

    code, result, modules, out, err = run_copy(
        root, "--workload", "throwaway_cell", "--seed", str(2**31 + 5), "--seconds", "1",
        "--trace", "0")
    assert code == 0, err[-3000:]
    assert result["correct"] is True, out[-3000:]
    metrics = result["metrics"]
    assert set(metrics) == {"train_audio_s_per_s", "train_step_ms_p95", "setup_s",
                            "throwaway_steps"}
    assert metrics["throwaway_steps"]["value"] == result["attempted"] > 0
    assert list(result)[-1] == "checks"
    assert not modules & NOT_LOADED
    for p, data in before.items():
        assert open(os.path.join(package, p), "rb").read() == data


def test_traced_run_and_the_modules_it_loads(tiny_root):
    root = os.path.dirname(tiny_root)
    code, result, modules, out, err = run_copy(
        root, "--workload", "tiny_cell", "--seed", "77", "--seconds", "1", "--trace", "1")
    assert code == 0, err[-3000:]
    assert result["correct"] is True
    assert {"input_wait_share.train", "train_mfu"} <= set(result["metrics"])
    assert "breakdown" in result and result["device"]["window_s"] > 0
    assert not modules & NOT_LOADED
    assert "speecht_tpu_torch" in modules


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import gpubench.reference.wav2letter, gpubench.check, "
            "gpubench.yardstick, gpubench.corpus; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & (NOT_LOADED | {"speecht_tpu_torch"})


def test_no_card_no_result(tmp_path):
    """Without a card the run exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload",
                           "train_mfcc39_libri", "--seed", "1", "--seconds", "1"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"correct"' not in proc.stdout


def test_only_the_benchmark_in_the_directory_fails(tmp_path):
    copy_harness(str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload",
                           "train_mfcc39_libri", "--seed", "1", "--seconds", "1"],
                          cwd=str(tmp_path), env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and '"correct"' not in proc.stdout


def unchanged_state(real):
    """A train step that computes the loss and returns its state as it was."""
    def make(model, tx, accum_steps=1, augment_fn=None, mesh=None, loss_fn=None):
        import torch
        from speecht_tpu_torch.train import step as tstep

        loss = tstep.make_loss_fn(model, mesh)

        def step(state, acc, batch):
            with torch.no_grad():
                value, _ = loss(batch)
            return state, tstep._fold_metrics(acc, value, torch.zeros(()), 1.0)

        return step
    return make


def half_batch(real):
    """The real step on the first half of each batch: the mean over the rest."""
    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def half(state, acc, batch):
            h = batch.features.shape[0] // 2
            cut = dataclasses.replace(batch, **{f.name: getattr(batch, f.name)[:h]
                                                for f in dataclasses.fields(batch)})
            return step(state, acc, cut)

        return half
    return make


@pytest.mark.parametrize("fault", [unchanged_state, half_batch])
def test_a_broken_step_is_not_correct(fault, tiny_root, monkeypatch, capsys):
    from speecht_tpu_torch.train import step as tstep

    from gpubench import run

    monkeypatch.setattr(tstep, "make_train_step_acc", fault(tstep.make_train_step_acc))
    code = run.main(["--workload", "tiny_cell", "--seed", "31", "--seconds", "0.5"],
                    device="cpu", package_dir=tiny_root)
    out, err = capsys.readouterr()
    result = json.loads(out.strip().splitlines()[-1])
    assert code == 0
    assert result["correct"] is False, result["checks"]
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
    assert "limit" in err.strip().splitlines()[-1]


def test_a_sound_step_is_correct(tiny_root, capsys):
    from gpubench import run

    assert run.main(["--workload", "tiny_cell", "--seed", "31", "--seconds", "0.5"],
                    device="cpu", package_dir=tiny_root) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


def test_tiny_cell_files_are_what_the_copy_holds(tiny_root):
    with open(os.path.join(tiny_root, "configs", "tiny_w2l.json")) as f:
        assert json.load(f) == TINY_CONFIG
    with open(os.path.join(tiny_root, "traffic", "tiny_mix.json")) as f:
        assert json.load(f) == TINY_TRAFFIC


# a second architecture as files alone: the Wav2Letter reference under
# another name, a step's operations counted its own way (the card's peak
# over 100 a step, so that ``train_mfu`` reads steps per second of the
# window), no count of the padded convolutions
TINY_ALT = '''"""A test's second architecture."""

from gpubench import yardstick
from gpubench.reference.wav2letter import (logit_frames, logit_lengths,  # noqa: F401
                                           make_weights, program_flags, train_steps)


def train_flops_valid(config, seq_lengths):
    return yardstick.PEAK_BF16_FLOPS / 100.0
'''


def snapshot(root: str) -> dict:
    files = {}
    for folder, _dirs, names in os.walk(root):
        for name in names:
            path = os.path.join(folder, name)
            with open(path, "rb") as f:
                files[path] = f.read()
    return files


def test_a_second_architecture_comes_in_as_files(tmp_path):
    root = str(tmp_path)
    package = copy_harness(root)
    with open(os.path.join(package, "reference", "tiny_alt.py"), "w") as f:
        f.write(TINY_ALT)
    add_tiny_cell(root, package, name="alt_cell", config="tiny_alt",
                  config_data=dict(TINY_CONFIG, model="tiny_alt"))
    before = snapshot(root)

    for trace in ("0", "1"):
        code, result, modules, out, err = run_copy(
            root, "--workload", "alt_cell", "--seed", str(2**31 + 9), "--seconds", "1",
            "--trace", trace)
        assert code == 0, err[-3000:]
        assert result["correct"] is True, out[-3000:]
        assert not modules & NOT_LOADED
        metrics = result["metrics"]
        if trace == "0":
            assert {"train_audio_s_per_s", "train_step_ms_p95", "setup_s"} <= set(metrics)
            continue
        window = re.search(r"^window: (\d+) steps in ([0-9.]+) s", out, re.M)
        assert int(window.group(1)) == result["attempted"] > 0
        steps_per_s = result["attempted"] / float(window.group(2))
        assert metrics["train_mfu"]["value"] == pytest.approx(steps_per_s, rel=2e-3)
        assert "conv_roofline.train" not in metrics
        assert "Traceback" not in err
    after = snapshot(root)
    assert {p: after.get(p) for p in before} == before


def test_a_model_with_no_reference_fails_before_set_up(tmp_path, monkeypatch):
    from gpubench import corpus, run

    root = str(tmp_path)
    package = copy_harness(root)
    add_tiny_cell(root, package, name="lost_cell", config="tiny_lost",
                  config_data=dict(TINY_CONFIG, model="no_such_model"))

    def no_corpus(*args, **kwargs):
        raise AssertionError("set-up began")

    monkeypatch.setattr(corpus, "draw", no_corpus)
    with pytest.raises(ValueError, match="tiny_lost: model 'no_such_model'"):
        run.main(["--workload", "lost_cell", "--seed", "3", "--seconds", "0.5"],
                  device="cpu", package_dir=package)


def test_readers_take_their_counts_from_the_architecture(monkeypatch):
    """``conv_roofline.train`` reads nothing, and ``ctc_roofline.train``
    the module's own lengths, for an architecture without a padded count."""
    from gpubench import manifest
    from gpubench.kinds.train import Step
    from gpubench.reference import wav2letter

    alt = types.ModuleType("gpubench.reference.tiny_alt")
    for name in manifest.ARCHITECTURE:
        setattr(alt, name, getattr(wav2letter, name))
    alt.logit_lengths = lambda config, seq_lengths: seq_lengths // 4
    alt.logit_frames = lambda config, frames: -(-frames // 4)
    monkeypatch.setitem(sys.modules, "gpubench.reference.tiny_alt", alt)

    trace = types.SimpleNamespace(op_device_s=lambda ops: 1.0, kernel_s=lambda names: 1.0)
    steps = [Step(256, 8, np.array([256, 200]), np.array([8, 5]))]
    bench = manifest.Manifest.load()
    read = {}
    for model in ("wav2letter", "tiny_alt"):
        ctx = types.SimpleNamespace(config=dict(TINY_CONFIG, model=model),
                                    result=types.SimpleNamespace(trace=trace, steps=steps))
        read[model] = {m: bench.reader(m)(ctx) for m in ("conv_roofline.train",
                                                        "ctc_roofline.train")}
    assert read["wav2letter"]["conv_roofline.train"] > 0
    assert read["tiny_alt"]["conv_roofline.train"] is None
    assert 0 < read["tiny_alt"]["ctc_roofline.train"] < read["wav2letter"]["ctc_roofline.train"]
