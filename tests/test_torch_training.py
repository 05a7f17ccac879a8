"""The port's ``train`` command end to end on the CPU, and its loop.

``python -m speecht_tpu_torch train --device cpu`` at tiny widths on a
synthetic cached corpus (numpy seed): the step lines, the checkpoints, a
resume, and ``evaluate --device cpu`` restoring the port's own
checkpoint. The loop's plateau decay against the JAX loop's rule, the
deferred stop, the device histograms and their event records against the
JAX package's (byte for byte: the same wire format), ``--spec-augment``,
``--verbose-summaries`` and ``--profile-steps`` end to end, and the grid
flags refused on one process.
"""

import os
import re
import signal
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speecht_tpu.train import metrics_writer as jwriter
from speecht_tpu.train import summaries as jsummaries
from speecht_tpu_torch import training
from speecht_tpu_torch.cli import CLI
from speecht_tpu_torch.train import metrics_writer, summaries
from speecht_tpu_torch.train import state as tstate
from speecht_tpu_torch.train.checkpoint import CheckpointManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH_FLAGS = ["--base-channels", "16", "--wide-channels", "32",
               "--num-body-layers", "2"]
STEP_LINE = re.compile(
    r"^global step (\d+) learning rate ([\d.]+) step-time [\d.]+ "
    r"average loss ([\d.]+) perplexity ([\d.]+|inf)$"
)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("training")
    rng = np.random.RandomState(0)
    for split, n in (("train", 6), ("test", 4)):
        d = root / "data" / "preprocessed-power" / split
        d.mkdir(parents=True)
        for i in range(n):
            frames = rng.randint(40, 90)
            np.savez(
                d / f"utt{i}",
                audio_fragments=rng.randn(frames, 8).astype(np.float32),
                transcript=rng.randint(0, 28, size=rng.randint(3, 9)).astype(np.int64),
            )
    return root


def _argv(root, command, *extra):
    return [
        command, "--device", "cpu",
        "--data-dir", str(root / "data"),
        "--train-dir", str(root / "train"),
        "--log-dir", str(root / "log"),
        "--batch-size", "2",
        "--compute-dtype", "float32", "--transfer-dtype", "float32",
        *WIDTH_FLAGS, *extra,
    ]


def _run_module(argv):
    proc = subprocess.run(
        [sys.executable, "-m", "speecht_tpu_torch", *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    return proc.stdout


def test_train_then_resume_then_evaluate(corpus):
    run = ["--run-name", "cli"]
    out = _run_module(_argv(
        corpus, "train", *run, "--max-steps", "4", "--steps-per-checkpoint", "2",
        "--learning-rate", "1e-3",
    ))
    lines = out.splitlines()
    assert "Created model with fresh parameters." in lines
    steps = [STEP_LINE.match(ln) for ln in lines if ln.startswith("global step")]
    assert all(steps) and [int(m.group(1)) for m in steps] == [2, 4]
    assert all(0 < float(m.group(3)) < 1e29 for m in steps)
    assert lines.count("Model saved") == 2
    assert lines[-1] == "Done training -- step limit reached"
    mgr = CheckpointManager(str(corpus / "train" / "cli"))
    assert mgr.all_steps() == [2, 4]
    events = os.listdir(corpus / "log" / "cli_train")
    assert len(events) == 1 and events[0].startswith("events.out.tfevents.")

    out = _run_module(_argv(
        corpus, "train", *run, "--max-steps", "2", "--steps-per-checkpoint", "2",
    ))
    assert "Restored model at step 4" in out
    assert [int(m.group(1)) for m in map(STEP_LINE.match, out.splitlines()) if m] == [6]
    assert mgr.all_steps() == [2, 4, 6]

    out = _run_module(_argv(corpus, "evaluate", *run, "--test", "--no-save"))
    assert "Global statistics" in out
    losses = [float(ln.split()[3]) for ln in out.splitlines()
              if ln.startswith("validation average loss")]
    assert len(losses) == 2 and all(0 < x < 1e29 for x in losses)


def test_evaluate_restores_the_saved_parameters(corpus):
    """``evaluate`` without --reference-weights computes with exactly the
    checkpoint's parameters (same loss as a model loaded by hand)."""
    from speecht_tpu_torch.evaluation import Evaluation

    run = ["--run-name", "restore"]
    CLI(_argv(corpus, "train", *run, "--max-steps", "2",
              "--steps-per-checkpoint", "2")).run()
    cli = CLI(_argv(corpus, "evaluate", *run, "--test", "--no-save"))
    cli._ensure_directories()
    ev = Evaluation(cli.parsed)
    assert ev.load_weights() == 2  # the checkpoint's optimizer step
    payload = torch.load(
        str(corpus / "train" / "restore" / "ckpt-2.pt"), weights_only=True
    )
    for name, value in ev.model.state_dict().items():
        torch.testing.assert_close(value, payload["params"][name], rtol=0, atol=0)


def test_evaluate_without_checkpoint_keeps_the_jax_error(corpus):
    with pytest.raises(FileNotFoundError, match="No checkpoint for evaluation"):
        CLI(_argv(corpus, "evaluate", "--run-name", "none", "--test",
                  "--no-save")).run()


@pytest.mark.parametrize(
    "flags,named",
    [
        (["--seq-parallel", "2"], "--seq-parallel"),
        (["--data-parallel", "2"], "--data-parallel"),
        (["--model-parallel", "2"], "--model-parallel"),
    ],
)
def test_unported_train_flags_raise(corpus, flags, named):
    """``named`` asks for a grid of two ranks. These flags are ported, but
    one process is one rank, so they raise the mesh's error, as JAX's
    raises on too few devices; two ranks run them
    (tests/test_torch_parallel_train.py)."""
    with pytest.raises(ValueError, match="device count 1|exceeds 1 available devices"):
        CLI(_argv(corpus, "train", "--run-name", "x", *flags)).run()


def _event_payloads(path):
    """The payloads of a TFRecord event file (length, crc, data, crc)."""
    import struct

    data, out, at = open(path, "rb").read(), [], 0
    while at < len(data):
        (n,) = struct.unpack("<Q", data[at: at + 8])
        out.append(data[at + 12: at + 12 + n])
        at += 16 + n
    return out


def test_train_with_spec_augment_verbose_summaries_and_profile(corpus, capsys):
    """The three flags together on the CPU: the SpecAugment line, image
    and activation summaries in the event file at each checkpoint, and a
    torch.profiler trace of steps 1:3 under <log_dir>/profile with the
    program's spans (the loader's put of a batch is logged with the next
    batch, so the window takes two; the checkpoint at step 2)."""
    import json

    run = ["--run-name", "flags"]
    CLI(_argv(corpus, "train", *run, "--max-steps", "4",
              "--steps-per-checkpoint", "2", "--spec-augment",
              "--verbose-summaries", "--profile-steps", "1:3")).run()
    lines = capsys.readouterr().out.splitlines()
    assert ("SpecAugment on: 2 freq masks (width <= 15), "
            "2 time masks (width <= 0.05 x valid frames)") in lines
    assert lines.count(f"Profiler trace written to {corpus / 'log'}/profile") == 1
    steps = [STEP_LINE.match(ln) for ln in lines if ln.startswith("global step")]
    assert all(steps) and [int(m.group(1)) for m in steps] == [2, 4]
    assert all(0 < float(m.group(3)) < 1e29 for m in steps)

    (event_file,) = os.listdir(corpus / "log" / "flags_train")
    payloads = _event_payloads(corpus / "log" / "flags_train" / event_file)
    images = [p for p in payloads if b"\x89PNG" in p]
    acts = [p for p in payloads if b"activations/conv_0" in p]
    assert len(images) == 4  # filter/bias images and the logits image, twice
    assert len(acts) == 2
    # per checkpoint: one record of filter/bias images (conv_0..conv_5 at
    # 2 body layers), one of the logits image
    params_images, logits_images = images[0::2], images[1::2]
    assert all(b"conv_0/kernel" in p and b"conv_5/bias" in p for p in params_images)
    assert all(b"logits" in p for p in logits_images)

    (trace,) = os.listdir(corpus / "log" / "profile")
    assert trace == "flags_steps_1-3.pt.trace.json"
    with open(corpus / "log" / "profile" / trace) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv1d" in str(e.get("name", "")) for e in events)
    # the program's spans: the step's and the wait for its batch on the
    # loop's thread, the loader's stages on its own
    threads = {}
    for e in events:
        if str(e.get("name", "")).startswith("speecht."):
            threads.setdefault(e["name"], set()).add(e["tid"])
    loop = {"speecht.step.forward", "speecht.step.backward",
            "speecht.step.optimizer", "speecht.loader.wait",
            "speecht.train.interval", "speecht.checkpoint.save"}
    loader = {"speecht.loader.produce", "speecht.loader.build",
              "speecht.loader.h2d", "speecht.loader.put"}
    assert loop | loader <= set(threads)
    (loop_tid,) = set.union(*(threads[n] for n in loop))
    (loader_tid,) = set.union(*(threads[n] for n in loader))
    assert loop_tid != loader_tid


def test_profile_window_defaults_to_five_steps(tmp_path):
    prof = training.StepProfiler("3", str(tmp_path), "r", "cpu")
    assert (prof.start, prof.stop) == (3, 8)
    prof.before_step(2)
    assert prof._prof is None
    prof.before_step(3)
    torch.zeros(4).sum()
    prof.after_step(4)
    assert prof._prof is not None  # still inside 3:8
    prof.close()  # the loop ended early: the trace is still written
    assert os.listdir(tmp_path / "profile") == ["r_steps_3-8.pt.trace.json"]


# the port's own flags choosing the network, which the JAX package (one
# network) lacks, with their defaults: Wav2Letter, and Conformer (L)'s widths
PORT_MODEL_FLAGS = {"model": "wav2letter", "d_model": 512, "num_heads": 8,
                    "ffn_dim": 2048, "num_blocks": 17, "conv_kernel": 32,
                    "subsampling_channels": 512, "dropout": 0.1}


def _pop_port_model_flags(ours: dict) -> None:
    assert {k: ours.pop(k) for k in PORT_MODEL_FLAGS} == PORT_MODEL_FLAGS


def test_train_flags_and_defaults_match_jax():
    from speecht_tpu.cli import CLI as JaxCLI

    ours = vars(CLI(["train"]).parsed)
    theirs = vars(JaxCLI(["train"]).parsed)
    assert ours.pop("device") == "cuda"
    _pop_port_model_flags(ours)
    theirs.pop("lm", None)
    assert ours == theirs


@pytest.mark.parametrize("command", ["record", "export"])
def test_record_and_export_flags_and_defaults_match_jax(command):
    """Every flag of JAX's ``record`` and ``export`` with its default; the
    one default that differs is ``--export-platforms`` (torch devices,
    ``cuda,cpu``, against JAX's ``tpu,cpu``). The port adds ``--device``,
    the network's flags (``--model``, which both commands refuse at
    ``conformer``) and, on ``record``, ``--reference-weights`` (as on
    ``evaluate``)."""
    from speecht_tpu.cli import CLI as JaxCLI

    ours = vars(CLI([command]).parsed)
    theirs = vars(JaxCLI([command]).parsed)
    assert ours.pop("device") == "cuda"
    _pop_port_model_flags(ours)
    if command == "record":
        assert ours.pop("reference_weights") is None
        assert vars(ours.pop("lm")) == vars(theirs.pop("lm"))
    else:
        assert (ours.pop("export_platforms"), theirs.pop("export_platforms")) == (
            "cuda,cpu", "tpu,cpu")
    assert ours == theirs
    argv = {"record": ["record", "--input-size", "39", "--streaming", "--feature-rate",
                       "16000", "--audio-source", "a.flac", "b.flac", "--language-model",
                       "lm", "--beam-width", "7", "--device-beam", "--rescore", "2"],
            "export": ["export", "--weights", "w", "--input-size", "39", "--stablehlo",
                       "s", "--export-batch-size", "4", "--export-frames", "64",
                       "--export-platforms", "cpu", "--from-audio", "--wire-sr", "16000"]}
    ours = vars(CLI(argv[command]).parsed)
    theirs = vars(JaxCLI(argv[command]).parsed)
    ours.pop("device"), ours.pop("reference_weights", None)
    _pop_port_model_flags(ours)
    if command == "record":
        assert vars(ours.pop("lm")) == vars(theirs.pop("lm"))
    assert ours == theirs
    assert ours["run_type"] == ("record" if command == "record" else "other")


def _loop_harness(tmp_path, losses, stop_after=None, signals_in_step=0):
    """Runs ``Training._train_loop`` on a stub step. At call ``stop_after``
    the step asks for a stop: by the flag, or by delivering
    ``signals_in_step`` signals to the handler while it is in flight."""
    t = training.Training.__new__(training.Training)
    t.flags = SimpleNamespace(steps_per_checkpoint=1, learning_rate_decay_factor=0.5)
    t.device = torch.device("cpu")
    t._stop_requested = False
    t._in_step = False

    n_batches = len(losses)

    class Loader:
        stall_count, stall_seconds = 0, 0.0

        def __iter__(self):
            return iter([(None, None)] * n_batches)

    t.create_loader = Loader
    losses = iter(losses)
    calls = []

    def stub_step(state, acc, _batch):
        calls.append(1)
        if stop_after is not None and len(calls) == stop_after:
            if signals_in_step:
                for _ in range(signals_in_step):
                    t._request_stop(signal.SIGINT, None)
            else:
                t._stop_requested = True
        acc = {
            "loss_sum": acc["loss_sum"] + next(losses),
            "grad_norm_sum": acc["grad_norm_sum"] + 1.0,
            "count": acc["count"] + 1.0,
            "updates": acc["updates"] + 1.0,
        }
        return tstate.TrainState(
            state.params, state.opt_state, state.step + 1, state.learning_rate
        ), acc

    params = {"w": torch.zeros(4)}
    state = tstate.create_train_state(params, tstate.make_optimizer(), 1.0)
    saves = []
    ckpt = SimpleNamespace(
        save=lambda s, wait=False, step=None: saves.append(step),
        latest_step=lambda: None,
    )
    writer = metrics_writer.SummaryWriter(str(tmp_path))
    out = t._train_loop(state, stub_step, writer, ckpt)
    writer.close()
    return out, saves, calls


def test_train_loop_applies_plateau_decay(tmp_path):
    # checkpoint losses 10, 10, 10, 12 (> max of the last 3: decay), 11
    out, saves, _calls = _loop_harness(tmp_path, [10.0, 10.0, 10.0, 12.0, 11.0])
    assert float(out.learning_rate) == pytest.approx(0.5)
    assert saves == [1, 2, 3, 4, 5]  # a checkpoint per interval


def test_train_loop_stops_at_a_step_boundary(tmp_path):
    out, saves, calls = _loop_harness(tmp_path, [10.0] * 5, stop_after=2)
    assert len(calls) == 2 and int(out.step) == 2
    assert saves == [1]  # the crash-save is the caller's (Training.run)


def test_second_signal_in_a_step_waits_for_its_end(tmp_path):
    """Two signals while a step is in flight raise nothing there: the step
    ends whole (the crash-save state is its result) and the loop stops at
    the boundary. Between steps a second signal interrupts at once."""
    out, saves, calls = _loop_harness(
        tmp_path, [10.0] * 5, stop_after=3, signals_in_step=2
    )
    assert len(calls) == 3 and int(out.step) == 3
    assert saves == [1, 2]

    t = training.Training.__new__(training.Training)
    t._stop_requested, t._in_step = True, False
    with pytest.raises(KeyboardInterrupt):
        t._request_stop(signal.SIGINT, None)


def test_device_histograms_and_records_match_jax():
    rng = np.random.RandomState(0)
    params = {
        "conv_0.weight": torch.from_numpy(rng.randn(16, 8, 5).astype(np.float32)),
        "conv_0.bias": torch.zeros(16),
    }
    ours, images = summaries.make_param_summarizer()(params)
    assert images == {}  # images only with --verbose-summaries
    theirs = jax.device_get(jsummaries.make_param_summarizer()({
        "conv_0": {
            "kernel": jnp.asarray(params["conv_0.weight"].numpy().transpose(2, 1, 0)),
            "bias": jnp.zeros(16),
        }
    })[0])
    assert set(ours) == set(theirs) == {"conv_0/kernel", "conv_0/bias"}
    for tag, want in theirs.items():
        for key, value in want.items():
            # float32 on both sides; an edge that lands on 0 differs by
            # rounding alone, hence the absolute term
            np.testing.assert_allclose(
                ours[tag][key], value, rtol=1e-6, atol=1e-6, err_msg=tag + key
            )
    mine = metrics_writer._event(1.5, step=3, raw_histograms=ours)
    ref = jwriter._event(1.5, step=3, raw_histograms=ours)
    assert mine == ref
