"""The slice as a whole: the port's ``evaluate`` against the JAX one.

One synthetic npz corpus whose utterances all fit in one batch (so the
reader's shuffle cannot change the padding), one set of random weights in
the reference's export layout, and both CLIs in this process: the JAX
``evaluate`` and ``python -m speecht_tpu_torch evaluate --device cpu``,
float32 compute and transfer on both sides. The sorted expected/decoded
pairs and the ``Global statistics`` and ``precise:`` lines must be equal,
and the loss must agree to its printed 2 decimals (within 0.01: the
reader shuffles each run anew, so the batch's rows are summed in another
order, and a loss near 190 can straddle a rounding boundary). The same
holds for ``evaluate --language-model`` with ``test_beam.py``'s ARPA LM
and a vocabulary file (beam width 8), on the host beam and with
``--device-beam`` (fused, and ``--rescore 4``); a ``--device-lm-hbm-gb``
the LM does not fit prints JAX's message and decodes on the host beam.
"""

import os

import numpy as np
import pytest
import torch

from speecht_tpu.cli import CLI as JaxCLI
from test_beam import ARPA
from speecht_tpu_torch.cli import CLI
from speecht_tpu_torch.models.wav2letter import Wav2Letter, Wav2LetterConfig
from speecht_tpu_torch.ops import beam_device
from speecht_tpu_torch.weights import params_to_jax

WIDTH_FLAGS = ["--base-channels", "16", "--wide-channels", "32"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("evaluate")
    rng = np.random.RandomState(0)
    d = root / "data" / "preprocessed-power" / "test"
    d.mkdir(parents=True)
    for i in range(7):
        frames = rng.randint(60, 240)
        letters = rng.randint(8, 30)
        if i == 3:  # CTC-infeasible: more letters than logit frames
            frames, letters = 40, 30
        np.savez(
            d / f"utt{i}",
            audio_fragments=rng.randn(frames, 128).astype(np.float32),
            transcript=rng.randint(0, 28, size=letters).astype(np.int64),
        )
    model = Wav2Letter(
        Wav2LetterConfig(base_channels=16, wide_channels=32),
        generator=torch.Generator().manual_seed(0),
    )
    weights = root / "weights"
    for layer, leaves in params_to_jax(model.state_dict()).items():
        layer_dir = weights / layer.replace("conv_", "convolution_layer_")
        layer_dir.mkdir(parents=True)
        np.save(layer_dir / "filters:0.npy", leaves["kernel"])
        # non-zero biases, so their placement counts too
        np.save(layer_dir / "bias:0.npy", rng.randn(*leaves["bias"].shape) * 0.1)
    return root


def _argv(workdir, *extra):
    return [
        "evaluate", "--test", "--no-save",
        "--data-dir", str(workdir / "data"),
        "--train-dir", str(workdir / "train"),
        "--log-dir", str(workdir / "log"),
        "--batch-size", "8",
        "--reference-weights", str(workdir / "weights"),
        "--compute-dtype", "float32",
        "--transfer-dtype", "float32",
        *WIDTH_FLAGS,
        *extra,
    ]


def _parse(out):
    lines = out.splitlines()
    pairs = sorted(
        (lines[i][len("expected: "):], lines[i + 1][len("decoded: "):])
        for i, line in enumerate(lines)
        if line.startswith("expected: ")
    )
    loss = [
        float(ln.split()[3])
        for ln in lines
        if ln.startswith("validation average loss")
    ]
    tail = lines[lines.index("Global statistics"):]
    return pairs, loss, tail


def test_evaluate_matches_jax(workdir, capsys):
    jax_stats = JaxCLI(_argv(workdir)).run()
    jax_out = capsys.readouterr().out
    stats = CLI(_argv(workdir, "--device", "cpu")).run()
    out = capsys.readouterr().out

    pairs, loss, tail = _parse(out)
    jax_pairs, jax_loss, jax_tail = _parse(jax_out)
    assert len(pairs) == 7 and stats.decodings_counter == 7
    assert pairs == jax_pairs
    assert len(loss) == len(jax_loss) == 1
    assert abs(loss[0] - jax_loss[0]) <= 0.01
    assert tail == jax_tail
    assert stats.global_letter_error_rate == pytest.approx(
        jax_stats.global_letter_error_rate
    )


def test_evaluate_language_model_matches_jax(workdir, capsys):
    lm_dir = workdir / "lm"
    lm_dir.mkdir(exist_ok=True)
    (lm_dir / "model.arpa").write_text(ARPA)
    (lm_dir / "vocabulary").write_text("the\ncat\ndog\nsat\n")
    lm_flags = ["--language-model", str(lm_dir), "--beam-width", "8"]
    jax_stats = JaxCLI(_argv(workdir, *lm_flags)).run()
    jax_out = capsys.readouterr().out
    stats = CLI(_argv(workdir, "--device", "cpu", *lm_flags)).run()
    out = capsys.readouterr().out

    pairs, loss, tail = _parse(out)
    jax_pairs, jax_loss, jax_tail = _parse(jax_out)
    assert len(pairs) == 7 and stats.decodings_counter == 7
    assert pairs == jax_pairs
    assert len(loss) == len(jax_loss) == 1
    assert abs(loss[0] - jax_loss[0]) <= 0.01
    assert tail == jax_tail
    assert stats.global_letter_error_rate == pytest.approx(
        jax_stats.global_letter_error_rate
    )
    greedy = CLI(_argv(workdir, "--device", "cpu")).run()
    capsys.readouterr()
    assert stats.global_letter_error_rate != greedy.global_letter_error_rate


@pytest.mark.parametrize("rescore", [[], ["--rescore", "4"]], ids=["fused", "rescore"])
def test_evaluate_device_beam_matches_jax(workdir, capsys, tmp_path, monkeypatch, rescore):
    """``evaluate --device-beam`` (and ``--rescore 4``) on the CPU prints
    the JAX CLI's decode lines, loss within 0.01."""
    monkeypatch.setenv("SPEECHT_DEVICE_LM_CACHE", str(tmp_path))
    lm_dir = workdir / "lm"
    lm_dir.mkdir(exist_ok=True)
    (lm_dir / "model.arpa").write_text(ARPA)
    (lm_dir / "vocabulary").write_text("the\ncat\ndog\nsat\n")
    lm_flags = ["--language-model", str(lm_dir), "--beam-width", "8",
                "--device-beam", *rescore]
    jax_stats = JaxCLI(_argv(workdir, *lm_flags)).run()
    jax_out = capsys.readouterr().out
    stats = CLI(_argv(workdir, "--device", "cpu", *lm_flags)).run()
    out = capsys.readouterr().out

    pairs, loss, tail = _parse(out)
    jax_pairs, jax_loss, jax_tail = _parse(jax_out)
    assert len(pairs) == 7 and stats.decodings_counter == 7
    assert pairs == jax_pairs
    assert len(loss) == len(jax_loss) == 1
    assert abs(loss[0] - jax_loss[0]) <= 0.01
    assert tail == jax_tail
    assert stats.global_letter_error_rate == pytest.approx(
        jax_stats.global_letter_error_rate
    )


def test_device_lm_budget_falls_back_to_the_host_beam(workdir, capsys, tmp_path,
                                                     monkeypatch):
    """``--device-lm-hbm-gb`` too small: JAX's message, then the host beam."""
    monkeypatch.setenv("SPEECHT_DEVICE_LM_CACHE", str(tmp_path))
    lm_dir = workdir / "lm"
    lm_dir.mkdir(exist_ok=True)
    (lm_dir / "model.arpa").write_text(ARPA)
    (lm_dir / "vocabulary").write_text("the\ncat\ndog\nsat\n")
    flags = ["--language-model", str(lm_dir), "--beam-width", "8"]
    host = CLI(_argv(workdir, "--device", "cpu", *flags)).run()
    host_pairs = _parse(capsys.readouterr().out)[0]
    # below the estimate from the file's size, then between it and the
    # tables' exact size (the check before the copy to the device)
    estimate = 1.2 * os.path.getsize(lm_dir / "model.arpa")
    exact = beam_device.DeviceLM(
        str(lm_dir / "model.arpa"), str(lm_dir / "vocabulary")
    ).hbm_bytes()
    assert estimate < exact
    for budget in (estimate / 2, (estimate + exact) / 2):
        stats = CLI(_argv(workdir, "--device", "cpu", *flags, "--device-beam",
                          "--device-lm-hbm-gb", repr(budget / (1 << 30)))).run()
        out = capsys.readouterr().out
        assert "falling back to the host beam (use --rescore N for a " \
            "device-accelerated path with large LMs)" in out
        assert _parse(out)[0] == host_pairs
        assert stats.global_letter_error_rate == pytest.approx(
            host.global_letter_error_rate
        )


def test_device_beam_past_the_kernel_width_falls_back(workdir, capsys, tmp_path,
                                                     monkeypatch):
    """``--device-beam --beam-width 1025``: the message before the first
    batch, then the host beam's decode of the whole split (the width used to
    raise at the first batch)."""
    monkeypatch.setenv("SPEECHT_DEVICE_LM_CACHE", str(tmp_path))
    lm_dir = workdir / "lm"
    lm_dir.mkdir(exist_ok=True)
    (lm_dir / "model.arpa").write_text(ARPA)
    (lm_dir / "vocabulary").write_text("the\ncat\ndog\nsat\n")
    flags = ["--device", "cpu", "--language-model", str(lm_dir), "--beam-width", "1025"]
    host = CLI(_argv(workdir, *flags)).run()
    host_pairs = _parse(capsys.readouterr().out)[0]
    stats = CLI(_argv(workdir, *flags, "--device-beam")).run()
    out = capsys.readouterr().out
    message = out.index("beam width 1025 is more than the kernel's 1024; "
                        "falling back to the host beam")
    assert message < out.index("Begin evaluation")
    assert _parse(out)[0] == host_pairs
    assert stats.decodings_counter == 7
    assert stats.global_letter_error_rate == pytest.approx(
        host.global_letter_error_rate
    )


def test_evaluate_writes_eval_loss_summary(workdir, capsys):
    argv = [a for a in _argv(workdir, "--device", "cpu") if a != "--no-save"]
    CLI(argv + ["--run-name", "summary"]).run()
    capsys.readouterr()
    log_dir = workdir / "log" / "summary_test"
    (event_file,) = os.listdir(log_dir)
    assert b"eval_loss" in (log_dir / event_file).read_bytes()


def test_default_device_without_gpu_raises(workdir):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLI(_argv(workdir)).run()


def test_missing_weights_is_fatal(workdir):
    argv = _argv(workdir, "--device", "cpu")
    i = argv.index("--reference-weights")
    del argv[i:i + 2]
    with pytest.raises(FileNotFoundError, match="No checkpoint for evaluation"):
        CLI(argv).run()


@pytest.mark.parametrize(
    "flags",
    [
        ["--language-model", "lm", "--device-beam", "--data-parallel", "2"],
        ["--from-audio", "--data-parallel", "2"],
        ["--seq-parallel", "2"],
        ["--data-parallel", "2"],
        ["--model-parallel", "2"],
    ],
)
def test_unported_paths_raise(workdir, flags):
    """Every grid flag is ported, with the LM beam and the audio front end
    too, but one process is one rank, so alone they raise the mesh's
    error, as JAX's mesh does on one device
    (tests/test_torch_parallel_train.py and test_torch_parallel_decode.py
    run two ranks). The name is older than the port of the LM and audio
    paths on several ranks."""
    with pytest.raises(ValueError, match="device count 1|exceeds 1 available devices"):
        CLI(_argv(workdir, "--device", "cpu", *flags)).run()
