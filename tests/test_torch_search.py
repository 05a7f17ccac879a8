"""``search`` of the port against the JAX package's.

A synthetic dev split whose utterances all fit in one batch (so the
readers' private shuffles cannot change what is decoded), one set of
random weights saved as each package's own checkpoint (the JAX package's
orbax state with the port's parameters through ``weights.params_to_jax``,
and the port's ``ckpt-0.pt``), ``test_beam.py``'s ARPA LM, and both CLIs
in this process with float32 compute and transfer. ``random`` and
``np.random`` are seeded alike before each side's run, so the candidates
drawn and mutated line up: the ``candidate-precise:`` lines must be
equal, on the host beam and with ``--device-beam``. The search's flags and defaults are JAX's, and its ``run_type``
is ``"other"``.
"""

import dataclasses
import random

import jax
import numpy as np
import pytest
import torch

from speecht_tpu import execution as jexecution
from speecht_tpu.cli import CLI as JaxCLI
from speecht_tpu.train import checkpoint as jcheckpoint
from speecht_tpu_torch.cli import CLI
from speecht_tpu_torch.models.wav2letter import Wav2Letter, Wav2LetterConfig
from speecht_tpu_torch.parameter_search import Candidate
from speecht_tpu_torch.train.checkpoint import CheckpointManager
from speecht_tpu_torch.train.state import create_train_state, make_optimizer
from speecht_tpu_torch.weights import params_to_jax
from test_beam import ARPA
from test_torch_training import _pop_port_model_flags

WIDTH_FLAGS = ["--base-channels", "16", "--wide-channels", "32"]
# wide mutations, so that some candidates decode otherwise than others
SEARCH_FLAGS = ["--generations", "3", "--noise-std", "4"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("search")
    rng = np.random.RandomState(3)
    d = root / "data" / "preprocessed-power" / "dev"
    d.mkdir(parents=True)
    for i in range(6):
        np.savez(
            d / f"utt{i}",
            audio_fragments=rng.randn(rng.randint(60, 200), 128).astype(np.float32),
            transcript=rng.randint(0, 28, size=rng.randint(8, 25)).astype(np.int64),
        )
    lm = root / "lm"
    lm.mkdir()
    (lm / "model.arpa").write_text(ARPA)
    (lm / "vocabulary").write_text("the\ncat\ndog\nsat\n")

    model = Wav2Letter(
        Wav2LetterConfig(base_channels=16, wide_channels=32),
        generator=torch.Generator().manual_seed(0),
    )
    CheckpointManager(str(root / "train" / "torch")).save(
        create_train_state(dict(model.named_parameters()), make_optimizer(), 1e-4),
        step=0,
    )
    flags = JaxCLI(_argv(root, "jax")).parsed
    jstate, _tx = jexecution.init_state(jexecution.build_model(128, flags), flags)
    jstate = jstate.replace(params=jax.tree_util.tree_map(
        jax.numpy.asarray, params_to_jax(model.state_dict())
    ))
    mgr = jcheckpoint.CheckpointManager(str(root / "train" / "jax"))
    mgr.save(jstate, wait=True, step=0)
    mgr.close()
    return root


def _argv(root, run_name, *extra):
    return [
        "search",
        "--data-dir", str(root / "data"),
        "--train-dir", str(root / "train"),
        "--log-dir", str(root / "log"),
        "--run-name", run_name,
        "--batch-size", "8",
        "--language-model", str(root / "lm"),
        "--beam-width", "8",
        "--compute-dtype", "float32",
        "--transfer-dtype", "float32",
        *WIDTH_FLAGS,
        *extra,
    ]


def _candidate_lines(out):
    return [ln for ln in out.splitlines() if ln.startswith("candidate-precise:")]


def test_search_matches_jax(workdir, capsys):
    random.seed(11)
    np.random.seed(11)
    jax_candidates = JaxCLI(_argv(workdir, "jax", *SEARCH_FLAGS)).run()
    jax_lines = _candidate_lines(capsys.readouterr().out)

    random.seed(11)
    np.random.seed(11)
    candidates = CLI(
        _argv(workdir, "torch", *SEARCH_FLAGS, "--device", "cpu")
    ).run()
    out = capsys.readouterr().out
    lines = _candidate_lines(out)

    assert "Collecting device emissions over the dev subset" in out
    assert len(lines) == 4 and lines == jax_lines
    assert [str(c) for c in candidates] == [str(c) for c in jax_candidates]
    scores = [c.score for c in candidates]
    assert scores == sorted(scores) and all(s <= 0 for s in scores)
    assert len({ln.split()[2] for ln in lines}) > 1  # the scores differ
    assert candidates[0].stats.decodings_counter == 6


def test_search_device_beam_matches_jax(workdir, capsys, tmp_path, monkeypatch):
    """``search --device-beam`` on the CPU scores its candidates as the
    JAX CLI does; the emissions stay where the device part left them."""
    monkeypatch.setenv("SPEECHT_DEVICE_LM_CACHE", str(tmp_path))
    flags = [*SEARCH_FLAGS, "--device-beam"]
    random.seed(11)
    np.random.seed(11)
    jax_candidates = JaxCLI(_argv(workdir, "jax", *flags)).run()
    jax_lines = _candidate_lines(capsys.readouterr().out)

    random.seed(11)
    np.random.seed(11)
    candidates = CLI(_argv(workdir, "torch", *flags, "--device", "cpu")).run()
    lines = _candidate_lines(capsys.readouterr().out)
    assert len(lines) == 4 and lines == jax_lines
    assert [str(c) for c in candidates] == [str(c) for c in jax_candidates]
    assert candidates[0].stats.decodings_counter == 6


def test_search_flags_and_defaults_match_jax():
    ours = CLI(["search"]).parsed
    theirs = JaxCLI(["search"]).parsed
    assert ours.run_type == theirs.run_type == "other"
    assert dataclasses.asdict(ours.lm) == dataclasses.asdict(theirs.lm)
    ours, theirs = vars(ours), vars(theirs)
    assert ours.pop("device") == "cuda"
    _pop_port_model_flags(ours)
    ours.pop("lm"), theirs.pop("lm")
    assert ours == theirs


def test_candidate_mutation_draws_from_np_random():
    np.random.seed(4)
    child = Candidate(1.0, 0.0, 0.0).mutate(0.5)
    np.random.seed(4)
    noise = np.random.normal(0, 0.5, size=3)
    assert (child.lm_weight, child.word_count_weight,
            child.valid_word_count_weight) == tuple(
        float(x) for x in noise + np.array([1.0, 0.0, 0.0])
    )
    a, b = Candidate(0, 0, 0), Candidate(0, 0, 0)
    a.score, b.score = -1.0, -0.5
    assert a < b and b > a


def test_search_without_checkpoint_is_fatal(workdir):
    with pytest.raises(FileNotFoundError, match="No checkpoint"):
        CLI(_argv(workdir, "none", "--device", "cpu")).run()


@pytest.mark.parametrize(
    "flags", [["--device-beam", "--data-parallel", "2"], ["--data-parallel", "2"]]
)
def test_unported_search_paths_raise(workdir, flags, monkeypatch):
    """One process is one rank, so the grid flags raise the mesh's
    ValueError, as the JAX CLI's ``search`` raises it on one device (its
    mesh takes ``jax.devices()``, cut here to the first of the suite's
    eight virtual devices). The name is older than the port of the LM
    paths on several ranks."""
    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])
    with pytest.raises(ValueError) as jax_error:
        JaxCLI(_argv(workdir, "jax", *flags)).run()
    monkeypatch.undo()
    with pytest.raises(ValueError) as error:
        CLI(_argv(workdir, "torch", "--device", "cpu", *flags)).run()
    assert str(jax_error.value) == "mesh 2x1 exceeds 1 available devices"
    assert str(error.value).startswith(str(jax_error.value))
