"""The port's multi-process train and evaluate on the CPU, against JAX's meshes.

Two gloo ranks (``tests/torch_parallel_workers.py``: spawned processes,
one torch thread each, a ``file://`` rendezvous) run the port's train
steps on a ``2 x 1`` data-parallel grid, a ``1 x 2`` tensor-parallel grid
and the data-parallel grid with ``--grad-accum 2``, from the JAX ``TINY``
state of tests/test_torch_train.py carried in by
``weights.train_state_from_jax``; the JAX package runs the same steps on
the same global batches on a ``(2, 1)`` or ``(1, 2)`` mesh of its
8-device virtual CPU platform, and the port on one process runs them too.
The first batch gives rank 1 a padding row and a CTC-infeasible row, so
the ranks hold different numbers of real rows (an average of the ranks'
averages would be off). Then ``train`` and ``evaluate`` through the CLI on
two ranks: the global LED/LER/WED/WER equal one process's, and a
two-rank checkpoint restores in one process.

Tolerances, float32 on both sides, as tests/test_torch_train.py: loss
rtol 1e-5, grad norm rtol 1e-4, parameters rtol 1e-5 / atol 1e-6.
"""

import json
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speecht_tpu import vocabulary as jvocab
from speecht_tpu.data.pipeline import Batch as JBatch
from speecht_tpu.models.wav2letter import Wav2Letter as JWav2Letter
from speecht_tpu.models.wav2letter import Wav2LetterConfig as JConfig
from speecht_tpu.parallel import mesh as jmesh
from speecht_tpu.train import step as jstep
from speecht_tpu.train.state import create_train_state as jcreate
from speecht_tpu.train.state import make_optimizer as jmake_optimizer
from speecht_tpu_torch.data.pipeline import Batch, to_device
from speecht_tpu_torch.models.wav2letter import Wav2Letter
from speecht_tpu_torch.train import step as tstep
from speecht_tpu_torch.weights import params_to_jax

import torch_parallel_workers as workers

LR = 3e-3
LOSS_RTOL, NORM_RTOL = 1e-5, 1e-4
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6
JTINY = JConfig(
    input_size=8, base_channels=16, wide_channels=32, num_body_layers=2,
    compute_dtype="float32",
)


def global_batch(seed, B=4, T=32, L=4):
    rng = np.random.RandomState(seed)
    b = Batch(
        features=rng.randn(B, T, 8).astype(np.float32),
        seq_lengths=np.full(B, T, np.int32),
        labels=rng.randint(0, 5, size=(B, L)).astype(np.int32),
        label_lengths=np.full(B, L, np.int32),
    )
    if seed == 0:
        # rank 1's half: a padding row and a row of 12 letters in 10 frames
        b.seq_lengths[2:] = [0, 20]
        b.features[2] = 0.0
        b.labels = np.full((B, 12), jvocab.PAD_ID, np.int32)
        b.label_lengths[:] = [4, 3, 0, 12]
        for i, n in enumerate(b.label_lengths):
            b.labels[i, :n] = rng.randint(0, 5, n)
    return b


def jbatch(b):
    return JBatch(b.features, b.seq_lengths, b.labels, b.label_lengths)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX state and batches, the two ranks' results and the port's
    one-process steps."""
    work = tmp_path_factory.mktemp("parallel_train")
    jmodel = JWav2Letter(JTINY)
    params = nn.meta.unbox(jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 8), jnp.float32))["params"])
    jtx = jmake_optimizer(max_gradient_norm=5.0, epsilon=1e-3)
    jst = jcreate(params, jtx, learning_rate=LR)
    host = jax.device_get(jst)
    adam = host.opt_state[1]
    flat = {"count": np.asarray(adam.count), "step": np.asarray(host.step)}
    for tree_name, tree in (("params", host.params), ("mu", adam.mu), ("nu", adam.nu)):
        for layer, leaves in tree.items():
            for leaf, v in leaves.items():
                flat[f"{tree_name}/{layer}/{leaf}"] = np.asarray(v)
    state_path = str(work / "state.npz")
    np.savez(state_path, **flat)
    batches = [global_batch(s) for s in range(4)]
    paths = []
    for i, b in enumerate(batches):
        paths.append(str(work / f"batch{i}.npz"))
        np.savez(paths[-1], features=b.features, seq_lengths=b.seq_lengths,
                 labels=b.labels, label_lengths=b.label_lengths)
    workers.run_ranks(workers.train_steps, work / "ranks", state_path, paths, LR)
    results = {name: dict(np.load(work / "ranks" / f"{name}.npz"))
               for name in ("dp", "tp", "dp_accum")}
    return jmodel, params, jtx, batches, results, state_path


def jax_steps(jmodel, params, jtx, batches, mesh_shape, accum=1):
    mesh = jmesh.make_mesh(*mesh_shape)
    jst = jcreate(jax.tree_util.tree_map(jnp.array, params), jtx, learning_rate=LR)
    losses, norms = [], []
    with jmesh.use_mesh(mesh):
        if accum == 1:
            step = jstep.make_train_step(jmodel, jtx)
            for b in batches:
                jst, m = step(jst, jmesh.shard_batch(jbatch(b)))
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        else:
            step = jstep.make_train_step_acc(jmodel, jtx, accum_steps=accum)
            gacc = jstep.init_grad_accum(jst.params)
            for b in batches:
                acc = jstep.init_metrics_acc()
                jst, gacc, acc = step(jst, gacc, acc, jmesh.shard_batch(jbatch(b)))
                losses.append(float(acc["loss_sum"]))
                norms.append(float(acc["grad_norm_sum"]))
    return jax.device_get(jst.params), losses, norms


def port_steps(state_path, batches, accum=1):
    """The port's own steps on one process, on the whole batches."""
    model = Wav2Letter(workers.tiny_config())
    state, tx = workers.fresh_state(model, state_path, LR)
    step = tstep.make_train_step_acc(model, tx, accum_steps=accum)
    gacc = tstep.init_grad_accum(state.params) if accum > 1 else None
    losses, norms = [], []
    for b in batches:
        tb = to_device(b, torch.device("cpu"), "float32")
        acc = tstep.init_metrics_acc()
        if gacc is None:
            state, acc = step(state, acc, tb)
        else:
            state, gacc, acc = step(state, gacc, acc, tb)
        losses.append(acc["loss_sum"].item())
        norms.append(acc["grad_norm_sum"].item())
    return params_to_jax(state.params), losses, norms


def assert_same(result, want_params, want_losses, want_norms):
    np.testing.assert_allclose(result["metric/loss"], want_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(result["metric/grad_norm"], want_norms, rtol=NORM_RTOL)
    got = params_to_jax({k: torch.from_numpy(v) for k, v in result.items()
                         if not k.startswith("metric/")})
    for layer, leaves in want_params.items():
        for leaf, value in leaves.items():
            np.testing.assert_allclose(
                got[layer][leaf], value, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                err_msg=f"{layer}/{leaf}",
            )


@pytest.mark.parametrize("name,mesh_shape", [("dp", (2, 1)), ("tp", (1, 2))])
def test_two_rank_steps_match_jax_mesh(runs, name, mesh_shape):
    jmodel, params, jtx, batches, results, _ = runs
    assert_same(results[name], *jax_steps(jmodel, params, jtx, batches, mesh_shape))


@pytest.mark.parametrize("name", ["dp", "tp"])
def test_two_rank_steps_match_one_process(runs, name):
    _jm, _p, _tx, batches, results, state_path = runs
    assert_same(results[name], *port_steps(state_path, batches))


@pytest.mark.parametrize("name", ["dp", "tp", "dp_accum"])
def test_two_rank_steps_take_forward_input_grad(runs, name):
    """The width-32 layer's input gradient runs as a forward conv once a
    step on every grid; on the tensor-parallel grid each rank takes its
    column shard's part, which ``CopyToModel``'s backward sums."""
    _jm, _p, _tx, batches, results, _state = runs
    assert int(results[name]["metric/input_grads"]) == len(batches)


def test_grad_accum_under_dp_matches_jax_and_one_process(runs):
    jmodel, params, jtx, batches, results, state_path = runs
    result = results["dp_accum"]
    assert float(result["metric/updates"]) == 2.0
    assert_same(result, *jax_steps(jmodel, params, jtx, batches, (2, 1), accum=2))
    assert_same(result, *port_steps(state_path, batches, accum=2))


WIDTH_FLAGS = ["--base-channels", "16", "--wide-channels", "32",
               "--num-body-layers", "2"]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """A synthetic cached corpus (numpy seed; 8 test utterances of 40-90
    frames, so every batch pads to the 256-frame bucket), and the two
    ranks' CLI runs on it (``torch_parallel_workers.cli_runs``)."""
    root = tmp_path_factory.mktemp("parallel_cli")
    rng = np.random.RandomState(0)
    for split, n in (("train", 8), ("test", 8)):
        d = root / "data" / "preprocessed-power" / split
        d.mkdir(parents=True)
        for i in range(n):
            frames = rng.randint(40, 90)
            np.savez(
                d / f"utt{i}",
                audio_fragments=rng.randn(frames, 8).astype(np.float32),
                transcript=rng.randint(0, 28, size=rng.randint(3, 9)).astype(np.int64),
            )
    argv = [
        "--device", "cpu", "--data-dir", str(root / "data"),
        "--train-dir", str(root / "train"), "--log-dir", str(root / "log"),
        "--batch-size", "4", "--compute-dtype", "float32",
        "--transfer-dtype", "float32", *WIDTH_FLAGS,
    ]
    workers.run_ranks(workers.cli_runs, root / "ranks", argv)
    ranks = [json.load(open(root / "ranks" / f"cli-{r}.json")) for r in range(2)]
    return root, argv, ranks


def _one_process_evaluate(argv, run_name):
    from speecht_tpu_torch.cli import CLI

    stats = CLI(["evaluate", *argv, "--run-name", run_name, "--test", "--no-save"]).run()
    return workers.stats_row(stats)


@pytest.mark.parametrize("grid", ["dp", "tp", "sp"])
def test_two_rank_evaluate_statistics_equal_one_process(cli_runs, grid, capsys):
    _root, argv, ranks = cli_runs
    want = _one_process_evaluate(argv, "dp")
    capsys.readouterr()
    for rank in ranks:  # every rank tracks the global statistics
        got = rank[f"evaluate_{grid}"]["stats"]
        assert got[:3] == want[:3]
        assert got[3:] == pytest.approx(want[3:], rel=1e-12)
    out = ranks[0][f"evaluate_{grid}"]["stdout"]
    assert "distributed: rank 0 of 2, backend gloo, device cpu" in out
    assert "Global statistics" in out and out.count("expected: ") == 8
    # rank 1 tracks the same rows but prints none of them
    assert "Global statistics" not in ranks[1][f"evaluate_{grid}"]["stdout"]


@pytest.mark.parametrize("run", ["dp", "tp"])
def test_multi_rank_checkpoint_restores_in_one_process(cli_runs, run):
    """Rank 0 wrote the one-device layout: one process restores it whole,
    and the two ranks trained alike (one interval line, on rank 0)."""
    from speecht_tpu_torch.execution import build_model, init_state
    from speecht_tpu_torch.train.checkpoint import CheckpointManager
    from types import SimpleNamespace

    root, _argv, ranks = cli_runs
    mgr = CheckpointManager(str(root / "train" / run))
    assert mgr.all_steps() == [2]
    flags = SimpleNamespace(base_channels=16, wide_channels=32, num_body_layers=2,
                            compute_dtype="float32")
    model = build_model(8, flags)
    state, _tx = init_state(model, flags)
    state = mgr.restore(state)
    assert int(state.step) == 2
    assert ranks[0][f"train_{run}"].count("global step 2 ") == 1
    assert "global step" not in ranks[1][f"train_{run}"]
