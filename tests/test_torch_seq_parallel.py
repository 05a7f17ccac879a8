"""The port's sequence parallelism on two CPU ranks against JAX's on a mesh.

Two gloo ranks (``tests/torch_parallel_workers.py``) shard the time axis
of tests/test_seq_parallel.py's TINY model (``n_seq`` 2) and run the
forward (halo exchanges, VALID convs, the logits gathered over time), the
CTC loss and its gradients summed over the sequence group, and one train
step; JAX runs ``make_sp_forward``, ``make_sp_loss_fn`` and
``make_sp_train_step`` on a ``(1, 2)`` mesh of its 8-device virtual CPU
platform, from the same weights and batch. The length checks raise JAX's
errors.

Tolerances, float32 on both sides: logits 1e-5 (JAX's own SP test);
loss rtol 1e-5; gradients rtol 1e-3 / atol 1e-4 (JAX's SP-against-dense
gradient test: the halo sums run in another order); after the step,
parameters rtol 1e-5 / atol 1e-6 and the grad norm rtol 1e-4, as
tests/test_torch_train.py. The summed gradients also match the port's
one-device gradients, at the same tolerance as JAX's.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speecht_tpu.data.pipeline import Batch as JBatch
from speecht_tpu.models.wav2letter import Wav2Letter as JWav2Letter
from speecht_tpu.models.wav2letter import Wav2LetterConfig as JConfig
from speecht_tpu.parallel import mesh as jmesh
from speecht_tpu.parallel import seq_parallel as jsp
from speecht_tpu.train.state import create_train_state as jcreate
from speecht_tpu.train.state import make_optimizer as jmake_optimizer
from speecht_tpu_torch.data.pipeline import Batch, to_device
from speecht_tpu_torch.models.wav2letter import Wav2Letter
from speecht_tpu_torch.ops import conv_grad
from speecht_tpu_torch.parallel import seq_parallel as sp
from speecht_tpu_torch.train import step as tstep
from speecht_tpu_torch.weights import params_from_jax

import torch_parallel_workers as workers

LR = 3e-3
TINY = JConfig(
    input_size=8, base_channels=16, wide_channels=32, num_body_layers=2,
    compute_dtype="float32",
)


def sp_batch(seed, B=2, T=192, L=4):
    rng = np.random.RandomState(seed)
    return JBatch(
        features=rng.randn(B, T, TINY.input_size).astype(np.float32),
        seq_lengths=np.array([T, T - 40], np.int32),
        labels=rng.randint(0, 5, (B, L)).astype(np.int32),
        label_lengths=np.full(B, L, np.int32),
    )


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("seq_parallel")
    model = JWav2Letter(TINY)
    params = nn.meta.unbox(
        model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 8)))["params"])
    tx = jmake_optimizer(max_gradient_norm=5.0, epsilon=1e-3)
    host = jax.device_get(jcreate(params, tx, learning_rate=LR))
    adam = host.opt_state[1]
    flat = {"count": np.asarray(adam.count), "step": np.asarray(host.step)}
    for tree_name, tree in (("params", host.params), ("mu", adam.mu), ("nu", adam.nu)):
        for layer, leaves in tree.items():
            for leaf, v in leaves.items():
                flat[f"{tree_name}/{layer}/{leaf}"] = np.asarray(v)
    np.savez(work / "state.npz", **flat)
    batch = sp_batch(2)
    np.savez(work / "batch.npz", features=batch.features, seq_lengths=batch.seq_lengths,
             labels=batch.labels, label_lengths=batch.label_lengths)
    workers.run_ranks(workers.seq_parallel, work / "ranks", str(work / "state.npz"),
                      str(work / "batch.npz"), LR)
    return model, params, tx, batch, dict(np.load(work / "ranks" / "sp.npz"))


def _torch_names(tree):
    return {k: v.numpy() for k, v in params_from_jax(tree).items()}


def test_sp_forward_matches_jax(runs):
    model, params, _tx, batch, got = runs
    mesh = jmesh.make_mesh(data_parallel=1, model_parallel=2)
    want = np.asarray(jsp.make_sp_forward(model, mesh)(params, batch.features))
    np.testing.assert_allclose(got["logits"], want, rtol=1e-5, atol=1e-5)


def test_sp_loss_and_gradients_match_jax(runs):
    model, params, _tx, batch, got = runs
    mesh = jmesh.make_mesh(data_parallel=1, model_parallel=2)
    loss_fn = jsp.make_sp_loss_fn(model, mesh)
    loss, grads = jax.value_and_grad(lambda p: loss_fn(p, batch)[0])(params)
    assert float(got["loss"]) == pytest.approx(float(loss), rel=1e-5)
    for name, want in _torch_names(jax.device_get(grads)).items():
        np.testing.assert_allclose(got[f"grad/{name}"], want, rtol=1e-3, atol=1e-4,
                                   err_msg=name)


def test_sp_train_step_matches_jax(runs):
    model, params, tx, batch, got = runs
    mesh = jmesh.make_mesh(data_parallel=1, model_parallel=2)
    state = jcreate(jax.tree_util.tree_map(jnp.array, params), tx, learning_rate=LR)
    state, m = jsp.make_sp_train_step(model, tx, mesh)(state, batch)
    assert float(got["step_loss"]) == pytest.approx(float(m["loss"]), rel=1e-5)
    assert float(got["step_grad_norm"]) == pytest.approx(float(m["grad_norm"]), rel=1e-4)
    for name, want in _torch_names(jax.device_get(state.params)).items():
        np.testing.assert_allclose(got[f"param/{name}"], want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("T,n,match", [(388, 4, "divisible"), (128, 8, "too short")])
def test_sp_length_checks_raise_jax_errors(T, n, match):
    from speecht_tpu_torch.models.wav2letter import Wav2LetterConfig

    cfg = Wav2LetterConfig(input_size=8, base_channels=16, wide_channels=32,
                           num_body_layers=2)
    with pytest.raises(ValueError, match=match) as got:
        sp.validate_sp_length(T, n, cfg)
    with pytest.raises(ValueError) as want:
        jsp.validate_sp_length(T, n, TINY)
    assert str(got.value) == str(want.value)


def test_sp_data_axis_matches_jax():
    from speecht_tpu_torch.parallel.mesh import Mesh

    for dp, n in ((1, 2), (2, 2), (2, 4)):
        want = jsp.sp_data_axis(jmesh.make_mesh(data_parallel=dp, model_parallel=n))
        assert sp.sp_data_axis(Mesh(dp=dp, mp=n, seq_parallel=True)) == want


def test_sp_gradients_match_one_device_through_forward_input_grad(runs):
    """The width-32 layer's input gradient, halo frames included, runs as a
    forward conv on each rank (once a rank for the loss's gradients), and
    the gradients summed over the sequence group match one device's."""
    _model, params, _tx, batch, got = runs
    model = Wav2Letter(workers.tiny_config())
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    tb = to_device(Batch(batch.features, batch.seq_lengths, batch.labels,
                         batch.label_lengths), torch.device("cpu"), "float32")
    before = conv_grad.input_grads
    loss, _logits = tstep.make_loss_fn(model)(tb)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    assert conv_grad.input_grads - before == 1
    assert int(got["input_grads"]) == 1
    for name, want in zip(params, grads):
        np.testing.assert_allclose(got[f"grad/{name}"], want.numpy(), rtol=1e-3,
                                   atol=1e-4, err_msg=name)
