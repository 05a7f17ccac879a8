"""The conv_0 path (``SPEECHT_PALLAS_CONV0=1``) through the port's model and
train steps, against the JAX package on the CPU.

A small model whose first layer the gate admits (input 64, so that
``2I % 128 == 0``; base 16, wide 32, 2 body layers), T=96, float32. JAX on
the CPU takes its lax path for conv_0 (its gate admits only a TPU), which
in float32 computes the same function as the port's plain version. The
env var is set through ``monkeypatch``. Tolerances: logits 1e-4 abs and
rel, as tests/test_torch_wav2letter.py; train steps those of
tests/test_torch_train.py (loss rtol 1e-5, grad norm rtol 1e-4, parameters
rtol 1e-5 / atol 1e-6).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speecht_tpu.data.pipeline import Batch as JBatch
from speecht_tpu.models import wav2letter as jw2l
from speecht_tpu.train import step as jstep
from speecht_tpu.train.state import create_train_state as jcreate
from speecht_tpu.train.state import make_optimizer as jmake_optimizer
from speecht_tpu_torch.data.pipeline import Batch, to_device
from speecht_tpu_torch.models import wav2letter
from speecht_tpu_torch.ops import conv0_cuda
from speecht_tpu_torch.train import state as tstate
from speecht_tpu_torch.train import step as tstep
from speecht_tpu_torch.weights import params_from_jax, params_to_jax, train_state_from_jax

WIDTHS = dict(input_size=64, base_channels=16, wide_channels=32, num_body_layers=2)
# Adam's first update is about g / (|g| + eps) for eps 1e-3: on a gradient
# entry far below eps it multiplies a float32 rounding difference of the
# gradient by lr / eps. With 64 input channels (8 in test_torch_train.py)
# the gradients carry more rounding, and at lr 3e-3 two entries of 1792
# moved 1.5e-6 apart on the cuDNN path as well. lr 1e-4, the CLI default,
# keeps the parameter tolerance (1% of the step's update of about lr)
LR = 1e-4
LOSS_RTOL, NORM_RTOL = 1e-5, 1e-4
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6


@pytest.fixture
def conv0_env(monkeypatch):
    monkeypatch.setenv("SPEECHT_PALLAS_CONV0", "1")


@pytest.fixture(scope="module")
def jparams():
    cfg = jw2l.Wav2LetterConfig(compute_dtype="float32", **WIDTHS)
    tree = nn.meta.unbox(jw2l.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(0)  # non-zero biases, so conv_0's is checked
    return {
        layer: {
            "kernel": np.asarray(leaves["kernel"]),
            "bias": rng.randn(*leaves["bias"].shape).astype(np.float32) * 0.1,
        }
        for layer, leaves in tree.items()
    }


def _model(params):
    model = wav2letter.Wav2Letter(
        wav2letter.Wav2LetterConfig(compute_dtype="float32", **WIDTHS)
    )
    model.load_state_dict(params_from_jax(params))
    return model


@pytest.mark.parametrize("T,taken", [(96, True), (97, False), (46, False)])
def test_logits_match_jax_on_the_conv0_path(conv0_env, jparams, T, taken):
    """T=96 takes the conv_0 path (a plain call counted); odd T and T < 48
    take the cuDNN path, as JAX's gate refuses them."""
    x = np.random.RandomState(T).randn(2, T, 64).astype(np.float32)
    jmodel = jw2l.Wav2Letter(jw2l.Wav2LetterConfig(compute_dtype="float32", **WIDTHS))
    want = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(x)))
    model = _model(jparams)
    before = conv0_cuda.CONV0.plain_calls
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert conv0_cuda.CONV0.plain_calls == before + int(taken)
    assert got.shape == want.shape == (2, -(-T // 2), 29)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_env_var_unset_keeps_the_cudnn_path(monkeypatch, jparams):
    monkeypatch.delenv("SPEECHT_PALLAS_CONV0", raising=False)
    x = np.random.RandomState(1).randn(2, 96, 64).astype(np.float32)
    before = conv0_cuda.CONV0.plain_calls
    with torch.no_grad():
        _model(jparams)(torch.from_numpy(x))
    assert conv0_cuda.CONV0.plain_calls == before
    monkeypatch.setenv("SPEECHT_PALLAS_CONV0", "0")
    with torch.no_grad():
        _model(jparams)(torch.from_numpy(x))
    assert conv0_cuda.CONV0.plain_calls == before


def _batch(seed, B=3, T=96, L=8):
    rng = np.random.RandomState(seed)
    b = Batch(
        features=rng.randn(B, T, 64).astype(np.float32),
        seq_lengths=np.array([T, T - 10, T - 30][:B], np.int32),
        labels=rng.randint(0, 28, size=(B, L)).astype(np.int32),
        label_lengths=np.array([L, L - 2, L - 3][:B], np.int32),
    )
    for i, n in enumerate(b.label_lengths):
        b.labels[i, n:] = -1
    return b


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_jax_on_the_conv0_path(conv0_env, steps):
    jmodel = jw2l.Wav2Letter(jw2l.Wav2LetterConfig(compute_dtype="float32", **WIDTHS))
    jp = nn.meta.unbox(
        jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 96, 64), jnp.float32))["params"]
    )
    jtx = jmake_optimizer(max_gradient_norm=5.0, epsilon=1e-3)
    jst = jcreate(jax.tree_util.tree_map(jnp.array, jp), jtx, learning_rate=LR)

    model = wav2letter.Wav2Letter(
        wav2letter.Wav2LetterConfig(compute_dtype="float32", **WIDTHS)
    )
    tx = tstate.make_optimizer(max_gradient_norm=5.0, epsilon=1e-3)
    host = jax.device_get(jst)
    st = train_state_from_jax(
        tstate.create_train_state(dict(model.named_parameters()), tx, 0.0),
        host.params, host.opt_state[1].mu, host.opt_state[1].nu,
        host.opt_state[1].count, host.step, host.learning_rate,
    )
    jtrain = jstep.make_train_step(jmodel, jtx)
    train = tstep.make_train_step(model, tx)
    before = conv0_cuda.CONV0.plain_calls
    for seed in range(steps):
        b = _batch(seed)
        jst, jm = jtrain(jst, JBatch(b.features, b.seq_lengths, b.labels, b.label_lengths))
        st, m = train(st, to_device(b, torch.device("cpu"), "float32"))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=LOSS_RTOL)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=NORM_RTOL)
        got, want = params_to_jax(st.params), jax.device_get(jst.params)
        for layer, leaves in want.items():
            for leaf, value in leaves.items():
                np.testing.assert_allclose(
                    got[layer][leaf], value, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                    err_msg=f"{layer}/{leaf}",
                )
    assert conv0_cuda.CONV0.plain_calls == before + steps
