"""The port's train steps against the JAX package's.

Both packages start from the same point: the JAX ``TINY`` model of
tests/test_train.py (input 8, 16/32 channels, 2 body layers, float32
compute) is initialised in JAX and its train state carried into the port
with ``weights.train_state_from_jax``; batches are made from numpy seeds
and fed to both. After every step the loss, the grad norm (before the
clip) and every parameter are compared.

Tolerances, float32 on the CPU on both sides: loss rtol 1e-5 and grad
norm rtol 1e-4 (the convolutions and the CTC sums run in another order);
parameters rtol 1e-5 / atol 1e-6, as tests/test_train.py compares its
own accumulated and big-batch updates (Adam's update is about lr in size
whatever the gradient, so the parameters move by at most about 3e-3 a
step and keep the gradients' agreement).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speecht_tpu import vocabulary as jvocab
from speecht_tpu import training as jtraining
from speecht_tpu.data.pipeline import Batch as JBatch
from speecht_tpu.models.wav2letter import Wav2Letter as JWav2Letter
from speecht_tpu.models.wav2letter import Wav2LetterConfig as JConfig
from speecht_tpu.train import step as jstep
from speecht_tpu.train.state import create_train_state as jcreate
from speecht_tpu.train.state import make_optimizer as jmake_optimizer
from speecht_tpu_torch import training
from speecht_tpu_torch.data.pipeline import Batch, to_device
from speecht_tpu_torch.models.wav2letter import Wav2Letter, Wav2LetterConfig
from speecht_tpu_torch.train import state as tstate
from speecht_tpu_torch.train import step as tstep
from speecht_tpu_torch.weights import params_to_jax, train_state_from_jax

LR = 3e-3
LOSS_RTOL, NORM_RTOL = 1e-5, 1e-4
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6

JTINY = JConfig(
    input_size=8, base_channels=16, wide_channels=32, num_body_layers=2,
    compute_dtype="float32",
)
TINY = Wav2LetterConfig(
    input_size=8, base_channels=16, wide_channels=32, num_body_layers=2,
    compute_dtype="float32",
)


def tiny_batch(seed, B=4, T=32, L=4):
    rng = np.random.RandomState(seed)
    return Batch(
        features=rng.randn(B, T, 8).astype(np.float32),
        seq_lengths=np.full(B, T, np.int32),
        labels=rng.randint(0, 5, size=(B, L)).astype(np.int32),
        label_lengths=np.full(B, L, np.int32),
    )


def ragged_batch(seed):
    """Ragged rows, a padded row and a CTC-infeasible row."""
    b = tiny_batch(seed, B=5, T=40, L=12)
    b.seq_lengths[:] = [40, 30, 36, 0, 20]
    b.label_lengths[:] = [6, 4, 12, 0, 12]  # row 4: 12 letters, 10 frames
    b.labels[3] = jvocab.PAD_ID
    for i, n in enumerate(b.label_lengths):
        b.labels[i, n:] = jvocab.PAD_ID
    b.features[3] = 0.0
    return b


def jbatch(b):
    return JBatch(b.features, b.seq_lengths, b.labels, b.label_lengths)


def tbatch(b):
    return to_device(b, torch.device("cpu"), "float32")


class Pair:
    """A JAX train state and the port's, started from the same point."""

    def __init__(self, max_gradient_norm=5.0):
        self.jmodel = JWav2Letter(JTINY)
        params = self.jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 8), jnp.float32)
        )["params"]
        self.jparams = nn.meta.unbox(params)
        self.jtx = jmake_optimizer(max_gradient_norm=max_gradient_norm, epsilon=1e-3)
        self.model = Wav2Letter(TINY)
        self.tx = tstate.make_optimizer(max_gradient_norm=max_gradient_norm, epsilon=1e-3)

    def jstate(self):
        params = jax.tree_util.tree_map(jnp.array, self.jparams)
        return jcreate(params, self.jtx, learning_rate=LR)

    def carry(self, jstate):
        """The port's state equal to ``jstate`` (params, moments, counts)."""
        host = jax.device_get(jstate)
        adam = host.opt_state[1]
        fresh = tstate.create_train_state(
            dict(self.model.named_parameters()), self.tx, 0.0
        )
        return train_state_from_jax(
            fresh, host.params, adam.mu, adam.nu, adam.count, host.step,
            host.learning_rate,
        )


def assert_params_equal(state, jstate):
    got = params_to_jax(state.params)
    want = jax.device_get(jstate.params)
    for layer, leaves in want.items():
        for leaf, value in leaves.items():
            np.testing.assert_allclose(
                got[layer][leaf], value, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                err_msg=f"{layer}/{leaf}",
            )


@pytest.mark.parametrize("max_gradient_norm", [5.0, 0.05])
def test_one_and_three_steps_match_jax(max_gradient_norm):
    pair = Pair(max_gradient_norm)
    jtrain = jstep.make_train_step(pair.jmodel, pair.jtx)
    train = tstep.make_train_step(pair.model, pair.tx)
    jst = pair.jstate()
    st = pair.carry(jst)
    for seed in range(3):
        batch = tiny_batch(seed)
        jst, jm = jtrain(jst, jbatch(batch))
        st, m = train(st, tbatch(batch))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=LOSS_RTOL)
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=NORM_RTOL
        )
        assert float(m["learning_rate"]) == pytest.approx(LR)
        assert int(st.step) == int(jst.step) == seed + 1
        assert_params_equal(st, jst)
        if max_gradient_norm < 1:
            assert float(m["grad_norm"]) > max_gradient_norm  # the clip ran
    adam = jax.device_get(jst.opt_state[1])
    assert int(st.opt_state.count) == int(adam.count) == 3


def test_step_from_mid_training_state_matches_jax():
    """The port resumes a JAX state after two steps (non-zero moments,
    Adam count 2) and takes the third step as JAX does."""
    pair = Pair()
    jtrain = jstep.make_train_step(pair.jmodel, pair.jtx)
    jst = pair.jstate()
    for seed in (10, 11):
        jst, _ = jtrain(jst, jbatch(tiny_batch(seed)))
    st = pair.carry(jst)
    batch = tiny_batch(12)
    jst, jm = jtrain(jst, jbatch(batch))
    st, m = tstep.make_train_step(pair.model, pair.tx)(st, tbatch(batch))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=LOSS_RTOL)
    assert_params_equal(st, jst)


def test_accumulating_step_matches_jax():
    """make_train_step_acc with G=2: two applies over four micro-batches,
    the metric sums and the parameters as in JAX."""
    pair = Pair()
    jacc_step = jstep.make_train_step_acc(pair.jmodel, pair.jtx, accum_steps=2)
    acc_step = tstep.make_train_step_acc(pair.model, pair.tx, accum_steps=2)
    jst = pair.jstate()
    st = pair.carry(jst)
    jgacc, jacc = jstep.init_grad_accum(jst.params), jstep.init_metrics_acc()
    gacc, acc = tstep.init_grad_accum(st.params), tstep.init_metrics_acc()
    for seed in range(20, 24):
        batch = tiny_batch(seed)
        jst, jgacc, jacc = jacc_step(jst, jgacc, jacc, jbatch(batch))
        st, gacc, acc = acc_step(st, gacc, acc, tbatch(batch))
    assert float(acc["count"]) == float(jacc["count"]) == 4.0
    assert float(acc["updates"]) == float(jacc["updates"]) == 2.0
    assert gacc["k"] == int(jgacc["k"]) == 0
    assert int(st.step) == int(jst.step) == 2
    assert float(acc["loss_sum"]) == pytest.approx(
        float(jacc["loss_sum"]), rel=LOSS_RTOL
    )
    assert float(acc["grad_norm_sum"]) == pytest.approx(
        float(jacc["grad_norm_sum"]), rel=NORM_RTOL
    )
    assert_params_equal(st, jst)


def test_single_accumulating_step_sums_per_step_metrics():
    """G=1: the accumulator folds exactly the losses and norms that the
    plain step reports, with the same parameters."""
    pair = Pair()
    jacc_step = jstep.make_train_step_acc(pair.jmodel, pair.jtx)
    acc_step = tstep.make_train_step_acc(pair.model, pair.tx)
    jst = pair.jstate()
    st = pair.carry(jst)
    jacc, acc = jstep.init_metrics_acc(), tstep.init_metrics_acc()
    for seed in range(30, 33):
        batch = tiny_batch(seed)
        jst, jacc = jacc_step(jst, jacc, jbatch(batch))
        st, acc = acc_step(st, acc, tbatch(batch))
    assert float(acc["count"]) == float(acc["updates"]) == 3.0
    assert float(acc["loss_sum"]) == pytest.approx(
        float(jacc["loss_sum"]), rel=LOSS_RTOL
    )
    assert_params_equal(st, jst)


def test_padded_and_infeasible_rows_excluded_from_loss():
    pair = Pair()
    jst = pair.jstate()
    st = pair.carry(jst)
    batch = ragged_batch(40)
    jloss, _ = jstep.make_loss_fn(pair.jmodel)(jst.params, jbatch(batch))
    with torch.no_grad():
        loss, _ = tstep.make_loss_fn(pair.model)(tbatch(batch))
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    # only the three real, feasible rows count
    good = Batch(*(getattr(batch, f)[:3] for f in
                   ("features", "seq_lengths", "labels", "label_lengths")))
    with torch.no_grad():
        loss_good, _ = tstep.make_loss_fn(pair.model)(tbatch(good))
    assert float(loss) == pytest.approx(float(loss_good), rel=1e-6)

    jtrain = jstep.make_train_step(pair.jmodel, pair.jtx)
    jst, jm = jtrain(jst, jbatch(batch))
    st, m = tstep.make_train_step(pair.model, pair.tx)(st, tbatch(batch))
    assert np.isfinite(float(m["grad_norm"]))
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=NORM_RTOL)
    assert_params_equal(st, jst)


def test_decay_learning_rate_matches_jax():
    pair = Pair()
    jst = pair.jstate()
    st = pair.carry(jst)
    jst = jstep.decay_learning_rate(jst, 0.5)
    st = tstep.decay_learning_rate(st, 0.5)
    assert float(st.learning_rate) == float(jst.learning_rate)
    assert st.learning_rate.dtype == torch.float32


@pytest.mark.parametrize(
    "previous,current,factor",
    [
        ([10.0, 10.0, 10.0], 12.0, 0.5),
        ([10.0, 10.0, 12.0], 11.0, 0.5),
        ([10.0, 10.0], 12.0, 0.5),
        ([10.0, 10.0, 10.0], 12.0, 0.0),
        ([9.0, 8.0, 7.0, 6.0], 7.5, 0.9),
    ],
)
def test_plateau_rule_matches_jax(previous, current, factor):
    assert training.should_decay_learning_rate(
        previous, current, factor
    ) == jtraining.should_decay_learning_rate(previous, current, factor)
    assert training.perplexity(current) == pytest.approx(
        jtraining.perplexity(current)
    )
    assert training.perplexity(400.0) == jtraining.perplexity(400.0)


@pytest.mark.parametrize("scale", [0.5, 1.0, 3.0])
def test_clip_adam_update_matches_optax(scale):
    """Two updates below, at and above the clip threshold, against optax:
    the trigger is ``norm < max_norm`` and the clip divides by the norm
    alone (no 1e-6 term)."""
    grads = [np.array([1.2e-3, -1.6e-3, 0.0], np.float32) * scale * 1000,
             np.array([0.3, 0.1, -2.0], np.float32) * scale]
    jtx = jmake_optimizer(max_gradient_norm=2.0)
    tx = tstate.make_optimizer(max_gradient_norm=2.0)
    jopt = jtx.init({"w": jnp.zeros(3)})
    opt = tx.init({"w": torch.zeros(3)})
    for g in grads:
        ju, jopt = jtx.update({"w": jnp.asarray(g)}, jopt)
        u, opt, norm = tx.update({"w": torch.from_numpy(g)}, opt)
        np.testing.assert_allclose(u["w"].numpy(), np.asarray(ju["w"]), rtol=1e-6)
        assert float(norm) == pytest.approx(float(np.linalg.norm(g)), rel=1e-6)
    np.testing.assert_allclose(opt.nu["w"].numpy(), np.asarray(jopt[1].nu["w"]), rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 50.0])
def test_clip_adam_list_ops_equal_the_per_leaf_formulas(max_norm):
    """Two updates of seven leaves, clipped (0.5) and not (50): given the
    global norm, the list ops give the per-leaf formulas' values bit for
    bit."""
    gen = torch.Generator().manual_seed(0)
    shapes = [(3,), (4, 5), (2, 3, 4), (1,), (6,), (7, 2), (3, 3)]
    tx = tstate.make_optimizer(max_gradient_norm=max_norm, epsilon=1e-3)
    state = tx.init({f"p{i}": torch.zeros(s) for i, s in enumerate(shapes)})
    mu = {k: torch.zeros_like(v) for k, v in state.mu.items()}
    nu = {k: torch.zeros_like(v) for k, v in state.nu.items()}
    for step in (1, 2):
        grads = {k: torch.randn(v.shape, generator=gen) for k, v in mu.items()}
        updates, state, norm = tx.update(grads, state)
        # the norm of the leaves' norms: the sum of squares to float32's rounding
        want_norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads.values()))
        assert float(norm) == pytest.approx(float(want_norm), rel=1e-6)
        assert bool(norm < max_norm) == (max_norm > 1)
        c = torch.tensor(float(step))
        for k, g in grads.items():
            g = torch.where(norm < max_norm, g, (g / norm) * max_norm)
            mu[k] = (1 - 0.9) * g + 0.9 * mu[k]
            nu[k] = (1 - 0.999) * (g * g) + 0.999 * nu[k]
            want = (mu[k] / (1 - torch.pow(0.9, c))) / (
                torch.sqrt(nu[k] / (1 - torch.pow(0.999, c))) + 1e-3)
            assert torch.equal(updates[k], want), k
            assert torch.equal(state.mu[k], mu[k]) and torch.equal(state.nu[k], nu[k]), k
