"""The port's SpecAugment against the JAX package's (``ops/augment.py``).

Philox (or the CPU generator) does not give threefry's bits, so the tests
hold the port to the same behaviour (padding never masked, width bounds,
time masks within the valid frames, zero widths the identity, keyed
determinism) and to the same statistics: over 2400 rows the mean masked
share of each axis agrees with JAX's ``spec_augment`` within 5 standard
errors of the difference of the two means.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speecht_tpu.ops import augment as jaugment
from speecht_tpu_torch.data.pipeline import Batch
from speecht_tpu_torch.ops.augment import make_augment_fn, spec_augment

Z_LIMIT = 5.0


def _batch(B=3, T=64, F=16, valid=None):
    rng = np.random.RandomState(0)
    valid = np.asarray(valid if valid is not None else [T] * B, np.int32)
    feats = rng.randn(B, T, F).astype(np.float32) + 5.0  # never zero
    for b in range(B):
        feats[b, valid[b]:] = 0.0  # zero padding, as build_batch leaves it
    return torch.from_numpy(feats), torch.from_numpy(valid)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_masks_zero_cells_and_leave_the_rest():
    feats, valid = _batch()
    out = spec_augment(feats, valid, _gen(1))
    changed = out != feats
    assert bool(changed.any())
    assert bool((out[changed] == 0).all())
    torch.testing.assert_close(out[~changed], feats[~changed], rtol=0, atol=0)


@pytest.mark.parametrize("seed", range(8))
def test_time_masks_stay_on_valid_frames_within_bounds(seed):
    feats, valid = _batch(valid=[20, 40, 64])
    out = spec_augment(feats, valid, _gen(seed), n_freq_masks=0)
    for b, v in enumerate(valid.tolist()):
        # padding is never masked (it is zero and stays so)
        torch.testing.assert_close(out[b, v:], feats[b, v:], rtol=0, atol=0)
        zero_rows = (out[b, :v] == 0).all(dim=1)
        # two spans of at most floor(0.05 v) frames each
        assert int(zero_rows.sum()) <= 2 * int(0.05 * v)
        # a time mask zeroes whole frames and nothing else
        assert bool((out[b, :v][~zero_rows] == feats[b, :v][~zero_rows]).all())


@pytest.mark.parametrize("seed", range(8))
def test_freq_masks_within_bounds(seed):
    feats, valid = _batch(F=64)
    out = spec_augment(feats, valid, _gen(seed), n_time_masks=0, freq_width=5)
    for b in range(3):
        zero_cols = (out[b] == 0).all(dim=0)
        assert int(zero_cols.sum()) <= 2 * 5
        assert bool((out[b][:, ~zero_cols] == feats[b][:, ~zero_cols]).all())


def test_zero_widths_are_the_identity():
    feats, valid = _batch()
    out = spec_augment(feats, valid, _gen(3), freq_width=0, time_frac=0.0)
    torch.testing.assert_close(out, feats, rtol=0, atol=0)


def test_augment_fn_is_keyed_on_step_and_micro_batch():
    feats, valid = _batch()
    batch = Batch(feats, valid, torch.zeros(3, 4, dtype=torch.int32),
                  torch.full((3,), 4, dtype=torch.int32))
    aug = make_augment_fn()
    a = aug(batch, 0, 0).features
    torch.testing.assert_close(aug(batch, 0, 0).features, a, rtol=0, atol=0)
    assert bool((aug(batch, 1, 0).features != a).any())  # fresh per step
    assert bool((aug(batch, 0, 1).features != a).any())  # and per micro-batch
    assert bool((make_augment_fn(seed=1)(batch, 0, 0).features != a).any())
    assert aug(batch, 0, 0).labels is batch.labels


def test_masks_land_on_valid_frames_of_padded_rows():
    """Starts are drawn within the valid extent: a 20-frame row padded to
    256 is time-masked on most draws."""
    feats, valid = _batch(B=1, T=256, valid=[20])
    hits = sum(
        bool((spec_augment(feats, valid, _gen(seed), n_freq_masks=0,
                           time_frac=0.3)[0, :20] == 0).all(dim=1).any())
        for seed in range(50)
    )
    assert hits >= 25, hits


def test_masked_share_per_axis_matches_jax():
    B, T, F = 2400, 200, 128
    rng = np.random.RandomState(7)
    valid = rng.randint(60, T + 1, size=B).astype(np.int32)
    feats = np.ones((B, T, F), np.float32)
    for b in range(B):
        feats[b, valid[b]:] = 0.0
    kw = dict(freq_width=15, time_frac=0.1)
    ours = spec_augment(torch.from_numpy(feats), torch.from_numpy(valid),
                        _gen(11), **kw).numpy()
    theirs = np.asarray(jaugment.spec_augment(
        jnp.asarray(feats), jnp.asarray(valid), jax.random.PRNGKey(11), **kw
    ))

    def shares(out):
        cells = (out == 0) & (feats != 0)  # masked valid cells
        cols = cells.all(axis=1)  # a frequency masked over all valid frames
        rows = cells.all(axis=2)  # a frame masked over all frequencies
        return cols.mean(axis=1), rows.sum(axis=1) / valid

    for axis, a, c in zip(("frequency", "time"), shares(ours), shares(theirs)):
        se = np.sqrt(a.var() / B + c.var() / B)
        z = abs(a.mean() - c.mean()) / se
        assert z < Z_LIMIT, (axis, a.mean(), c.mean(), z)
        assert 0 < a.mean() < 0.3


@pytest.mark.parametrize("accum,keys", [
    (1, [(0, 0), (1, 1), (2, 2), (3, 0)]),
    (2, [(0, 0), (0, 1), (1, 2), (1, 0)]),
])
def test_train_step_augments_each_micro_batch_with_its_key(accum, keys):
    """make_train_step_acc applies augment_fn to each micro-batch before
    the loss, keyed on (optimizer step, micro-batch index of the metrics
    window) as JAX's step is; the loss is that of the augmented batch."""
    from speecht_tpu_torch.models.wav2letter import Wav2Letter, Wav2LetterConfig
    from speecht_tpu_torch.train import state as tstate
    from speecht_tpu_torch.train import step as tstep

    cfg = Wav2LetterConfig(input_size=16, base_channels=8, wide_channels=16,
                           num_body_layers=1, compute_dtype="float32")
    model = Wav2Letter(cfg)
    tx = tstate.make_optimizer()
    state = tstate.create_train_state(dict(model.named_parameters()), tx, 1e-3)
    feats, valid = _batch(B=2, T=48, F=16, valid=[48, 40])
    batch = Batch(feats, valid, torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32),
                  torch.full((2,), 4, dtype=torch.int32))
    real = make_augment_fn(freq_width=3, time_frac=0.1)
    seen = []

    def recording(b, step, micro):
        seen.append((step, micro))
        return real(b, step, micro)

    with torch.no_grad():
        want_loss, _ = tstep.make_loss_fn(model)(real(batch, 0, 0))
    step = tstep.make_train_step_acc(model, tx, accum_steps=accum, augment_fn=recording)
    acc = tstep.init_metrics_acc()
    gacc = tstep.init_grad_accum(state.params) if accum > 1 else None
    for i in range(4):
        if i == 3:
            acc = tstep.init_metrics_acc()  # the loop's reset at a checkpoint
        if gacc is None:
            state, acc = step(state, acc, batch)
        else:
            state, gacc, acc = step(state, gacc, acc, batch)
        if i == 0:
            assert float(acc["loss_sum"]) == pytest.approx(float(want_loss), rel=1e-6)
    assert seen == keys
    assert acc["micro"] == 1 and float(acc["count"]) == 1.0
