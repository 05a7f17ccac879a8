"""The port's checkpoints and weight export.

The port cannot read the JAX package's orbax checkpoints, so its own
format (``train/checkpoint.py``) is tested for what the JAX
``CheckpointManager`` gives: a round trip of params, Adam moments, step
and learning rate (exact: float32 tensors are saved as they are), the
skip of an existing label, ``max_to_keep``, a leftover temporary file
ignored, the learning-rate reset, and the corrupt-checkpoint error with
the same actionable message. A directory that holds only orbax steps is
refused. ``export_weights`` writes the JAX package's ``.npy`` names,
which the JAX export writes too and ``load_weight_dir`` reads back.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speecht_tpu.models.wav2letter import Wav2Letter as JWav2Letter
from speecht_tpu.models.wav2letter import Wav2LetterConfig as JConfig
from speecht_tpu.train import checkpoint as jcheckpoint
from speecht_tpu.train.state import create_train_state as jcreate
from speecht_tpu.train.state import make_optimizer as jmake_optimizer
from speecht_tpu_torch.models.wav2letter import Wav2Letter, Wav2LetterConfig
from speecht_tpu_torch.train import state as tstate
from speecht_tpu_torch.train import step as tstep
from speecht_tpu_torch.train.checkpoint import CheckpointManager, export_weights
from speecht_tpu_torch.weights import load_weight_dir

TINY = Wav2LetterConfig(
    input_size=8, base_channels=16, wide_channels=32, num_body_layers=2,
    compute_dtype="float32",
)


def _state(seed=0, lr=3e-3):
    model = Wav2Letter(TINY, generator=torch.Generator().manual_seed(seed))
    tx = tstate.make_optimizer()
    st = tstate.create_train_state(dict(model.named_parameters()), tx, lr)
    return model, tx, st


def _trained_state():
    """A state after one real step and a decay: every field non-trivial."""
    model, tx, st = _state()
    rng = np.random.RandomState(0)
    from speecht_tpu_torch.data.pipeline import Batch, to_device

    batch = Batch(
        rng.randn(3, 32, 8).astype(np.float32), np.full(3, 32, np.int32),
        rng.randint(0, 5, size=(3, 4)).astype(np.int32), np.full(3, 4, np.int32),
    )
    st, _m = tstep.make_train_step(model, tx)(
        st, to_device(batch, torch.device("cpu"), "float32")
    )
    return tstep.decay_learning_rate(st, 0.25)


def _assert_states_equal(a, b):
    for name in a.params:
        torch.testing.assert_close(a.params[name], b.params[name], rtol=0, atol=0)
        torch.testing.assert_close(
            a.opt_state.mu[name], b.opt_state.mu[name], rtol=0, atol=0
        )
        torch.testing.assert_close(
            a.opt_state.nu[name], b.opt_state.nu[name], rtol=0, atol=0
        )
    assert int(a.opt_state.count) == int(b.opt_state.count)
    assert int(a.step) == int(b.step)
    assert float(a.learning_rate) == float(b.learning_rate)


def test_roundtrip_and_lr_reset(tmp_path):
    st = _trained_state()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(st)
    assert mgr.latest_step() == 1

    _model, _tx, template = _state(seed=5, lr=1.0)
    restored, was_restored = mgr.restore_or_create(template)
    assert was_restored
    _assert_states_equal(restored, st)
    # restored in place: the template's (the model's) tensors hold it
    assert restored.params["conv_0.weight"] is template.params["conv_0.weight"]
    assert float(restored.learning_rate) == pytest.approx(3e-3 * 0.25)

    reset = mgr.restore(template, reset_learning_rate=1e-4)
    assert float(reset.learning_rate) == pytest.approx(1e-4)
    assert reset.learning_rate.dtype == torch.float32


def test_existing_label_is_not_rewritten(tmp_path):
    st = _trained_state()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(st, step=7)
    before = os.stat(mgr.path(7)).st_mtime_ns
    st = tstep.decay_learning_rate(st, 0.5)
    mgr.save(st, step=7)
    assert os.stat(mgr.path(7)).st_mtime_ns == before
    _m, _t, template = _state()
    assert float(mgr.restore(template).learning_rate) == pytest.approx(3e-3 * 0.25)


def test_max_to_keep_and_leftover_temporary_file(tmp_path):
    _m, _t, st = _state()
    mgr = CheckpointManager(str(tmp_path), max_to_keep=5)
    # a save that died before its rename leaves only a temporary file
    (tmp_path / "ckpt-99.pt.tmp-12345").write_bytes(b"torn")
    for step in range(1, 8):
        mgr.save(st, step=step)
    assert mgr.all_steps() == [3, 4, 5, 6, 7]
    assert mgr.latest_step() == 7
    mgr.restore(st)  # the torn temporary file is never read


def test_missing_checkpoint(tmp_path):
    _m, _t, st = _state()
    mgr = CheckpointManager(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError, match="No checkpoint for evaluation"):
        mgr.restore(st)
    out, was_restored = mgr.restore_or_create(st)
    assert out is st and not was_restored


@pytest.mark.parametrize("damage", ["truncated", "garbage", "wrong_shape"])
def test_corrupt_checkpoint_raises_actionable_error(tmp_path, damage):
    st = _trained_state()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(st, step=3)
    path = mgr.path(3)
    if damage == "truncated":
        data = open(path, "rb").read()
        open(path, "wb").write(data[: len(data) // 2])
    elif damage == "garbage":
        open(path, "wb").write(b"\x00" * 64)
    else:
        payload = torch.load(path, weights_only=True)
        payload["params"]["conv_0.weight"] = torch.zeros(3, 3, 3)
        torch.save(payload, path)
    _m, _t, template = _state()
    with pytest.raises(RuntimeError) as err:
        mgr.restore(template)
    msg = str(err.value)
    assert msg.startswith(f"Checkpoint at step 3 in {mgr.directory} failed to restore")
    assert "likely corrupt or truncated; remove" in msg and path in msg


def test_orbax_only_directory_is_refused(tmp_path):
    """A run directory of the JAX package (orbax steps) is not misread,
    and train does not start fresh over it."""
    jmodel = JWav2Letter(JConfig(input_size=8, base_channels=16,
                                 wide_channels=32, num_body_layers=2))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 8)))["params"]
    import flax.linen as nn

    jtx = jmake_optimizer()
    jmgr = jcheckpoint.CheckpointManager(str(tmp_path))
    jmgr.save(jcreate(nn.meta.unbox(params), jtx, 1e-4), wait=True)
    jmgr.close()

    _m, _t, st = _state()
    mgr = CheckpointManager(str(tmp_path))
    for restore in (mgr.restore, mgr.restore_or_create):
        with pytest.raises(RuntimeError, match="orbax.*export --weights"):
            restore(st)


def test_export_weights_names_match_jax(tmp_path):
    model, _tx, st = _state(seed=3)
    written = export_weights(st.params, str(tmp_path / "torch"))
    got = sorted(os.path.relpath(p, tmp_path / "torch") for p in written)

    jparams = {
        f"conv_{i}": {"kernel": np.zeros(1), "bias": np.zeros(1)}
        for i in range(len(TINY.layer_specs))
    }
    jwritten = jcheckpoint.export_weights(jparams, str(tmp_path / "jax"))
    assert got == sorted(os.path.relpath(p, tmp_path / "jax") for p in jwritten)

    # read back: the same state dict
    fresh = Wav2Letter(TINY, generator=torch.Generator().manual_seed(9))
    loaded = load_weight_dir(str(tmp_path / "torch"), fresh)
    for name, value in model.state_dict().items():
        torch.testing.assert_close(loaded[name], value, rtol=0, atol=0)
    kernel = np.load(tmp_path / "torch" / "conv_0" / "kernel.npy")
    assert kernel.shape == (48, 8, 16)  # [W, I, O], the JAX layout
