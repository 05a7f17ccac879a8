"""The port's import of the reference's weights against the JAX package's.

The released ``best_run`` weights are a TF Saver checkpoint. The checkpoints
here are written with ``tf.compat.v1`` Saver as tests/test_compat.py writes
them (skipped where tensorflow is not installed), with extra variables:
an int64 global step, an int32 and a float64 variable, a bool one and a
partitioned (sliced) one. The port reads them with its own V2 tensor-bundle
reader (no tensorflow): its import equals JAX's ``import_tf_checkpoint``
and ``import_reference_weights`` bit for bit, its reader equals
``tf.train.load_checkpoint`` on every variable it reads and refuses the
others by name, a corrupted block CRC, a corrupted tensor (its own
CRC32C, where JAX's tensorflow raises its checksum error), a missing data
shard and a V1 single-file checkpoint raise, and ``evaluate --reference-weights <tf dir>``
decodes as the same weights exported as ``.npy`` do. The ``.npy`` export's
import and its errors equal JAX's too.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from speecht_tpu import compat as jcompat
from speecht_tpu_torch import compat
from speecht_tpu_torch.models.wav2letter import Wav2Letter, Wav2LetterConfig
from speecht_tpu_torch.weights import load_weight_dir, params_from_jax, params_to_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(48, 8, 16)] + [(7, 16, 16)] * 7 + [(32, 16, 32), (1, 32, 32), (1, 32, 29)]
CONFIG = Wav2LetterConfig(input_size=8, base_channels=16, wide_channels=32,
                          num_body_layers=7, compute_dtype="float32")


def _arrays(seed):
    rng = np.random.RandomState(seed)
    return {f"conv_{i}": (rng.randn(*s).astype(np.float32),
                          rng.randn(s[-1]).astype(np.float32))
            for i, s in enumerate(SHAPES)}


@pytest.fixture(scope="module")
def tf_ckpt(tmp_path_factory):
    tf = pytest.importorskip("tensorflow")
    directory = tmp_path_factory.mktemp("tf_ckpt")
    arrays = _arrays(3)
    graph = tf.Graph()
    with graph.as_default():  # a TF1-style Saver checkpoint needs a graph
        tf_vars = []
        for name, (k, b) in arrays.items():
            i = name.split("_")[1]
            tf_vars.append(tf.compat.v1.get_variable(
                f"convolution_layer_{i}/filters", initializer=k))
            tf_vars.append(tf.compat.v1.get_variable(
                f"convolution_layer_{i}/bias", initializer=b))
        tf_vars.append(tf.compat.v1.get_variable(
            "global_step", initializer=np.int64(123)))
        tf_vars.append(tf.compat.v1.get_variable(
            "counts", initializer=np.arange(5, dtype=np.int32)))
        tf_vars.append(tf.compat.v1.get_variable(
            "scale", initializer=np.linspace(0, 1, 3)))
        tf_vars.append(tf.compat.v1.get_variable(
            "flag", initializer=np.array([True, False])))
        tf_vars.append(tf.compat.v1.get_variable(
            "partitioned", shape=[4, 2], initializer=tf.compat.v1.ones_initializer(),
            partitioner=tf.compat.v1.fixed_size_partitioner(2)))
        saver = tf.compat.v1.train.Saver(var_list=tf_vars)
        init = tf.compat.v1.global_variables_initializer()
    with tf.compat.v1.Session(graph=graph) as sess:
        sess.run(init)
        saver.save(sess, str(directory / "speechT.ckpt"), global_step=123)
    return directory, arrays


def _template():
    return Wav2Letter(CONFIG).state_dict()


def _assert_tree_equal(state, tree):
    got = params_to_jax(state)
    assert set(got) == set(tree)
    for layer, leaves in tree.items():
        for leaf, value in leaves.items():
            np.testing.assert_array_equal(got[layer][leaf], value)


def _jax_params():
    return {f"conv_{i}": {"kernel": np.zeros(s, np.float32),
                          "bias": np.zeros(s[-1], np.float32)}
            for i, s in enumerate(SHAPES)}


def test_tf_import_equals_jax_bit_for_bit(tf_ckpt):
    directory, _arrays = tf_ckpt
    want = jcompat.import_tf_checkpoint(_jax_params(), str(directory))
    _assert_tree_equal(compat.import_tf_checkpoint(_template(), str(directory)), want)
    # the checkpoint's prefix itself, as JAX allows
    prefix = str(directory / "speechT.ckpt-123")
    _assert_tree_equal(compat.import_tf_checkpoint(_template(), prefix), want)
    _assert_tree_equal(
        compat.import_reference_weights(_template(), str(directory)),
        jcompat.import_reference_weights(_jax_params(), str(directory)),
    )
    # weights.load_weight_dir routes the directory to it (evaluate and
    # record --reference-weights)
    _assert_tree_equal(load_weight_dir(str(directory), Wav2Letter(CONFIG)), want)


def test_reader_equals_tf_on_every_variable(tf_ckpt):
    tf = pytest.importorskip("tensorflow")
    directory, _arrays = tf_ckpt
    ours = compat.load_checkpoint(str(directory))
    theirs = tf.train.load_checkpoint(str(directory))
    assert ours.get_variable_to_shape_map() == theirs.get_variable_to_shape_map()
    read = 0
    for name in theirs.get_variable_to_shape_map():
        if name in ("flag", "partitioned"):
            continue
        got, want = ours.get_tensor(name), theirs.get_tensor(name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        read += 1
    assert read == 2 * len(SHAPES) + 3
    assert ours.get_tensor("global_step").dtype == np.int64
    assert int(ours.get_tensor("global_step")) == 123


@pytest.mark.parametrize("name,match", [("flag", "DT_BOOL"), ("partitioned", "sliced")])
def test_reader_refuses_other_dtypes_and_slices_by_name(tf_ckpt, name, match):
    directory, _arrays = tf_ckpt
    with pytest.raises(ValueError, match=f"variable {name} .*{match}"):
        compat.load_checkpoint(str(directory)).get_tensor(name)


def _copy(tf_ckpt, tmp_path):
    directory, _arrays = tf_ckpt
    out = tmp_path / "ckpt"
    shutil.copytree(directory, out)
    with open(out / "checkpoint", "w") as f:  # Saver wrote an absolute path
        f.write('model_checkpoint_path: "speechT.ckpt-123"\n')
    return out


def test_corrupt_index_block_fails_its_crc(tf_ckpt, tmp_path):
    out = _copy(tf_ckpt, tmp_path)
    index = out / "speechT.ckpt-123.index"
    data = bytearray(index.read_bytes())
    data[20] ^= 0x01  # a key byte of the first block
    index.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC32C"):
        compat.import_tf_checkpoint(_template(), str(out))


def test_corrupt_data_shard_fails_its_tensor_crc(tf_ckpt, tmp_path):
    """A byte flipped in the middle of the data shard: TF's reader (JAX's
    import) raises its checksum error (an ``OpError``; ``DataLossError``
    in some TF versions), the port's ValueError naming the variable that
    holds the byte. The stored CRC is masked as TF's
    ``crc32c::Mask``: the good checkpoint's tensors all pass."""
    tf = pytest.importorskip("tensorflow")
    out = _copy(tf_ckpt, tmp_path)
    shard = out / "speechT.ckpt-123.data-00000-of-00001"
    data = bytearray(shard.read_bytes())
    middle = len(data) // 2
    entries = compat.load_checkpoint(str(out)).entries.values()
    (hit,) = [e.name for e in entries if e.offset <= middle < e.offset + e.size]
    data[middle] ^= 0x10
    shard.write_bytes(bytes(data))
    with pytest.raises(tf.errors.OpError, match="Checksum does not match"):
        jcompat.import_tf_checkpoint(_jax_params(), str(out))
    with pytest.raises(ValueError, match=f"variable {hit} in checkpoint data shard "
                       f".*{shard.name} fails its CRC32C check"):
        compat.import_tf_checkpoint(_template(), str(out))


def test_missing_data_shard_raises(tf_ckpt, tmp_path):
    out = _copy(tf_ckpt, tmp_path)
    os.remove(out / "speechT.ckpt-123.data-00000-of-00001")
    with pytest.raises(FileNotFoundError, match="data shard"):
        compat.import_tf_checkpoint(_template(), str(out))


def test_v1_single_file_and_missing_checkpoint_raise(tmp_path):
    v1 = tmp_path / "model.ckpt"
    v1.write_bytes(b"\0" * 64)
    with pytest.raises(ValueError, match="V1"):
        compat.import_tf_checkpoint(_template(), str(v1))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="Couldn't find 'checkpoint' file"):
        compat.import_tf_checkpoint(_template(), str(empty))


def test_shape_mismatch_and_missing_layers_raise_jax_errors(tf_ckpt, tmp_path):
    directory, _arrays = tf_ckpt
    small = Wav2Letter(Wav2LetterConfig(input_size=8, base_channels=12,
                                        wide_channels=32, num_body_layers=7)).state_dict()
    # the reference's [W, I, O] layout in the message, as JAX's
    with pytest.raises(ValueError, match=r"shape mismatch for conv_0/(kernel: "
                       r"model \(48, 8, 12\) vs ckpt \(48, 8, 16\)|bias: "
                       r"model \(12,\) vs ckpt \(16,\))"):
        compat.import_tf_checkpoint(small, str(directory))
    shallow = Wav2Letter(Wav2LetterConfig(input_size=8, base_channels=16,
                                          wide_channels=32, num_body_layers=2)).state_dict()
    with pytest.raises(KeyError, match=r"reference layer conv_(5|6|7|8|9|10) not present"):
        compat.import_tf_checkpoint(shallow, str(directory))


def _write_npy_export(directory, arrays):
    for name, (k, b) in arrays.items():
        d = directory / f"convolution_layer_{name.split('_')[1]}"
        d.mkdir(parents=True)
        np.save(d / "filters:0.npy", k)
        np.save(d / "bias:0.npy", b)


def test_npy_export_import_and_errors_equal_jax(tmp_path):
    arrays = _arrays(4)
    _write_npy_export(tmp_path / "export", arrays)
    got = compat.import_reference_weights(_template(), str(tmp_path / "export"))
    _assert_tree_equal(got, jcompat.import_reference_weights(
        _jax_params(), str(tmp_path / "export")))
    shutil.rmtree(tmp_path / "export" / "convolution_layer_5")
    with pytest.raises(KeyError) as ours:
        compat.import_reference_weights(_template(), str(tmp_path / "export"))
    with pytest.raises(KeyError) as theirs:
        jcompat.import_reference_weights(_jax_params(), str(tmp_path / "export"))
    assert str(ours.value) == str(theirs.value)
    assert compat.reference_name_to_param_path("convolution_layer_10/bias") == (
        jcompat.reference_name_to_param_path("convolution_layer_10/bias"))
    assert compat.load_reference_export(str(tmp_path / "export")).keys() == (
        jcompat.load_reference_export(str(tmp_path / "export")).keys())


def test_evaluate_reference_weights_reads_the_tf_checkpoint(tf_ckpt, tmp_path):
    """``python -m speecht_tpu_torch evaluate --reference-weights <tf dir>``
    decodes exactly as the same arrays exported as ``.npy`` do."""
    directory, arrays = tf_ckpt
    _write_npy_export(tmp_path / "npy", arrays)
    rng = np.random.RandomState(0)
    d = tmp_path / "data" / "preprocessed-power" / "test"
    d.mkdir(parents=True)
    for i in range(4):
        np.savez(d / f"utt{i}",
                 audio_fragments=rng.randn(rng.randint(40, 90), 8).astype(np.float32),
                 transcript=rng.randint(0, 28, size=5).astype(np.int64))

    def run(weights):
        proc = subprocess.run(
            [sys.executable, "-m", "speecht_tpu_torch", "evaluate", "--device", "cpu",
             "--test", "--no-save", "--data-dir", str(tmp_path / "data"),
             "--train-dir", str(tmp_path / "train"), "--log-dir", str(tmp_path / "log"),
             "--batch-size", "4", "--compute-dtype", "float32",
             "--transfer-dtype", "float32", "--base-channels", "16",
             "--wide-channels", "32", "--reference-weights", str(weights)],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
        )
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
        lines = proc.stdout.splitlines()
        # the shuffle is unseeded: the batch's rows come in another order
        return (sorted(ln for ln in lines if ln.startswith("decoded:")),
                [float(ln.split()[3]) for ln in lines
                 if ln.startswith("validation average loss")])

    decoded, losses = run(directory)
    assert len(decoded) == 4 and len(losses) == 1
    want_decoded, want_losses = run(tmp_path / "npy")
    assert decoded == want_decoded
    assert losses == pytest.approx(want_losses, rel=1e-6)
