"""The port's serving artifact and ``export`` against the JAX package's.

One set of seeded weights (a few layers, narrow widths, float32 compute)
goes to both packages through ``weights.params_from_jax``:

- the ``torch.export`` program (cpu) from one polymorphic artifact, at
  two batch sizes and two even frame counts, against JAX's
  ``make_infer_fn`` under ``jax.jit``: logits within 1e-4 (the tolerance
  of ``test_torch_wav2letter.py``, float32 convolutions summed in another
  order), ids and lengths equal except on rows with a near tie (a frame
  whose two best logits lie within 1e-3);
- the from-audio program at ``wire_sr`` None and 16000 against
  ``make_audio_infer_fn``, to 1e-3 + 1e-3 x |value| on the logits (the
  features' float32 FFT and mel sums in another order, through the
  normalisation; the front end's own test holds features to 1e-3);
- the bf16 program against the port's eager eval step: bit-equal;
- the manifest's keys against JAX's; fixed shapes; the flags' refusals
  (odd frames, samples off the granularity, ``tpu``, ``cuda`` without a
  card, ``SPEECHT_PALLAS_CONV0=1``); ``export --weights`` writing JAX's
  file names and values; the whole ``export`` command on a port
  checkpoint. Each export traces the model once (a few seconds).
"""

import json
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speecht_tpu import serving as jserving
from speecht_tpu.models import wav2letter as jw2l
from speecht_tpu.train.checkpoint import export_weights as jax_export_weights
from speecht_tpu_torch import serving
from speecht_tpu_torch.cli import CLI
from speecht_tpu_torch.models import wav2letter
from speecht_tpu_torch.train import step as tstep
from speecht_tpu_torch.train.checkpoint import CheckpointManager, export_weights
from speecht_tpu_torch.train.state import create_train_state, make_optimizer
from speecht_tpu_torch.weights import params_from_jax

WIDTHS = dict(input_size=128, base_channels=16, wide_channels=32, num_body_layers=2)
NEAR_TIE = 1e-3


def _params(compute_dtype):
    cfg = jw2l.Wav2LetterConfig(compute_dtype=compute_dtype, **WIDTHS)
    tree = nn.meta.unbox(jw2l.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(0)
    tree = {
        layer: {
            "kernel": np.asarray(leaves["kernel"]),
            "bias": rng.randn(*leaves["bias"].shape).astype(np.float32) * 0.1,
        }
        for layer, leaves in tree.items()
    }
    model = wav2letter.Wav2Letter(
        wav2letter.Wav2LetterConfig(compute_dtype=compute_dtype, **WIDTHS)
    )
    model.load_state_dict(params_from_jax(tree))
    return jw2l.Wav2Letter(cfg), tree, model.eval()


@pytest.fixture(scope="module")
def models():
    return _params("float32")


def _near_tie_rows(logits, lengths):
    """Rows with a valid frame whose two best logits are within NEAR_TIE."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    close = (top2[..., 1] - top2[..., 0]) < NEAR_TIE
    valid = np.arange(logits.shape[1])[None] < lengths[:, None]
    return (close & valid).any(axis=1)


def _check_against_jax(got, want, out_lengths):
    ids, lens, logits = (t.numpy() for t in got)
    jids, jlens, jlogits = (np.asarray(w) for w in want)
    assert ids.shape == jids.shape and logits.shape == jlogits.shape
    np.testing.assert_allclose(logits, jlogits, rtol=1e-4, atol=1e-4)
    ties = _near_tie_rows(jlogits, out_lengths)
    np.testing.assert_array_equal(ids[~ties], jids[~ties])
    np.testing.assert_array_equal(lens[~ties], jlens[~ties])


def test_polymorphic_program_matches_jax(models, tmp_path):
    """One artifact serves two batch sizes and two frame counts."""
    jmodel, tree, model = models
    out = str(tmp_path / "artifact")
    manifest = serving.export_stablehlo(model, out, feature_type="power",
                                        platforms=("cpu",))
    assert manifest["batch_size"] == "dynamic"
    assert manifest["artifact"] == {"cpu": "wav2letter_greedy.cpu.pt2"}
    assert os.path.getsize(os.path.join(out, "wav2letter_greedy.cpu.pt2")) == \
        manifest["bytes"]["cpu"]
    program, loaded = serving.load_stablehlo(out, "cpu")
    assert loaded == json.loads(json.dumps(manifest))
    jinfer = jax.jit(jserving.make_infer_fn(jmodel))
    rng = np.random.RandomState(1)
    for b, t in ((3, 64), (5, 150)):
        feats = rng.randn(b, t, 128).astype(np.float32)
        lens = rng.randint(t // 2, t + 1, size=b).astype(np.int32)
        got = program(torch.from_numpy(feats), torch.from_numpy(lens))
        want = jinfer(tree, jnp.asarray(feats), jnp.asarray(lens))
        _check_against_jax(got, want, lens // 2)


@pytest.mark.parametrize("wire_sr", [None, 16000])
def test_from_audio_program_matches_jax(models, tmp_path, wire_sr):
    jmodel, tree, model = models
    out = str(tmp_path / "artifact")
    manifest = serving.export_stablehlo(model, out, feature_type="power",
                                        from_audio=True, wire_sr=wire_sr,
                                        platforms=("cpu",))
    gran = manifest["audio_granularity_samples"]
    assert gran == jserving._audio_granularity(wire_sr)
    assert manifest["wire_sr"] == (wire_sr or 22050)
    program, _ = serving.load_stablehlo(out, "cpu")
    jinfer = jax.jit(jserving.make_audio_infer_fn(jmodel, "power", wire_sr=wire_sr))
    rng = np.random.RandomState(2)
    for b, units in ((2, 40), (3, 57)):
        S = gran * units
        audio = (rng.randn(b, S) * 3000).astype(np.int16)
        lens = rng.randint(S // 2, S + 1, size=b).astype(np.int32)
        ids, dec_lens, logits = (
            t.numpy() for t in program(torch.from_numpy(audio), torch.from_numpy(lens))
        )
        jids, jlens, jlogits = (np.asarray(w) for w in jinfer(tree, audio, lens))
        # the manifest's shape contract: T' = ceil(frames / 2)
        frames = 1 + (S * 22050 // (wire_sr or 22050)) // 160
        assert logits.shape == jlogits.shape == (b, (frames + 1) // 2, 29)
        np.testing.assert_allclose(logits, jlogits, rtol=1e-3, atol=1e-3)
        ties = _near_tie_rows(jlogits, np.full(b, logits.shape[1]))
        np.testing.assert_array_equal(ids[~ties], jids[~ties])
        np.testing.assert_array_equal(dec_lens[~ties], jlens[~ties])


def test_bf16_program_equals_the_eager_eval_step(tmp_path):
    """bf16 compute with float32 parameters survives the export: the
    program's ids equal the port's eager eval step's, its logits the
    model's, bit for bit."""
    _jmodel, _tree, model = _params("bfloat16")
    out = str(tmp_path / "artifact")
    serving.export_stablehlo(model, out, feature_type="power", platforms=("cpu",))
    program, _ = serving.load_stablehlo(out, "cpu")
    rng = np.random.RandomState(3)
    feats = torch.from_numpy(rng.randn(4, 96, 128).astype(np.float32))
    lens = torch.tensor([96, 70, 50, 0], dtype=torch.int32)
    ids, dec_lens, logits = program(feats, lens)
    with torch.inference_mode():
        want_logits = model(feats)
    torch.testing.assert_close(logits, want_logits, rtol=0, atol=0)
    from speecht_tpu_torch.ops import decode

    want_ids, want_lens, _ = decode.greedy_decode(want_logits, lens // 2)
    torch.testing.assert_close(ids, want_ids, rtol=0, atol=0)
    torch.testing.assert_close(dec_lens, want_lens, rtol=0, atol=0)


def test_fixed_shapes_and_manifest_keys(models, tmp_path):
    jmodel, tree, model = models
    ours = serving.export_stablehlo(model, str(tmp_path / "ours"), feature_type="power",
                                    batch_size=2, frames=64, platforms=("cpu",))
    theirs = jserving.export_stablehlo(jmodel, tree, str(tmp_path / "theirs"),
                                       feature_type="power", batch_size=2, frames=64,
                                       platforms=("cpu",))
    assert set(ours) == (set(theirs) - {"jax_version", "calling_convention_version"}
                         ) | {"torch_version", "conv0_path"}
    for key in ("batch_size", "frames", "input_size", "num_classes", "alphabet",
                "blank_id", "inputs", "outputs", "feature_type", "from_audio"):
        assert ours[key] == theirs[key], key
    program, _ = serving.load_stablehlo(str(tmp_path / "ours"), "cpu")
    feats = torch.zeros(2, 64, 128)
    assert program(feats, torch.full((2,), 64, dtype=torch.int32))[0].shape == (2, 32)
    with pytest.raises(Exception):
        program(torch.zeros(3, 64, 128), torch.full((3,), 64, dtype=torch.int32))


def test_from_audio_manifest_keys(models, tmp_path):
    jmodel, tree, model = models
    ours = serving.export_stablehlo(model, str(tmp_path / "ours"), feature_type="power",
                                    from_audio=True, frames=320 * 16, batch_size=1,
                                    platforms=("cpu",))
    theirs = jserving.export_stablehlo(jmodel, tree, str(tmp_path / "theirs"),
                                       feature_type="power", from_audio=True,
                                       frames=320 * 16, batch_size=1, platforms=("cpu",))
    assert set(ours) == (set(theirs) - {"jax_version", "calling_convention_version"}
                         ) | {"torch_version", "conv0_path"}
    for key in ("wire_sr", "audio_granularity_samples", "min_audio_samples",
                "inputs", "outputs", "frames"):
        assert ours[key] == theirs[key], key


@pytest.mark.parametrize(
    "kwargs,error,match",
    [
        (dict(frames=33), ValueError, "--export-frames must be even"),
        (dict(from_audio=True, frames=321), ValueError, "320-sample granularity"),
        (dict(from_audio=True, wire_sr=16000, frames=321), ValueError,
         "320-sample granularity"),
        (dict(platforms=("tpu", "cpu")), ValueError, "'tpu' is not a platform"),
        (dict(platforms=()), ValueError, "names no platform"),
    ],
)
def test_refusals(models, tmp_path, kwargs, error, match):
    _jmodel, _tree, model = models
    kwargs = {"platforms": ("cpu",), **kwargs}
    with pytest.raises(error, match=match):
        serving.export_stablehlo(model, str(tmp_path / "x"), feature_type="power",
                                 **kwargs)
    assert not (tmp_path / "x").exists() or not os.listdir(tmp_path / "x")


def test_jax_refuses_the_same_frames(models, tmp_path):
    """The messages are JAX's: its export refuses the same values."""
    jmodel, tree, _model = models
    with pytest.raises(ValueError, match="--export-frames must be even"):
        jserving.export_stablehlo(jmodel, tree, str(tmp_path / "x"),
                                  feature_type="power", frames=33)


def test_cuda_platform_without_a_card_raises(models, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is a platform here")
    _jmodel, _tree, model = models
    with pytest.raises(RuntimeError, match="--export-platforms cuda: no CUDA device"):
        serving.export_stablehlo(model, str(tmp_path / "x"), feature_type="power")


def test_conv0_kernel_path_refuses_to_export(models, tmp_path, monkeypatch):
    _jmodel, _tree, model = models
    monkeypatch.setenv("SPEECHT_PALLAS_CONV0", "1")
    with pytest.raises(RuntimeError, match="SPEECHT_PALLAS_CONV0=1"):
        serving.export_stablehlo(model, str(tmp_path / "x"), feature_type="power",
                                 platforms=("cpu",))


def test_export_weights_writes_jax_files(models, tmp_path):
    _jmodel, tree, model = models
    ours = export_weights(dict(model.named_parameters()), str(tmp_path / "ours"))
    theirs = jax_export_weights(tree, str(tmp_path / "theirs"))
    rel = lambda paths, root: sorted(os.path.relpath(p, root) for p in paths)  # noqa: E731
    assert rel(ours, tmp_path / "ours") == rel(theirs, tmp_path / "theirs")
    for name in rel(ours, tmp_path / "ours"):
        a, b = np.load(tmp_path / "ours" / name), np.load(tmp_path / "theirs" / name)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _write_checkpoint(model, train_dir):
    state = create_train_state(dict(model.named_parameters()), make_optimizer(), 1e-4)
    CheckpointManager(train_dir).save(state, step=3)


def _export_argv(tmp_path, *extra):
    return [
        "export", "--train-dir", str(tmp_path / "train"), "--run-name", "r",
        "--data-dir", str(tmp_path / "data"), "--log-dir", str(tmp_path / "log"),
        "--base-channels", "16", "--wide-channels", "32", "--num-body-layers", "2",
        *extra,
    ]


def test_export_command_on_a_port_checkpoint(models, tmp_path, capsys):
    """``export --device cpu --export-platforms cpu --weights --stablehlo``
    restores the port checkpoint; the weights and the program are the
    model's."""
    _jmodel, tree, model = models
    _write_checkpoint(model, str(tmp_path / "train" / "r"))
    results = CLI(_export_argv(
        tmp_path, "--device", "cpu", "--export-platforms", "cpu",
        "--weights", str(tmp_path / "w"), "--stablehlo", str(tmp_path / "a"),
    )).run()
    out = capsys.readouterr().out
    assert "Exported 12 arrays" in out and "platforms ['cpu']" in out
    assert results[-1]["platforms"] == ["cpu"]
    np.testing.assert_array_equal(
        np.load(tmp_path / "w" / "conv_0" / "kernel.npy"), tree["conv_0"]["kernel"]
    )
    program, _ = serving.load_stablehlo(str(tmp_path / "a"), "cpu")
    feats = torch.from_numpy(np.random.RandomState(4).randn(2, 64, 128).astype(np.float32))
    lens = torch.tensor([64, 40], dtype=torch.int32)
    # the command's model computes in bf16 (the default --compute-dtype)
    bf16 = wav2letter.Wav2Letter(wav2letter.Wav2LetterConfig(**WIDTHS))
    bf16.load_state_dict(params_from_jax(tree))
    want = tstep.make_forward_step(bf16.eval())(feats)
    torch.testing.assert_close(program(feats, lens)[2], want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="no program for cuda"):
        serving.load_stablehlo(str(tmp_path / "a"), "cuda")


def test_export_errors_are_one_line(models, tmp_path, capsys):
    """``main`` prints a missing card and a refused flag as one line."""
    from speecht_tpu_torch.cli import main

    _jmodel, _tree, model = models
    _write_checkpoint(model, str(tmp_path / "train" / "r"))
    runs = [(["--device", "cpu", "--export-platforms", "cpu", "--export-frames", "33",
              "--stablehlo", str(tmp_path / "a")],
             "error: --export-frames must be even (stride-2 first conv); got 33")]
    if not torch.cuda.is_available():
        runs += [(["--weights", str(tmp_path / "w")],
                  "error: --device cuda: no CUDA device is available "
                  "(pass --device cpu to run on the CPU)"),
                 (["--device", "cpu", "--stablehlo", str(tmp_path / "a")],
                  "error: --export-platforms cuda: no CUDA device is available "
                  "(pass --export-platforms cpu to export for the CPU alone)")]
    for flags, line in runs:
        with pytest.raises(SystemExit):
            main(_export_argv(tmp_path, *flags))
        assert capsys.readouterr().err.strip().splitlines() == [line]
