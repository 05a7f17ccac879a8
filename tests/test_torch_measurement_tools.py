"""The port's measurement tools (``speecht_tpu_torch/tools/``:
``arpa_to_kenlm_binary``, ``layer_breakdown``, ``perf_probe``,
``device_beam_probe``, ``pipeline_soak``) against the repo's ``tools/``
scripts and the JAX package, on the CPU at narrow widths:

- the converter writes the bytes JAX's converter writes, and both print
  their usage and return 1 on a wrong argument count;
- ``prefix_forward`` for every k against JAX's prefix (float32, atol
  1e-5), the 11-layer prefix against the model, ``flops_layer`` against
  JAX's formula at the full width (1615.89 GFLOP at B=64, T=1024);
- ``synth_arpa`` byte-equal to JAX's; ``write_cache`` equal to JAX's
  draws; two soak loops from one state agree bit for bit, one with
  nothing read back and one reading the loss back after each step;
- the perf probe's device part (loss, collapsed log-probs and lengths)
  against JAX's ``make_loss_fn`` + ``blank_collapse`` (1e-5);
- each tool's ``main`` on the CPU prints its lines, and raises on
  ``--device cuda`` without a card.

``tools/layer_breakdown.py`` and ``tools/pipeline_soak.py`` do their work
at import, so the parts compared here are copied from them, each with its
source named.
"""

import copy
import importlib.util
import os
import random
import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speecht_tpu.data.pipeline import Batch as JaxBatch
from speecht_tpu.models import wav2letter as jw2l
from speecht_tpu.ops import decode as jdecode
from speecht_tpu.train import step as jstep
from speecht_tpu_torch.data import reader
from speecht_tpu_torch.models import wav2letter
from speecht_tpu_torch.tools import (
    arpa_to_kenlm_binary,
    device_beam_probe,
    layer_breakdown,
    perf_probe,
    pipeline_soak,
)
from speecht_tpu_torch.train import step as tstep
from speecht_tpu_torch.weights import params_from_jax
from test_beam import ARPA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = dict(input_size=128, base_channels=16, wide_channels=32)
NARROW = ["--base-channels", "16", "--wide-channels", "32", "--num-body-layers", "2"]
PREFIX_ATOL = 1e-5
DEVICE_PART_TOL = 1e-5


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# -- arpa_to_kenlm_binary ------------------------------------------------


def test_converter_writes_jax_bytes(tmp_path, capsys):
    arpa = tmp_path / "model.arpa"
    arpa.write_text(ARPA)
    jax_tool = _jax_tool("arpa_to_kenlm_binary")
    assert jax_tool.main([str(arpa), str(tmp_path / "jax.binary")]) == 0
    assert arpa_to_kenlm_binary.main([str(arpa), str(tmp_path / "port.binary")]) == 0
    assert f"wrote {tmp_path / 'port.binary'}" in capsys.readouterr().out
    assert (tmp_path / "port.binary").read_bytes() == (tmp_path / "jax.binary").read_bytes()


@pytest.mark.parametrize("argv", [[], ["only.arpa"], ["a", "b", "c"]])
def test_converter_usage_on_wrong_argument_count(argv, capsys):
    assert _jax_tool("arpa_to_kenlm_binary").main(argv) == 1
    assert "Usage:" in capsys.readouterr().out
    assert arpa_to_kenlm_binary.main(argv) == 1
    out = capsys.readouterr().out
    assert "Usage: python -m speecht_tpu_torch.tools.arpa_to_kenlm_binary model.arpa " \
        "kenlm-model.binary" in out


# -- layer_breakdown -----------------------------------------------------


def jax_partial_forward(cfg, k):
    """``tools/layer_breakdown.py:24-40`` (``partial_forward``) verbatim
    but for ``cfg``, a global there."""
    @jax.jit
    def fwd(p, x):
        y = x
        dtype = jnp.dtype(cfg.compute_dtype)
        for i, (w, s, f, relu) in enumerate(cfg.layer_specs[:k]):
            pr = p[f"conv_{i}"]
            y = jax.lax.conv_general_dilated(
                y.astype(dtype), pr["kernel"].astype(dtype),
                window_strides=(s,), padding="SAME",
                dimension_numbers=("NWC", "WIO", "NWC"))
            y = y + pr["bias"].astype(dtype)
            if relu:
                y = jnp.maximum(y, 0.0)
            y = y.astype(dtype)
        return y.astype(jnp.float32)
    return fwd


def jax_flops_layer(cfg, B, T, F, i):
    """``tools/layer_breakdown.py:42-51`` (``flops_layer``) verbatim but
    for ``cfg``, ``B``, ``T`` and ``F``, globals there."""
    t = T
    cin = F
    for j, (w, s, cout, _r) in enumerate(cfg.layer_specs):
        t //= s
        fl = 2.0 * B * t * w * cin * cout
        if j == i:
            return fl
        cin = cout
    return 0.0


@pytest.fixture(scope="module")
def narrow():
    """(JAX config, params with non-zero biases, port model, features
    [2, 67, 128]) in float32."""
    cfg = jw2l.Wav2LetterConfig(compute_dtype="float32", **WIDTHS)
    tree = nn.meta.unbox(jw2l.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(0)
    params = {
        layer: {"kernel": np.asarray(leaves["kernel"]),
                "bias": rng.randn(*leaves["bias"].shape).astype(np.float32) * 0.1}
        for layer, leaves in tree.items()
    }
    model = wav2letter.Wav2Letter(wav2letter.Wav2LetterConfig(compute_dtype="float32", **WIDTHS))
    model.load_state_dict(params_from_jax(params))
    x = rng.randn(2, 67, 128).astype(np.float32)
    return cfg, params, model.eval(), x


@pytest.mark.parametrize("k", range(1, 12))
def test_prefix_forward_matches_jax(narrow, k):
    cfg, params, model, x = narrow
    want = np.asarray(jax_partial_forward(cfg, k)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = layer_breakdown.prefix_forward(model, torch.from_numpy(x), k)
    assert got.dtype == torch.float32
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PREFIX_ATOL)
    if k == 11:
        with torch.no_grad():
            assert torch.equal(got, model(torch.from_numpy(x)))


@pytest.mark.parametrize("i", range(11))
def test_flops_layer_matches_jax(i):
    cfg = wav2letter.Wav2LetterConfig()
    want = jax_flops_layer(jw2l.Wav2LetterConfig(), 64, 1024, 128, i)
    assert layer_breakdown.flops_layer(cfg, 64, 1024, i) == want
    total = sum(layer_breakdown.flops_layer(cfg, 64, 1024, j) for j in range(11))
    assert round(total / 1e9, 2) == 1615.89


# -- device_beam_probe ---------------------------------------------------


def test_synth_arpa_byte_equal_to_jax(tmp_path):
    _jax_tool("device_beam_probe").synth_arpa(str(tmp_path / "jax.arpa"), 300, 800, 400)
    device_beam_probe.synth_arpa(str(tmp_path / "port.arpa"), 300, 800, 400)
    assert (tmp_path / "port.arpa").read_bytes() == (tmp_path / "jax.arpa").read_bytes()


# -- pipeline_soak -------------------------------------------------------


def jax_cache_draws(n):
    """``tools/pipeline_soak.py:18-25``'s draws (its loop writes each pair
    with ``np.savez``)."""
    rng = np.random.RandomState(0)
    out = []
    for i in range(n):
        T = int(rng.randint(400, 560))
        out.append((rng.randn(T, 128).astype(np.float32),
                    rng.randint(0, 28, size=rng.randint(30, 90)).astype(np.int32)))
    return out


def test_write_cache_matches_jax_draws(tmp_path):
    cache = pipeline_soak.write_cache(str(tmp_path), n=6)
    assert cache == str(tmp_path / "preprocessed-power" / "train")
    assert sorted(os.listdir(cache)) == sorted(f"utt-{i}.npz" for i in range(6))
    for i, (feats, labels) in enumerate(jax_cache_draws(6)):
        with np.load(os.path.join(cache, f"utt-{i}.npz")) as got:
            np.testing.assert_array_equal(got["audio_fragments"], feats)
            np.testing.assert_array_equal(got["transcript"], labels)
            assert got["transcript"].dtype == np.int32


def _soak_args(device="cpu"):
    return pipeline_soak.parse_args(["--device", device, "--batch-size", "4", *NARROW])


def test_soak_loop_without_readback_equals_one_with_it(tmp_path, monkeypatch):
    """The tool's loop reads nothing back; the same steps reading the loss
    back after each one give the same bits. The reader's shuffle is
    seeded so both see the same batches."""
    monkeypatch.setattr(reader, "random", types.SimpleNamespace(
        Random=lambda seed=None: random.Random(0 if seed is None else seed)))
    pipeline_soak.write_cache(str(tmp_path), n=8)
    flags = pipeline_soak.soak_flags(str(tmp_path), _soak_args())
    got = pipeline_soak.soak(flags, steps=4, warmup=1)
    assert got["n_timed"] == 3 and got["last_step"] == 3
    assert float(got["acc"]["count"]) == 4.0
    assert np.isfinite(got["loss"]) and got["ms_per_step"] > 0

    t = pipeline_soak.Training(flags)
    t.model.to(t.device).train()
    state, tx = pipeline_soak.init_state(t.model, flags)
    train_step = tstep.make_train_step_acc(t.model, tx, mesh=t.mesh)
    acc = tstep.init_metrics_acc(t.device)
    losses = []
    for i, (_host, batch) in enumerate(t.create_loader()):
        state, acc = train_step(state, acc, batch)
        losses.append(float(acc["loss_sum"]))
        if i == 3:
            break
    assert torch.equal(acc["loss_sum"], got["acc"]["loss_sum"])
    for name, p in state.params.items():
        assert torch.equal(p, got["state"].params[name]), name
    assert all(np.isfinite(losses))


# -- perf_probe ----------------------------------------------------------


def test_device_part_matches_jax(narrow):
    """``make_loss_fn`` + ``blank_collapse(..., 0.999)`` as
    ``tools/perf_probe.py:54-60`` composes them, on the probe's inputs at
    B=2, T=64 (labels 12 of 16). The last layer's kernel is scaled and
    the blank's bias raised so that the collapse drops some frames."""
    cfg, params, model, _x = narrow
    inputs = perf_probe.make_inputs(2, 128, "cpu")
    batch = inputs["device_part"]
    jparams = dict(params, conv_10={
        "kernel": params["conv_10"]["kernel"] * np.float32(40.0),
        "bias": params["conv_10"]["bias"] + np.eye(29, dtype=np.float32)[28] * 10.5,
    })
    model = copy.deepcopy(model)
    model.load_state_dict(params_from_jax(jparams))
    loss, logp, lengths = perf_probe.make_device_part(model)(batch)
    jbatch = JaxBatch(**{f: jnp.asarray(getattr(batch, f).numpy()) for f in
                         ("features", "seq_lengths", "labels", "label_lengths")})
    want_loss, logits = jstep.make_loss_fn(jw2l.Wav2Letter(cfg))(jparams, jbatch)
    want_logp, want_len = jdecode.blank_collapse(
        logits, jw2l.output_length(jbatch.seq_lengths), 0.999)
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(want_len))
    assert 0 < int(lengths.sum()) < 2 * 32
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=DEVICE_PART_TOL)
    np.testing.assert_allclose(logp.numpy(), np.asarray(want_logp),
                               rtol=DEVICE_PART_TOL, atol=DEVICE_PART_TOL)


# -- each tool's main ----------------------------------------------------


MAINS = {
    "layer_breakdown": (layer_breakdown.main,
                        ["--batch", "2", "--frames", "64", *NARROW],
                        ["layer breakdown on cpu", "conv_0", "conv_5",
                         "6-layer prefix (the whole forward)"]),
    "perf_probe": (perf_probe.main,
                   ["--batch", "2", "--frames", "128", "--iters", "2", *NARROW],
                   ["greedy_eval B2T128:", "forward_only B2T128:",
                    "beam_device_part B2T64:", "collapsed shape (2, 32, 29)",
                    "cpu_count", "host beam 1 utt:", "device_part+fetch logp:",
                    "frontend B2 20k-samples:"]),
    "device_beam_probe": (device_beam_probe.main,
                          ["--uni", "300", "--bi", "800", "--tri", "400", "--batch", "2",
                           "--frames", "12", "--width", "8"],
                          ["synth ARPA write", "DeviceLM build", "first call:",
                           "trial 0:", "trial 2:", "utt/s"]),
    "pipeline_soak": (pipeline_soak.main,
                      ["--utterances", "8", "--batch-size", "4", "--steps", "3",
                       "--warmup", "1", *NARROW],
                      ["sustained pipeline step:", "ms over 2 steps",
                       "loss after 2 steps:"]),
}


@pytest.mark.parametrize("name", sorted(MAINS))
def test_main_prints_its_lines_on_the_cpu(name, capsys):
    main, argv, lines = MAINS[name]
    assert main(["--device", "cpu", *argv]) == 0
    out = capsys.readouterr().out
    for line in lines:
        assert line in out, (line, out)


@pytest.mark.parametrize("name", sorted(MAINS))
def test_main_raises_on_cuda_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, argv, _lines = MAINS[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--device", "cuda", *argv])
