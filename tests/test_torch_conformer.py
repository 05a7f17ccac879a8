"""The port's Conformer-CTC (``models/conformer.py``) on the CPU, at a tiny
size, against a plain float32 reference written apart from it
(``tests/conformer_reference.py``).

Tiny: d = 32, 2 heads, FFN 64, 2 blocks, depthwise kernel 8, 8
subsampling channels, 8 features, compute in float32, dropout 0, seeded
random weights (every bias, norm and position bias moved off its start).
Tolerances, float32 on both sides: the same products summed in other
orders (the SDPA core against einsums and a softmax, a strided shift
against ESPnet's pad-and-reshape), so 1e-5 on values of order 1; a
leaf's gradient within 1e-4 of the larger of its norm and the median
leaf's (the depthwise biases' gradients are nought to rounding: BatchNorm
takes a channel's mean away).

Then the normal path: one ``make_train_step_acc`` step through clip +
Adam, padding and zero-length rows, ``output_length``, the attention
counter, ``train --model conformer`` and ``evaluate`` (greedy and with
``--language-model``) through the CLI, the
checkpoint's BatchNorm statistics, two data-parallel ranks, and each path
that refuses the Conformer.
"""

import dataclasses
import math
import os

import numpy as np
import pytest
import torch

import conformer_reference as ref
import torch_parallel_workers as workers
from speecht_tpu_torch import serving
from speecht_tpu_torch.cli import CLI
from speecht_tpu_torch.data.pipeline import Batch, to_device
from speecht_tpu_torch.execution import build_model, init_state
from speecht_tpu_torch.models import conformer
from speecht_tpu_torch.train import state as tstate
from speecht_tpu_torch.train import step as tstep
from speecht_tpu_torch.train.checkpoint import CheckpointManager

TINY = conformer.ConformerConfig(
    input_size=8, d_model=32, num_heads=2, ffn_dim=64, num_blocks=2, conv_kernel=8,
    subsampling_channels=8, dropout=0.0, compute_dtype="float32",
)
TINY_FLAGS = ["--model", "conformer", "--d-model", "32", "--num-heads", "2",
              "--ffn-dim", "64", "--num-blocks", "2", "--conv-kernel", "8",
              "--subsampling-channels", "8", "--dropout", "0"]
CPU = torch.device("cpu")
ARPA = """\\data\\
ngram 1=5
ngram 2=1

\\1-grams:
-1.0\t<unk>
-0.5\t<s>\t-0.4
-0.6\t</s>
-0.9\tthe\t-0.3
-1.2\tcat

\\2-grams:
-0.3\tthe cat

\\end\\
"""


def _model(seed=0, config=TINY):
    model = conformer.Conformer(config, generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1 or "pos_bias" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return model.train()


def _batch(lengths, frames, seed=0, labels=6):
    rng = np.random.RandomState(seed)
    n = np.asarray(lengths, np.int32)
    feats = rng.randn(len(n), frames, 8).astype(np.float32)
    feats[np.arange(frames)[None, :] >= n[:, None]] = 0
    lab = rng.randint(0, 28, (len(n), 16)).astype(np.int32)
    lab_lengths = np.minimum(labels, n // 8).astype(np.int32)
    return Batch(feats, n, lab, lab_lengths)


def _dev(host):
    return to_device(host, CPU, "float32")


def _reference(params, batch):
    weights = {k: p.detach().clone().requires_grad_(True) for k, p in params.items()}
    logits = ref.forward(weights, batch.features, batch.seq_lengths.long(),
                         TINY.num_heads, TINY.conv_kernel)
    loss = ref.ctc_loss(logits, batch.seq_lengths, batch.labels, batch.label_lengths, 28)
    grads = torch.autograd.grad(loss, list(weights.values()))
    return logits.detach(), loss.detach(), dict(zip(weights, grads))


def _valid(batch, frames):
    return ref.valid_frames(ref.ceil_div(batch.seq_lengths, 4), frames)


def test_logits_loss_and_every_gradient_match_the_reference():
    model = _model()
    batch = _dev(_batch([64, 41, 17], 64))
    params = dict(model.named_parameters())
    loss, logits = tstep.make_loss_fn(model)(batch)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    want_logits, want_loss, want_grads = _reference(params, batch)
    valid = _valid(batch, logits.shape[1])
    assert logits.shape == want_logits.shape == (3, 16, 29)
    torch.testing.assert_close(logits.detach()[valid], want_logits[valid],
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(loss.detach(), want_loss, rtol=1e-5, atol=0)
    floor = float(np.median([float(g.norm()) for g in want_grads.values()]))
    assert len(grads) == 74
    for name, g in grads.items():
        gap = float((g - want_grads[name]).norm())
        assert gap <= 1e-4 * max(float(want_grads[name].norm()), floor), name


def test_one_train_step_matches_clip_and_adam_on_the_reference():
    lr, max_norm, eps, b1, b2 = 1e-2, 0.5, 1e-3, 0.9, 0.999
    model = _model(seed=3)
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    batch = _dev(_batch([64, 60, 33, 20], 64, seed=3))
    _logits, _loss, grads = _reference(params, batch)

    tx = tstate.make_optimizer(max_gradient_norm=max_norm, epsilon=eps)
    state = tstate.create_train_state(params, tx, lr)
    step = tstep.make_train_step_acc(model, tx)
    state, acc = step(state, tstep.init_metrics_acc(), batch)

    norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values()))
    assert norm > max_norm  # the clip scales this step's gradient
    assert float(acc["grad_norm_sum"]) == pytest.approx(norm, rel=1e-5)
    for name, g in grads.items():
        g = g * (max_norm / norm)
        mu, nu = (1 - b1) * g, (1 - b2) * g * g
        want = start[name] - lr * (mu / (1 - b1)) / (torch.sqrt(nu / (1 - b2)) + eps)
        torch.testing.assert_close(state.params[name].detach(), want, rtol=1e-4, atol=1e-6)


def test_rel_shift_is_its_definition():
    raw = torch.randn(2, 3, 7, 13)
    got = conformer.rel_shift(raw)
    t = raw.shape[-2]
    want = torch.empty(2, 3, t, t)
    for i in range(t):
        for j in range(t):
            want[..., i, j] = raw[..., i, t - 1 - i + j]
    assert torch.equal(got, want)
    assert torch.equal(ref.espnet_rel_shift(raw), want)


@pytest.mark.parametrize("training", [True, False])
def test_valid_logits_do_not_depend_on_the_padding(training):
    model = _model(seed=5).train(training)
    if not training:  # running statistics that are not the identity
        with torch.no_grad():
            model(_dev(_batch([64, 50], 64, seed=9)).features, torch.tensor([64, 50]))
            model.eval()
    host = _batch([61, 44, 9], 64, seed=5)
    wider = Batch(np.pad(host.features, ((0, 0), (0, 64), (0, 0))), host.seq_lengths,
                  host.labels, host.label_lengths)
    short, long = _dev(host), _dev(wider)
    a = model(short.features, short.seq_lengths).detach()
    b = model(long.features, long.seq_lengths).detach()
    assert b.shape[1] == 2 * a.shape[1]
    valid = _valid(short, a.shape[1])
    torch.testing.assert_close(a[valid], b[:, : a.shape[1]][valid], rtol=1e-5, atol=1e-5)


def test_a_zero_length_row_stays_finite():
    model = _model(seed=7)
    batch = _dev(_batch([40, 0, 23], 64, seed=7))
    params = dict(model.named_parameters())
    loss, logits = tstep.make_loss_fn(model)(batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert torch.isfinite(logits).all() and torch.isfinite(loss)
    assert all(torch.isfinite(g).all() for g in grads)
    alone = _dev(_batch([0, 0], 64))
    assert torch.isfinite(model(alone.features, alone.seq_lengths)).all()


def test_output_length_is_the_front_ends_own():
    model = _model()
    for n in range(1, 40):
        x = torch.randn(1, n, 8)
        out = model.subsample(x, torch.tensor([n]), torch.float32)
        assert out.shape[1] == int(model.output_length(torch.tensor(n))) == math.ceil(n / 4)
    assert int(model.output_length(torch.tensor(0))) == 0


def test_attention_runs_once_a_block():
    model = _model()
    batch = _dev(_batch([64, 30], 64))
    before = conformer.attention_calls
    model(batch.features, batch.seq_lengths)
    assert conformer.attention_calls - before == 2


def test_batch_norm_statistics_round_trip_the_checkpoint(tmp_path):
    model = _model(seed=11)
    with torch.no_grad():
        batch = _dev(_batch([64, 40], 64, seed=11))
        model(batch.features, batch.seq_lengths)  # moves the running statistics
    buffers = dict(model.named_buffers())
    assert sorted(buffers) == [f"blocks.{i}.conv.batch_norm.running_{s}"
                               for i in range(2) for s in ("mean", "var")]
    tx = tstate.make_optimizer()
    state = tstate.create_train_state(dict(model.named_parameters()), tx, 1e-4)
    CheckpointManager(str(tmp_path), buffers=buffers).save(state, step=3)
    payload = torch.load(tmp_path / "ckpt-3.pt", weights_only=True)
    assert sorted(payload["buffers"]) == sorted(buffers)

    fresh = _model(seed=12).eval()
    fresh_state = tstate.create_train_state(dict(fresh.named_parameters()), tx, 1e-4)
    CheckpointManager(str(tmp_path), buffers=dict(fresh.named_buffers())).restore(fresh_state)
    for name, value in fresh.state_dict().items():
        assert torch.equal(value, model.state_dict()[name]), name
    other = _model(seed=13).eval()
    CheckpointManager(str(tmp_path), buffers=dict(other.named_buffers())).restore_params(
        dict(other.named_parameters()))
    b = _dev(_batch([50], 64, seed=1))
    assert torch.equal(other(b.features, b.seq_lengths), fresh(b.features, b.seq_lengths))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("conformer")
    rng = np.random.RandomState(0)
    for split, n in (("train", 8), ("test", 4)):
        d = root / "data" / "preprocessed-power" / split
        d.mkdir(parents=True)
        for i in range(n):
            frames = rng.randint(60, 120)
            np.savez(d / f"utt{i}", audio_fragments=rng.randn(frames, 8).astype(np.float32),
                     transcript=rng.randint(0, 28, size=rng.randint(3, 9)).astype(np.int64))
    return root


def _argv(root, command, *extra):
    return [command, "--device", "cpu", "--data-dir", str(root / "data"),
            "--train-dir", str(root / "train"), "--log-dir", str(root / "log"),
            "--batch-size", "2", "--compute-dtype", "float32",
            "--transfer-dtype", "float32", *TINY_FLAGS, *extra]


def test_train_then_evaluate_through_the_cli(corpus, capsys):
    run = ["--run-name", "conformer"]
    CLI(_argv(corpus, "train", *run, "--max-steps", "2", "--steps-per-checkpoint", "2",
              "--learning-rate", "1e-3", "--verbose-summaries")).run()
    out = capsys.readouterr().out
    assert "Model saved" in out and "global step 2 " in out
    payload = torch.load(corpus / "train" / "conformer" / "ckpt-2.pt", weights_only=True)
    assert len(payload["params"]) == 74 and len(payload["buffers"]) == 4
    stats = CLI(_argv(corpus, "evaluate", *run, "--test", "--no-save")).run()
    out = capsys.readouterr().out
    losses = [float(ln.split()[3]) for ln in out.splitlines()
              if ln.startswith("validation average loss")]
    assert len(losses) == 2 and all(0 < x < 1e29 for x in losses)
    assert "Global statistics" in out and stats is not None

    lm = corpus / "lm"
    lm.mkdir()
    (lm / "model.arpa").write_text(ARPA)
    (lm / "vocabulary").write_text("the\ncat\n")
    CLI(_argv(corpus, "evaluate", *run, "--test", "--no-save", "--language-model", str(lm),
              "--beam-width", "8")).run()
    out = capsys.readouterr().out
    assert "Global statistics" in out and out.count("decoded: ") == 4
    beam_losses = [float(ln.split()[3]) for ln in out.splitlines()
                   if ln.startswith("validation average loss")]
    assert len(beam_losses) == 2 and all(0 < x < 1e29 for x in beam_losses)


def test_two_data_parallel_ranks_train_the_conformer_alike(corpus, tmp_path):
    argv = _argv(corpus, "train", "--run-name", "dp", "--max-steps", "2",
                 "--steps-per-checkpoint", "2", "--learning-rate", "1e-3")
    argv[argv.index("--batch-size") + 1] = "4"
    workers.run_ranks(workers.conformer_train, tmp_path / "ranks", argv)
    got = [np.load(tmp_path / "ranks" / f"conformer-{r}.npz") for r in range(2)]
    assert len(got[0].files) == 74
    for name in got[0].files:
        np.testing.assert_array_equal(got[0][name], got[1][name])
    saved = CheckpointManager(str(corpus / "train" / "dp")).all_steps()
    assert saved == [2]


@pytest.mark.parametrize("command,extra,env,named", [
    ("train", ["--model-parallel", "2"], None, "--model-parallel"),
    ("train", ["--seq-parallel", "2"], None, "--seq-parallel"),
    ("evaluate", ["--seq-parallel", "2"], None, "--seq-parallel"),
    ("train", [], "1", "SPEECHT_PALLAS_CONV0"),
    ("evaluate", ["--reference-weights", "w"], None, "--reference-weights"),
    ("export", ["--weights", "w"], None, "export"),
    ("record", ["--audio-source", "a.flac"], None, "record"),
])
def test_paths_that_run_wav2letter_alone_refuse_the_conformer(
        corpus, monkeypatch, command, extra, env, named):
    if env is not None:
        monkeypatch.setenv("SPEECHT_PALLAS_CONV0", env)
    with pytest.raises(ValueError, match=named) as info:
        CLI(_argv(corpus, command, "--run-name", "refused", *extra)).run()
    assert "conformer" in str(info.value)


def test_serving_refuses_the_conformer():
    with pytest.raises(ValueError, match="serving holds Wav2Letter alone"):
        serving.make_infer_fn(_model())


def test_build_model_and_init_state_draw_the_conformer_from_the_flags(corpus):
    flags = CLI(_argv(corpus, "train")).parsed
    model = build_model(8, flags, seed=4)
    assert isinstance(model, conformer.Conformer)
    assert dataclasses.replace(model.config, input_size=8) == TINY
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    init_state(model, flags, torch.Generator().manual_seed(4))
    for name, p in model.named_parameters():  # the same draw from the same seed
        assert torch.equal(p, before[name]), name
    init_state(model, flags)  # seed 0: another draw
    assert not torch.equal(model.head.weight, before["head.weight"])
