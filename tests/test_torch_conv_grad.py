"""The wide layer's input gradient as a forward conv (``ops/conv_grad.py``).

A ``Conv1d`` layer of the port, with SAME padding, bias and ReLU, against
autograd through plain ``F.pad`` + ``F.conv1d`` on the same float32
weights: the input, weight and bias gradients, at odd and even lengths,
for the model's widths and either side of ``conv_grad.MIN_WIDTH``; the
counter moves for the layers that take the forward form and for no
other. Then the model: one input gradient a micro-step through
``make_train_step_acc``, none in the eval step or the serving forward.
The sharded paths are in tests/test_torch_parallel_train.py (tensor
parallel) and tests/test_torch_seq_parallel.py (sequence parallel).

Tolerance, float32 on the CPU: rtol 1e-5 / atol 1e-6 on the gradients
(the same products summed in another order, sums of at most 32 x 6
terms of order 1); the forward is the same call and equal bit for bit.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from speecht_tpu_torch import serving
from speecht_tpu_torch.data.pipeline import Batch, to_device
from speecht_tpu_torch.models.wav2letter import (
    Conv1d, Wav2Letter, Wav2LetterConfig, same_padding,
)
from speecht_tpu_torch.ops import conv_grad
from speecht_tpu_torch.train import state as tstate
from speecht_tpu_torch.train import step as tstep

RTOL, ATOL = 1e-5, 1e-6
TINY = Wav2LetterConfig(
    input_size=8, base_channels=16, wide_channels=32, num_body_layers=2,
    compute_dtype="float32",
)
# (width, stride): the body's 7, the wide layer's 32, the 1x1 layers, both
# sides of the constant, and conv_0 (stride 2, never takes it)
LAYERS = sorted({(1, 1), (7, 1), (32, 1), (conv_grad.MIN_WIDTH - 1, 1),
                 (conv_grad.MIN_WIDTH, 1), (48, 2)})


def _plain(layer, x):
    pads = same_padding(x.shape[-1], layer.width, layer.stride)
    y = F.conv1d(F.pad(x, pads), layer.weight, stride=layer.stride)
    return torch.relu(y + layer.bias[:, None])


@pytest.mark.parametrize("T", [37, 40])
@pytest.mark.parametrize("width,stride", LAYERS)
def test_layer_gradients_match_plain_conv(width, stride, T):
    layer = Conv1d(5, 6, width, stride, relu=True)
    layer.reset_parameters(torch.Generator().manual_seed(width))
    gen = torch.Generator().manual_seed(T)
    with torch.no_grad():
        layer.bias.uniform_(-0.1, 0.1, generator=gen)
    x = torch.randn(3, 5, T, generator=gen, requires_grad=True)
    before = conv_grad.input_grads
    y = layer(x, torch.float32)
    want_y = _plain(layer, x)
    assert torch.equal(y, want_y)
    r = torch.randn(y.shape, generator=gen)
    got = torch.autograd.grad((y * r).sum(), (x, layer.weight, layer.bias))
    engaged = stride == 1 and width >= conv_grad.MIN_WIDTH
    assert conv_grad.input_grads - before == int(engaged)
    want = torch.autograd.grad((want_y * r).sum(), (x, layer.weight, layer.bias))
    for name, g, w in zip(("input", "weight", "bias"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    assert conv_grad.engages(layer.weight, stride) == engaged
    with torch.no_grad():
        assert not conv_grad.engages(layer.weight, stride)
        assert torch.equal(layer(x, torch.float32), want_y)
    assert not conv_grad.engages(layer.weight.detach(), stride)


def test_wide_layer_alone_takes_forward_form():
    """In the reference configuration, conv_8 (width 32) is the one layer
    at or above the constant with stride 1."""
    specs = Wav2LetterConfig().layer_specs
    assert [i for i, (w, s, _o, _r) in enumerate(specs)
            if s == 1 and w >= conv_grad.MIN_WIDTH] == [8]


def _batch(seed, B=3, T=40, L=4):
    rng = np.random.RandomState(seed)
    b = Batch(
        features=rng.randn(B, T, 8).astype(np.float32),
        seq_lengths=np.full(B, T, np.int32),
        labels=rng.randint(0, 5, size=(B, L)).astype(np.int32),
        label_lengths=np.full(B, L, np.int32),
    )
    return to_device(b, torch.device("cpu"), "float32")


@pytest.mark.parametrize("accum", [1, 2])
def test_counter_one_per_micro_step_none_in_eval(accum):
    model = Wav2Letter(TINY)
    tx = tstate.make_optimizer(max_gradient_norm=5.0, epsilon=1e-3)
    state = tstate.create_train_state(dict(model.named_parameters()), tx, 1e-3)
    step = tstep.make_train_step_acc(model, tx, accum_steps=accum)
    gacc = tstep.init_grad_accum(state.params) if accum > 1 else None
    acc = tstep.init_metrics_acc()
    before = conv_grad.input_grads
    for seed in range(4):
        if gacc is None:
            state, acc = step(state, acc, _batch(seed))
        else:
            state, gacc, acc = step(state, gacc, acc, _batch(seed))
        assert conv_grad.input_grads - before == seed + 1
    assert float(acc["updates"]) == 4 / accum
    before = conv_grad.input_grads
    tstep.make_eval_step(model)(_batch(9))
    batch = _batch(9)
    serving.make_infer_fn(model)(batch.features, batch.seq_lengths)
    assert conv_grad.input_grads == before


def test_depthwise_conv_keeps_autograd_input_gradient():
    """A grouped conv (the Conformer's depthwise width-32 one) is not
    dense: it keeps autograd's input gradient and the counter stays,
    while a dense layer of the same width still takes the forward form."""
    gen = torch.Generator().manual_seed(32)
    weight = torch.randn(6, 1, 32, generator=gen, requires_grad=True)
    x = torch.randn(2, 6, 40, generator=gen, requires_grad=True)
    assert not conv_grad.engages(weight, 1, groups=6)
    before = conv_grad.input_grads
    y = conv_grad.conv1d(x, weight, 1, (15, 16), groups=6)
    dy = torch.randn(y.shape, generator=gen)
    got = torch.autograd.grad(y, (x, weight), dy)
    want_y = F.conv1d(F.pad(x, (15, 16)), weight, groups=6)
    want = torch.autograd.grad(want_y, (x, weight), dy)
    assert torch.equal(y, want_y)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
    assert conv_grad.input_grads == before
    wide = Wav2Letter(Wav2LetterConfig(input_size=39)).conv_8
    assert wide.width == 32 and conv_grad.engages(wide.weight, wide.stride)
