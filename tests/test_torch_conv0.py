"""The port's conv_0 plain version and autograd Function against the JAX
package's Pallas kernel (interpret mode) and its custom VJP.

Inputs are made with numpy from a seed and handed to both sides in
float32. Tolerances: forward atol/rtol 2e-4, as tests/test_conv0_pallas.py
holds the Pallas kernel to lax (6400 products summed in another order);
gradients atol/rtol 3e-3, as that file holds the custom VJP to jax.grad
of lax; ``phase_weights`` exactly (a rearrangement, no arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speecht_tpu.ops import conv0_pallas
from speecht_tpu_torch.ops import conv0, conv0_cuda

FWD_TOL = 2e-4
GRAD_TOL = 3e-3


def _inputs(seed, B, T, I, O):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, I).astype(np.float32)
    kernel = (rng.randn(48, I, O) * 0.05).astype(np.float32)  # JAX [W, I, O]
    bias = rng.randn(O).astype(np.float32)
    return x, kernel, bias


def _torch_weight(kernel):
    return torch.from_numpy(np.ascontiguousarray(kernel.transpose(2, 1, 0)))


@pytest.mark.parametrize("T", [96, 512])
@pytest.mark.parametrize("O", [250, 29])
def test_plain_matches_pallas_interpret(T, O):
    x, kernel, bias = _inputs(0, 2, T, 128, O)
    want = np.asarray(conv0_pallas._pallas_forward(
        jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias), interpret=True
    ))
    got = conv0.conv0_plain(
        torch.from_numpy(x), _torch_weight(kernel), torch.from_numpy(bias)
    ).numpy()
    assert got.shape == want.shape == (2, T // 2, O)
    np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=FWD_TOL)


def test_phase_weights_equal_jax_exactly():
    rng = np.random.RandomState(1)
    kernel = rng.randn(48, 8, 5).astype(np.float32)
    want = np.asarray(conv0_pallas.phase_weights(jnp.asarray(kernel)))
    got = conv0.phase_weights(_torch_weight(kernel)).numpy()
    assert got.shape == want.shape == (25, 16, 5)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("T", [96, 97])
def test_reference_conv_matches_jax(T):
    """The linear map alone, odd T included (SAME puts the odd pad right)."""
    x, kernel, _bias = _inputs(2, 2, T, 64, 16)
    want = np.asarray(conv0_pallas._reference_conv(jnp.asarray(x), jnp.asarray(kernel)))
    got = conv0.reference_conv(torch.from_numpy(x), _torch_weight(kernel)).numpy()
    np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("input_grad", [True, False])
def test_function_grads_match_jax_custom_vjp(input_grad):
    x, kernel, bias = _inputs(3, 2, 96, 128, 32)
    g = np.random.RandomState(4).randn(2, 48, 32).astype(np.float32)

    def loss(xx, kk, bb):
        return jnp.sum(conv0_pallas.conv0_fused(xx, kk, bb, True) * g)

    jgx, jgk, jgb = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias)
    )
    tx = torch.from_numpy(x).requires_grad_(input_grad)
    tw = _torch_weight(kernel).requires_grad_(True)
    tb = torch.from_numpy(bias).requires_grad_(True)
    before = conv0_cuda.CONV0.plain_calls
    y = conv0_cuda.conv0(tx, tw, tb)
    assert conv0_cuda.CONV0.plain_calls == before + 1
    wrt = ([tx] if input_grad else []) + [tw, tb]
    grads = torch.autograd.grad(y, wrt, torch.from_numpy(g))
    if input_grad:
        np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)
    np.testing.assert_allclose(grads[-2].numpy().transpose(2, 1, 0), np.asarray(jgk),
                               atol=GRAD_TOL, rtol=GRAD_TOL)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgb),
                               atol=GRAD_TOL, rtol=GRAD_TOL)


# the JAX package's gate table (tests/test_conv0_pallas.py::test_supported_gates)
GATE_TABLE = [
    ((4, 511, 128), 48, 2, True),   # odd T
    ((4, 512, 39), 48, 2, True),    # 2*39 not lane-aligned (mfcc)
    ((4, 512, 128), 7, 1, True),    # not the first layer
    ((4, 512, 128), 48, 2, False),  # no relu
    ((4, 40, 128), 48, 2, True),    # shorter than the filter
    ((4, 6146, 128), 48, 2, True),  # T/2 beyond MAX_U
]


@pytest.mark.parametrize("shape,width,stride,relu", GATE_TABLE)
def test_gate_refuses_what_jax_refuses(shape, width, stride, relu):
    assert not conv0_pallas.supported(shape, width, stride, relu)
    for device in ("cpu", "cuda"):
        assert not conv0.supported(shape, width, stride, relu, device)


@pytest.mark.parametrize("shape", [(4, 512, 128), (1, 48, 64), (2, 6144, 128)])
def test_gate_admits_cuda_and_cpu_tensors(shape):
    # JAX admits these shapes only on a TPU backend; the port on CUDA
    # (the kernel) and on the CPU (the plain version)
    assert not conv0_pallas.supported(shape, 48, 2, True)
    assert conv0.supported(shape, 48, 2, True, "cuda")
    assert conv0.supported(shape, 48, 2, True, torch.device("cpu"))
    assert not conv0.supported(shape, 48, 2, True, "meta")


def test_kernel_wrapper_refuses_cpu_tensors():
    """No quiet fallback: the kernel's wrapper takes CUDA tensors only,
    and the plain route is counted apart from the launches."""
    x, kernel, bias = _inputs(5, 1, 96, 64, 8)
    before = conv0_cuda.CONV0.launches
    with pytest.raises(ValueError, match="CUDA"):
        conv0_cuda.CONV0(torch.from_numpy(x), _torch_weight(kernel), torch.from_numpy(bias))
    assert conv0_cuda.CONV0.launches == before


def test_plain_rounds_once_after_the_bias():
    """bf16 inputs: products exact and summed in float32, the bias added
    in float32, one rounding at the end (the Pallas path), which differs
    from rounding the conv before the bias (the default lax path)."""
    x, kernel, bias = _inputs(6, 2, 96, 64, 16)
    xb = torch.from_numpy(x).bfloat16()
    wb = _torch_weight(kernel).bfloat16()
    bb = torch.from_numpy(bias).bfloat16()
    got = conv0.conv0_plain(xb, wb, bb)
    assert got.dtype == torch.bfloat16
    want = torch.relu(
        conv0.reference_conv(xb.double(), wb.double()) + bb.double()
    ).bfloat16()
    # float32 sums of exact products against float64: at most one bf16 ulp
    diff = (got.double() - want.double()).abs()
    ulp = torch.finfo(torch.bfloat16).eps * want.double().abs().clamp(min=1e-30)
    assert bool((diff <= ulp).all())
