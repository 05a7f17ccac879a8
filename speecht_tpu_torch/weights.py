"""Model weights carried across from the JAX package and the reference.

- :func:`params_from_jax` turns a flax parameter tree of numpy arrays
  (``conv_i/kernel [W, I, O]``, ``conv_i/bias [O]``) into the port's state
  dict (``conv_i.weight [O, I, W]``, ``conv_i.bias [O]``);
  :func:`params_to_jax` goes the other way. Both frameworks' convolutions
  are cross-correlations, so the taps keep their order.
- :func:`load_weight_dir` reads a directory of ``.npy`` files in either
  layout: the reference's export (``convolution_layer_i/filters:0.npy``
  and ``bias:0.npy``, as ``speecht_tpu/compat.py`` reads it) or the JAX
  package's ``export --weights`` (``conv_i/kernel.npy``, ``bias.npy``).
  A model trained by the JAX package reaches the port through
  ``speecht-cli export --weights <dir>``.
- :func:`train_state_from_jax` turns a JAX train state given as numpy
  (params, optax Adam ``mu``/``nu`` and ``count``, ``step``, learning
  rate) into the port's :class:`TrainState`, so the tests can start both
  packages from the same point, mid-training included.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from speecht_tpu_torch.train.state import AdamState, TrainState

_REFERENCE_NAME = re.compile(r"convolution_layer_(\d+)/(filters|bias)(:0)?$")
_JAX_NAME = re.compile(r"conv_(\d+)/(kernel|bias)$")


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """flax params ``{conv_i: {kernel [W,I,O], bias [O]}}`` -> state dict."""
    state = {}
    for layer, leaves in tree.items():
        for leaf, value in leaves.items():
            value = np.asarray(value, dtype=np.float32)
            if leaf == "kernel":
                state[f"{layer}.weight"] = torch.from_numpy(
                    np.ascontiguousarray(value.transpose(2, 1, 0))
                )
            else:
                state[f"{layer}.bias"] = torch.from_numpy(value.copy())
    return state


def params_to_jax(state_dict: dict[str, torch.Tensor]) -> dict:
    """State dict -> flax params ``{conv_i: {kernel [W,I,O], bias [O]}}``."""
    tree: dict[str, dict[str, np.ndarray]] = {}
    for name, value in state_dict.items():
        layer, leaf = name.rsplit(".", 1)
        array = value.detach().cpu().float().numpy()
        if leaf == "weight":
            tree.setdefault(layer, {})["kernel"] = np.ascontiguousarray(
                array.transpose(2, 1, 0)
            )
        else:
            tree.setdefault(layer, {})["bias"] = array.copy()
    return tree


def _read_npy_tree(directory: str) -> dict:
    """``.npy`` files under ``directory`` in either layout -> flax tree."""
    tree: dict[str, dict[str, np.ndarray]] = {}
    for root, _dirs, files in os.walk(directory):
        for fname in files:
            if not fname.endswith(".npy"):
                continue
            path = os.path.join(root, fname)
            name = os.path.relpath(path, directory)[: -len(".npy")]
            name = name.replace(os.sep, "/")
            ref = _REFERENCE_NAME.match(name)
            jax = _JAX_NAME.match(name)
            if ref:
                layer, leaf = ref.group(1), (
                    "kernel" if ref.group(2) == "filters" else "bias"
                )
            elif jax:
                layer, leaf = jax.group(1), jax.group(2)
            else:
                continue  # optimizer slots and other variables
            tree.setdefault(f"conv_{layer}", {})[leaf] = np.load(path)
    return tree


def load_weight_dir(directory: str, model: torch.nn.Module) -> dict:
    """State dict for ``model`` from a ``.npy`` weight directory.

    Raises FileNotFoundError for a missing directory, KeyError when any
    of the model's kernels or biases is absent, ValueError when one has
    the wrong shape.
    """
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"weight directory {directory} does not exist")
    state = params_from_jax(_read_npy_tree(directory))
    expected = model.state_dict()
    missing = sorted(set(expected) - set(state))
    if missing:
        raise KeyError(
            f"weight directory {directory} is missing {missing[:4]}"
            + ("..." if len(missing) > 4 else "")
        )
    for name, ref in expected.items():
        if tuple(state[name].shape) != tuple(ref.shape):
            raise ValueError(
                f"shape mismatch for {name}: model {tuple(ref.shape)} vs "
                f"weights {tuple(state[name].shape)} (as [O, I, W])"
            )
    return {name: state[name] for name in expected}


def copy_into(targets: dict[str, torch.Tensor], values: dict, what: str):
    """Copies ``values`` into the same-named, same-shaped ``targets`` in
    place; raises KeyError when the names differ, ValueError on a shape."""
    if set(values) != set(targets):
        raise KeyError(
            f"{what}: names differ from the model's "
            f"({sorted(set(values) ^ set(targets))[:4]})"
        )
    with torch.no_grad():
        for name, t in targets.items():
            if tuple(values[name].shape) != tuple(t.shape):
                raise ValueError(
                    f"{what}: shape of {name} is {tuple(values[name].shape)}, "
                    f"the model's {tuple(t.shape)}"
                )
            t.copy_(values[name])


def train_state_from_jax(
    state: TrainState,
    params: dict,
    mu: dict,
    nu: dict,
    count,
    step,
    learning_rate,
) -> TrainState:
    """Loads a JAX train state, given as numpy, into ``state`` in place.

    ``params``, ``mu`` and ``nu`` are flax trees ``{conv_i: {kernel [W,I,O],
    bias [O]}}`` (``state.params``, ``state.opt_state[1].mu`` / ``.nu`` of
    the JAX package's clip -> Adam chain); ``count`` is that Adam state's
    count. ``state`` keeps its tensors (the model's parameters among
    them) and device. Returns ``state``.
    """
    copy_into(state.params, params_from_jax(params), "params")
    copy_into(state.opt_state.mu, params_from_jax(mu), "mu")
    copy_into(state.opt_state.nu, params_from_jax(nu), "nu")
    opt = state.opt_state
    device = opt.count.device
    return TrainState(
        params=state.params,
        opt_state=AdamState(
            mu=opt.mu, nu=opt.nu,
            count=torch.tensor(int(np.asarray(count)), dtype=torch.int32, device=device),
        ),
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device),
        learning_rate=torch.tensor(
            float(np.asarray(learning_rate)), dtype=torch.float32, device=device
        ),
    )
