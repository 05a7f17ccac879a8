"""The port's large-LM probe (``speecht_tpu_torch/tools/large_lm_probe.py``)
against the JAX tool (``tools/large_lm_probe.py``, loaded by path) and the
JAX package's device beam, on the CPU, at a size below the probe's
``--smoke`` (30,000 n-grams over 2,000 words: enough keys that the arena
and the words table both need two-choice placement):

- the ARPA the port's generators write is byte-identical to JAX's for the
  same seed, and so is the tiny LM;
- the tables the port builds from its own PROBING binary equal the JAX
  package's (``_build_np_from_binary``), meta and flags included, and
  ``DeviceLM.from_binary`` holds them;
- the probe's scorer spot-check agrees with the host scorer within 1e-4
  on all 30 contexts;
- the plain search on that LM gives JAX's ids at B=2, T=24, W=16, K=8.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speecht_tpu.ops import beam_device as jbd
from speecht_tpu_torch.ops import beam_device as bd
from speecht_tpu_torch.tools import large_lm_probe as probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NGRAMS, VOCAB = 30_000, 2_000


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_large_lm_probe", os.path.join(REPO, "tools", "large_lm_probe.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _arpa(module, path):
    rng = np.random.RandomState(0)
    n_rest = NGRAMS - VOCAB - 3
    words = module.gen_words(VOCAB, rng)
    module.write_arpa(path, words, n_rest // 2, n_rest - n_rest // 2, rng)
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def binary(tmp_path_factory):
    path, facts = probe.synthesize(str(tmp_path_factory.mktemp("large_lm")), NGRAMS, VOCAB)
    assert not facts["reused"]
    return path


def test_arpa_byte_identical_to_jax(tmp_path):
    want = _arpa(_jax_tool(), str(tmp_path / "jax.arpa"))
    got = _arpa(probe, str(tmp_path / "port.arpa"))
    assert got == want
    assert probe.TINY_ARPA == _jax_tool().TINY_ARPA


def test_tables_from_the_binary_match_jax(binary):
    meta, tables = bd._build_np_from_binary(binary, None)
    want_meta, want = jbd._build_np_from_binary(binary, None)
    assert meta == want_meta
    assert meta["arena_two_choice"] and meta["words_two_choice"]
    assert sorted(tables) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(tables[key], want[key])
    lm = bd.DeviceLM.from_binary(binary)
    assert (lm.arena_two_choice, lm.words_two_choice) == (True, True)
    for key in want:
        np.testing.assert_array_equal(lm.tables[key].numpy(), want[key])


def test_spot_check_matches_the_host_scorer(binary):
    assert probe.spot_check(bd.DeviceLM.from_binary(binary), binary) == (30, 0)


def test_plain_search_ids_match_jax(binary):
    logp, lengths = probe.probe_emissions(B=2, T=24)
    want = jbd.make_device_beam_search(
        16, lm=jbd.DeviceLM.from_binary(binary), prune_top_k=8)(
        jnp.asarray(logp), jnp.asarray(lengths), *probe.BEAM_WEIGHTS)
    got = bd.make_device_beam_search(16, lm=bd.DeviceLM.from_binary(binary), prune_top_k=8)(
        torch.from_numpy(logp), torch.from_numpy(lengths), *probe.BEAM_WEIGHTS)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert int(got[1].min()) > 0  # the rows decode to something
