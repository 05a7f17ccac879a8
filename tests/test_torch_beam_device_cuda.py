"""The device beam kernel (``csrc/beam_device.cu``) against its plain
PyTorch version on the card.

Marked ``cuda``: skipped where there is no card. This file imports torch,
numpy and the port only (no JAX), so it runs on the card's machine:

    python -m pytest tests/test_torch_beam_device_cuda.py -m cuda -q

Both sides run the same float32 operations in the same order on the card,
so the ids and lengths must be equal on every row and the n-best scores
equal to 1e-6 relative; two kernel calls must be bit-equal. Cases:
``chip_smoke.py`` phase 2d's at a smaller batch (the order-3 LM of
``chip_smoke.write_lm``, no LM, n-best, W=1024, ragged rows, order-1 and
order-6 LMs, KenLM-keyed tables), tables that need two-choice placement
(a PROBING binary), tie-heavy emissions with and without
the LM, W=1024 on full-length rows, the shape edges (W=1, W=2, W=1024 at
K=8, K=29 at W=128, T=1, every row of length 0), a launch the kernel
cannot take raising before it is made (a width or an LM table of a shape
it does not read), and the kernel, never the plain version, taking a
CUDA tensor.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from speecht_tpu_torch.ops import beam_device, beam_device_cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: see README)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def lm_dirs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("beam_lm"))
    lm_dir, _n = chip_smoke.write_lm(root)
    order1, order6 = chip_smoke.lm_variants(root, lm_dir)
    return {"order3": lm_dir, "order1": order1, "order6": order6}


def _lm(lm_dirs, name, device):
    if name is None:
        return None
    if name == "kenlm":
        return chip_smoke.kenlm_keyed_lm(lm_dirs["order3"], device)
    d = lm_dirs[name]
    return beam_device.DeviceLM(f"{d}/model.arpa", f"{d}/vocabulary", device=device)


def _check(lm, lengths, device, seed=0, **kwargs):
    logp, lengths = chip_smoke.beam_emissions(seed, lengths)
    result = chip_smoke.check_beam("test", lm, logp, lengths, device, **kwargs)
    assert result["ok"]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "lm_name,kwargs",
    [
        ("order3", {}),
        (None, {}),
        ("order3", {"n_best": 8}),
        ("order1", {}),
        ("order6", {}),
        ("kenlm", {}),
        ("order3", {"n_best": 4, "weights": (1.5, 0.5, 1.2)}),
    ],
    ids=["order3", "no_lm", "n_best", "order1", "order6", "kenlm", "weights"],
)
def test_kernel_matches_plain(cuda_device, lm_dirs, lm_name, kwargs):
    lengths = np.random.RandomState(3).randint(130, 231, size=12)
    _check(_lm(lm_dirs, lm_name, cuda_device), lengths, cuda_device, **kwargs)


@pytest.mark.cuda
def test_ragged_lengths(cuda_device, lm_dirs):
    _check(_lm(lm_dirs, "order3", cuda_device), [0, 1, 2, 5, 50, 130, 200, 230],
           cuda_device, seed=2, n_best=4)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "W,top_k,lengths",
    [
        (1, 8, [40, 17]),
        (2, 8, [40, 17]),
        (1024, 8, [20, 13, 1]),
        (128, 0, [60, 31]),
        (100, 8, [1, 1, 1]),
        (100, 8, [0, 0, 0]),
    ],
    ids=["W1", "W2", "W1024", "K29", "T1", "all_empty"],
)
def test_shape_edges(cuda_device, lm_dirs, W, top_k, lengths):
    lm = _lm(lm_dirs, "order6", cuda_device)
    _check(lm, lengths, cuda_device, seed=W, W=W, top_k=top_k)
    _check(None, lengths, cuda_device, seed=W + 1, W=W, top_k=top_k)


@pytest.mark.cuda
@pytest.mark.parametrize("lm_name", ["order3", None], ids=["order3", "no_lm"])
def test_tie_heavy(cuda_device, lm_dirs, lm_name):
    """Emissions rounded to whole nats: the pool's totals tie often, so the
    selection's index rule (the lower candidate first) decides the order."""
    logp, lengths = chip_smoke.tie_emissions(
        6, np.random.RandomState(8).randint(130, 231, size=8))
    result = chip_smoke.check_beam("test", _lm(lm_dirs, lm_name, cuda_device), logp,
                                   lengths, cuda_device, n_best=4)
    assert result["ok"]


@pytest.mark.cuda
def test_widest_beam_full_rows(cuda_device, lm_dirs):
    """W=1024 over rows of the main shape's lengths (the backpointers in
    global memory, 1024 threads, one candidate rank a thread)."""
    _check(_lm(lm_dirs, "order3", cuda_device),
           np.random.RandomState(9).randint(130, 231, size=6), cuda_device, seed=9,
           W=1024)


@pytest.mark.cuda
def test_two_choice_tables(cuda_device, tmp_path):
    """An LM whose arena and words table both need two-choice placement
    (``large_lm_probe``'s generators, 30,000 n-grams over 2,000 words, as
    a PROBING binary: KenLM keys): the kernel's second-bucket probe
    against the plain version, on the probe's emissions and at n-best 4."""
    from speecht_tpu_torch.tools import large_lm_probe

    binary, _facts = large_lm_probe.synthesize(str(tmp_path), 30_000, 2_000)
    lm = beam_device.DeviceLM.from_binary(binary, device=cuda_device)
    assert lm.arena_two_choice and lm.words_two_choice
    logp, lengths = large_lm_probe.probe_emissions(B=16, T=128)
    for n_best in (1, 4):
        result = chip_smoke.check_beam("two-choice", lm, logp, lengths, cuda_device,
                                       n_best=n_best, weights=large_lm_probe.BEAM_WEIGHTS)
        assert result["ok"]


@pytest.mark.cuda
def test_refused_shapes_raise(cuda_device):
    logp = torch.zeros(2, 4, 29, device=cuda_device)
    lengths = torch.full((2,), 4, dtype=torch.int32, device=cuda_device)
    before = beam_device_cuda.BEAM_DEVICE.launches
    with pytest.raises(ValueError, match="shared memory"):
        beam_device.make_device_beam_search(1024, prune_top_k=0)(
            logp, lengths, 0.8, 0.0, 2.3)
    with pytest.raises(ValueError, match="more than 1024"):
        beam_device.make_device_beam_search(1025)(logp, lengths, 0.8, 0.0, 2.3)
    with pytest.raises(ValueError, match="lengths must be int32"):
        beam_device.make_device_beam_search(8)(logp, lengths.long(), 0.8, 0.0, 2.3)
    assert beam_device_cuda.BEAM_DEVICE.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize(
    "table,shape",
    [("arena_v", (4, 3)), ("arena_k", (2, 2)), ("words_v", (4, 1)),
     ("words_k", (4, 4)), ("uni", (2,))],
)
def test_misshaped_tables_raise(cuda_device, lm_dirs, table, shape):
    lm = _lm(lm_dirs, "order3", cuda_device)
    rows = lm.tables[table].shape[0]
    lm.tables = dict(lm.tables, **{table: torch.zeros(
        rows, *shape, dtype=torch.int32, device=cuda_device)})
    logp, lengths = chip_smoke.beam_emissions(5, [12, 7])
    before = beam_device_cuda.BEAM_DEVICE.launches
    with pytest.raises(ValueError, match=table):
        beam_device.make_device_beam_search(16, lm=lm)(
            torch.from_numpy(logp).to(cuda_device),
            torch.from_numpy(lengths).to(cuda_device), 0.8, 0.0, 2.3)
    assert beam_device_cuda.BEAM_DEVICE.launches == before


@pytest.mark.cuda
def test_cuda_tensor_never_takes_the_plain_version(cuda_device, lm_dirs, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(beam_device, "plain_beam_search", refuse)
    lm = _lm(lm_dirs, "order3", cuda_device)
    logp, lengths = chip_smoke.beam_emissions(4, [30, 12])
    before = beam_device_cuda.BEAM_DEVICE.launches
    ids, lens = beam_device.make_device_beam_search(16, lm=lm)(
        torch.from_numpy(logp).to(cuda_device),
        torch.from_numpy(lengths).to(cuda_device), 0.8, 0.0, 2.3,
    )
    torch.cuda.synchronize()
    assert beam_device_cuda.BEAM_DEVICE.launches == before + 1
    assert ids.device.type == "cuda" and tuple(ids.shape) == (2, 30)
    assert int(lens.max()) > 0


@pytest.mark.cuda
def test_python_limits_equal_the_library(cuda_device):
    """The constants and the shared-memory twin that ``ops/beam.py``
    decides with, before the library is built, equal the library's."""
    lib = beam_device_cuda.BEAM_DEVICE.lib
    assert lib.beam_device_max_width() == beam_device_cuda.MAX_WIDTH
    assert lib.beam_device_max_smem() == beam_device_cuda.MAX_SMEM
    for W in (1, 2, 31, 32, 33, 100, 255, 256, 257, 1000, 1024):
        for K in (1, 2, 8, 13, 29, 32):
            for H in (0, 1, 3, 5):
                assert lib.beam_device_smem_bytes(W, K, H) == \
                    beam_device_cuda.smem_bytes(W, K, H), (W, K, H)


@pytest.mark.cuda
def test_evaluate_device_beam_width_1025_completes(cuda_device, lm_dirs, tmp_path,
                                                   monkeypatch, capsys):
    """``evaluate --language-model --device-beam --beam-width 1025`` on the
    card prints the fall-back before the first batch and decodes every
    utterance on the host beam."""
    from speecht_tpu_torch.cli import CLI
    from speecht_tpu_torch.models.wav2letter import Wav2Letter, Wav2LetterConfig
    from speecht_tpu_torch.weights import params_to_jax

    monkeypatch.setenv("SPEECHT_DEVICE_LM_CACHE", str(tmp_path / "lm_cache"))
    rng = np.random.RandomState(0)
    d = tmp_path / "data" / "preprocessed-power" / "test"
    d.mkdir(parents=True)
    for i in range(4):
        np.savez(d / f"utt{i}",
                 audio_fragments=rng.randn(rng.randint(60, 200), 128).astype(np.float32),
                 transcript=rng.randint(0, 28, size=8).astype(np.int64))
    model = Wav2Letter(Wav2LetterConfig(base_channels=16, wide_channels=32))
    weights = tmp_path / "weights"
    for layer, leaves in params_to_jax(model.state_dict()).items():
        (weights / layer).mkdir(parents=True)
        for leaf, value in leaves.items():
            np.save(weights / layer / f"{leaf}.npy", value)
    stats = CLI([
        "evaluate", "--test", "--no-save", "--data-dir", str(tmp_path / "data"),
        "--train-dir", str(tmp_path / "train"), "--log-dir", str(tmp_path / "log"),
        "--batch-size", "4", "--reference-weights", str(weights),
        "--base-channels", "16", "--wide-channels", "32",
        "--language-model", lm_dirs["order3"], "--beam-width", "1025", "--device-beam",
    ]).run()
    out = capsys.readouterr().out
    assert out.index("falling back to the host beam") < out.index("Begin evaluation")
    assert stats.decodings_counter == 4
