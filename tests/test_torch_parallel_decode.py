"""The port's ``evaluate --language-model`` and ``--from-audio`` on two ranks, against one process.

Two gloo ranks (``tests/torch_parallel_workers.py``: spawned processes,
one torch thread each, a ``file://`` rendezvous) run ``evaluate`` through
the CLI on a ``2 x 1`` data-parallel and a ``1 x 2`` tensor-parallel grid,
at narrow widths, on a seeded corpus: 10 cached utterances (one of them
CTC-infeasible) and 10 seeded 16 kHz FLACs of 0.5-3.5 s (two sample
buckets, so the ranks' own buckets differ in some batch), global batch
4, so the last batch holds two real rows and two padding rows (on the
tensor-parallel grid one rank's share of it is padding alone). The
weights are in the reference's export layout, which both packages read,
at full depth (the JAX package's reader of it requires 11 layers). The
paths: the host beam with ``test_beam.py``'s ARPA LM, ``--device-beam``
and ``--device-beam --rescore 2`` (the plain search on the CPU), the
device-LM budget's fall-back to the host beam, and ``--from-audio``,
greedy and with the LM. Each rank searches half the rows one process
searches.
The port's one process runs each path on the same rows in the ranks'
order (seed 0): every rank's statistics and decoded rows equal it, each
batch's loss within ``LOSS_RTOL``, and rank 0 alone prints. The JAX
package's one-process ``evaluate --language-model`` on the same weights
decodes the same rows as the two ranks.

Without processes: the beam's row split and gather on simulated grids,
the FLAC reader's shards against the JAX package's, the audio batch's
bucket sync, the device beam's decodes padded from a row bucket to the
logit width, and ``--seq-parallel`` with the LM or the audio refused with
JAX's ValueError.
"""

import json
import threading

import numpy as np
import pytest
import torch

import chip_smoke
from speecht_tpu.cli import CLI as JaxCLI
from speecht_tpu.data.reader import SpeechCorpusReader as JaxReader
from speecht_tpu_torch import vocabulary
from speecht_tpu_torch.cli import CLI
from speecht_tpu_torch.data import pipeline
from speecht_tpu_torch.data.reader import SpeechCorpusReader
from speecht_tpu_torch.models.wav2letter import Wav2Letter, Wav2LetterConfig
from speecht_tpu_torch.ops.beam import BeamSearchDecoder, LanguageModelConfig
from speecht_tpu_torch.parallel import comm
from speecht_tpu_torch.parallel import mesh as pmesh
from speecht_tpu_torch.weights import params_to_jax
from test_beam import ARPA

import torch_parallel_workers as workers

# float32 on both sides; the two ranks sum each batch's loss over another
# split of its rows (DP), or the wide layers' channels (TP)
LOSS_RTOL = 1e-6
# test_torch_parallel_train.py's widths, at the full depth
WIDTH_FLAGS = ["--base-channels", "16", "--wide-channels", "32"]
UTTERANCES, BATCH = 10, 4
GRIDS = {"dp": ["--data-parallel", "2"], "tp": ["--model-parallel", "2"]}
# (path, its flags, the one-process path it must equal)
PATHS = {
    "lm": (["--language-model", "{lm}"], "lm"),
    "device_beam": (["--language-model", "{lm}", "--device-beam"], "device_beam"),
    "rescore": (["--language-model", "{lm}", "--device-beam", "--rescore", "2"],
                "rescore"),
    "audio": (["--from-audio"], "audio"),
    "audio_lm": (["--from-audio", "--language-model", "{lm}"], "audio_lm"),
    # the LM does not fit the budget: rank 0's message, then the host beam
    "budget_fallback": (["--language-model", "{lm}", "--device-beam",
                         "--device-lm-hbm-gb", "1e-9"], "lm"),
}
CASES = [(path, grid) for path in PATHS for grid in GRIDS
         if not (path == "budget_fallback" and grid == "tp")]
FALLBACK = "falling back to the host beam"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The cache, the FLACs, one set of weights in the reference's export
    layout (read by both packages) and the LM; returns (root, argv)."""
    root = tmp_path_factory.mktemp("parallel_decode")
    rng = np.random.RandomState(7)
    cache = root / "data" / "preprocessed-power" / "test"
    cache.mkdir(parents=True)
    for i in range(UTTERANCES):
        frames, letters = rng.randint(60, 200), rng.randint(8, 25)
        if i == 3:  # CTC-infeasible: more letters than logit frames
            frames, letters = 40, 30
        np.savez(cache / f"utt{i}",
                 audio_fragments=rng.randn(frames, 128).astype(np.float32),
                 transcript=rng.randint(0, 28, size=letters).astype(np.int64))
    chip_smoke.write_flac_corpus(str(root / "data"), "test", UTTERANCES, seed=3,
                                 seconds=(0.5, 3.5), letters=(4, 12))
    model = Wav2Letter(
        Wav2LetterConfig(base_channels=16, wide_channels=32),
        generator=torch.Generator().manual_seed(0),
    )
    for layer, leaves in params_to_jax(model.state_dict()).items():
        layer_dir = root / "weights" / layer.replace("conv_", "convolution_layer_")
        layer_dir.mkdir(parents=True)
        np.save(layer_dir / "filters:0.npy", leaves["kernel"])
        np.save(layer_dir / "bias:0.npy", rng.randn(*leaves["bias"].shape) * 0.1)
    lm = root / "lm"
    lm.mkdir()
    (lm / "model.arpa").write_text(ARPA)
    (lm / "vocabulary").write_text("the\ncat\ndog\nsat\n")
    argv = ["--test", "--no-save", "--data-dir", str(root / "data"),
            "--train-dir", str(root / "train"), "--log-dir", str(root / "log"),
            "--reference-weights", str(root / "weights"),
            "--batch-size", str(BATCH), "--beam-width", "8",
            "--compute-dtype", "float32", "--transfer-dtype", "float32",
            *WIDTH_FLAGS]
    return root, argv


def _flags(root, path):
    return [f.format(lm=root / "lm") for f in PATHS[path][0]]


@pytest.fixture(scope="module")
def ranks(corpus):
    """Both ranks' runs of every case (``torch_parallel_workers.decode_runs``)."""
    root, argv = corpus
    cases = [(f"{path}/{grid}", ["--device", "cpu", *_flags(root, path), *GRIDS[grid]])
             for path, grid in CASES]
    workers.run_ranks(workers.decode_runs, root / "ranks", argv, cases)
    return [json.load(open(root / "ranks" / f"decode-{r}.json")) for r in range(2)]


@pytest.fixture(scope="module")
def one_process(corpus, tmp_path_factory):
    """The port's one process on each path, in the ranks' order."""
    root, argv = corpus
    import os

    os.environ["SPEECHT_DEVICE_LM_CACHE"] = str(tmp_path_factory.mktemp("device_lm"))
    with chip_smoke.seeded_reader():
        return {path: workers.evaluate_recorded([*argv, "--device", "cpu",
                                                 *_flags(root, path)])
                for path in {want for _f, want in PATHS.values()}}


@pytest.mark.parametrize("path,grid", CASES, ids=[f"{p}-{g}" for p, g in CASES])
def test_two_ranks_decode_as_one_process(ranks, one_process, path, grid):
    want = one_process[PATHS[path][1]]
    assert want["stats"][0] == UTTERANCES and len(want["losses"]) == 3
    assert want["searched"] == (0 if path == "audio" else 3 * BATCH)
    for rank in ranks:  # every rank tracks the global rows
        got = rank[f"{path}/{grid}"]
        # and searches half of them (greedy: none)
        assert 2 * got["searched"] == want["searched"]
        assert got["rows"] == want["rows"]
        assert got["stats"][:3] == want["stats"][:3]
        assert got["stats"][3:] == pytest.approx(want["stats"][3:], rel=1e-12)
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    out, quiet = (r[f"{path}/{grid}"]["stdout"] for r in ranks)
    assert "distributed: rank 0 of 2, backend gloo, device cpu" in out
    assert out.count("expected: ") == UTTERANCES and "Global statistics" in out
    assert out.count("validation average loss") == 3
    for line in ("expected: ", "Global statistics", "validation average loss",
                 "from-audio: decoding at native", FALLBACK):
        assert line not in quiet
    assert "distributed: rank 1 of 2" in quiet
    assert (FALLBACK in out) == (path == "budget_fallback")
    if path.startswith("audio"):
        assert "from-audio: decoding at native 16000 Hz" in out


def test_two_ranks_decode_as_the_jax_package(corpus, ranks, capsys):
    """The JAX CLI's one process, host beam: the same rows, decode for
    decode (its reader shuffles anew, so its batches hold other rows)."""
    root, argv = corpus
    JaxCLI(["evaluate", *argv, *_flags(root, "lm")]).run()
    lines = capsys.readouterr().out.splitlines()
    jax_rows = sorted([lines[i][len("expected: "):], lines[i + 1][len("decoded: "):]]
                      for i, line in enumerate(lines) if line.startswith("expected: "))
    assert len(jax_rows) == UTTERANCES
    for rank in ranks:
        for grid in GRIDS:
            assert rank[f"lm/{grid}"]["rows"] == jax_rows


@pytest.mark.parametrize("flags", [["--language-model", "lm"], ["--from-audio"]],
                         ids=["language-model", "from-audio"])
def test_seq_parallel_with_the_lm_or_audio_raises_as_jax(corpus, flags):
    root, argv = corpus
    argv = [*argv, *flags, "--seq-parallel", "2"]
    with pytest.raises(ValueError) as jax_error:
        JaxCLI(["evaluate", *argv]).run()
    with pytest.raises(ValueError) as error:
        CLI(["evaluate", *argv, "--device", "cpu"]).run()
    assert str(error.value) == str(jax_error.value)
    assert "--seq-parallel combines only with" in str(error.value)


# -- the helpers, without processes ------------------------------------------


def _simulated_gather(monkeypatch, parts):
    """comm as on a grid whose ranks hold ``parts``: records the thread
    each gather names and whether it ran on the main thread."""
    calls = []

    def gather(array, thread="host"):
        calls.append((thread, threading.current_thread() is threading.main_thread()))
        assert array.shape == parts[0].shape
        return [np.asarray(p) for p in parts]

    monkeypatch.setattr(comm, "initialized", lambda: True)
    monkeypatch.setattr(comm, "host_all_gather", gather)
    return calls


@pytest.mark.parametrize("dp,mp", [(2, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("block", [3, 4])
def test_beam_rows_and_their_gather_restore_the_global_rows(monkeypatch, dp, mp, block):
    x = np.arange(dp * block * 5, dtype=np.int32).reshape(dp * block, 5) + 1
    meshes = [pmesh.Mesh(dp=dp, mp=mp, rank=r) for r in range(dp * mp)]
    shares = [pmesh.beam_rows(pmesh.local_rows(x, m), m) for m in meshes]
    per = -(-block // mp)
    for m, share in zip(meshes, shares):
        assert share.shape == (per, 5)
        torch_share = pmesh.beam_rows(torch.from_numpy(pmesh.local_rows(x, m)), m)
        np.testing.assert_array_equal(torch_share.numpy(), share)
    # the padding rows are zero (length 0), and only they
    assert sum(int((s == 0).all(1).sum()) for s in shares) == dp * (per * mp - block)
    calls = _simulated_gather(monkeypatch, shares)
    for m in meshes:
        np.testing.assert_array_equal(pmesh.gather_beam_rows(shares[m.rank], m, block), x)
    # the decoder's gather: the main thread's gloo group, never the
    # loader's (the loader thread syncs bucket dims meanwhile)
    assert calls == [("host", True)] * len(meshes)


def test_one_process_beam_rows_are_the_identity():
    mesh = pmesh.make_mesh()
    x = np.arange(6).reshape(3, 2)
    np.testing.assert_array_equal(pmesh.beam_rows(x, mesh), x)
    np.testing.assert_array_equal(pmesh.gather_beam_rows(x, mesh, 3), x)


def _flac_ids(module, root, **kwargs):
    reader = module(str(root))
    return [tuple(t) for _audio, t in reader.load_raw_samples(
        "test", sample_rate=16000, **kwargs)]


@pytest.mark.parametrize("limit,count", [(8, 2), (9, 3)])
def test_flac_shards_match_jax(corpus, limit, count):
    """Disjoint, equal shards of the seed-0 order, cut to ``limit`` first:
    together the limited list; each the JAX package's shard, in order."""
    root = corpus[0] / "data"
    limited = _flac_ids(SpeechCorpusReader, root, limit_count=limit, seed=0)
    shards = [_flac_ids(SpeechCorpusReader, root, limit_count=limit, shard_index=i,
                        shard_count=count) for i in range(count)]
    assert shards == [_flac_ids(JaxReader, root, limit_count=limit, shard_index=i,
                                shard_count=count) for i in range(count)]
    assert [len(s) for s in shards] == [limit // count] * count
    assert sorted(sum(shards, [])) == sorted(limited) and len(set(limited)) == limit


def test_build_audio_batch_syncs_its_widths(monkeypatch):
    seen = []

    def sync(*dims):
        seen.append(dims)
        return tuple(d * 2 for d in dims)

    monkeypatch.setattr(pipeline, "sync_bucket_dims", sync)
    samples = [(np.ones(9000, np.float32), np.arange(5, dtype=np.int32))]
    batch = pipeline.build_audio_batch(samples, sample_bucket=4096, pad_to_batch=2)
    assert seen == [(12288, 32)]
    assert batch.audio.shape == (2, 24576) and batch.labels.shape == (2, 64)
    np.testing.assert_array_equal(batch.num_samples, [9000, 0])


def _tiny_model():
    return Wav2Letter(Wav2LetterConfig(input_size=8, base_channels=8, wide_channels=8,
                                       num_body_layers=1))


@pytest.mark.parametrize("rescore", [0, 2], ids=["fused", "rescore"])
def test_device_beam_decodes_padded_to_the_logit_width_equal_those_at_it(
        tmp_path, monkeypatch, rescore):
    """A rank's device beam searches its own 32-multiple bucket (64 frames
    for rows of at most 37 frames); its decodes padded to the logit width
    T = 96 equal a search over all 96 frames: frames past a row's length
    are never read."""
    monkeypatch.setenv("SPEECHT_DEVICE_LM_CACHE", str(tmp_path))
    (tmp_path / "model.arpa").write_text(ARPA)
    (tmp_path / "vocabulary").write_text("the\ncat\ndog\nsat\n")
    cfg = LanguageModelConfig(language_model=str(tmp_path), beam_width=8,
                              device_beam=True, rescore_n=rescore)
    decoder = BeamSearchDecoder(_tiny_model(), cfg, num_threads=1)
    rng = np.random.RandomState(0)
    logp = torch.log_softmax(
        torch.from_numpy(rng.randn(4, 96, 29).astype(np.float32) * 3), -1)
    lengths = np.array([37, 5, 0, 20], np.int32)
    weights = (cfg.lm_weight, cfg.word_count_weight, cfg.valid_word_count_weight)
    try:
        ids, lens = decoder.decode_emissions(logp, lengths)
        lens_t = torch.from_numpy(lengths)
        if rescore:
            n_ids, n_lens, scores = decoder._beam_fn(logp, lens_t, 0.0, 0.0, 0.0)
            want_ids, want_lens = decoder._rescore(
                n_ids.numpy(), n_lens.numpy(), scores.numpy(), *weights)
        else:
            want_ids, want_lens = (t.numpy() for t in decoder._beam_fn(logp, lens_t, *weights))
    finally:
        decoder.close()
    assert ids.shape == (4, 64) and want_ids.shape == (4, 96)
    np.testing.assert_array_equal(lens, want_lens)
    np.testing.assert_array_equal(
        np.pad(ids, ((0, 0), (0, 32)), constant_values=vocabulary.PAD_ID), want_ids)


def test_host_beam_threads_share_the_cores_among_a_hosts_ranks(monkeypatch):
    import os

    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    decoder = BeamSearchDecoder(_tiny_model(), LanguageModelConfig())
    try:
        assert decoder.num_threads == 2
    finally:
        decoder.close()
