"""The slice as a whole: ``preprocess`` and ``evaluate --from-audio``.

One synthetic FLAC corpus (``chip_smoke.write_flac_corpus``: 16 kHz, 0.3-
1.5 s clips, a split of 7 utterances so one batch of 8 has a padding row)
goes through both packages' command lines in this process:

- ``preprocess --num-workers 1`` (the host DSP) writes the same files and
  keys as ``speecht-cli preprocess``, the arrays bit-equal; a pool of 2
  spawned workers writes the same bytes;
- ``preprocess --device cpu`` (the torch front end in batches) matches the
  JAX package's ``store_samples_device`` within JAX's device-against-host
  tolerance plus one bfloat16 spacing (both download bf16);
- ``evaluate --from-audio --device cpu`` matches the JAX ``evaluate
  --from-audio`` on the same weights (float32 compute and wire): the
  decodes and statistics equal, the loss within 0.01 as in
  ``test_torch_evaluate.py``; with ``--language-model`` too; the int16
  wire gives the float32 wire's output line for line;
- ``SpeechCorpusProvider`` extracts a locally built tarball into the tree
  JAX's extracts;
- the flags and defaults of ``preprocess`` and ``evaluate --from-audio``
  are JAX's, and ``--device`` keeps JAX's meaning on ``preprocess``.
"""

import io
import os
import tarfile

import numpy as np
import pytest
import torch

import chip_smoke
from speecht_tpu import corpus as jcorpus
from speecht_tpu.cli import CLI as JaxCLI
from speecht_tpu.data.reader import SpeechCorpusReader as JaxReader
from test_beam import ARPA
from test_torch_training import _pop_port_model_flags
from speecht_tpu_torch import corpus
from speecht_tpu_torch.cli import CLI
from speecht_tpu_torch.data.reader import SpeechCorpusReader
from speecht_tpu_torch.models.wav2letter import Wav2Letter, Wav2LetterConfig
from speecht_tpu_torch.weights import params_to_jax

WIDTH_FLAGS = ["--base-channels", "16", "--wide-channels", "32"]
SECONDS, LETTERS = (0.3, 1.5), (4, 12)
CACHE_ATOL, CACHE_RTOL = 1e-2, 1e-2  # tests/test_features.py, power


def _corpus(root, n=7):
    data = os.path.join(root, "data")
    chip_smoke.write_flac_corpus(data, "test", n, seed=0, seconds=SECONDS,
                                 letters=LETTERS)
    return data


def _dirs(root):
    return ["--train-dir", os.path.join(root, "train"),
            "--log-dir", os.path.join(root, "log")]


def _cache(data, feature_type="power"):
    d = os.path.join(data, "preprocessed-power" if feature_type == "power"
                     else "preprocessed", "test")
    out = {}
    for name in sorted(os.listdir(d)):
        with np.load(os.path.join(d, name)) as z:
            out[name] = {k: z[k] for k in z.files}
    return out


@pytest.mark.parametrize("feature_type", ["power", "mfcc"])
def test_host_preprocess_matches_jax(tmp_path, feature_type):
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    flag = f"--{feature_type}"
    for root, cli in ((ours, CLI), (theirs, JaxCLI)):
        data = _corpus(root)
        cli(["preprocess", "--test-only", "--num-workers", "1", flag,
             "--data-dir", data, *_dirs(root)]).run()
    a, b = _cache(os.path.join(ours, "data"), feature_type), _cache(
        os.path.join(theirs, "data"), feature_type)
    assert sorted(a) == sorted(b) and len(a) == 7
    for name in a:
        assert sorted(a[name]) == sorted(b[name]) == ["audio_fragments",
                                                      "transcript"]
        for key in a[name]:
            assert a[name][key].dtype == b[name][key].dtype
            np.testing.assert_array_equal(a[name][key], b[name][key])


def test_host_preprocess_pool_writes_the_same_cache(tmp_path):
    data = _corpus(str(tmp_path))
    reader = SpeechCorpusReader(data)
    assert reader.store_samples("test", "power", num_workers=1) == 7
    one = _cache(data)
    assert reader.store_samples("test", "power", num_workers=2) == 7
    two = _cache(data)
    for name in one:
        for key in one[name]:
            np.testing.assert_array_equal(one[name][key], two[name][key])


def test_preprocess_collects_errors(tmp_path):
    data = _corpus(str(tmp_path))
    bad = os.path.join(data, "test", "19", "198", "19-198-0003.flac")
    with open(bad, "wb") as f:
        f.write(b"not a flac")
    for extra in ([], ["--device", "cpu"]):
        with pytest.raises(RuntimeError, match="19-198-0003"):
            CLI(["preprocess", "--test-only", "--num-workers", "1",
                 "--data-dir", data, *_dirs(str(tmp_path)), *extra]).run()
        assert len(os.listdir(os.path.join(
            data, "preprocessed-power", "test"))) == 6


@pytest.mark.parametrize("feature_type", ["power", "mfcc"])
def test_device_preprocess_matches_jax(tmp_path, feature_type):
    data = _corpus(str(tmp_path))
    CLI(["preprocess", "--test-only", "--device", "cpu", f"--{feature_type}",
         "--data-dir", data, *_dirs(str(tmp_path))]).run()
    ours = _cache(data, feature_type)
    JaxReader(data).store_samples_device("test", feature_type)
    theirs = _cache(data, feature_type)
    atol, rtol = {"power": (1e-2, 1e-2), "mfcc": (2e-2, 1e-2)}[feature_type]
    assert sorted(ours) == sorted(theirs) and len(ours) == 7
    for name in ours:
        a, b = ours[name]["audio_fragments"], theirs[name]["audio_fragments"]
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_array_equal(ours[name]["transcript"],
                                      theirs[name]["transcript"])
        spacing = chip_smoke.bf16_spacing(torch.from_numpy(b)).numpy()
        assert np.all(np.abs(a - b) <= atol + rtol * np.abs(b) + spacing)


def test_device_preprocess_against_the_host_cache(tmp_path):
    """A 16 kHz file and one at a rate with no polyphase plan (44101 Hz,
    resampled on the host) against the host DSP's cache."""
    data = _corpus(str(tmp_path), n=3)
    odd = os.path.join(data, "test", "19", "198", "19-198-0001.flac")
    pcm = chip_smoke.synthetic_speech(np.random.RandomState(5), 30000, 44101)
    chip_smoke.write_flac(odd, pcm, 44101)
    reader = SpeechCorpusReader(data)
    reader.store_samples("test", "power", num_workers=1)
    host = _cache(data)
    assert reader.store_samples_device("test", "power", "cpu",
                                       transfer_dtype="float32") == 3
    device = _cache(data)
    for name in host:
        a, b = device[name]["audio_fragments"], host[name]["audio_fragments"]
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=CACHE_ATOL, rtol=CACHE_RTOL)


def _weights(root):
    rng = np.random.RandomState(0)
    model = Wav2Letter(Wav2LetterConfig(base_channels=16, wide_channels=32),
                       generator=torch.Generator().manual_seed(0))
    weights = os.path.join(root, "weights")
    for layer, leaves in params_to_jax(model.state_dict()).items():
        d = os.path.join(weights, layer.replace("conv_", "convolution_layer_"))
        os.makedirs(d)
        np.save(os.path.join(d, "filters:0.npy"), leaves["kernel"])
        np.save(os.path.join(d, "bias:0.npy"), rng.randn(*leaves["bias"].shape) * 0.1)
    return weights


@pytest.fixture(scope="module")
def audio_workdir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("from_audio"))
    _corpus(root)
    lm = os.path.join(root, "lm")
    os.makedirs(lm)
    with open(os.path.join(lm, "model.arpa"), "w") as f:
        f.write(ARPA)
    with open(os.path.join(lm, "vocabulary"), "w") as f:
        f.write("the\ncat\ndog\nsat\n")
    return root, _weights(root)


def _evaluate_argv(root, weights, *extra):
    return ["evaluate", "--test", "--no-save", "--from-audio",
            "--data-dir", os.path.join(root, "data"), *_dirs(root),
            "--batch-size", "8", "--reference-weights", weights,
            "--compute-dtype", "float32", *WIDTH_FLAGS, *extra]


def _parse(out):
    lines = out.splitlines()
    pairs = sorted(
        (lines[i][len("expected: "):], lines[i + 1][len("decoded: "):])
        for i, line in enumerate(lines) if line.startswith("expected: ")
    )
    loss = [float(ln.split()[3]) for ln in lines
            if ln.startswith("validation average loss")]
    return pairs, loss, lines[lines.index("Global statistics"):]


@pytest.mark.parametrize("lm", [False, True], ids=["greedy", "language_model"])
def test_evaluate_from_audio_matches_jax(audio_workdir, capsys, lm):
    root, weights = audio_workdir
    extra = ["--transfer-dtype", "float32"]
    if lm:
        extra += ["--language-model", os.path.join(root, "lm"), "--beam-width", "8"]
    jax_stats = JaxCLI(_evaluate_argv(root, weights, *extra)).run()
    jax_out = capsys.readouterr().out
    stats = CLI(_evaluate_argv(root, weights, "--device", "cpu", *extra)).run()
    out = capsys.readouterr().out
    assert "resampling to 22050 Hz on device" in out
    pairs, loss, tail = _parse(out)
    jax_pairs, jax_loss, jax_tail = _parse(jax_out)
    assert len(pairs) == 7 and stats.decodings_counter == 7
    assert pairs == jax_pairs
    assert len(loss) == len(jax_loss) == 1
    assert abs(loss[0] - jax_loss[0]) <= 0.01
    assert tail == jax_tail
    assert stats.global_letter_error_rate == pytest.approx(
        jax_stats.global_letter_error_rate
    )


def test_evaluate_from_audio_int16_wire_is_the_float_wire(audio_workdir, capsys):
    root, weights = audio_workdir
    outs = []
    for wire in ("bfloat16", "float32"):  # bfloat16: the int16 audio wire
        CLI(_evaluate_argv(root, weights, "--device", "cpu",
                           "--transfer-dtype", wire)).run()
        outs.append(_parse(capsys.readouterr().out))
    assert outs[0][0] == outs[1][0] and outs[0][2] == outs[1][2]
    assert abs(outs[0][1][0] - outs[1][1][0]) <= 0.01


def _add(tar, name, payload):
    info = tarfile.TarInfo(name)
    info.size = len(payload)
    tar.addfile(info, io.BytesIO(payload))


def test_corpus_provider_extracts_as_jax(tmp_path, monkeypatch):
    mirror = tmp_path / "mirror"
    mirror.mkdir()
    for _set_type, set_name in corpus.DATA_SETS:
        with tarfile.open(mirror / (set_name + corpus.SET_FILE_EXTENSION),
                          "w:gz") as tar:
            base = f"{corpus.TAR_ROOT}{set_name}/19/198"
            _add(tar, f"{base}/19-198-0001.flac", set_name.encode())
            _add(tar, f"{base}/19-198.trans.txt", b"19-198-0001 HELLO\n")
            _add(tar, f"{corpus.TAR_ROOT}other-set/stray.flac", b"x")
            _add(tar, "not-under-root/escape.txt", b"x")
    monkeypatch.setattr(corpus, "BASE_URL", mirror.as_uri() + "/")
    monkeypatch.setattr(jcorpus, "BASE_URL", mirror.as_uri() + "/")
    trees = []
    for module, name in ((corpus, "ours"), (jcorpus, "theirs")):
        data = tmp_path / name
        module.SpeechCorpusProvider(str(data)).ensure_availability(test_only=True)
        module.SpeechCorpusProvider(str(data)).ensure_availability()
        module.SpeechCorpusProvider(str(data)).ensure_availability()  # idempotent
        trees.append(sorted(
            (os.path.relpath(os.path.join(r, f), data),
             open(os.path.join(r, f), "rb").read())
            for r, _d, files in os.walk(data) for f in files
            if not f.endswith(corpus.SET_FILE_EXTENSION)
        ))
    assert trees[0] == trees[1]
    assert ("test/test-clean/19/198/19-198-0001.flac", b"test-clean") in trees[0]
    assert not any("stray" in p or "escape" in p for p, _ in trees[0])


def test_preprocess_and_from_audio_flags_match_jax():
    """``preprocess --device`` is JAX's ``device_preprocess`` switch, with
    an optional device name; the other flags are JAX's."""
    for argv in (["preprocess"], ["preprocess", "--num-workers", "3",
                                   "--dev-only", "--mfcc"]):
        ours, theirs = vars(CLI(argv).parsed), vars(JaxCLI(argv).parsed)
        assert ours.pop("device") is None
        assert theirs.pop("device_preprocess") is False
        assert ours == theirs
    for argv, device in ((["--device"], "cuda"), (["--device", "cpu"], "cpu"),
                         (["--device", "--test-only"], "cuda")):
        assert CLI(["preprocess", *argv]).parsed.device == device
    assert JaxCLI(["preprocess", "--device", "--test-only"]).parsed.device_preprocess
    ours = vars(CLI(["evaluate", "--from-audio"]).parsed)
    theirs = vars(JaxCLI(["evaluate", "--from-audio"]).parsed)
    assert ours.pop("device") == "cuda" and ours["from_audio"]
    _pop_port_model_flags(ours)
    ours.pop("lm"), theirs.pop("lm")
    assert ours == theirs


def test_preprocess_device_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device is usable")
    data = _corpus(str(tmp_path), n=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLI(["preprocess", "--test-only", "--device", "--data-dir", data,
             *_dirs(str(tmp_path))]).run()
