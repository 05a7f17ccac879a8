"""``record`` of the port against the JAX package's, and its host pieces.

- ``native.lm_write_binary``: the bytes of the KenLM binary it writes from
  an ARPA file equal the JAX package's writer's, and the port's reader
  scores every word of the binary as it scores the ARPA source.
- ``record_utils``: the post chain and ``FileAudioSource`` (one-shot
  utterances and the raw chunk stream) equal JAX's on the same FLACs.
- The whole command: ``python -m speecht_tpu_torch record --device cpu
  --audio-source FLAC...`` against JAX's ``Recording`` on the same files
  and weights (float32 compute; the weights go to JAX through the
  reference-weights directory both read, and JAX's executor takes them in
  place of a restored checkpoint). One-shot at the default feature rate
  (22050) and at ``--feature-rate 16000``, and ``--streaming``, each
  greedy and with the ARPA LM (host beam): the transcripts, the printed
  ``decoded:`` lines and, streaming, every printed partial must be equal.
  The last layer is scaled so the logits are peaky, as a trained model's;
  the inputs were checked to leave no logit frame within 1e-3 of a tie
  (the two models' logits agree to 1e-4, see ``test_torch_wav2letter.py``).
- Without pyaudio, ``record`` without ``--audio-source`` prints one line.
"""

import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from speecht_tpu import native as jnative
from speecht_tpu import record_utils as jrecord_utils
from speecht_tpu import recording as jrecording
from speecht_tpu.cli import CLI as JaxCLI
from speecht_tpu.models.wav2letter import Wav2Letter as JaxWav2Letter
from speecht_tpu.models.wav2letter import Wav2LetterConfig as JaxConfig
from speecht_tpu.train.checkpoint import export_weights as jax_export_weights
from speecht_tpu_torch import native, record_utils
from speecht_tpu_torch.cli import CLI
from test_beam import ARPA

WIDTHS = ["--base-channels", "16", "--wide-channels", "32", "--num-body-layers", "2",
          "--compute-dtype", "float32"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """Three 16 kHz FLACs of synthetic speech (0.8-1.6 s), seeded weights
    in JAX's export layout, and the ARPA LM with a vocabulary file."""
    root = tmp_path_factory.mktemp("record")
    rng = np.random.RandomState(0)
    flacs = []
    for i, seconds in enumerate((1.2, 0.8, 1.6)):
        pcm = chip_smoke.synthetic_speech(rng, int(seconds * 16000), 16000)
        path = str(root / f"utt{i}.flac")
        chip_smoke.write_flac(path, pcm, 16000)
        flacs.append(path)
    cfg = JaxConfig(input_size=128, base_channels=16, wide_channels=32,
                    num_body_layers=2, compute_dtype="float32")
    params = jax.device_get(nn.meta.unbox(JaxWav2Letter(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 128)))["params"]))
    last = f"conv_{len(params) - 1}"
    params = {**params, last: {k: np.asarray(v) * 100.0 for k, v in params[last].items()}}
    jax_export_weights(params, str(root / "weights"))
    lm = root / "lm"
    lm.mkdir()
    (lm / "model.arpa").write_text(ARPA)
    (lm / "vocabulary").write_text("the\ncat\ndog\nsat\n")
    return root, flacs, params


# -- the binary LM writer ----------------------------------------------------


def test_lm_write_binary_matches_jax(tmp_path):
    arpa = tmp_path / "model.arpa"
    arpa.write_text(ARPA)
    native.lm_write_binary(str(arpa), str(tmp_path / "ours.binary"))
    jnative.lm_write_binary(str(arpa), str(tmp_path / "theirs.binary"))
    ours = (tmp_path / "ours.binary").read_bytes()
    assert ours == (tmp_path / "theirs.binary").read_bytes()
    assert native.lm_is_binary(str(tmp_path / "ours.binary"))
    binary = native.NGramLM(str(tmp_path / "ours.binary"))
    source = native.NGramLM(str(arpa))
    assert binary.order == source.order
    for history in ("", "the", "the cat", "<s>", "dog the"):
        for word in ("the", "cat", "dog", "sat", "zebra"):
            assert binary.score_word(history, word) == pytest.approx(
                source.score_word(history, word), abs=1e-6)
    with pytest.raises(ValueError, match="binary conversion failed"):
        native.lm_write_binary(str(tmp_path / "missing.arpa"), str(tmp_path / "x"))


def test_lm_write_binary_of_the_smoke_lm_matches_jax(tmp_path):
    """The seeded order-3 LM of ``chip_smoke.write_lm`` (10^5 n-grams):
    the same bytes as JAX's writer."""
    lm_dir, _n = chip_smoke.write_lm(str(tmp_path))
    arpa = os.path.join(lm_dir, "model.arpa")
    native.lm_write_binary(arpa, str(tmp_path / "ours.binary"))
    jnative.lm_write_binary(arpa, str(tmp_path / "theirs.binary"))
    assert (tmp_path / "ours.binary").read_bytes() == \
        (tmp_path / "theirs.binary").read_bytes()


# -- record_utils ------------------------------------------------------------


def test_post_chain_matches_jax():
    rng = np.random.RandomState(1)
    for audio in (rng.randn(5000).astype(np.float32) * 0.2,
                  np.zeros(100, np.float32),
                  np.concatenate([np.zeros(300), rng.randn(800) * 0.5, np.zeros(200)])):
        np.testing.assert_array_equal(record_utils.normalize_peak(audio),
                                      jrecord_utils.normalize_peak(audio))
        np.testing.assert_array_equal(record_utils.trim_silence(audio, 0.03),
                                      jrecord_utils.trim_silence(audio, 0.03))
        np.testing.assert_array_equal(record_utils.add_silence(audio, 0.1, 16000),
                                      jrecord_utils.add_silence(audio, 0.1, 16000))
        got = record_utils.postprocess_recording(audio, 16000)
        np.testing.assert_array_equal(got, jrecord_utils.postprocess_recording(audio, 16000))
        assert got.dtype == np.float32


def test_file_audio_source_matches_jax(workdir, tmp_path):
    _root, flacs, _params = workdir
    npy = tmp_path / "extra.npy"
    np.save(npy, np.random.RandomState(2).randn(3000).astype(np.float32) * 0.3)
    paths = flacs + [str(npy)]
    ours = record_utils.FileAudioSource(paths, rate=22050, chunk_size=4096)
    theirs = jrecord_utils.FileAudioSource(paths, rate=22050, chunk_size=4096)
    for _ in paths:
        a, b = ours.record(), theirs.record()
        assert a[1] == b[1] == 4
        np.testing.assert_array_equal(a[0], b[0])
    with pytest.raises(record_utils.AudioSourceExhausted):
        ours.record()
    with ours.open_input_stream() as mine, theirs.open_input_stream() as jax_read:
        while True:
            try:
                a = mine()
            except record_utils.AudioSourceExhausted:
                with pytest.raises(jrecord_utils.AudioSourceExhausted):
                    jax_read()
                break
            np.testing.assert_array_equal(a, jax_read())
    with pytest.raises(ValueError, match="at least one audio file"):
        record_utils.FileAudioSource([])


# -- the record command --------------------------------------------------------


def _argv(root, flacs, *extra):
    return ["record", "--train-dir", str(root / "train"), "--run-name", "rec",
            "--data-dir", str(root / "data"), "--log-dir", str(root / "log"),
            *WIDTHS, "--audio-source", *flacs, *extra]


class _Restored:
    """JAX's checkpoint manager, replaced: ``restore`` returns the state
    with the test's parameters, as a checkpoint holding them would."""

    params = None

    def __init__(self, directory):
        pass

    def restore(self, state):
        return state.replace(params=jax.tree_util.tree_map(jnp.asarray, self.params))


def _printed(out):
    lines = out.replace("\r", "\n").splitlines()
    return [ln for ln in lines if ln.startswith(("partial:", "decoded:"))]


@pytest.mark.parametrize("streaming", [False, True], ids=["one_shot", "streaming"])
@pytest.mark.parametrize("feature_rate", [None, "16000"])
@pytest.mark.parametrize("lm", [False, True], ids=["greedy", "lm"])
def test_record_matches_jax(workdir, monkeypatch, capsys, streaming, feature_rate, lm):
    root, flacs, params = workdir
    extra = ["--streaming"] if streaming else []
    if feature_rate:
        extra += ["--feature-rate", feature_rate]
    if lm:
        extra += ["--language-model", str(root / "lm"), "--beam-width", "16"]
    monkeypatch.setattr(_Restored, "params", params)
    monkeypatch.setattr(jrecording, "CheckpointManager", _Restored)
    want = jrecording.Recording(JaxCLI(_argv(root, flacs, *extra)).parsed).run()
    jax_lines = _printed(capsys.readouterr().out)
    got = CLI(_argv(root, flacs, "--device", "cpu", "--reference-weights",
                    str(root / "weights"), *extra)).run()
    lines = _printed(capsys.readouterr().out)
    assert got == want
    assert lines == jax_lines
    if streaming:
        assert isinstance(got, str) and sum(ln.startswith("partial:") for ln in lines) > 5
    else:
        assert len(got) == len(flacs)
    assert any(got), "every transcript is empty: the check would be vacuous"


def test_record_without_pyaudio_is_one_line(workdir, capsys):
    try:
        import pyaudio  # noqa: F401
        pytest.skip("pyaudio is installed")
    except ImportError:
        pass
    from speecht_tpu_torch.cli import main

    root, flacs, _params = workdir
    argv = _argv(root, flacs, "--device", "cpu", "--reference-weights",
                 str(root / "weights"))
    argv = argv[:argv.index("--audio-source")] + argv[argv.index("--audio-source") + 1 + len(flacs):]
    with pytest.raises(SystemExit):
        main(argv)
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and err[0].startswith("error: record needs pyaudio")


def test_record_without_a_card_names_the_device(workdir, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from speecht_tpu_torch.cli import main

    root, flacs, _params = workdir
    with pytest.raises(SystemExit):
        main(_argv(root, flacs, "--reference-weights", str(root / "weights")))
    assert capsys.readouterr().err.strip().splitlines() == [
        "error: --device cuda: no CUDA device is available (pass --device cpu to run "
        "on the CPU)"]
