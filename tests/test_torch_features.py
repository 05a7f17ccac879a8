"""The port's audio front end against the JAX package's, on the CPU.

- The host DSP (``data/features.py``) is bit-equal to
  ``speecht_tpu.data.features`` for the power spectrogram and the MFCCs.
- ``ops/resample.batch_resample`` matches JAX's ``batch_resample`` to 1e-5
  (the tolerance of ``tests/test_resample.py`` against the host resampler);
  ``out_count``, ``input_bucket`` and ``is_rational`` are JAX's.
- The device front end (``data/features_device.py``) matches JAX's
  ``features_tpu`` on ragged padded batches with a padding row, at the
  native rate and through the 16 kHz resample, within JAX's own
  device-against-host tolerances (``tests/test_features.py``: power
  1e-2/1e-2, MFCC 2e-2/1e-2): frames past each length exactly 0, NaN where
  JAX's features are NaN, the same frame lengths. An utterance shorter
  than half an FFT window matches JAX's device framing.
- The int16 wire gives the float wire's features bit for bit.

The card-only tests of the front end are in ``test_torch_features_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from speecht_tpu.data import features as jfeatures
from speecht_tpu.data import features_tpu
from speecht_tpu.data import pipeline as jpipeline
from speecht_tpu.ops import resample as jresample
from speecht_tpu_torch.data import features, features_device, pipeline
from speecht_tpu_torch.ops import resample

TOLERANCE = {"power": (1e-2, 1e-2), "mfcc": (2e-2, 1e-2)}  # (atol, rtol)
RESAMPLE_ATOL = 1e-5


def _speech(n, seed):
    pcm = chip_smoke.synthetic_speech(np.random.RandomState(seed), n, 16000)
    return pcm.astype(np.float32) / 32768


@pytest.mark.parametrize("feature_type", ["power", "mfcc"])
@pytest.mark.parametrize("n", [100, 257, 5000, 11025])
def test_host_dsp_bit_equal(feature_type, n):
    audio = _speech(n, seed=n)
    ours = features.FEATURE_FUNCTIONS[feature_type](audio, 22050)
    theirs = jfeatures.FEATURE_FUNCTIONS[feature_type](audio, 22050)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)


def test_feature_size_is_jax():
    for feature_type in ("power", "mfcc"):
        assert features.feature_size(feature_type) == jfeatures.feature_size(
            feature_type
        )


def _padded(lengths, sr_in, seed=0, sample_bucket=None):
    """[B, S] with S a multiple of the resample hop; rows of ``lengths``
    samples (0: a padding row)."""
    S = resample.input_bucket(sample_bucket or 4096, sr_in, 22050)
    S *= -(-max(lengths) // S)
    batch = np.zeros((len(lengths), S), np.float32)
    for i, n in enumerate(lengths):
        if n:
            batch[i, :n] = _speech(n, seed + i)
    return batch, np.array(lengths, np.int32)


@pytest.mark.parametrize(
    "sr_in", [16000, 8000, 44100, 48000, 22050]
)
def test_batch_resample_matches_jax(sr_in):
    batch, _ = _padded([7001, 3000, 0], sr_in)
    ours = resample.batch_resample(torch.from_numpy(batch), sr_in, 22050)
    theirs = np.asarray(jresample.batch_resample(jnp.asarray(batch), sr_in, 22050))
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours.numpy(), theirs, atol=RESAMPLE_ATOL, rtol=0)
    assert ours[2].abs().max() == 0  # a padding row resamples to zeros


def test_resample_helpers_are_jax():
    for sr_in in (16000, 8000, 44100, 44101, 48000, 22050):
        assert resample.is_rational(sr_in, 22050) == jresample.is_rational(
            sr_in, 22050
        )
        for n in (0, 1, 319, 320, 123457, 5 * 60 * 16000):
            assert resample.out_count(n, sr_in, 22050) == jresample.out_count(
                n, sr_in, 22050
            )
        assert resample.input_bucket(
            160 * 512, sr_in, 22050
        ) == jresample.input_bucket(160 * 512, sr_in, 22050)
    counts = torch.tensor([0, 1, 319, 5 * 60 * 16000], dtype=torch.int32)
    assert resample.out_count(counts, 16000, 22050).tolist() == [
        jresample.out_count(int(n), 16000, 22050) for n in counts
    ]
    with pytest.raises(ValueError, match="irrational"):
        resample.batch_resample(torch.zeros(1, 44101), 44101, 22050)


def _compare_to_jax(feature_type, batch, lengths, wire_sr):
    ours, our_lengths = features_device.make_front_end(
        feature_type, wire_sr=wire_sr
    )(torch.from_numpy(batch), torch.from_numpy(lengths))
    theirs, their_lengths = features_tpu.make_front_end(
        feature_type, wire_sr=wire_sr
    )(jnp.asarray(batch), jnp.asarray(lengths))
    ours, theirs = ours.numpy(), np.asarray(theirs)
    assert ours.shape == theirs.shape and ours.dtype == np.float32
    np.testing.assert_array_equal(our_lengths.numpy(), np.asarray(their_lengths))
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(theirs))
    atol, rtol = TOLERANCE[feature_type]
    finite = ~np.isnan(theirs)
    np.testing.assert_allclose(ours[finite], theirs[finite], atol=atol, rtol=rtol)
    for i, frames in enumerate(our_lengths.numpy()):
        assert np.all(ours[i, frames:] == 0)  # exactly 0 past the length
    return ours, our_lengths.numpy()


@pytest.mark.parametrize("feature_type", ["power", "mfcc"])
@pytest.mark.parametrize("wire_sr", [22050, 16000])
def test_front_end_matches_jax(feature_type, wire_sr):
    """Ragged rows, a row shorter than half a window, and a padding row."""
    batch, lengths = _padded([9000, 4321, 200, 0], wire_sr, seed=7)
    ours, frames = _compare_to_jax(feature_type, batch, lengths, wire_sr)
    if feature_type == "power":  # the padding row's one frame is 0/0
        assert np.isnan(ours[3, 0]).all() and frames[3] == 1


@pytest.mark.parametrize("feature_type", ["power", "mfcc"])
def test_front_end_float32_error_on_synthetic_speech(feature_type):
    """On chip_smoke's synthetic speech (16 kHz, the 4.4-7.4 s of phase
    3f) the float32 front end is within 1e-4 of the host's float64
    resample and DSP: the basis of phase 4e's card-against-CPU tolerance
    (two float32 sides, 1e-3)."""
    from speecht_tpu_torch import native

    rng = np.random.RandomState(11)
    lengths = [int(rng.uniform(4.4, 7.4) * 16000) for _ in range(3)]
    batch, lengths = _padded(lengths, 16000, seed=11, sample_bucket=160 * 256)
    ours, frames = features_device.make_front_end(feature_type, wire_sr=16000)(
        torch.from_numpy(batch), torch.from_numpy(lengths)
    )
    for i, n in enumerate(lengths):
        audio = native.resample(batch[i, :n], 16000, 22050)
        host = features.FEATURE_FUNCTIONS[feature_type](audio, 22050)
        assert int(frames[i]) == len(host)
        assert np.abs(ours[i, : len(host)].numpy() - host).max() <= 1e-4


def test_front_end_tiny_utterances_match_jax_device_framing():
    """tests/test_features.py::test_device_framing_tiny_audio's shapes:
    rows of 400 and 350 samples, shorter than the boundary patch window."""
    audio = np.random.RandomState(0).randn(2, 400).astype(np.float32) * 0.1
    _compare_to_jax("power", audio, np.array([400, 350], np.int32), 22050)


def test_int16_wire_gives_the_float_wire():
    batch, lengths = _padded([6000, 2500, 0], 16000, seed=3)
    wire = pipeline.audio_to_int16(batch)
    np.testing.assert_array_equal(wire, jpipeline.audio_to_int16(batch))
    np.testing.assert_array_equal(wire.astype(np.float32) / 32768, batch)
    for feature_type in ("power", "mfcc"):
        front_end = features_device.make_front_end(feature_type, wire_sr=16000)
        a, _ = front_end(torch.from_numpy(wire), torch.from_numpy(lengths))
        b, _ = front_end(torch.from_numpy(batch), torch.from_numpy(lengths))
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    audio_batch = pipeline.AudioBatch(
        batch, lengths, np.zeros((3, 4), np.int32), np.zeros(3, np.int32)
    )
    cpu = torch.device("cpu")
    assert pipeline.to_device(audio_batch, cpu).audio.dtype == torch.int16
    assert pipeline.to_device(audio_batch, cpu, "float32").audio.dtype == (
        torch.float32
    )


def test_build_audio_batch_is_jax():
    rng = np.random.RandomState(4)
    samples = [
        (_speech(n, n), rng.randint(0, 28, size=k).astype(np.int32))
        for n, k in ((3000, 12), (7000, 40), (100, 2))
    ]
    ours = pipeline.build_audio_batch(samples, 2880, pad_to_batch=4)
    theirs = jpipeline.build_audio_batch(samples, 2880, pad_to_batch=4)
    for field in ("audio", "num_samples", "labels", "label_lengths"):
        np.testing.assert_array_equal(getattr(ours, field), getattr(theirs, field))


def test_front_end_pins_float32_matmuls():
    """Whatever the process-wide TF32 setting, the front end's products run
    in IEEE float32, and the setting is restored."""
    matmul = torch.backends.cuda.matmul
    name = "fp32_precision" if hasattr(matmul, "fp32_precision") else "allow_tf32"
    before = getattr(matmul, name)
    seen = []
    real = resample.batch_resample

    def spy(*args):
        seen.append(getattr(matmul, name))
        return real(*args)

    setattr(matmul, name, "tf32" if name == "fp32_precision" else True)
    try:
        resample.batch_resample = spy
        batch, lengths = _padded([4000], 16000)
        features_device.make_front_end("power", wire_sr=16000)(
            torch.from_numpy(batch), torch.from_numpy(lengths)
        )
        after = getattr(matmul, name)
    finally:
        resample.batch_resample = real
        setattr(matmul, name, before)
    assert seen == (["ieee"] if name == "fp32_precision" else [False])
    assert after == ("tf32" if name == "fp32_precision" else True)
