"""The port's streaming pieces against the JAX package's.

- ``ops/resample.StreamResampler``: the same chunks (sizes from a seed,
  one chunk longer than the guard, one of a single sample) through both
  resamplers, chunk by chunk: the same number of samples out of every
  ``process`` and of ``flush``, bit-equal (both call the same windowed
  sinc in their own C++ library), and the whole equal to one
  ``native.resample`` of the signal.
- ``native.ctc_beam_search_cont``: random log-probs with committed
  context (none, complete words, a trailing partial word, a repeat carry
  ending mid-character or in a blank), no LM, the ARPA LM and its KenLM
  binary: ids equal to the JAX package's library (the same C++).
- ``ops/streaming.StreamingRecognizer`` (float32 compute, a few layers):
  the incremental features (``debug_buffers``: mel power and log-mel) and
  the frozen dB / MFCC rows against JAX's recognizer on the same chunks;
  the committed and partial text after each chunk; ``finalize`` greedy and
  through a beam decoder with the ARPA LM; ``partial_text_fused`` after
  each chunk; the window guard. Both sides compute the same float64 host
  features (the features to 1e-12 relative: numpy's FFT on both), and the
  logits of both models agree to 1e-4 (``test_torch_wav2letter.py``), so
  each text is compared exactly on audio that keeps no logit frame within
  1e-3 of a tie (checked on the final logits; the last layer is scaled so
  the logits are peaky, as a trained model's).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speecht_tpu import native as jnative
from speecht_tpu.config import LanguageModelConfig as JaxLMConfig
from speecht_tpu.models.wav2letter import Wav2Letter as JaxWav2Letter
from speecht_tpu.models.wav2letter import Wav2LetterConfig as JaxConfig
from speecht_tpu.ops import beam as jbeam
from speecht_tpu.ops import resample as jresample
from speecht_tpu.ops import streaming as jstreaming
from speecht_tpu_torch import native
from speecht_tpu_torch.models.wav2letter import Wav2Letter, Wav2LetterConfig
from speecht_tpu_torch.ops import resample, streaming
from speecht_tpu_torch.ops.beam import BeamSearchDecoder, LanguageModelConfig
from speecht_tpu_torch.weights import params_from_jax
from test_beam import ARPA, softmax_logs

TINY = dict(input_size=128, base_channels=16, wide_channels=32, num_body_layers=2,
            compute_dtype="float32")


@pytest.fixture(scope="module")
def lm_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm")
    (d / "model.arpa").write_text(ARPA)
    (d / "vocabulary").write_text("the\ncat\ndog\nsat\n")
    jnative.lm_write_binary(str(d / "model.arpa"), str(d / "model.binary"))
    return d


def _models(cfg, seed):
    """JAX's and the port's model on the same seeded parameters, the last
    layer scaled by 100 so the logits are peaky (their gaps of order 1, as
    a trained model's) rather than all within 0.1 of each other."""
    jmodel = JaxWav2Letter(JaxConfig(**cfg))
    params = jax.device_get(nn.meta.unbox(jmodel.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 64, cfg["input_size"])))["params"]))
    last = f"conv_{len(params) - 1}"
    params = {**params, last: {k: np.asarray(v) * 100.0 for k, v in params[last].items()}}
    model = Wav2Letter(Wav2LetterConfig(**cfg))
    model.load_state_dict(params_from_jax(params))
    return jmodel, params, model.eval()


@pytest.fixture(scope="module")
def models():
    return _models(TINY, 0)


def speechlike_audio(seconds, sr=16000, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(int(sr * seconds)) / sr
    x = np.zeros_like(t)
    for f in (220, 440, 880, 1760):
        x += rng.rand() * np.sin(2 * np.pi * f * t + rng.rand())
    x *= 0.3 + 0.7 * np.abs(np.sin(2 * np.pi * 3.0 * t))
    x += 0.05 * rng.randn(len(t))
    return (x / np.abs(x).max() * 0.5).astype(np.float32)


# -- StreamResampler -------------------------------------------------------


@pytest.mark.parametrize("sr_in,sr_out", [(16000, 22050), (22050, 16000), (8000, 22050)])
def test_stream_resampler_matches_jax_chunk_by_chunk(sr_in, sr_out):
    rng = np.random.RandomState(sr_in + sr_out)
    audio = rng.randn(int(1.3 * sr_in)).astype(np.float32) * 0.3
    sizes = [1, 4096, 700, 3, 9000] + list(rng.randint(1, 3000, size=20))
    ours, theirs = resample.StreamResampler(sr_in, sr_out), jresample.StreamResampler(sr_in, sr_out)
    pieces, pos = [], 0
    for n in sizes:
        chunk = audio[pos:pos + n]
        pos += n
        a, b = ours.process(chunk), theirs.process(chunk)
        assert a.dtype == np.float32 and len(a) == len(b)
        np.testing.assert_array_equal(a, b)
        pieces.append(a)
        if pos >= len(audio):
            break
    a, b = ours.flush(), theirs.flush()
    np.testing.assert_array_equal(a, b)
    whole = np.concatenate(pieces + [a])
    np.testing.assert_array_equal(whole, native.resample(audio[:pos], sr_in, sr_out))
    with pytest.raises(RuntimeError, match="already flushed"):
        ours.process(audio[:10])


# -- the continuation beam -------------------------------------------------


@pytest.mark.parametrize("lm_kind", [None, "arpa", "binary"])
@pytest.mark.parametrize(
    "context,last,ended_in_blank",
    [("", -1, True), ("the cat", -1, True), ("the ca", 2, False),
     ("the c", 2, True), ("dog", 6, False), ("the cat ", 27, True)],
)
def test_ctc_beam_search_cont_matches_jax(lm_dir, lm_kind, context, last, ended_in_blank):
    rng = np.random.RandomState(len(context) + last + 1)
    lm = jlm = None
    if lm_kind:
        path = str(lm_dir / f"model.{lm_kind}")
        lm = native.NGramLM(path, str(lm_dir / "vocabulary"))
        jlm = jnative.NGramLM(path, str(lm_dir / "vocabulary"))
    for T, scale in ((30, 1.0), (50, 4.0), (1, 2.0), (0, 1.0)):
        logp = softmax_logs(rng.randn(T, 29).astype(np.float32) * scale)
        for width, weights in ((8, (0.8, 0.0, 2.3)), (32, (2.0, -1.0, 0.5))):
            kwargs = dict(context_text=context, last_char_id=last,
                          ended_in_blank=ended_in_blank, beam_width=width,
                          lm_weight=weights[0], word_count_weight=weights[1],
                          valid_word_count_weight=weights[2])
            got = native.ctc_beam_search_cont(logp, lm=lm, **kwargs)
            want = jnative.ctc_beam_search_cont(logp, lm=jlm, **kwargs)
            np.testing.assert_array_equal(got, want)
            if not context and last < 0:
                np.testing.assert_array_equal(
                    got, native.ctc_beam_search(
                        logp, beam_width=width, lm=lm, lm_weight=weights[0],
                        word_count_weight=weights[1],
                        valid_word_count_weight=weights[2]))


def test_ctc_beam_search_cont_refuses_bad_input():
    with pytest.raises(ValueError, match=r"\[T, C\]"):
        native.ctc_beam_search_cont(np.zeros(29, np.float32))
    with pytest.raises(ValueError, match="beam_width"):
        native.ctc_beam_search_cont(np.zeros((3, 29), np.float32), beam_width=0)


# -- StreamingRecognizer ---------------------------------------------------


def _assert_no_near_tie(logits):
    top2 = np.sort(logits, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 1e-3


@pytest.mark.parametrize("feature_type", ["power", "mfcc"])
def test_recognizer_matches_jax_chunk_by_chunk(models, feature_type):
    jmodel, params, model = models
    if feature_type == "mfcc":
        jmodel, params, model = _models(dict(TINY, input_size=39), 1)
    sr = 16000
    audio = speechlike_audio(3.0, sr, seed=1)
    ours = streaming.StreamingRecognizer(model, sample_rate=sr, feature_type=feature_type,
                                         window_frames=384, debug_buffers=True)
    theirs = jstreaming.StreamingRecognizer(jmodel, params, sample_rate=sr,
                                            feature_type=feature_type,
                                            window_frames=384, debug_buffers=True)
    # chunks of a mic's 4096 samples, then one longer than a window (the
    # catch-up sweep), then small ones
    rng = np.random.RandomState(0)
    bounds = np.cumsum([4096] * 4 + [20000] + list(rng.randint(200, 3000, size=40)))
    chunks = np.split(audio, bounds[bounds < len(audio)])
    for chunk in chunks:
        got, want = ours.accept_chunk(chunk), theirs.accept_chunk(chunk)
        assert got == want
        assert ours.committed_text() == theirs.committed_text()
        assert ours._frontier == theirs._frontier and ours._good_rows == theirs._good_rows
    np.testing.assert_allclose(ours._mel_power, theirs._mel_power, rtol=1e-12)
    np.testing.assert_allclose(ours._log_mel, theirs._log_mel, rtol=1e-12, atol=1e-9)
    frozen = "_db" if feature_type == "power" else "_mfcc"
    np.testing.assert_allclose(getattr(ours, frozen), getattr(theirs, frozen),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(ours._logits, np.asarray(theirs._logits),
                               rtol=1e-4, atol=1e-4)
    logits = ours.finalize_logits()
    np.testing.assert_allclose(logits, theirs.finalize_logits(), rtol=1e-4, atol=1e-4)
    _assert_no_near_tie(logits)
    assert ours.finalize() == theirs.finalize()


def test_fused_partials_and_lm_finalize_match_jax(models, lm_dir):
    jmodel, params, model = models
    sr = 16000
    audio = speechlike_audio(2.5, sr, seed=2)
    ours = streaming.StreamingRecognizer(model, sample_rate=sr, window_frames=384)
    theirs = jstreaming.StreamingRecognizer(jmodel, params, sample_rate=sr,
                                            window_frames=384)
    path, vocab = str(lm_dir / "model.arpa"), str(lm_dir / "vocabulary")
    lm, jlm = native.NGramLM(path, vocab), jnative.NGramLM(path, vocab)
    for chunk in np.array_split(audio, 12):
        ours.accept_chunk(chunk)
        theirs.accept_chunk(chunk)
        for weights in ((0.8, 0.0, 2.3), (2.0, 1.0, 0.5)):
            kwargs = dict(lm_weight=weights[0], word_count_weight=weights[1],
                          valid_word_count_weight=weights[2], beam_width=16)
            assert ours.partial_text_fused(lm, **kwargs) == \
                theirs.partial_text_fused(jlm, **kwargs)
    _assert_no_near_tie(ours.finalize_logits())
    cfg = dict(language_model=str(lm_dir), beam_width=16)
    beam = BeamSearchDecoder(model, LanguageModelConfig(**cfg), num_threads=2)
    jbeam_dec = jbeam.BeamSearchDecoder(jmodel, JaxLMConfig(**cfg), num_threads=2)
    try:
        assert ours.finalize(beam=beam) == theirs.finalize(beam=jbeam_dec)
        assert ours.finalize(beam=beam, lm_weight=3.0) == \
            theirs.finalize(beam=jbeam_dec, lm_weight=3.0)
    finally:
        beam.close()


def test_greedy_collapse_matches_jax():
    rng = np.random.RandomState(5)
    for prev in (-1, 28, 3):
        path = rng.randint(0, 29, size=60)
        assert streaming.greedy_collapse_carry(path, prev) == \
            jstreaming.greedy_collapse_carry(path, prev)
        assert streaming.greedy_collapse(path, prev) == jstreaming.greedy_collapse(path, prev)


def test_window_and_feature_guards(models):
    _jmodel, _params, model = models
    for W in (4 * streaming.MARGIN_ROWS, 511):
        with pytest.raises(ValueError, match="window_frames"):
            streaming.StreamingRecognizer(model, window_frames=W)
    with pytest.raises(ValueError, match="does not match feature type 'mfcc'"):
        streaming.StreamingRecognizer(model, feature_type="mfcc")
    with pytest.raises(ValueError, match="unsupported feature type"):
        streaming.StreamingRecognizer(model, feature_type="raw")
    assert (streaming.RIGHT_CONTEXT, streaming.MARGIN_ROWS) == \
        (jstreaming.RIGHT_CONTEXT, jstreaming.MARGIN_ROWS)


def test_window_runs_on_the_models_device(models, monkeypatch):
    """Only a window's [W//2, C] logits come back: the forward step gets
    the window as a tensor on the model's device."""
    _jmodel, _params, model = models
    rec = streaming.StreamingRecognizer(model, sample_rate=16000, window_frames=384)
    seen = []
    step = rec._forward_step
    rec._forward_step = lambda x: seen.append((x.device, tuple(x.shape))) or step(x)
    rec.accept_chunk(speechlike_audio(2.0, seed=3))
    assert seen and all(d == torch.device("cpu") and s[:2] == (1, 384) for d, s in seen[:-1])
