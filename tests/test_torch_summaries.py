"""The port's summaries (``--verbose-summaries``) against the JAX package's.

- ``encode_png_grayscale`` and the image event records are byte-equal.
- Parameter images equal JAX's exactly for weights carried across by
  ``weights.py`` (a strided slice of the same values, in JAX's [W, I, O]
  order), downsampling included.
- Activation and logits histograms of ``make_activation_summarizer``, on
  the default path and on the conv_0 path, float32 on both sides: min, max
  and num within 1e-5 relative; the sums within 1e-5 relative to
  sqrt(num * sum_squares), which bounds the sum of the absolute values (a
  logits sum may cancel to near 0); bucket counts within 3 of JAX's (a
  value within rounding of an edge may fall on the other side) and the
  same total. The logits image within 1e-5.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speecht_tpu.models import wav2letter as jw2l
from speecht_tpu.train import metrics_writer as jwriter
from speecht_tpu.train import summaries as jsummaries
from speecht_tpu_torch.models import wav2letter
from speecht_tpu_torch.ops import conv0_cuda
from speecht_tpu_torch.train import metrics_writer, summaries
from speecht_tpu_torch.weights import params_from_jax

WIDTHS = dict(input_size=64, base_channels=16, wide_channels=300, num_body_layers=1)
RTOL = 1e-5
BUCKET_SLACK = 3


@pytest.fixture(scope="module")
def jparams():
    cfg = jw2l.Wav2LetterConfig(compute_dtype="float32", **WIDTHS)
    tree = nn.meta.unbox(jw2l.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(0)
    return {
        layer: {
            "kernel": np.asarray(leaves["kernel"]),
            "bias": rng.randn(*leaves["bias"].shape).astype(np.float32) * 0.1,
        }
        for layer, leaves in tree.items()
    }


def _model(params):
    model = wav2letter.Wav2Letter(
        wav2letter.Wav2LetterConfig(compute_dtype="float32", **WIDTHS)
    )
    model.load_state_dict(params_from_jax(params))
    return model


@pytest.mark.parametrize(
    "img",
    [np.arange(12.0).reshape(3, 4), np.full((2, 5), 3.0),
     np.random.RandomState(1).randn(40, 29).astype(np.float32)],
    ids=["ramp", "constant", "random"],
)
def test_png_bytes_equal_jax(img):
    assert metrics_writer.encode_png_grayscale(img) == jwriter.encode_png_grayscale(img)


def test_param_images_and_records_equal_jax(jparams):
    model = _model(jparams)
    hists, images = summaries.make_param_summarizer(with_images=True)(
        dict(model.named_parameters())
    )
    jhists, jimages = jax.device_get(
        jsummaries.make_param_summarizer(with_images=True)(jparams)
    )
    assert set(images) == set(jimages) == set(hists) == set(jhists)
    # conv_0/kernel is [48 * 64, 16] before the stride-12 downsample,
    # conv_2/kernel [32 * 16, 300] (both axes strided)
    assert images["conv_0/kernel"].shape == (256, 16)
    assert images["conv_2/kernel"].shape == (256, 150)
    for tag, want in jimages.items():
        np.testing.assert_array_equal(images[tag], np.asarray(want), err_msg=tag)
    mine = metrics_writer._event(1.5, step=3, images=images)
    assert mine == jwriter._event(1.5, step=3, images=images)

    writer_images = {"logits": images["conv_1/kernel"]}
    assert metrics_writer._event(2.0, step=1, raw_histograms=hists,
                                 images=writer_images) == jwriter._event(
        2.0, step=1, raw_histograms=hists, images=writer_images)


def _assert_hist_close(got, want, tag):
    for key in ("min", "max", "num"):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=tag + key)
    scale = np.sqrt(float(want["num"]) * float(want["sum_squares"]))
    for key in ("sum", "sum_squares"):
        atol = RTOL * (scale if key == "sum" else float(want["sum_squares"]))
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=atol,
                                   err_msg=tag + key)
    np.testing.assert_allclose(got["bucket_limits"], want["bucket_limits"],
                               rtol=RTOL, atol=RTOL * float(abs(want["max"] - want["min"])),
                               err_msg=tag)
    buckets, jbuckets = np.asarray(got["buckets"]), np.asarray(want["buckets"])
    assert buckets.sum() == jbuckets.sum() == want["num"], tag
    assert np.abs(buckets - jbuckets).max() <= BUCKET_SLACK, tag


@pytest.mark.parametrize("conv0_path", [False, True])
def test_activation_summaries_match_jax(jparams, monkeypatch, conv0_path):
    if conv0_path:
        monkeypatch.setenv("SPEECHT_PALLAS_CONV0", "1")
    else:
        monkeypatch.delenv("SPEECHT_PALLAS_CONV0", raising=False)
    x = np.random.RandomState(2).randn(2, 96, 64).astype(np.float32)
    jmodel = jw2l.Wav2Letter(jw2l.Wav2LetterConfig(compute_dtype="float32", **WIDTHS))
    jhists, jimages = jax.device_get(
        jsummaries.make_activation_summarizer(jmodel)(jparams, jnp.asarray(x))
    )
    model = _model(jparams)
    before = conv0_cuda.CONV0.plain_calls
    hists, images = summaries.make_activation_summarizer(model)(torch.from_numpy(x))
    # the hooks saw conv_0's output on the path it took
    assert conv0_cuda.CONV0.plain_calls == before + int(conv0_path)
    assert set(hists) == set(jhists) == {
        *(f"activations/conv_{i}" for i in range(len(model.layer_names))), "logits"
    }
    for tag, want in jhists.items():
        _assert_hist_close(hists[tag], want, tag)
    assert set(images) == set(jimages) == {"logits"}
    assert images["logits"].shape == np.asarray(jimages["logits"]).shape == (29, 48)
    np.testing.assert_allclose(images["logits"], np.asarray(jimages["logits"]),
                               rtol=RTOL, atol=RTOL)
    # the hooks are removed after the summary forward
    assert not any(getattr(model, n)._forward_hooks for n in model.layer_names)
