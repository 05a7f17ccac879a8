"""The port's host beam decode against the JAX package's.

- ``native.ctc_beam_search``: the port's library and the JAX package's on
  identical float32 emissions (random rows and peaky rows that spell
  words, T=0 and T=1), with no LM, the ARPA LM and its KenLM binary,
  beam widths 1, 8 and 100, several weight triples and ``prune_top_k`` 0
  and 8. The ids must be exactly equal: the same C++ arithmetic on the
  same input.
- ``decode.blank_collapse`` against JAX's on seeded logits with rows of
  length 0 and all-blank rows, thresholds 0.9 and 0.999: lengths equal,
  values within 1e-6.
- ``BeamSearchDecoder``: its device part (the plain CTC recursion on the
  CPU) and beam against JAX's decoder on the same weights and batches,
  and its pipelined ``eval_batches`` against sequential ``eval_step``, as
  ``test_beam.py`` checks JAX's; with ``--device-beam`` against JAX's
  device-beam decoder; ``--rescore`` alone raises. Beam pools use 2
  threads.
"""

import itertools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speecht_tpu import native as jnative
from speecht_tpu import vocabulary
from speecht_tpu.config import LanguageModelConfig as JaxLMConfig
from speecht_tpu.data.pipeline import Batch as JaxBatch
from speecht_tpu.models.wav2letter import Wav2Letter as JaxWav2Letter
from speecht_tpu.models.wav2letter import Wav2LetterConfig as JaxConfig
from speecht_tpu.ops import beam as jbeam
from speecht_tpu.ops import decode as jdecode
from speecht_tpu_torch import native
from speecht_tpu_torch.data.pipeline import Batch, to_device
from speecht_tpu_torch.models.wav2letter import Wav2Letter, Wav2LetterConfig
from speecht_tpu_torch.ops import decode
from speecht_tpu_torch.ops.beam import BeamSearchDecoder, LanguageModelConfig
from speecht_tpu_torch.weights import params_from_jax
from test_beam import ARPA, emissions_for_text, softmax_logs

BLANK = vocabulary.BLANK_ID


@pytest.fixture(scope="module")
def lm_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm")
    (d / "model.arpa").write_text(ARPA)
    (d / "vocabulary").write_text("the\ncat\ndog\nsat\n")
    jnative.lm_write_binary(str(d / "model.arpa"), str(d / "model.binary"))
    return d


def _rows():
    """Emission rows [T, 29]: random, peaky ones that spell words with
    alternates and blanks between them, and the T=0 and T=1 edges."""
    rng = np.random.RandomState(0)
    rows = [softmax_logs(rng.randn(T, 29).astype(np.float32) * s)
            for T, s in ((40, 1.0), (60, 3.0), (25, 6.0))]
    for text, smear in (("the cat sat", {1: (7, 2.5), 5: (0, 2.0)}),
                        ("the dog sat", {4: (2, 2.9)}),
                        ("thecat dgo", None)):
        peaky = emissions_for_text(text, confidence=4.0, smear=smear)
        # blank frames between the letters, as a CTC model emits
        blank = softmax_logs(np.eye(29, dtype=np.float32)[[BLANK]] * 4.0)
        rows.append(np.concatenate(
            [np.concatenate([f[None], blank]) for f in peaky]
        ))
    rows.append(np.zeros((0, 29), np.float32))
    rows.append(softmax_logs(rng.randn(1, 29).astype(np.float32)))
    return rows


WEIGHTS = [(0.8, 0.0, 2.3), (0.0, 0.0, 0.0), (2.0, -1.0, 0.5), (0.3, 1.5, -2.0)]


@pytest.mark.parametrize("width", [1, 8, 100])
@pytest.mark.parametrize("lm_kind", [None, "arpa", "binary"])
def test_ctc_beam_search_matches_jax(lm_dir, lm_kind, width):
    ours = theirs = None
    if lm_kind is not None:
        path = str(lm_dir / f"model.{lm_kind}")
        ours = native.NGramLM(path, str(lm_dir / "vocabulary"))
        theirs = jnative.NGramLM(path, str(lm_dir / "vocabulary"))
    checked = 0
    for row in _rows():
        for lm_w, wc_w, vwc_w in WEIGHTS:
            for top_k in (0, 8):
                kwargs = dict(
                    beam_width=width, lm_weight=lm_w, word_count_weight=wc_w,
                    valid_word_count_weight=vwc_w, blank_id=BLANK,
                    prune_top_k=top_k,
                )
                got = native.ctc_beam_search(row, lm=ours, **kwargs)
                want = jnative.ctc_beam_search(row, lm=theirs, **kwargs)
                np.testing.assert_array_equal(got, want)
                assert got.dtype == np.int32
                checked += len(want)
    assert checked > 0


def test_ctc_beam_search_fuses_the_lm(lm_dir):
    """The weights reach the search: the valid-word bonus steers
    ``test_beam.py``'s "cbt " emissions to the LM's word "cat"."""
    lm = native.NGramLM(str(lm_dir / "model.arpa"), str(lm_dir / "vocabulary"))
    row = emissions_for_text("cbt ", smear={1: (0, 2.9)})
    plain = native.ctc_beam_search(row, 30, lm, 0.0, 0.0, 0.0)
    fused = native.ctc_beam_search(row, 30, lm, 0.0, 0.0, 5.0)
    assert vocabulary.ids_to_sentence(plain) == "cbt "
    assert vocabulary.ids_to_sentence(fused) == "cat "


def test_ctc_beam_search_rejects_bad_input():
    with pytest.raises(ValueError, match=r"\[T, C\]"):
        native.ctc_beam_search(np.zeros((2, 3, 29), np.float32))
    with pytest.raises(ValueError, match="beam_width"):
        native.ctc_beam_search(np.zeros((2, 29), np.float32), beam_width=0)
    with pytest.raises(ValueError, match="blank_id"):
        native.ctc_beam_search(np.zeros((2, 5), np.float32), blank_id=28)


def _collapse_case(seed):
    rng = np.random.RandomState(seed)
    B, T = 6, 45
    logits = (rng.randn(B, T, 29) * 3).astype(np.float32)
    logits[:, ::2, BLANK] += 14.0  # confident blanks on every other frame
    logits[3, :, BLANK] += 40.0  # an all-blank row
    lengths = rng.randint(1, T + 1, size=B).astype(np.int32)
    lengths[0], lengths[1] = 0, T
    return logits, lengths


@pytest.mark.parametrize("threshold", [0.9, 0.999])
@pytest.mark.parametrize("seed", [0, 1])
def test_blank_collapse_matches_jax(seed, threshold):
    logits, lengths = _collapse_case(seed)
    want, want_len = jdecode.blank_collapse(
        jnp.asarray(logits), jnp.asarray(lengths), threshold
    )
    got, got_len = decode.blank_collapse(
        torch.from_numpy(logits), torch.from_numpy(lengths), threshold
    )
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert got_len.dtype == torch.int32 and got.dtype == torch.float32
    assert got_len[0] == 0 and got_len[3] == 0  # no frames, all blank
    assert 0 < got_len[1] < lengths[1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


TINY = dict(input_size=8, base_channels=16, wide_channels=32,
            num_body_layers=2, compute_dtype="float32")


@pytest.fixture(scope="module")
def models():
    jmodel = JaxWav2Letter(JaxConfig(**TINY))
    params = nn.meta.unbox(jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 8), jnp.float32)
    )["params"])
    model = Wav2Letter(Wav2LetterConfig(**TINY))
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    return jmodel, params, model.eval()


def _batch(seed):
    r = np.random.RandomState(seed)
    return Batch(
        features=r.randn(3, 64, 8).astype(np.float32),
        seq_lengths=np.array([64, 41, 0], np.int32),
        labels=r.randint(0, 5, (3, 6)).astype(np.int32),
        label_lengths=np.array([6, 4, 0], np.int32),
    )


def _config(cls, lm_dir, **kwargs):
    return cls(language_model=str(lm_dir), beam_width=8,
               blank_threshold=0.9, **kwargs)


def test_eval_step_matches_jax_decoder(models, lm_dir):
    jmodel, params, model = models
    ours = BeamSearchDecoder(model, _config(LanguageModelConfig, lm_dir),
                             num_threads=2)
    theirs = jbeam.BeamSearchDecoder(jmodel, _config(JaxLMConfig, lm_dir),
                                     num_threads=2)
    try:
        for seed in range(3):
            batch = _batch(seed)
            _loss, logp, lengths = ours.device_part(to_device(batch, torch.device("cpu"), "float32"))
            _jl, jlogp, jlengths = theirs._device_part(
                params, JaxBatch(**vars(batch))
            )
            np.testing.assert_array_equal(lengths.numpy(), np.asarray(jlengths))
            np.testing.assert_allclose(
                logp.numpy(), np.asarray(jlogp), rtol=1e-5, atol=1e-5
            )
            loss, decoded, dec_lengths = ours.eval_step(
                to_device(batch, torch.device("cpu"), "float32")
            )
            jloss, jdecoded, jdec_lengths = theirs.eval_step(
                params, JaxBatch(**vars(batch))
            )
            assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
            np.testing.assert_array_equal(dec_lengths, np.asarray(jdec_lengths))
            np.testing.assert_array_equal(decoded, np.asarray(jdecoded))
            assert dec_lengths[2] == 0  # the padding row decodes to nothing
    finally:
        ours.close()


def test_eval_batches_match_sequential_eval_step(models, lm_dir):
    _jmodel, _params, model = models
    beam = BeamSearchDecoder(model, _config(LanguageModelConfig, lm_dir),
                             num_threads=2)
    assert beam.blank_threshold == 0.9  # taken from the config
    try:
        cpu = torch.device("cpu")
        pairs = [(b, to_device(b, cpu, "float32")) for b in map(_batch, range(3))]
        sequential = [beam.eval_step(dev) for _host, dev in pairs]
        pipelined = list(beam.eval_batches(iter(pairs)))
        assert len(pipelined) == 3
        for (host, loss_p, dec_p, len_p), (loss_s, dec_s, len_s), (orig, _d) in zip(
            pipelined, sequential, pairs
        ):
            assert host is orig
            assert float(loss_p) == float(loss_s)
            np.testing.assert_array_equal(dec_p, dec_s)
            np.testing.assert_array_equal(len_p, len_s)
    finally:
        beam.close()


def test_device_beam_raises(models, lm_dir, tmp_path, monkeypatch):
    """The device-beam decoder decodes on the CPU as JAX's does: each
    batch through the plain search over the LM tables gives JAX's
    device-beam decoder's ids. (The name is that of the refusal this
    decoder raised before it was ported; it no longer raises.)"""
    monkeypatch.setenv("SPEECHT_DEVICE_LM_CACHE", str(tmp_path))
    jmodel, params, model = models
    ours = BeamSearchDecoder(
        model, _config(LanguageModelConfig, lm_dir, device_beam=True),
        num_threads=2,
    )
    theirs = jbeam.BeamSearchDecoder(
        jmodel, _config(JaxLMConfig, lm_dir, device_beam=True), num_threads=2
    )
    try:
        assert ours.device_beam and ours.lm is None
        for seed in range(3):
            batch = _batch(seed)
            loss, decoded, dec_lengths = ours.eval_step(
                to_device(batch, torch.device("cpu"), "float32")
            )
            jloss, jdecoded, jdec_lengths = theirs.eval_step(
                params, JaxBatch(**vars(batch))
            )
            assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
            np.testing.assert_array_equal(dec_lengths, np.asarray(jdec_lengths))
            np.testing.assert_array_equal(decoded, np.asarray(jdecoded))
            assert dec_lengths[2] == 0  # the padding row decodes to nothing
    finally:
        ours.close()


@pytest.mark.parametrize("lm_kind", ["arpa", "binary"])
def test_rescore_matches_jax(models, lm_dir, lm_kind, tmp_path):
    """``--device-beam --rescore 4``: the pure-acoustic device n-best,
    rescored by the host LM (ARPA or KenLM binary), decodes as JAX's."""
    jmodel, params, model = models
    d = tmp_path / "lm"
    d.mkdir()
    (d / f"model.{lm_kind}").write_bytes((lm_dir / f"model.{lm_kind}").read_bytes())
    (d / "vocabulary").write_bytes((lm_dir / "vocabulary").read_bytes())
    ours = BeamSearchDecoder(
        model, _config(LanguageModelConfig, d, device_beam=True, rescore_n=4),
        num_threads=2,
    )
    theirs = jbeam.BeamSearchDecoder(
        jmodel, _config(JaxLMConfig, d, device_beam=True, rescore_n=4),
        num_threads=2,
    )
    try:
        assert ours.lm is not None and ours._beam_fn.spec.n_best == 4
        for seed in range(3):
            batch = _batch(seed)
            _loss, decoded, dec_lengths = ours.eval_step(
                to_device(batch, torch.device("cpu"), "float32")
            )
            _jl, jdecoded, jdec_lengths = theirs.eval_step(
                params, JaxBatch(**vars(batch))
            )
            np.testing.assert_array_equal(dec_lengths, np.asarray(jdec_lengths))
            np.testing.assert_array_equal(decoded, np.asarray(jdecoded))
    finally:
        ours.close()


def test_rescore_without_device_beam_raises(models, lm_dir):
    _jmodel, _params, model = models
    with pytest.raises(ValueError, match="--rescore requires --device-beam"):
        BeamSearchDecoder(model, _config(LanguageModelConfig, lm_dir,
                                         rescore_n=4))


def test_no_language_model_decodes_without_lm(models):
    _jmodel, _params, model = models
    beam = BeamSearchDecoder(model, LanguageModelConfig(beam_width=4),
                             num_threads=2)
    try:
        assert beam.lm is None
        _loss, decoded, lengths = beam.eval_step(
            to_device(_batch(0), torch.device("cpu"), "float32")
        )
        assert decoded.shape == (3, 32) and lengths[2] == 0
    finally:
        beam.close()


@pytest.mark.parametrize("width,rescore", [(1024, 0), (1025, 0), (1025, 4)])
def test_device_beam_width_follows_the_kernel_limits(models, lm_dir, tmp_path,
                                                     monkeypatch, capsys, width,
                                                     rescore):
    """The decoder decides from the flags, before it loads the LM, whether
    the kernel takes the width: 1024 keeps ``--device-beam``; 1025 prints
    the fall-back and decodes on the host beam (under ``--rescore`` without
    the rescoring), as a host-beam decoder of that width does."""
    monkeypatch.setenv("SPEECHT_DEVICE_LM_CACHE", str(tmp_path))
    _jmodel, _params, model = models
    cfg = dict(device_beam=True, rescore_n=rescore, beam_width=width)
    ours = BeamSearchDecoder(
        model, LanguageModelConfig(language_model=str(lm_dir),
                                   blank_threshold=0.9, **cfg),
        num_threads=2,
    )
    out = capsys.readouterr().out
    try:
        if width <= 1024:
            assert ours.device_beam and "falling back" not in out
            return
        assert not ours.device_beam and ours.rescore_n == 0
        assert ours.lm is not None
        assert ("device beam kernel: beam width 1025 is more than the "
                "kernel's 1024; falling back to the host beam") in out
        assert ("without --rescore 4" in out) == bool(rescore)
        host = BeamSearchDecoder(
            model, LanguageModelConfig(language_model=str(lm_dir),
                                       blank_threshold=0.9, beam_width=width),
            num_threads=2,
        )
        try:
            batch = to_device(_batch(0), torch.device("cpu"), "float32")
            got, want = ours.eval_step(batch), host.eval_step(batch)
            for g, w in zip(got[1:], want[1:]):
                np.testing.assert_array_equal(g, w)
        finally:
            host.close()
    finally:
        ours.close()


def test_device_beam_candidate_limit_falls_back(models, lm_dir, monkeypatch,
                                                capsys):
    """Every char a frame (top-k 0: K = 29) at width 2185 is 65550
    candidates, past the kernel's int16 index: the decoder names that limit
    and takes the host beam."""
    _jmodel, _params, model = models
    monkeypatch.setattr(BeamSearchDecoder, "prune_top_k", 0)
    ours = BeamSearchDecoder(
        model, LanguageModelConfig(language_model=str(lm_dir), beam_width=2185,
                                   device_beam=True),
        num_threads=2,
    )
    ours.close()
    out = capsys.readouterr().out
    assert not ours.device_beam
    assert "(top-k 29 + 1) x beam width 2185 candidates is more than 65535" in out
    assert "falling back to the host beam" in out


@pytest.mark.parametrize(
    "W,K,H,limits",
    [(1024, 8, 5, []), (1024, 8, 1, []), (1, 1, 0, []), (1025, 8, 5, ["width"]),
     (1024, 64, 1, ["candidates", "shared memory"]), (1024, 29, 1, ["shared memory"]),
     (512, 29, 5, [])],
)
def test_shape_limits(W, K, H, limits):
    from speecht_tpu_torch.ops import beam_device_cuda

    found = beam_device_cuda.shape_limits(W, K, H)
    assert len(found) == len(limits)
    for phrase, word in zip(found, limits):
        assert word in phrase


def _first_kernel_smem_bytes(W, K, H):
    """The shared memory of the device beam kernel's first version (a
    bitonic sort of next_pow2((K+1)·W) keys): the widths it took."""
    P2 = 1 << max(0, ((K + 1) * W - 1).bit_length())
    regions = (128, 128, 128, 6 * W * 4, 6 * W * 4, 5 * W * 4, W * max(H, 1) * 4, W,
               W * K * 2, P2 * 4, P2 * 2)
    total = 0
    for n in regions:
        total = (total + n + 15) & ~15
    return total


def test_shape_limits_admit_every_earlier_shape():
    """Every (W, K, H) the first kernel took, the redesigned one takes, so
    no ``--device-beam`` width that ran on the card falls back to the host
    beam."""
    from speecht_tpu_torch.ops import beam_device_cuda

    widths = (1, 2, 31, 32, 33, 64, 100, 127, 128, 255, 256, 500, 512, 513, 700,
              1000, 1023, 1024)
    taken = 0
    for W, K, H in itertools.product(widths, range(1, 33), range(0, 6)):
        if (K + 1) * W <= 0xFFFF and _first_kernel_smem_bytes(W, K, H) <= 232448:
            taken += 1
            assert beam_device_cuda.shape_limits(W, K, H) == [], (W, K, H)
    assert taken > 3000
