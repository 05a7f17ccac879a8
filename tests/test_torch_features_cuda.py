"""The audio front end on the card against the CPU (card-only).

Marked ``cuda``: skipped where there is no card. This file imports torch
and numpy only (no JAX), so it runs on the card's machine:

    python -m pytest tests/test_torch_features_cuda.py -m cuda -q

The device front end (resample 16000 -> 22050, framing, rFFT, mel, dB,
normalization; power and MFCC) on the card against the CPU on one padded
batch with a row shorter than half a window and a padding row, to
``chip_smoke.py``'s phase-4e tolerance (1e-3 + 1e-3 x |value|); the
from-audio eval step (float32, TF32 off) card against CPU as phase 4
holds an eval step: the loss to 1e-4 relative, at least 99% of the decoded
tokens equal, the padding row decoded to length 0.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from speecht_tpu_torch.data import features_device, pipeline
from speecht_tpu_torch.ops import resample


def _speech(n, seed):
    pcm = chip_smoke.synthetic_speech(np.random.RandomState(seed), n, 16000)
    return pcm.astype(np.float32) / 32768


def _padded(lengths, seed):
    S = resample.input_bucket(4096, 16000, 22050)
    S *= -(-max(lengths) // S)
    batch = np.zeros((len(lengths), S), np.float32)
    for i, n in enumerate(lengths):
        if n:
            batch[i, :n] = _speech(n, seed + i)
    return batch, np.array(lengths, np.int32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: see README)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("feature_type", ["power", "mfcc"])
def test_front_end_on_the_card_matches_the_cpu(cuda_device, feature_type):
    batch, lengths = _padded([90000, 61234, 100, 0], seed=9)
    front_end = features_device.make_front_end(feature_type, wire_sr=16000)
    wire = torch.from_numpy(pipeline.audio_to_int16(batch))
    n = torch.from_numpy(lengths)
    got, got_frames = front_end(wire.to(cuda_device), n.to(cuda_device))
    want, want_frames = front_end(wire, n)
    got = got.cpu()
    assert torch.equal(got_frames.cpu(), want_frames)
    assert torch.equal(got.isnan(), want.isnan())
    ok = ~want.isnan()
    torch.testing.assert_close(
        got[ok], want[ok], atol=chip_smoke.FRONT_END_ATOL,
        rtol=chip_smoke.FRONT_END_RTOL,
    )


@pytest.mark.cuda
def test_audio_eval_step_on_the_card_matches_the_cpu(cuda_device):
    from speecht_tpu_torch.models.wav2letter import Wav2Letter, Wav2LetterConfig
    from speecht_tpu_torch.train.step import make_audio_eval_step

    samples = [
        (_speech(n, n), np.random.RandomState(n).randint(0, 28, size=20))
        for n in (30000, 24000, 20000)
    ]
    batch = pipeline.build_audio_batch(
        samples, resample.input_bucket(160 * 256, 16000, 22050), pad_to_batch=4
    )
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    outs = []
    try:
        for device in (cuda_device, torch.device("cpu")):
            model = Wav2Letter(
                Wav2LetterConfig(base_channels=32, wide_channels=64,
                                 compute_dtype="float32"),
                generator=torch.Generator().manual_seed(0),
            ).to(device).eval()
            step = make_audio_eval_step(
                model, features_device.make_front_end("power", wire_sr=16000)
            )
            loss, decoded, lengths = step(pipeline.to_device(batch, device))
            outs.append((float(loss), decoded.cpu(), lengths.cpu()))
    finally:
        torch.backends.cudnn.allow_tf32 = before
    (lg, dg, ng), (lc, dc, nc) = outs
    assert abs(lg - lc) <= chip_smoke.PARITY_LOSS_RTOL * abs(lc)
    assert ng[-1] == nc[-1] == 0
    width = torch.maximum(ng, nc)
    same = sum(int((dg[i, :w] == dc[i, :w]).sum()) for i, w in enumerate(width))
    assert same >= chip_smoke.PARITY_MIN_TOKEN_SHARE * max(int(width.sum()), 1)
