"""Serving artifacts: the inference program as a ``torch.export`` program.

Counterpart of ``speecht_tpu/serving.py``. The whole inference program,
the conv stack and the greedy CTC decode with the weights inside it, is
captured with ``torch.export.export`` and written with
``torch.export.save`` into an artifact that a host with torch alone can
load and run, without this package, a checkpoint or the model's code:

- **shape-polymorphic by default**: batch is ``Dim("b")`` and frames are
  ``2 * Dim("t")`` (the stride-2 first conv wants an even input, and the
  bucketed pipeline only makes even frame counts), so one artifact serves
  every batch size and every even frame count. ``batch_size``/``frames``
  fix a dimension.
- **one program per platform**: ``platforms`` names torch devices,
  ``cuda`` and ``cpu`` (default both). Each is traced once on its own
  device (a copy of the model moved there), not exported on the CPU and
  moved with ``move_to_device_pass``, so every constant the trace makes
  (index ranges, the front end's resample and mel matrices) is created on
  the device the program runs on. A platform torch cannot run here
  (``tpu``, any other name; ``cuda`` without a card) raises and names
  itself; none is dropped from the list.
- **self-describing**: ``manifest.json`` has JAX's keys (feature type and
  geometry, the input/output contract, the alphabet, so ids turn into
  text without this package), with ``torch_version`` in place of
  ``jax_version`` and ``calling_convention_version``, and ``conv0_path``.

The files differ from JAX's single ``wav2letter_greedy.stablehlo``: one
``wav2letter_greedy.<platform>.pt2`` a platform
(``wav2letter_greedy_from_audio.<platform>.pt2`` for ``from_audio``), and
the manifest's ``artifact`` and ``bytes`` map each platform to its file
and its size.

The program's contract (all inputs and outputs dense):

    (features [B, T, input_size] f32, seq_lengths [B] i32)
      -> (decoded [B, T'] i32 padded with -1, decoded_lengths [B] i32,
          logits [B, T', num_classes] f32)   with T' = T // 2

What it does not capture:

- **The conv_0 kernel.** ``csrc/conv0.cu`` is launched through ``ctypes``
  (``ops/cuda_build.py``), which ``torch.export`` cannot trace, so the
  program's conv_0 is always ``F.conv1d`` (cuDNN on the card), as JAX's
  exported program never takes the Pallas branch; with
  ``SPEECHT_PALLAS_CONV0=1`` set, :func:`export_stablehlo` raises rather
  than trace another path than the one asked for.
- **The float32 matmul setting.** The from-audio program's resample and
  mel products must run in IEEE float32 (``ops/resample.float32_matmuls``),
  a process-wide backend flag no graph holds; the runner that
  :func:`load_stablehlo` returns sets it around every call.

bf16 compute with float32 parameters survives the export: the casts are
inside ``Wav2Letter.forward``, so they are ops of the graph.
"""

from __future__ import annotations

import copy
import json
import math
import os

import torch
from torch import nn

from speecht_tpu_torch import vocabulary
from speecht_tpu_torch.models.wav2letter import Wav2Letter
from speecht_tpu_torch.ops import conv0, decode

ARTIFACT_STEM = "wav2letter_greedy"
AUDIO_ARTIFACT_STEM = "wav2letter_greedy_from_audio"
MANIFEST_NAME = "manifest.json"
PLATFORMS = ("cuda", "cpu")
CONV0_PATH = (
    "F.conv1d (cuDNN on a card): csrc/conv0.cu is launched through ctypes "
    "and cannot be captured by torch.export"
)


def artifact_name(platform: str, from_audio: bool) -> str:
    stem = AUDIO_ARTIFACT_STEM if from_audio else ARTIFACT_STEM
    return f"{stem}.{platform}.pt2"


def _wav2letter(model):
    """``model``; a ValueError for any other network: the program's
    contract (T' = T // 2, the conv stack alone) is Wav2Letter's."""
    if not isinstance(model, Wav2Letter):
        raise ValueError(
            f"serving holds Wav2Letter alone, not {type(model).__name__}"
        )
    return model


class _Infer(nn.Module):
    """features [B, T, F] f32, seq_lengths [B] -> (ids, lengths, logits)."""

    def __init__(self, model):
        super().__init__()
        self.model = _wav2letter(model)

    def forward(self, features, seq_lengths):
        logits = self.model(features)
        decoded, dec_lengths, _scores = decode.greedy_decode(
            logits, self.model.output_length(seq_lengths)
        )
        return decoded, dec_lengths, logits.float()


class _AudioInfer(nn.Module):
    """audio [B, S] int16, num_samples [B] -> (ids, lengths, logits)."""

    def __init__(self, model, feature_type: str, wire_sr: int | None):
        super().__init__()
        from speecht_tpu_torch.data import features_device

        self.model = _wav2letter(model)
        self.front_end = features_device.make_front_end(feature_type, wire_sr=wire_sr)

    def forward(self, audio, num_samples):
        features, frame_lengths = self.front_end(audio, num_samples)
        logits = self.model(features)
        decoded, dec_lengths, _scores = decode.greedy_decode(
            logits, self.model.output_length(frame_lengths)
        )
        return decoded, dec_lengths, logits.float()


def make_infer_fn(model):
    """(features [B,T,F], seq_lengths [B]) -> (ids, lengths, logits) on the
    model's device: the conv stack and the greedy CTC decode
    (``ops/decode.greedy_decode``). The logits come too, so a downstream
    beam can rescore from the same program."""
    infer = _Infer(model)
    return torch.inference_mode()(infer.forward)


def make_audio_infer_fn(model, feature_type: str, wire_sr: int | None = None):
    """(audio [B,S] i16, num_samples [B]) -> (ids, lengths, logits).

    The from-audio serving forward: the device front end
    (``data/features_device.make_front_end``: the int16 wire, the resample
    from ``wire_sr`` if given, framing, FFT, mel, dB, normalisation) ahead
    of the conv stack and the greedy decode. Audio is int16 PCM (sample x
    32768). The front end pins its own products to IEEE float32.
    """
    infer = _AudioInfer(model, feature_type, wire_sr)
    return torch.inference_mode()(infer.forward)


def _audio_granularity(wire_sr: int | None, sr: int = 22050) -> int:
    """Sample-count granularity of a polymorphic audio dimension.

    Resampling needs S to be a multiple of the polyphase hop M
    (``ops/resample.py``); without resampling, 2 x hop (= 320) keeps the
    frame count 1 + S//160 odd and the stride-2 conv's output S//320 + 1.
    """
    if wire_sr is None or wire_sr == sr:
        return 320
    g = math.gcd(wire_sr, sr)
    return wire_sr // g


def _platform_device(platform: str) -> torch.device:
    if platform not in PLATFORMS:
        raise ValueError(
            f"--export-platforms: {platform!r} is not a platform the torch "
            f"port exports for (it takes {', '.join(PLATFORMS)})"
        )
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--export-platforms cuda: no CUDA device is available "
            "(pass --export-platforms cpu to export for the CPU alone)"
        )
    return torch.device(platform)


def export_stablehlo(
    model,
    out_dir: str,
    *,
    feature_type: str,
    batch_size: int = 0,
    frames: int = 0,
    from_audio: bool = False,
    wire_sr: int | None = None,
    platforms: tuple[str, ...] = PLATFORMS,
) -> dict:
    """Export the greedy-inference program of ``model`` to ``out_dir``.

    The name is JAX's; the artifact is a ``torch.export`` program, one a
    platform. ``batch_size``/``frames`` of 0 leave the dimension
    polymorphic. With ``from_audio`` the program takes int16 audio at
    ``wire_sr`` (default the feature rate, 22050) through the device front
    end; ``frames`` is then a sample count, a multiple of the audio
    granularity (:func:`_audio_granularity`). Returns the manifest.
    """
    from torch.export import Dim

    if os.environ.get(conv0.ENV_VAR) == "1":
        raise RuntimeError(
            f"{conv0.ENV_VAR}=1: the conv_0 kernel is launched through ctypes "
            "and cannot be exported; unset it to export the F.conv1d path"
        )
    if not platforms:
        raise ValueError("--export-platforms names no platform")
    devices = [_platform_device(p) for p in platforms]
    cfg = model.config
    if from_audio:
        gran = _audio_granularity(wire_sr)
        # framing's boundary reflection needs a few hundred samples; below
        # 0.1 s is not a serving case
        min_units = max(1, -(-2560 // gran))
        if frames > 0 and frames % gran:
            raise ValueError(
                f"--export-frames (audio samples for --from-audio) must "
                f"be a multiple of the {gran}-sample granularity; got "
                f"{frames}"
            )
        t_dim = (gran * Dim("s", min=min_units)) if frames <= 0 else None
        example_t = frames if frames > 0 else gran * max(min_units, 16)
        shape_tail, in_dtype = (), torch.int16
    else:
        if frames > 0 and frames % 2:
            raise ValueError(
                f"--export-frames must be even (stride-2 first conv); "
                f"got {frames}"
            )
        t_dim = (2 * Dim("t")) if frames <= 0 else None
        example_t = frames if frames > 0 else 64
        shape_tail, in_dtype = (cfg.input_size,), torch.float32
    b_dim = Dim("b") if batch_size <= 0 else None
    example_b = batch_size if batch_size > 0 else 2
    dims = {k: v for k, v in ((0, b_dim), (1, t_dim)) if v is not None}
    dynamic_shapes = (dims or None, {0: b_dim} if b_dim is not None else None)

    os.makedirs(out_dir, exist_ok=True)
    names, sizes = {}, {}
    for platform, device in zip(platforms, devices):
        traced = copy.deepcopy(model).to(device).eval()
        module = (
            _AudioInfer(traced, feature_type, wire_sr) if from_audio else _Infer(traced)
        )
        example = (
            torch.zeros((example_b, example_t, *shape_tail), dtype=in_dtype, device=device),
            torch.full((example_b,), example_t, dtype=torch.int32, device=device),
        )
        with torch.no_grad():
            # one eager call first: the front end's matrices are cached at
            # their first use, and made inside the trace they would be its
            # fake tensors
            module(*example)
            program = torch.export.export(module, example, dynamic_shapes=dynamic_shapes)
        name = artifact_name(platform, from_audio)
        path = os.path.join(out_dir, name)
        torch.export.save(program, path)
        names[platform], sizes[platform] = name, os.path.getsize(path)

    if from_audio:
        sr_in = wire_sr or 22050
        io_contract = {
            "wire_sr": sr_in,
            "audio_granularity_samples": gran,
            "min_audio_samples": gran * min_units,
            "inputs": [
                f"audio [B, S] int16 PCM at {sr_in} Hz "
                "(float sample x 32768; S a multiple of "
                f"{gran}, pad with zeros)",
                "num_samples [B] int32 (valid sample counts)",
            ],
            "outputs": [
                "decoded [B, T'] int32 (greedy CTC ids, padded with -1)",
                "decoded_lengths [B] int32",
                "logits [B, T', num_classes] float32 "
                "(T' = ceil(frames/2) rows, frames = 1 + S22k//160 with "
                "S22k = S * 22050 / wire_sr the on-device-resampled "
                "length; decoded_lengths cover valid_frames//2 rows — "
                "reference seq_len//2 parity)",
            ],
        }
    else:
        io_contract = {
            "inputs": [
                "features [B, T, input_size] float32 "
                "(normalized features, data/features.py numerics)",
                "seq_lengths [B] int32 (valid frame counts)",
            ],
            "outputs": [
                "decoded [B, T//2] int32 (greedy CTC ids, padded with -1)",
                "decoded_lengths [B] int32",
                "logits [B, T//2, num_classes] float32",
            ],
        }
    manifest = {
        "format": "torch.export ExportedProgram (torch.export.save), "
        "one file a platform",
        "artifact": names,
        "bytes": sizes,
        "platforms": list(platforms),
        "feature_type": feature_type,
        "from_audio": bool(from_audio),
        "input_size": cfg.input_size,
        "num_classes": cfg.num_classes,
        "batch_size": int(batch_size) or "dynamic",
        "frames": int(frames)
        or (
            "dynamic (granularity-aligned samples)"
            if from_audio
            else "dynamic (must be even)"
        ),
        **io_contract,
        "alphabet": [vocabulary.ids_to_sentence([i]) for i in range(vocabulary.SIZE)],
        "blank_id": vocabulary.BLANK_ID,
        "conv0_path": CONV0_PATH,
        "torch_version": torch.__version__,
    }
    with open(os.path.join(out_dir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


class LoadedProgram:
    """A loaded artifact's program for one device: call it with the
    contract's inputs on that device. A from-audio program runs inside
    ``float32_matmuls`` (IEEE float32 products whatever the TF32 flag)."""

    def __init__(self, program, from_audio: bool):
        self.program = program
        self.module = program.module()
        self.from_audio = from_audio

    @torch.inference_mode()
    def __call__(self, *inputs):
        if not self.from_audio:
            return self.module(*inputs)
        from speecht_tpu_torch.ops import resample

        with resample.float32_matmuls():
            return self.module(*inputs)


def load_stablehlo(out_dir: str, device) -> tuple[LoadedProgram, dict]:
    """Load an exported artifact's program for ``device``: returns
    ``(program, manifest)``. Needs torch alone (no checkpoint, no model
    code). A device whose platform the artifact was not exported for
    raises."""
    device = torch.device(device)
    with open(os.path.join(out_dir, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    name = manifest["artifact"].get(device.type)
    if name is None:
        raise ValueError(
            f"the artifact in {out_dir} holds no program for {device.type} "
            f"(platforms {manifest['platforms']})"
        )
    program = torch.export.load(os.path.join(out_dir, name))
    return LoadedProgram(program, manifest["from_audio"]), manifest
