"""The ``export`` executor: the trained weights as ``.npy`` files, and the
serving artifact.

Counterpart of ``speecht_tpu/exporting.py``: restore the run's latest
checkpoint (the port's own, ``train/checkpoint.py``) into the model on
``--device`` and save every parameter as ``--weights/conv_i/{kernel,bias}.npy``
in the JAX package's layout (``train/checkpoint.export_weights``), which
the JAX package and ``evaluate --reference-weights`` read. ``--stablehlo
DIR`` also writes the inference program, the conv stack and the greedy
decode with the weights inside it, as a shape-polymorphic ``torch.export``
program for each of ``--export-platforms`` (``serving.py``).
"""

from __future__ import annotations

from speecht_tpu_torch.execution import build_model, refuse_conformer, resolve_device
from speecht_tpu_torch.train.checkpoint import CheckpointManager, export_weights


class Exporting:
    def __init__(self, flags):
        self.flags = flags
        refuse_conformer(flags, "export")
        self.device = resolve_device(getattr(flags, "device", "cuda"))

    def run(self):
        flags = self.flags
        model = build_model(flags.input_size, flags).to(self.device).eval()
        CheckpointManager(flags.run_train_dir).restore_params(
            dict(model.named_parameters())
        )

        results = []
        if flags.export_weights_dir:
            written = export_weights(
                dict(model.named_parameters()), flags.export_weights_dir
            )
            print(f"Exported {len(written)} arrays to {flags.export_weights_dir}")
            results.extend(written)

        if getattr(flags, "export_stablehlo_dir", None):
            from speecht_tpu_torch.serving import export_stablehlo

            manifest = export_stablehlo(
                model,
                flags.export_stablehlo_dir,
                feature_type=flags.feature_type,
                batch_size=flags.export_batch_size,
                frames=flags.export_frames,
                from_audio=flags.from_audio,
                wire_sr=flags.export_wire_sr or None,
                platforms=tuple(
                    p.strip() for p in flags.export_platforms.split(",") if p.strip()
                ),
            )
            print(
                f"Exported serving artifact to "
                f"{flags.export_stablehlo_dir} ({manifest['bytes']} bytes, "
                f"platforms {manifest['platforms']}, "
                f"B={manifest['batch_size']}, T={manifest['frames']})"
            )
            results.append(manifest)

        if not results:
            print("Nothing to do.")
        return results
