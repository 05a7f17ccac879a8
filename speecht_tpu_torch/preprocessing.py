"""Preprocess executor: corpus availability and the feature cache.

Counterpart of ``speecht_tpu/preprocessing.py``: makes sure the corpus is
there (``corpus.SpeechCorpusProvider``), then writes the npz cache of the
train, test and dev splits, or of the one ``--train-only``,
``--test-only`` or ``--dev-only`` names, with the feature type of
``--power``/``--mfcc``. Without ``--device`` the DSP runs on the host in
``--num-workers`` processes (``reader.store_samples``), as the JAX
``preprocess`` does by default, and touches no card; with ``--device``
(``cuda``) or ``--device cpu`` it runs in batches on that device
(``reader.store_samples_device``). Both write the same layout.
"""

from __future__ import annotations

from speecht_tpu_torch.corpus import SpeechCorpusProvider
from speecht_tpu_torch.data.reader import SpeechCorpusReader


class Preprocessing:
    def __init__(self, flags):
        self.flags = flags

    def run(self):
        flags = self.flags
        SpeechCorpusProvider(flags.data_dir).ensure_availability()
        reader = SpeechCorpusReader(flags.data_dir)
        if flags.feature_type not in ("power", "mfcc"):
            raise ValueError("Feature type must be mfcc or power.")
        device = None
        if flags.device is not None:
            from speecht_tpu_torch.execution import resolve_device

            device = resolve_device(flags.device)

        def store(split: str):
            if device is not None:
                reader.store_samples_device(
                    split, flags.feature_type, device,
                    transfer_dtype=flags.transfer_dtype,
                )
            else:
                reader.store_samples(
                    split, flags.feature_type, num_workers=flags.num_workers
                )

        preprocess_all = not (
            flags.train_only or flags.test_only or flags.dev_only
        )
        if flags.train_only or preprocess_all:
            print("Preprocessing training data")
            store("train")
        if flags.test_only or preprocess_all:
            print("Preprocessing test data")
            store("test")
        if flags.dev_only or preprocess_all:
            print("Preprocessing development data")
            store("dev")
