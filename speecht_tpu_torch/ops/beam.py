"""Beam-search CTC decoding with n-gram LM shallow fusion (the host beam).

Counterpart of the host-beam half of ``speecht_tpu/ops/beam.py``. The
device part runs the model, the CTC loss (the alpha kernel on the card,
without its history) and the blank collapse; the collapsed log-probs are
read back and a C++ prefix beam search with the n-gram LM
(``speecht_tpu_torch/native``) decodes each row on a thread pool.
:meth:`BeamSearchDecoder.eval_batches` launches batch N+1's device part
before batch N's beam runs, so the card computes while the host searches.

The three fusion weights are plain call arguments, so ``search`` can
re-decode the same emissions under each candidate's weights. The JAX
package's ``--device-beam`` (and ``--rescore``, which needs it) is not
ported: it raises.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os

import numpy as np
import torch

from speecht_tpu_torch import native, vocabulary
from speecht_tpu_torch.execution import finish_readback, start_readback
from speecht_tpu_torch.models.wav2letter import output_length
from speecht_tpu_torch.ops import decode
from speecht_tpu_torch.train import step as tstep


@dataclasses.dataclass
class LanguageModelConfig:
    """The beam and LM flags, as ``speecht_tpu/config.py`` holds them.

    The three weights are runtime inputs of the decode. ``blank_threshold``
    is the collapse threshold of the device part, fixed during ``search``.
    """

    language_model: str | None = None  # directory with the model files
    lm_weight: float = 0.8
    word_count_weight: float = 0.0
    valid_word_count_weight: float = 2.3
    beam_width: int = 100
    blank_threshold: float = 0.999
    device_beam: bool = False
    device_lm_hbm_gb: float = 8.0
    rescore_n: int = 0


def find_lm_files(directory: str) -> tuple[str, str | None]:
    """Locate (model, vocabulary) in an LM directory.

    Takes the reference's released bundle (``kenlm-model.binary`` +
    ``vocabulary``) or an ARPA source (``*.arpa`` / ``*.arpa.txt``); a
    binary is preferred when both are present. The optional ``vocabulary``
    file feeds the valid-word trie.
    """
    names = sorted(os.listdir(directory))
    model = None
    for name in names:
        if name.endswith(".binary") or name == "kenlm-model.bin":
            model = os.path.join(directory, name)
            break
    if model is None:
        model = find_arpa_file(directory)
    if model is None:
        raise FileNotFoundError(
            f"no .binary or .arpa language model found in {directory}"
        )
    vocab = os.path.join(directory, "vocabulary")
    return model, (vocab if os.path.exists(vocab) else None)


def find_arpa_file(directory: str) -> str | None:
    """The ARPA source in an LM directory, if any."""
    for name in sorted(os.listdir(directory)):
        if name.endswith(".arpa") or name.endswith(".arpa.txt"):
            return os.path.join(directory, name)
    return None


class BeamSearchDecoder:
    """Batch beam-search decoder with optional n-gram LM shallow fusion.

    ``lm_config`` is a :class:`LanguageModelConfig`. The beam runs on a
    pool of ``num_threads`` threads (default ``min(32, os.cpu_count())``);
    :meth:`close` shuts it down. With ``feature_type`` the batches are
    raw-audio ``AudioBatch``es (``evaluate --from-audio``): the device
    front end for that feature type (audio at ``wire_sr``) runs ahead of
    the model.
    """

    def __init__(self, model, lm_config: LanguageModelConfig,
                 num_threads: int | None = None,
                 feature_type: str | None = None,
                 wire_sr: int | None = None):
        self.lm_config = lm_config
        self.blank_threshold = lm_config.blank_threshold
        if lm_config.rescore_n and not lm_config.device_beam:
            raise ValueError("--rescore requires --device-beam")
        if lm_config.device_beam:
            raise NotImplementedError(
                "--device-beam: the beam on the device is not ported to "
                "speecht_tpu_torch yet (use `speecht-cli` for it)"
            )
        self.lm = None
        if lm_config.language_model:
            model_path, vocab = find_lm_files(lm_config.language_model)
            self.lm = native.NGramLM(model_path, vocab)
        self._loss_fn = tstep.make_loss_fn(model)
        self._audio_loss_fn = None
        if feature_type is not None:
            from speecht_tpu_torch.data import features_device

            self._audio_loss_fn = tstep.make_audio_loss_fn(
                model, features_device.make_front_end(feature_type, wire_sr)
            )
        self.num_threads = num_threads or min(32, os.cpu_count() or 8)
        self._pool = concurrent.futures.ThreadPoolExecutor(self.num_threads)

    def close(self) -> None:
        self._pool.shutdown()

    @torch.inference_mode()
    def device_part(self, batch):
        """(average loss, collapsed log-probs [B, T, C], new lengths [B]),
        on the batch's device; padding rows have length 0."""
        if self._audio_loss_fn is None:
            avg_loss, logits = self._loss_fn(batch)
            logit_lengths = output_length(batch.seq_lengths)
        else:
            avg_loss, logits, logit_lengths = self._audio_loss_fn(batch)
            logit_lengths = torch.where(
                batch.num_samples > 0, logit_lengths, 0
            )
        logp, new_lengths = decode.blank_collapse(
            logits, logit_lengths, self.blank_threshold
        )
        return avg_loss, logp, new_lengths

    def decode_emissions(
        self,
        logp: np.ndarray,
        lengths: np.ndarray,
        lm_weight: float | None = None,
        word_count_weight: float | None = None,
        valid_word_count_weight: float | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Host beam over [B, T, C] log-probs -> (ids [B, T], lengths [B]).

        A weight left at None takes the config's value.
        """
        cfg = self.lm_config
        lm_w = cfg.lm_weight if lm_weight is None else lm_weight
        wc_w = (
            cfg.word_count_weight
            if word_count_weight is None
            else word_count_weight
        )
        vwc_w = (
            cfg.valid_word_count_weight
            if valid_word_count_weight is None
            else valid_word_count_weight
        )

        B, T, _C = logp.shape
        out = np.full((B, T), vocabulary.PAD_ID, dtype=np.int32)
        out_lengths = np.zeros(B, dtype=np.int32)

        def one(i):
            return native.ctc_beam_search(
                logp[i, : lengths[i]],
                beam_width=cfg.beam_width,
                lm=self.lm,
                lm_weight=lm_w,
                word_count_weight=wc_w,
                valid_word_count_weight=vwc_w,
                blank_id=vocabulary.BLANK_ID,
            )

        for i, ids in enumerate(self._pool.map(one, range(B))):
            out[i, : len(ids)] = ids
            out_lengths[i] = len(ids)
        return out, out_lengths

    def eval_step(self, batch):
        """(loss, decoded ids, decoded lengths) as numpy for one batch on
        the device: the device part, its readback, then the beam."""
        avg_loss, logp, lengths = finish_readback(
            *start_readback(self.device_part(batch))
        )
        return avg_loss, *self.decode_emissions(logp, lengths)

    def eval_batches(self, batches):
        """Pipelined evaluation over (host batch, device batch) pairs:
        yields (host batch, loss, decoded, lengths) as numpy.

        Batch N+1's device part and readback are launched before batch N's
        beam runs, so the card works while the host searches.
        """
        pending = None
        for host_batch, device_batch in batches:
            readback = start_readback(self.device_part(device_batch))
            if pending is not None:
                yield self._finish_batch(*pending)
            pending = (host_batch, readback)
        if pending is not None:
            yield self._finish_batch(*pending)

    def _finish_batch(self, host_batch, readback):
        avg_loss, logp, lengths = finish_readback(*readback)
        return host_batch, avg_loss, *self.decode_emissions(logp, lengths)
