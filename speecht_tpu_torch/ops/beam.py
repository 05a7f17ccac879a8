"""Beam-search CTC decoding with n-gram LM shallow fusion.

Counterpart of ``speecht_tpu/ops/beam.py``. The device part runs the
model, the CTC loss (the alpha kernel on the card, without its history)
and the blank collapse; then one of three searches decodes:

  default:         the host C++ prefix beam with the n-gram LM
                   (``speecht_tpu_torch/native``) on a thread pool, over
                   the collapsed log-probs read back from the card;
  --device-beam:   the same LM-fused search on the device
                   (``ops/beam_device.py``; ``csrc/beam_device.cu`` on the
                   card, one launch a batch): only the [B] lengths are
                   read back before it, the log-probs stay on the card;
                   the LM may be an ARPA text or a KenLM PROBING binary;
  --rescore N:     with --device-beam: a pure-acoustic device beam keeps
                   the N best, and one native call per hypothesis adds
                   the LM bonus on the host and picks the winner.

:meth:`BeamSearchDecoder.eval_batches` launches batch N+1's device part
before batch N's search runs, so the card computes while the host
searches. The three fusion weights are plain call arguments, so
``search`` can re-decode the same emissions under each candidate's
weights.

On a grid of ranks (``evaluate`` under ``torchrun``, a ``mesh``) the
device part's loss is the data group's average, and the ranks share the
search: each takes its contiguous share of its data block
(``parallel/mesh.py::beam_rows``; the ranks of a model group hold the
same rows, and split them), searches it (the host beam or rescoring on
its own rows, the device beam on its own slice of the log-probs on its
own card), pads the decodes to the batch's logit width and gathers every
rank's (``gather_beam_rows``), so every rank returns the global batch's
decodes.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os

import numpy as np
import torch

from speecht_tpu_torch import native, vocabulary
from speecht_tpu_torch.execution import finish_readback, start_readback
from speecht_tpu_torch.ops import decode
from speecht_tpu_torch.parallel import mesh as pmesh
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

    ``lm_config`` is a :class:`LanguageModelConfig`. The host beam and the
    rescoring run on a pool of ``num_threads`` threads (default
    ``min(32, os.cpu_count() // ranks on this host)``); :meth:`close`
    shuts it down. With ``feature_type`` the batches are raw-audio
    ``AudioBatch``es (``evaluate --from-audio``): the device front end for
    that feature type (audio at ``wire_sr``) runs ahead of the model.
    ``mesh`` (``parallel/mesh.py``) is the grid of ranks that share the
    search; without one the decoder is one process's.

    ``lm_config.device_beam`` runs the search on the model's device. A
    beam width the kernel cannot take (``beam_device_cuda.shape_limits``:
    more than 1024, too many candidates or too much shared memory), decided
    from the flags before anything is loaded, falls back to the host beam
    with a printed message, and so does an LM whose tables do not fit
    ``device_lm_hbm_gb`` (one whose file already looks too large, 2.6x a
    binary's size or 1.2x an ARPA's, or whose tables are). Under
    ``--rescore N`` the width fall-back is the host beam without the
    rescoring (the rescoring puts no LM on the device, so the budget does
    not apply to it). The messages are rank 0's: every rank takes the same
    decision, from the flags and the LM file alone.
    """

    # the emission pruning of every search: only a frame's top-k chars
    # spawn extensions (native.ctc_beam_search's and JAX's default)
    prune_top_k = 8

    def __init__(self, model, lm_config: LanguageModelConfig,
                 num_threads: int | None = None,
                 feature_type: str | None = None,
                 wire_sr: int | None = None,
                 mesh: pmesh.Mesh | None = None):
        self.mesh = mesh or pmesh.Mesh()
        self.lm_config = lm_config
        self.blank_threshold = lm_config.blank_threshold
        self.device_beam = bool(lm_config.device_beam)
        self.rescore_n = int(lm_config.rescore_n or 0)
        if self.rescore_n and not self.device_beam:
            raise ValueError("--rescore requires --device-beam")
        self.lm = None
        self._beam_fn = None
        if self.device_beam:
            self._make_device_beam(next(model.parameters()).device)
        if not self.device_beam and lm_config.language_model:
            model_path, vocab = find_lm_files(lm_config.language_model)
            self.lm = native.NGramLM(model_path, vocab)
        self._loss_fn = tstep.make_loss_fn(model, self.mesh)
        self._output_length = model.output_length
        self._audio_loss_fn = None
        if feature_type is not None:
            from speecht_tpu_torch.data import features_device

            self._audio_loss_fn = tstep.make_audio_loss_fn(
                model, features_device.make_front_end(feature_type, wire_sr),
                self.mesh,
            )
        # ranks on one host share its cores
        self.num_threads = num_threads or min(
            32, max(1, (os.cpu_count() or 8) // pmesh.local_world_size())
        )
        self._pool = concurrent.futures.ThreadPoolExecutor(self.num_threads)

    def _make_device_beam(self, device) -> None:
        """The device search; with ``--rescore`` also the host LM. Without
        room for the LM tables it prints why and clears ``device_beam``."""
        from speecht_tpu_torch.ops import beam_device, beam_device_cuda

        cfg = self.lm_config
        # the kernel's limits, from the flags alone: the LM's history
        # length is known only once it is loaded, so take the longest (a
        # width that fits it fits every shorter one)
        C = vocabulary.NUM_CLASSES
        K = self.prune_top_k if 0 < self.prune_top_k < C else C
        H = beam_device_cuda.MAX_HIST if cfg.language_model and not self.rescore_n else 1
        limits = beam_device_cuda.shape_limits(cfg.beam_width, K, H)
        if limits:
            dropped = f" without --rescore {self.rescore_n}" if self.rescore_n else ""
            self._say(
                f"device beam kernel: {'; '.join(limits)}; falling back to "
                f"the host beam{dropped}"
            )
            self.device_beam = False
            self.rescore_n = 0
            return
        if self.rescore_n:
            # two stages: a pure-acoustic device beam keeps the n-best,
            # the host LM rescores them (no device tables needed)
            if cfg.language_model:
                model_path, vocab = find_lm_files(cfg.language_model)
                self.lm = native.NGramLM(model_path, vocab)
            self._beam_fn = beam_device.make_device_beam_search(
                cfg.beam_width, lm=None, prune_top_k=self.prune_top_k,
                n_best=self.rescore_n,
            )
            return
        device_lm = None
        if cfg.language_model:
            model_path, vocab = find_lm_files(cfg.language_model)
            budget_gb = float(cfg.device_lm_hbm_gb)
            # the tables measure about 2.6x a PROBING binary and 1.2x an
            # ARPA text: an LM that cannot fit is not even parsed
            factor = 2.6 if native.lm_is_binary(model_path) else 1.2
            est_gb = os.path.getsize(model_path) * factor / (1 << 30)
            fallback = (
                "falling back to the host beam (use --rescore N "
                "for a device-accelerated path with large LMs)"
            )
            if est_gb > budget_gb:
                self._say(
                    f"device LM tables would need ~{est_gb:.1f} GiB "
                    f"HBM (> --device-lm-hbm-gb {budget_gb:.1f}); " + fallback
                )
                self.device_beam = False
                return
            try:
                # the exact check runs before any copy to the device
                device_lm = beam_device.DeviceLM.cached(
                    model_path, vocab,
                    hbm_budget_bytes=int(budget_gb * (1 << 30)),
                    device=device,
                )
            except beam_device.DeviceLMBudgetError as e:
                self._say(
                    f"device LM tables need "
                    f"{e.bytes_needed / (1 << 30):.1f} GiB HBM "
                    f"(> --device-lm-hbm-gb {budget_gb:.1f}); " + fallback
                )
                self.device_beam = False
                return
        self._beam_fn = beam_device.make_device_beam_search(
            cfg.beam_width, lm=device_lm, prune_top_k=self.prune_top_k
        )

    def _say(self, message: str) -> None:
        if self.mesh.primary:
            print(message)

    def close(self) -> None:
        self._pool.shutdown()

    @torch.inference_mode()
    def device_part(self, batch):
        """(average loss, collapsed log-probs [B, T, C], new lengths [B]),
        on the batch's device; padding rows have length 0."""
        if self._audio_loss_fn is None:
            avg_loss, logits = self._loss_fn(batch)
            logit_lengths = self._output_length(batch.seq_lengths)
        else:
            avg_loss, logits, logit_lengths = self._audio_loss_fn(batch)
            logit_lengths = torch.where(
                batch.num_samples > 0, logit_lengths, 0
            )
        logp, new_lengths = decode.blank_collapse(
            logits, logit_lengths, self.blank_threshold
        )
        return avg_loss, logp, new_lengths

    def launch(self, batch):
        """Launches the device part of ``batch`` and the readback of what
        the search needs on the host: returns (the log-probs left on the
        device for the device beam, else None; the readback of the loss,
        (the host beam) the log-probs, and the lengths)."""
        avg_loss, logp, lengths = self.device_part(batch)
        if self.device_beam:
            return logp, start_readback([avg_loss, lengths])
        return None, start_readback([avg_loss, logp, lengths])

    def decode_emissions(
        self,
        logp,
        lengths: np.ndarray,
        lm_weight: float | None = None,
        word_count_weight: float | None = None,
        valid_word_count_weight: float | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Beam over [B, T, C] log-probs -> (ids [B, T'], lengths [B]).

        The host beam takes numpy log-probs (T' = T). The device beam
        takes them as a tensor on its device and searches the first
        T' = a multiple of 32 of the longest row's frames (at least 32, at
        most T). A weight left at None takes the config's value.
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
        if self.device_beam:
            t_max = int(np.max(lengths)) if B else 0
            t_bucket = min(T, max(32, -(-t_max // 32) * 32))
            emissions = torch.as_tensor(logp)[:, :t_bucket].contiguous()
            lens = torch.as_tensor(lengths, dtype=torch.int32).to(emissions.device)
            if self.rescore_n:
                # stage 1: the pure-acoustic n-best (all fusion weights 0)
                ids, lens, scores = self._beam_fn(emissions, lens, 0.0, 0.0, 0.0)
                return self._rescore(
                    ids.cpu().numpy(), lens.cpu().numpy(),
                    scores.cpu().numpy(), lm_w, wc_w, vwc_w,
                )
            ids, out_lengths = self._beam_fn(emissions, lens, lm_w, wc_w, vwc_w)
            return ids.cpu().numpy(), out_lengths.cpu().numpy()

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
                prune_top_k=self.prune_top_k,
            )

        for i, ids in enumerate(self._pool.map(one, range(B))):
            out[i, : len(ids)] = ids
            out_lengths[i] = len(ids)
        return out, out_lengths

    def _rescore(self, ids, lens, scores, lm_w, wc_w, vwc_w):
        """Stage 2 of ``--rescore``: add the fusion bonus to each n-best
        hypothesis on the host and keep the best per row.

        The bonus mirrors the fused beam: per completed word (every word of
        a final hypothesis, the last included) lm_weight * ln 10 *
        log10 P(w | <s> + the last 4 words) + word_count_weight +
        valid_word_count_weight * [in the vocabulary].
        """
        B, N, T = ids.shape
        out = np.full((B, T), vocabulary.PAD_ID, np.int32)
        out_lens = np.zeros(B, np.int32)
        ln10 = float(np.log(10.0))

        def bonus(hyp_ids, hyp_len):
            s = vocabulary.ids_to_sentence(hyp_ids[:hyp_len])
            if self.lm is not None:
                lm_sum, n_words, n_valid = self.lm.score_sentence(s)
                return lm_w * ln10 * lm_sum + wc_w * n_words + vwc_w * n_valid
            return wc_w * len([w for w in s.split(" ") if w])

        def one(b):
            totals = [
                scores[b, n] + bonus(ids[b, n], int(lens[b, n]))
                if scores[b, n] > -1e29
                else -np.inf
                for n in range(N)
            ]
            return int(np.argmax(totals))

        for b, best in enumerate(self._pool.map(one, range(B))):
            n = int(lens[b, best])
            out[b, :n] = ids[b, best, :n]
            out_lens[b] = n
        return out, out_lens

    def eval_step(self, batch):
        """(loss, decoded ids, decoded lengths) as numpy for one batch on
        the device: the device part, its readback, then the search."""
        return self._finish_batch(None, self.launch(batch))[1:]

    def eval_batches(self, batches):
        """Pipelined evaluation over (host batch, device batch) pairs:
        yields (host batch, loss, decoded, lengths) as numpy.

        Batch N+1's device part and readback are launched before batch N's
        search runs, so the card works while the host searches.
        """
        pending = None
        for host_batch, device_batch in batches:
            launched = self.launch(device_batch)
            if pending is not None:
                yield self._finish_batch(*pending)
            pending = (host_batch, launched)
        if pending is not None:
            yield self._finish_batch(*pending)

    def finish(self, launched):
        """(loss, log-probs, lengths) of a :meth:`launch`: the loss and the
        lengths on the host, the log-probs where the search reads them."""
        logp, readback = launched
        if logp is None:
            return finish_readback(*readback)
        avg_loss, lengths = finish_readback(*readback)
        return avg_loss, logp, lengths

    def decode_shared(self, logp, lengths) -> tuple[np.ndarray, np.ndarray]:
        """:meth:`decode_emissions` of a batch whose search the ranks share:
        each decodes its :func:`~speecht_tpu_torch.parallel.mesh.beam_rows`
        (the device beam slices the log-probs on its card), pads the ids
        to the batch's logit width ``T`` and gathers every rank's, so
        every rank returns the global rows ``[rows, T]``. Every rank calls
        it for every batch, in order, a share of padding rows alone too.
        On a ``1 x 1`` mesh: :meth:`decode_emissions` itself."""
        if self.mesh.dp * self.mesh.mp == 1:
            return self.decode_emissions(logp, lengths)
        rows, T = logp.shape[:2]
        ids, out_lengths = self.decode_emissions(
            pmesh.beam_rows(logp, self.mesh), pmesh.beam_rows(lengths, self.mesh)
        )
        # the device beam's ids end at its own bucket; frames past a row's
        # length are never read, so the padding changes no token
        ids = np.pad(ids, ((0, 0), (0, T - ids.shape[1])),
                     constant_values=vocabulary.PAD_ID)
        return (pmesh.gather_beam_rows(ids, self.mesh, rows),
                pmesh.gather_beam_rows(out_lengths, self.mesh, rows))

    def _finish_batch(self, host_batch, launched):
        avg_loss, logp, lengths = self.finish(launched)
        return host_batch, avg_loss, *self.decode_shared(logp, lengths)
