"""Evolutionary search over the language model's decoding weights.

Counterpart of ``speecht_tpu/parameter_search.py`` (the reference's
``search`` command): a :class:`Candidate` holds (lm_weight,
word_count_weight, valid_word_count_weight) and scores ``-(global LER +
global WER)`` on the dev split; mutations add Gaussian noise of
``--noise-std`` (``np.random.normal``) to a candidate drawn with
``random.choice``; the population stays sorted and capped at
``--population-size``, seeded with Candidate(1.0, 0.0, 0.0); ``--ui``
shows it through curses.

The weights are runtime arguments of the search, so the device part
(model, CTC loss, blank collapse) runs once per dev batch, and every
candidate only re-runs the beam over the same emissions: read back from
the card for the host beam, left on the card with ``--device-beam`` (each
candidate then re-runs only the beam kernel). Weights come from the
port's own checkpoint in ``<train-dir>/<run-name>``. The search runs in
one process; under a distributed launcher it raises, as JAX's does.
"""

from __future__ import annotations

import bisect
import random

import numpy as np

from speecht_tpu_torch import vocabulary
from speecht_tpu_torch.evaluation import Evaluation
from speecht_tpu_torch.metrics import EvalStatistics
from speecht_tpu_torch.ops.beam import BeamSearchDecoder
from speecht_tpu_torch.parallel import comm


class Candidate:
    def __init__(self, lm_weight: float, word_count_weight: float,
                 valid_word_count_weight: float):
        self.score = None
        self.stats: EvalStatistics | None = None
        self.lm_weight = lm_weight
        self.word_count_weight = word_count_weight
        self.valid_word_count_weight = valid_word_count_weight

    def __gt__(self, other):
        return self.score > other.score

    def __lt__(self, other):
        return self.score < other.score

    def __str__(self):
        return (
            "{:.2f} Candidate (lm_weight={:.2f}, wc_weight={:.2f}, "
            "valid_wc_weight={:.2f}) has LER: {:.2f} WER: {:.2f}"
        ).format(
            self.score,
            self.lm_weight,
            self.word_count_weight,
            self.valid_word_count_weight,
            self.stats.global_letter_error_rate,
            self.stats.global_word_error_rate,
        )

    def update_score(self, score: float, stats: EvalStatistics):
        self.score = score
        self.stats = stats

    @staticmethod
    def random_noise(std: float) -> float:
        return float(np.random.normal(loc=0, scale=std))

    def mutate(self, std: float) -> "Candidate":
        return Candidate(
            lm_weight=self.lm_weight + self.random_noise(std),
            word_count_weight=self.word_count_weight + self.random_noise(std),
            valid_word_count_weight=(
                self.valid_word_count_weight + self.random_noise(std)
            ),
        )


class LanguageModelParameterSearch(Evaluation):
    """Local search over the three decode weights on the dev split."""

    def __init__(self, flags):
        if comm.world_size() > 1:
            # the search is host-driven state (unseeded mutations, a
            # population each process would evolve differently): run
            # distributed, it would score candidates on divergent data
            raise ValueError(
                "search runs single-process; launch it without the "
                "distributed environment (torchrun's RANK, WORLD_SIZE etc.)"
            )
        super().__init__(flags)
        self.candidates: list[Candidate] = []
        self.num_iterations = 0

    def dataset_name(self) -> str:
        return "dev"

    def create_sample_generator(self, limit_count: int):
        return self.reader.load_samples(
            "dev",
            loop_infinitely=False,
            limit_count=limit_count,
            feature_type=self.flags.feature_type,
        )

    def get_loader_limit_count(self) -> int:
        return self.flags.step_count * self.flags.batch_size

    def get_max_steps(self):
        return self.flags.step_count or 1

    def _collect_emissions(self, beam: BeamSearchDecoder):
        """The device part once over the dev subset; returns, per batch,
        (host batch, collapsed log-probs, their lengths): the log-probs on
        the host for the host beam, on the device for ``--device-beam``,
        the lengths on the host."""
        cached = []
        for host_batch, device_batch in self.create_loader():
            _loss, logp, lengths = beam.finish(beam.launch(device_batch))
            cached.append((host_batch, logp, lengths))
        return cached

    def _score_candidate(self, beam, cached, candidate: Candidate):
        stats = EvalStatistics()
        for batch, logp, lengths in cached:
            decoded, dec_lengths = beam.decode_emissions(
                logp,
                lengths,
                lm_weight=candidate.lm_weight,
                word_count_weight=candidate.word_count_weight,
                valid_word_count_weight=candidate.valid_word_count_weight,
            )
            for i in range(decoded.shape[0]):
                if batch.seq_lengths[i] == 0:
                    continue
                expected = vocabulary.ids_to_sentence(
                    batch.labels[i, : batch.label_lengths[i]]
                )
                got = vocabulary.ids_to_sentence(decoded[i, : dec_lengths[i]])
                stats.track_decoding(got, expected)
        score = -(stats.global_letter_error_rate + stats.global_word_error_rate)
        candidate.update_score(score, stats)

    def run(self, max_iterations: int | None = None):
        flags = self.flags
        if max_iterations is None:
            # `search --generations N` bounds the run; 0 runs until
            # interrupted, as the reference does
            max_iterations = flags.generations or None
        self.model.to(self.device).eval()
        self.load_weights()

        beam = BeamSearchDecoder(self.model, flags.lm)
        try:
            print("Collecting device emissions over the dev subset")
            cached = self._collect_emissions(beam)

            def run_search(stdscr=None):
                new_candidate = Candidate(1.0, 0.0, 0.0)
                self._score_candidate(beam, cached, new_candidate)
                self.candidates.append(new_candidate)
                self._report(stdscr, new_candidate)

                while (
                    max_iterations is None
                    or self.num_iterations < max_iterations
                ):
                    random_candidate = random.choice(self.candidates)
                    new_candidate = random_candidate.mutate(flags.noise_std)
                    self._score_candidate(beam, cached, new_candidate)
                    bisect.insort(self.candidates, new_candidate)
                    if len(self.candidates) > flags.population_size:
                        del self.candidates[0]
                    self.num_iterations += 1
                    self._report(stdscr, new_candidate)

            if flags.use_ui:
                from curses import wrapper

                wrapper(run_search)
            else:
                run_search()
        finally:
            beam.close()
        return self.candidates

    def _report(self, stdscr, candidate):
        if stdscr is not None:
            stdscr.clear()
            stdscr.addstr(
                0, 0,
                f"Current population after {self.num_iterations} iterations",
            )
            for idx, cand in enumerate(reversed(self.candidates)):
                stdscr.addstr(idx + 2, 0, str(cand))
            stdscr.refresh()
        else:
            print(candidate)
            # 4-decimal twin for scripts: the line above rounds to 2
            # decimals, which cannot resolve gains near an error floor
            print(
                "candidate-precise: score {:.4f} lm_weight {:.4f} "
                "wc_weight {:.4f} valid_wc_weight {:.4f} "
                "LER {:.4f} WER {:.4f}".format(
                    candidate.score,
                    candidate.lm_weight,
                    candidate.word_count_weight,
                    candidate.valid_word_count_weight,
                    candidate.stats.global_letter_error_rate,
                    candidate.stats.global_word_error_rate,
                )
            )
