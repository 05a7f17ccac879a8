#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (speecht_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (``nvcc``). It builds the port's kernels from ``csrc/``,
drives the port's main path through its normal entry point, and fails
(non-zero exit, no result line) if anything is wrong. Phases:

1. Environment: card name and power limit (``nvidia-smi``), torch and
   CUDA versions, kernel build time (all sources compiled in parallel)
   and the build time of the port's host library (``g++``: FLAC decode,
   resample, the npz reader, the beam search and the n-gram LM), built
   beside them, and the symbols it exports (only ``stt_`` ones).
2. Each kernel against its plain PyTorch version on the card: the CTC
   alpha kernel, without the history (evaluate's variant) and with it
   (train's), at the evaluate/train shape (B=64, T=512 logit frames,
   L=256), at the largest corpus bucket (T=2176, L=1088), on edge rows
   (empty label, infeasible row, logit length 0, ragged lengths), at one
   width past 4096 states and at the widest the first version of the
   kernel took (S=14295):
   losses and the whole history, the two variants' losses bit-equal, two
   calls bit-equal; the times of both variants beside the plain version's,
   the ``F.ctc_loss`` yardstick's and each variant's bound, and the
   history's cost on rows that all run 513 states.
2b. The CTC beta kernel (dlogits) against the plain ``_posterior_grad``
   times g on the same inputs and alpha history, at the train shape
   (B=64, T=512, L=256), the largest bucket and edge rows (empty label,
   infeasible row with g=0, logit length 0, the full odd width, one
   frame, repeated letters, non-uniform g); the loss of the whole
   autograd Function against autograd through the plain forward scan
   (``ctc_loss_autodiff``), and the gradients of the Function and of that
   autograd in float32 each against it in float64, to a bound per entry
   (see ``f64_witness``); two calls bit-equal (the class scatter has a
   fixed order); times beside the plain version, the
   bound and ``F.ctc_loss`` (its backward alone, and forward+backward
   against alpha+beta); the kernel's shared memory at three widths.
2c. The conv0 kernel against ``conv0_plain`` on the card:
   the main shape (B=64, T=1024, I=128, O=250) in bf16 and float32, the
   largest bucket (B=8, T=4352) and edge shapes of the bf16 kernel's
   128x256 tiles and 64-channel K chunks (T=48, T=50, T=1000, B=1, O=16,
   O=29, O=300, I=64, I=256), with time, plain time, the ``F.conv1d`` +
   bias + ReLU yardstick and the bound; two bf16 calls bit-equal;
   ``Conv0Function``'s gradients against autograd through
   ``conv0_plain``; the kernels' registers, spills and shared memory.
2d. The device beam kernel (``csrc/beam_device.cu``) against its plain
   version (``ops/beam_device.plain_beam_search``) on the card, on
   collapsed-like log-probs made from a seed: the main shape (B=64,
   130-230 kept frames a row, width 100, top-k 8, the phase-3d order-3
   ARPA LM, which this phase writes), no LM, ``n_best=8``, W=1024 on short
   rows and on the main rows, ragged rows (lengths 0 and 1 among them),
   an order-1 LM, an order-6 LM (history 5, ``<s>`` pinned), the phase-3d
   LM keyed by KenLM's chained hash (``kenlm_keyed_lm``) and tie-heavy
   emissions (``tie_emissions``, with and without the LM): ids and
   lengths equal on every row, n-best scores to 1e-6 relative (the count
   bit-equal reported), two calls bit-equal; at the main shape the
   kernel's time (and µs a frame of the longest row) beside the plain
   version's, the bound and the yardstick, the port's host C++ beam on
   ``os.cpu_count()`` threads over the same rows (no single PyTorch call
   searches a beam), the LM's share (the time without it), and the split
   of a frame by the kernel's ``-DBEAM_DEVICE_SPLIT`` build
   (``beam_split``: µs a frame in each phase, with and without the LM);
   the kernel's shared memory at W=100 and W=1024.
3. The evaluate path: ``CLI(["evaluate", ...]).run()`` on a synthetic
   cached corpus (256 utterances of 600-1024 frames) with full-width
   random weights (128/250/2000/29, 11 layers) written as a
   reference-layout ``.npy`` directory; every kernel's launch count is set
   to 0 just before and read just after; ms per batch and utterances/s,
   each host stage of one batch alone, and the 64-file npz read through
   the native reader and through ``np.load`` in turns.
3b. The train path: the same weights written as a port checkpoint at
   step 0, then ``CLI(["train", "--max-steps", "8",
   "--steps-per-checkpoint", "4", "--batch-size", "64", ...]).run()`` on
   a synthetic cached train split (128 utterances of 600-1024 frames),
   launch counts reset just before and read just after (both CTC kernels
   must run, conv0 must not: phases 3 and 3b run without
   SPEECHT_PALLAS_CONV0), finite losses, a checkpoint at step 8, then
   ``evaluate`` without ``--reference-weights`` restoring it; ms per
   step, the train step's device time on one resident batch and its
   share of the card's dense bf16 peak, where that time goes (stages and
   each layer's backward by CUDA events, kernels by torch.profiler, and
   the step with ``cudnn.benchmark`` on for comparison), and a report (not
   a check) of whether two train steps from the same state leave
   bit-equal parameters, with cuDNN's default algorithms and with
   ``cudnn.deterministic``.
3c. The conv0 path, with SPEECHT_PALLAS_CONV0=1 for this phase only:
   ``train --spec-augment --verbose-summaries --profile-steps 2:4`` (8
   steps from the phase-3 weights), then ``evaluate`` restoring step 8;
   conv0 launches equal the forwards (train steps, activation-summary
   forwards, evaluate batches), the CTC kernels run, losses finite, image
   and activation summaries in the event file, a profiler trace; ms per
   step and per batch beside the default path's, and the device step
   times of both paths in turns.
3d. The LM path: ``CLI(["evaluate", "--language-model", LM_DIR, ...]).run()``
   on the phase-3 corpus, B=64, beam width 100 and top-k 8 (JAX's
   defaults), with phase 2d's synthetic order-3 ARPA LM written from a
   seed (4000 words, about 10^5 n-grams) and a vocabulary file, and the phase-3
   weights with the last layer's blank bias raised, calibrated on one
   batch so that the blank collapse keeps 20-30% of the frames (checked
   within 10-40%; conv_0's filters first take a gain that spreads the
   random weights' logits from frame to frame, see ``lm_weights_for``);
   launch counts reset just before and read just after (``ctc_alpha``
   once per batch, ``ctc_beta`` and conv0 not at all);
   ms per batch and utterances/s, then the LM load, the device part
   (forward, CTC alpha, collapse; CUDA events), the readback and the
   host beam of one batch, each alone, with ``os.cpu_count()``.
3e. ``search --generations 4 --step-count 1`` on a synthetic dev split of
   64 utterances with the same LM, from a port checkpoint of the 3d
   weights: five candidates scored and sorted, ``ctc_alpha`` launched once
   for the one dev batch; ms per candidate.
3g. The device beam through ``CLI([...]).run()``, on the phase-3d corpus,
   weights and LM: ``evaluate --language-model --device-beam`` (4
   batches; ms a batch and utt/s beside phase 3d's host-beam period, and
   the beam kernel's ms on one batch by CUDA events), ``--device-beam
   --rescore 8`` (4 batches), ``search --device-beam --generations 4
   --step-count 1`` (ms per candidate beside phase 3e's), ``evaluate
   --from-audio --language-model --device-beam`` (one batch of the
   phase-3f corpus, run in phase 3f) and ``--device-lm-hbm-gb 0.000001``
   (JAX's fall-back message, the host beam); the launch counts reset just
   before each run and read just after: ``ctc_alpha`` once a batch,
   ``beam_device`` once a batch (once a candidate in ``search``; never on
   the fall-back), ``ctc_beta`` and conv0 never. The LM tables are cached
   in the run's temporary directory.
3f. The audio front end: a synthetic FLAC corpus written from a seed by
   ``write_flac`` (64 test and 64 dev utterances, 16 kHz 16-bit mono,
   4.4-7.4 s, FIXED order-2 rice-coded subframes, 60-200 letters each,
   the corpus sets marked as extracted); ``preprocess --test-only`` on the
   host DSP into data dir A (``python -m speecht_tpu_torch`` in a process
   of its own, as a user runs it) and ``preprocess --test-only --device``
   (the resample and DSP on the card) into data dir B, each with its
   files/s;
   ``evaluate --from-audio`` (greedy, B=64, the phase-3 weights; the
   resample 16000 -> 22050 on the card) and ``evaluate --from-audio
   --language-model`` (the phase-3d LM and weights, the dev split), then
   ``evaluate`` on cache B read through the native npz reader; launch
   counts reset just before each and read just after (``ctc_alpha`` once
   a batch, ``ctc_beta`` and conv0 never); ms per batch, utterances/s and
   one batch's FLAC decode, batch build, int16 pin + H2D, front end on the
   card, eval step and metrics, each alone; the phase's wall time.
3h. ``export`` through ``CLI([...]).run()`` on a port checkpoint of the
   phase-3 weights: ``--weights`` (the files hold the checkpoint's values)
   and ``--stablehlo`` for ``--export-platforms cuda,cpu``, then
   ``--from-audio --wire-sr 16000``; the loaded cuda program on phase 3's
   first batch (B=64, T=1024) and at B=16, T=768 from the same artifact,
   against the eager eval step (phase 4's share of equal tokens) and the
   eager forward (logits to phase 4d's tolerance), launching no kernel;
   the cpu program once; the from-audio program on phase 3f's 64 FLACs
   against ``evaluate --from-audio``'s step; the artifacts' bytes, the
   export seconds and ms a batch of the programs and the eager step.
3i. ``record --audio-source`` on 4 of phase 3f's 16 kHz FLACs through
   ``CLI([...]).run()``: one-shot greedy (phase-3 weights), with
   ``--language-model`` (host beam), ``--device-beam`` and
   ``--device-beam`` on a KenLM binary that ``native.lm_write_binary``
   writes from the phase-3d ARPA (the 3d LM; the phase-3 weights
   calibrated as 3d's, on the FLACs' ``preprocess --device`` features, so
   the collapse keeps about a quarter of the frames); ``--streaming``
   greedy and with the LM; one-shot and streaming with
   SPEECHT_PALLAS_CONV0=1. Launch counts reset before each run and read
   after (``ctc_alpha`` once a one-shot recording, ``beam_device`` once a
   recording with ``--device-beam``, ``conv0`` only with the env var,
   nothing but conv0 on the streaming forward); each one-shot transcript
   equals the offline decode of the same post-processed audio, the binary
   LM's equal the ARPA's, each streaming final equals ``finalize``'s
   offline transcript; ms a recording, ms a chunk and the real-time
   factor, and one recording's resample, host features, eval step and
   decode, each alone.
3j. ``parallel/`` on two ranks sharing the card: ``torchrun --standalone
   --nproc-per-node 2 chip_smoke.py --rank-worker SPEC`` with
   ``SPEECHT_SHARE_CARD=1`` (gloo, collectives staged through host
   memory; each rank prints its backend), on the phase-3 corpus (its 256
   test utterances as the train and test splits) and weights at full
   width, global B=64, the 1024-frame bucket: ``train --data-parallel
   2``, ``--model-parallel 2`` and ``--seq-parallel 2`` (4 steps each from
   a step-0 port checkpoint), then ``evaluate --data-parallel 2`` and
   ``--seq-parallel 2`` (4 batches, the phase-3 weights), each rank
   setting the launch counts to 0 just before each run and reading them
   just after (``ctc_alpha`` and in train ``ctc_beta`` on every rank);
   then one process runs ``train`` and ``evaluate`` on the same rows
   (the cache read in the ranks' shared order): each step's loss and the
   parameters after 4 steps against it (``PARALLEL_LOSS_RTOL``,
   ``PARALLEL_UPDATE_RTOL``), the decoded tokens (phase 4's share on the
   DP grid; on the SP grid, whose forward rounds elsewhere, the share is
   reported and the SP logits of one batch are held to the dense ones,
   every argmax flip a near tie, ``PARALLEL_LOGIT_RTOL``) and the global
   statistics (within the decodes' own edit distance), and a
   one-process ``evaluate`` restores the DP run's checkpoint; ms/step and
   ms/batch a path, and each collective's ms at the paths' shapes
   (gloo's host-staged times, not NCCL's).
3k. ``evaluate --language-model`` and ``--from-audio`` on two ranks
   sharing the card, started as in 3j: on the phase-3 corpus with the
   phase-3d LM and the phase-3 weights calibrated as in 3d but to keep
   75-85% of the frames (so the beam decodes dozens of letters a row),
   the host beam, ``--device-beam`` and
   ``--device-beam --rescore 8`` (4 batches each) on ``--data-parallel 2``
   and ``--model-parallel 2``; on phase 3f's 64 test FLACs ``--from-audio``
   greedy (the phase-3 weights) and with ``--language-model --device-beam``
   (the calibrated weights) on ``--data-parallel 2``. Full width, B=64 global, float32 with TF32
   off on both sides (TP sums its wide layers in another order, so bf16
   would round them otherwise); one process runs each path on the same
   rows. Every decoded token and statistic equal to one process's, each
   batch's loss within ``PARALLEL_DECODE_LOSS_RTOL``, rank 0 alone
   printing; each rank's ``ctc_alpha`` and ``beam_device`` launches (one a
   batch, ``beam_device`` on the device-beam paths alone) go into
   ``launches_by_path``; ms a batch a path beside one process's and each
   rank's search ms a batch (host clock, gloo on one card).
4. One batch through the eval step on the card and on the CPU, float32
   compute with TF32 off, loss and decoded tokens compared.
4b. One train step on the card and on the CPU, float32 with TF32 off,
   B=8, same weights and batch: loss, grad norm and updated parameters.
4c. Phase 4 with SPEECHT_PALLAS_CONV0=1: the conv0 kernel (float32) on
   the card against ``conv0_plain`` on the CPU.
4d. One batch (B=8) through the beam decoder's device part on the card and
   on the CPU, float32 with TF32 off: the loss (to the CTC tolerance), the
   collapsed lengths (equal) and the kept log-probs (to 1e-4 of each
   value plus 1e-4); how many rows the host beam decodes alike on the
   two sides is reported, not checked (a near tie may flip on a 1e-6
   difference in the emissions).
4e. The audio path, card vs CPU (float32): with TF32 switched on
   process-wide, the resample of one padded batch (8 utterances and a
   padding row) to 1e-5 and the front end's power and MFCC features to
   1e-3 + 1e-3 x |value| (the front end pins IEEE float32 for its own
   products); then with TF32 off the from-audio eval step's loss and
   decodes as phase 4; cache B against cache A, file by file, within
   JAX's device-against-host tolerance (1e-2 + 1e-2 x |value|) plus one
   bfloat16 spacing.
4f. The card's collapsed log-probs of phase 4d through the beam kernel on
   the card and the plain version on the CPU (width 100, top-k 8, the
   phase-3d LM): how many rows decode alike; every row decoded otherwise
   must be a near tie, its two hypotheses within 0.1 of each other under
   float64 rescoring (the bound of JAX's ``tests/test_beam_device.py``).
5. The drills (``speecht_tpu_torch/tools/``), at full width with random
   initial weights from the port's seed, in the run's work directory:
   first phases 2 and 2b's comparisons at the drills' shapes (B=16, 64
   and 320 logit frames, labels of 6-28 letters); then
   ``synthetic_convergence`` (400 + 40 tone-speech utterances, ``train``
   600 steps at B=16 on the 128-frame buckets, then the held-out split
   greedy, with the host beam and its unigram LM, ``--device-beam`` and
   ``--device-beam --rescore 8``: the JAX tool's four gates) and
   ``train_features_check`` (``--spec-augment`` with narrow masks and
   ``--grad-accum 2`` for 1200 global steps, the first launch a process
   of its own stopped by SIGTERM after its first interval line, the
   crash-save at a step S, the relaunch for 1200 - S steps; the gates:
   greedy LER < 0.05 and the relaunch's facts). Each in-process CLI run's
   launch counts are set to 0 just before and read just after:
   ``ctc_alpha`` and ``ctc_beta`` once a train step, ``ctc_alpha`` once an
   evaluate batch, ``beam_device`` once a ``--device-beam`` batch, conv0
   never. Then the trained model's train step on one batch of the
   512-frame bucket by CUDA events beside the drill's period, and its
   emissions: the share of frames the collapse keeps, the beam kernel's
   and the host beam's ms on one batch, and every held-out row through
   both beams (the rows decoded otherwise with their float64 scores). A
   gate that fails fails the run.
6a. The four kernels under the sanitizers, in a worker process
   (``--sanitize-worker``): ``ctc_alpha`` with and without the history
   on the edge rows and at B=4, ``ctc_beta`` on both, conv0 bf16 and
   float32 at T=50 and T=1000, ``beam_device`` at B=4 with the phase-2d
   LM (and its n-best), each against its plain version. The worker runs
   under ``compute-sanitizer`` (found beside ``nvcc``; missing, the run
   fails) ``--tool memcheck``, ``synccheck`` and ``racecheck`` (side by
   side, a worker each) with
   ``PYTORCH_NO_CUDA_MEMORY_CACHING=1``: memcheck's and synccheck's errors
   fail the run, racecheck's report is printed, and a tool that refuses
   the card is reported as not run. Then the worker once more with every
   CUDA allocation through a guard allocator (built here with ``nvcc``:
   64 KiB of 0xFF poison on each side of each allocation, the allocation
   poisoned too, both guards read back at each free): a changed guard
   byte (a write out of bounds) or a case that differs (a read of
   memory nothing wrote) fails the run. Then each kernel 8 times on the
   same inputs, every other call beside matmuls on a second stream,
   every result bit-equal to the first.
6b. ``speecht_tpu_torch.tools.native_sanitize_check`` on FLACs of every
   layout ``write_flac`` writes (``sanitizer_flacs``), in a process of its
   own beside 6a, with the card machine's g++: the host C++ built with
   ASan and UBSan, every ``stt_`` entry point and three fuzz passes; it
   must print ``ALL ASAN CHECKS PASSED``.
7. The hard corpus (``speecht_tpu_torch/tools/hard_corpus.py``) at full
   width from the port's seeded initial weights: its 2000 + 128 + 128
   utterances written beside 6a and 6b in a process of its own, then the
   pilot at JAX's settings (``train --spec-augment --grad-accum 2
   --group-by-length``, B=64, 256-frame buckets, 1500 steps in 3
   segments, a greedy dev evaluate after each, then greedy and with the
   LM and ``--device-beam``), then ``hard_search_drill --device-beam``
   (60 generations, the mutations seeded here and the seed printed; the
   seed's and the best candidate's weights on the test split). Each CLI
   run's launch counts are set to 0 just before and read just after:
   ``ctc_alpha`` and ``ctc_beta`` once a train micro-step, ``ctc_alpha``
   once an evaluate or search dev batch, ``beam_device`` once a
   ``--device-beam`` batch and once a candidate's batch, conv0 never.
   Printed: each segment's interval losses, restored optimizer step and
   learning rate and period; the dev rates greedy and with the LM; the
   drill's scores, trajectory and test rates; the trained model's device
   step at the largest bucket; the share of frames the collapse keeps on
   its emissions and the beam kernel's ms a batch of 64 there; the wall
   times. Gates: the drill's two (dev and test improved) and the pilot's
   greedy dev LER below 0.5.
8. The device beam on a 10^7-n-gram LM
   (``speecht_tpu_torch/tools/large_lm_probe.py``'s: 100,000 words,
   orders 1-3, converted to a KenLM PROBING binary), synthesised and its
   tables built cold into the run's ``SPEECHT_DEVICE_LM_CACHE`` in a
   process of its own beside phases 6a, 6b and 9. Then, after phase 7:
   the warm load (the npz and the upload), its device-memory bytes and
   both two-choice flags (both must be on); the probe's 30-context scorer check against the
   host scorer; the kernel against its plain version on the probe's B=64
   x T=128 emissions (ids, n-best 8 scores bit-equal, two calls
   bit-equal), its ms with this LM, the tiny LM and no LM, the bound with
   this LM's table bytes and the split of a frame; ``evaluate
   --language-model --device-beam`` on the phase-3 corpus (4 batches) and
   with ``--device-lm-hbm-gb 0.25``, which must print the budget message
   and decode on the host beam with no ``beam_device`` launch.
9. ``python -m speecht_tpu_torch.tools.multiprocess_drill`` at full
   width, in a process group of its own beside phases 6a and 6b: 12 or
   more launches of 1, 2 and 4 ranks sharing the card (gloo,
   ``SPEECHT_SHARE_CARD=1``), every ``PASS`` line and exit code 0
   required; each launch's wall time, backend, its ranks'
   ``ctc_alpha``/``ctc_beta`` launches (counted in each rank, checked
   against its steps and batches) and their peak memory.
10. The corpus-scale soak, shortened: ``python -m
   speecht_tpu_torch.tools.librispeech_scale_soak --hard --n-train 1000
   --segment-steps 48 --steps-per-checkpoint 8 --max-segments 3`` (the
   steps cut together from 150 and 25: at 150 the phase took 235 s alone,
   at 120 265.7 s beside 6a, 6b and 9, against its 240 s; the corpus is
   never cut) at full width in a process group of its own beside phases 6a, 6b, 8's
   build and 9, each CLI process it starts (a process a segment and an
   evaluate) run through ``multiprocess_drill``'s ``rank`` entry, which
   writes its kernel launches and peak card memory at exit. Gates: every
   process exits 0; segments 2 and 3 resume where the one before stopped;
   after each segment the run directory is at most 5 x its largest
   checkpoint x 1.01 (6 saves a segment: rotation), at most 5 files at
   the end; every interval loss finite and segment 3's last below segment
   1's first; ``ctc_alpha`` and ``ctc_beta`` once a train micro-step,
   ``ctc_alpha`` once an evaluate batch, ``beam_device`` once a batch of
   the ``--device-beam`` evaluates, conv0 never; ``SOAK DONE`` with the
   test rates greedy and with the LM; ``soak_report`` renders the log.
   Printed: the corpus and bucket lines, each segment's wall time, step
   time p50/p95, prefetch stalls, checkpoint MB and dev rates, the train
   processes' peak card memory. Then the rows of the corpus's widest
   bucket through the model restored from the last checkpoint, and their
   log-probs through ``ctc_alpha`` (with the history) and ``ctc_beta``
   against the plain versions (phases 2 and 2b's checks, timed beside
   the bounds and ``F.ctc_loss``); the soak's directory is then removed.
11. One JSON line listing every kernel, then the result line
   ``{"ok": true, "device": {...}}`` as the last line.

Without a CUDA device it exits with code 2 before doing anything. With
``--rank-worker SPEC`` it is one rank of phase 3j or 3k (started by the phase
itself through ``torchrun``), with ``--sanitize-worker SPEC`` phase 6a's
worker, and neither prints a result line.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

# the card's published peaks (H100 SXM data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

# CTC alpha kernel vs the plain version, both float32 on the card: the
# recursion runs up to 2176 dependent log-sum-exp steps, each within a
# few ulps, so allow 1e-4 relative (plus 1e-3 absolute near 0)
CTC_RTOL, CTC_ATOL = 1e-4, 1e-3
# per state and frame: 3 exp, 1 log, 3 subtractions, 3 maxima, 2 adds
# for the sum, 1 add of the max back, 1 add of the emission
CTC_OPS_PER_STATE_FRAME = 14

# CTC beta kernel vs the plain version on the same alpha history: the
# same float32 recursion, but the kernel sums the posteriors onto their
# classes in another (fixed) order than the plain scatter
BETA_RTOL, BETA_ATOL = 1e-4, 1e-5
# the autograd Function (posterior form, float32) and float32 autograd
# through the plain forward scan, each against that autograd in float64.
# A posterior exp(alpha + beta - logP) carries the rounding of its
# exponent: two random walks of at most T float32 roundings of log-space
# sums, each at most ulp(|logP|)/2 (standard deviation at most
# sqrt(T/6) * ulp). So an entry [b, t, c] may be off by its posterior
# mass g_b * post times WITNESS_ULPS * sqrt(T_b) * ulp(|logP_b|) (about
# 7 standard deviations), plus the float32 softmax's rounding
# (WITNESS_ATOL). A posterior put on the wrong state, frame or class is
# off by the whole mass.
WITNESS_ULPS, WITNESS_ATOL = 3.0, 1e-5


def f64_witness(got, ref, logits, g, logit_lengths, loss):
    """(max |got - ref|, largest share of its entry's bound) for float32
    dlogits ``got`` against the float64 ``ref``; ``loss`` in float64."""
    mass = (g[:, None, None] * torch.softmax(logits, -1) - ref).clamp(min=0)
    feasible = (loss < 1e29).cpu().numpy()
    ulp = np.where(feasible, np.spacing(
        np.abs(np.where(feasible, loss.cpu().numpy(), 0.0)).astype(np.float32)
    ), 0.0)
    frames = logit_lengths.cpu().numpy().clip(1, None)
    delta = torch.from_numpy(WITNESS_ULPS * np.sqrt(frames) * ulp).to(ref)
    err = (got.double() - ref).abs()
    bound = delta[:, None, None] * mass + WITNESS_ATOL
    return float(err.max()), float((err / bound).max())


# per needed state and frame: beta (3 adds, 2 maxima, 3 subtractions, 3
# exp, 2 adds, 1 log, 1 add) + posterior (2 adds, 1 exp) + scatter (1 add)
BETA_OPS_PER_STATE_FRAME = 19
# per needed class and frame: exp, subtract, multiply by g
BETA_OPS_PER_CLASS_FRAME = 3

# one batch, card vs CPU, float32 with TF32 off: sums in another order
# through 11 conv layers and the CTC recursion
PARITY_LOSS_RTOL = 1e-4
PARITY_MIN_TOKEN_SHARE = 0.99
# one train step, card vs CPU: the grad norm sums the same gradients in
# another order; parameters move by about lr (1e-4) in the step, so 1e-6
# is 1% of the update
PARITY_GRAD_NORM_RTOL = 1e-4
PARITY_PARAM_ATOL = 1e-6

# the card's dense bf16 tensor-core peak (H100 SXM data sheet) and the
# model's forward cost at the 1024-frame bucket (PERF.md section 5,
# computed: 25.3 GFLOP per utterance); a train step is about 3 forwards
PEAK_BF16_OPS_PER_S = 989e12
FORWARD_FLOP_PER_UTT = 25.3e9

# conv0 kernel vs conv0_plain. float32: 6400 products a sum (25 taps x
# 2I), summed in another order; outputs of order 1. bfloat16: see
# check_conv0. Gradients (float32, TF32 off): the transpose convs (cuDNN)
# against autograd through the 25 matmuls, sums of up to 512 products.
CONV0_F32_RTOL, CONV0_F32_ATOL = 1e-5, 1e-4
CONV0_GRAD_RTOL, CONV0_GRAD_ATOL = 1e-4, 1e-4

MAIN_BATCH, MAIN_STEPS = 64, 4
TRAIN_STEPS, TRAIN_INTERVAL, TRAIN_UTTERANCES = 8, 4, 128


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 2: the CTC alpha kernel against its plain version -------------


def ctc_inputs(seed, B, T, L, label_range, frame_range):
    """Random log-probs [B, T, 29] and labels shaped like the corpus's."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, T, 29).astype(np.float32) * 2.0
    label_lengths = rng.randint(*label_range, size=B).astype(np.int32)
    labels = np.full((B, L), -1, dtype=np.int32)
    for b in range(B):
        labels[b, : label_lengths[b]] = rng.randint(0, 28, size=label_lengths[b])
    logit_lengths = rng.randint(*frame_range, size=B).astype(np.int32)
    return logits, logit_lengths, labels, label_lengths


def edge_inputs():
    logits, logit_lengths, labels, label_lengths = ctc_inputs(
        7, B=7, T=101, L=40, label_range=(10, 40), frame_range=(60, 102)
    )
    labels[0], label_lengths[0] = -1, 0  # empty label
    labels[1], label_lengths[1], logit_lengths[1] = 5, 40, 50  # infeasible
    logit_lengths[2] = 0  # no frames at all
    logit_lengths[3] = 101  # the full (odd) width
    labels[4], label_lengths[4], logit_lengths[4] = -1, 1, 1  # one frame
    labels[4, 0] = 3
    labels[5, :12] = [4, 4, 4, 9, 9, 4, 4, 2, 2, 2, 2, 7]  # repeated letters
    labels[5, 12:], label_lengths[5], logit_lengths[5] = -1, 12, 90
    return logits, logit_lengths, labels, label_lengths


def edge_grad(B):
    """A non-uniform cotangent for edge_inputs, 0 where the loss mask puts
    0: the infeasible row 1 and row 2, whose loss is 1e30 too (no frames
    for a non-empty label)."""
    g = np.linspace(0.25, 2.0, B).astype(np.float32)
    g[1:3] = 0.0
    return g


def ctc_bound_ms(logit_lengths, label_lengths, L, C=29, history_frames=0):
    """Least time for this data: each needed log-prob row read once, the
    labels and lengths read once, the losses written once, and with
    ``history_frames`` = T the [T, B, 2L+1] history written once; 14
    float32 operations per needed state and frame. Returns (ms, bound_by)."""
    frames = np.maximum(logit_lengths.astype(np.int64), 1)
    states = 2 * label_lengths.astype(np.int64) + 1
    B = len(frames)
    nbytes = 4 * (int(frames.sum()) * C + B * L + 2 * B + B
                  + history_frames * B * (2 * L + 1))
    ops = CTC_OPS_PER_STATE_FRAME * int((frames * states).sum())
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_ctc(name, inputs, device, time_it=True, history=False):
    """The alpha kernel without the history (evaluate's variant) and, with
    ``history``, with it (train's) against the plain version: the losses,
    the whole history, the no-history loss bit-equal to the history
    variant's, and two calls of each bit-equal; then the times of both
    beside the plain version, ``F.ctc_loss``'s forward and the bounds."""
    from speecht_tpu_torch import vocabulary
    from speecht_tpu_torch.ops import ctc, ctc_cuda

    logits, logit_lengths, labels, label_lengths = (
        torch.from_numpy(a).to(device) for a in inputs
    )
    logp = torch.log_softmax(logits, dim=-1).contiguous()
    B, T, C = logp.shape
    L = labels.shape[1]
    S = 2 * L + 1
    kernel = ctc_cuda.CTC_ALPHA

    def run_kernel(alpha_out=None):
        return kernel(logp, logit_lengths, labels, label_lengths, alpha_out)

    def run_plain():
        return ctc.ctc_loss_log_probs(logp, logit_lengths, labels, label_lengths)

    got = run_kernel()
    again = run_kernel()
    torch.cuda.synchronize()
    want = run_plain()
    torch.cuda.synchronize()
    diff = (got - want).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / want.abs().clamp(min=1e-30)).max())
    ok = bool(torch.allclose(got, want, rtol=CTC_RTOL, atol=CTC_ATOL))
    check(bool(torch.isfinite(got).all()), f"ctc_alpha {name}: non-finite loss")
    bit_equal = bool(torch.equal(got, again))
    if history:
        alpha = torch.full((T, B, S), float("nan"), device=device)
        alpha_again = torch.full_like(alpha, float("nan"))
        hist_loss = run_kernel(alpha)
        hist_loss_again = run_kernel(alpha_again)
        torch.cuda.synchronize()
        ext = ctc._extend_labels(labels, vocabulary.BLANK_ID)
        alphas, _ = ctc.ctc_alpha(
            logp, logit_lengths, ext,
            ctc._transition_masks(ext, vocabulary.BLANK_ID),
        )
        hist_err = float((alpha - alphas).abs().max())
        ok = ok and bool(torch.allclose(alpha, alphas, rtol=CTC_RTOL, atol=CTC_ATOL))
        bit_equal = (bit_equal and bool(torch.equal(alpha, alpha_again))
                     and bool(torch.equal(hist_loss, hist_loss_again)))
        same_loss = bool(torch.equal(got, hist_loss))
        print(f"ctc_alpha {name}: alpha history max abs err {hist_err!r}; the "
              f"no-history loss bit-equal to the history variant's: {same_loss}")
        check(same_loss, f"ctc_alpha {name}: the two variants' losses differ")
        del alphas
    print(f"ctc_alpha {name}: two calls bit-equal: {bit_equal}")
    check(bit_equal, f"ctc_alpha {name}: two calls on the same inputs differ")
    result = {
        "shape": f"B={B} T={T} L={L} S={S}",
        "max_abs_err": max_abs,
        "max_rel_err": max_rel,
        "ok": ok,
    }
    print(
        f"ctc_alpha {name} [{result['shape']}]: max abs err {max_abs!r}, "
        f"max rel err {max_rel!r} (tolerance rtol {CTC_RTOL} atol {CTC_ATOL}): "
        + ("ok" if ok else "DISAGREES")
    )
    check(ok, f"ctc_alpha {name} disagrees with the plain version")
    if not time_it:
        return result

    ms = time_ms(run_kernel, iters=20)
    plain_ms = time_ms(run_plain, iters=2)
    targets = labels.clamp(min=0).long()
    log_probs_tbc = logp.transpose(0, 1)
    lengths64, label_lengths64 = logit_lengths.long(), label_lengths.long()

    def run_library():
        return torch.nn.functional.ctc_loss(
            log_probs_tbc, targets, lengths64, label_lengths64,
            blank=vocabulary.BLANK_ID, reduction="none", zero_infinity=False,
        )

    library_ms = time_ms(run_library, iters=10)
    lib = run_library()
    torch.cuda.synchronize()
    lib_err = float((lib - got).abs().max())
    bound_ms, bound_by = ctc_bound_ms(inputs[1], inputs[3], L, C)
    print(
        f"ctc_alpha {name}: kernel {ms!r} ms, plain {plain_ms!r} ms, "
        f"F.ctc_loss {library_ms!r} ms (agrees within {lib_err!r}), "
        f"bound {bound_ms!r} ms ({bound_by})"
    )
    result.update(
        ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=bound_ms, bound_by=bound_by,
    )
    if history:
        hist_ms = time_ms(lambda: run_kernel(alpha), iters=20)
        hist_bound, hist_by = ctc_bound_ms(inputs[1], inputs[3], L, C, history_frames=T)
        print(f"ctc_alpha {name} with the history: kernel {hist_ms!r} ms, bound "
              f"{hist_bound!r} ms ({hist_by}); without it {ms!r} ms; F.ctc_loss "
              f"forward {library_ms!r} ms")
        result["history"] = {
            "shape": result["shape"], "ms": hist_ms, "bound_ms": hist_bound,
            "bound_by": hist_by, "library_ms": library_ms,
        }
    return result


# S = 14295: the widest the first, shared-memory version of the alpha
# kernel took (16 S + 3712 bytes of the card's 227 KB)
FIRST_KERNEL_WIDEST_LABELS = 7147


def alpha_wide_rows(device):
    """The history's cost at the train shape with every row at full width
    (both variants then run all 513 states), and rows wider than 4096
    states: one width past it and the widest the first version took (K=32
    on 14 warps)."""
    full = ctc_inputs(3, B=64, T=512, L=256, label_range=(256, 257),
                      frame_range=(512, 513))
    r = check_ctc("full-width rows", full, device, history=True)
    print(f"ctc_alpha history cost at B=64 T=512 S=513, every row at 513 states: "
          f"{r['history']['ms'] - r['ms']!r} ms ({r['history']['ms']!r} with, "
          f"{r['ms']!r} without)")
    for name, B, L, T, seed in (
            ("S=4201", 2, 2100, 4300, 4),
            ("widest of the first kernel", 1, FIRST_KERNEL_WIDEST_LABELS, 14400, 5)):
        check_ctc(name, ctc_inputs(seed, B=B, T=T, L=L, label_range=(L - 600, L + 1),
                                   frame_range=(T - 100, T + 1)),
                  device, time_it=False, history=True)


def beta_bound_ms(logit_lengths, label_lengths, T, C=29):
    """Least time for this data: the alpha history and log-prob rows each
    row needs, read once, and the dlogits [B, T, C] written once; 19
    float32 operations per needed state and frame and 3 per class and
    frame. A row needs its frames t < T_b and its states s <= 2 L_b: past
    them beta keeps its -1e30 fill, so the posterior there is 0 and the
    alpha value never reaches dlogits. Returns (ms, bound_by)."""
    frames = logit_lengths.astype(np.int64).clip(0, None)
    states = 2 * label_lengths.astype(np.int64) + 1
    B = len(frames)
    nbytes = 4 * (int((frames * states).sum()) + int(frames.sum()) * C + B * T * C)
    ops = (BETA_OPS_PER_STATE_FRAME * int((frames * states).sum())
           + BETA_OPS_PER_CLASS_FRAME * int(frames.sum()) * C)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_beta(name, inputs, g, device, time_it=True):
    """ctc_beta against the plain _posterior_grad * g on the same alpha
    history, and the whole autograd Function against ctc_loss_autodiff."""
    from speecht_tpu_torch import vocabulary
    from speecht_tpu_torch.ops import ctc, ctc_cuda

    logits, logit_lengths, labels, label_lengths = (
        torch.from_numpy(a).to(device) for a in inputs
    )
    g = torch.from_numpy(g).to(device)
    logp = torch.log_softmax(logits, dim=-1).contiguous()
    B, T, C = logp.shape
    L = labels.shape[1]
    S = 2 * L + 1
    alpha = torch.empty(T, B, S, device=device)
    loss = ctc_cuda.CTC_ALPHA(logp, logit_lengths, labels, label_lengths, alpha)
    ext = ctc._extend_labels(labels, vocabulary.BLANK_ID)
    allow = ctc._transition_masks(ext, vocabulary.BLANK_ID)

    def run_kernel():
        return ctc_cuda.CTC_BETA(
            logp, logit_lengths, labels, label_lengths, alpha, loss, g
        )

    def run_plain():
        return ctc._posterior_grad(
            logp, logit_lengths, ext, allow, label_lengths, alpha, -loss
        ) * g[:, None, None]

    got = run_kernel()
    again = run_kernel()
    want = run_plain()
    torch.cuda.synchronize()
    max_abs = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=BETA_RTOL, atol=BETA_ATOL))
    bit_equal = bool(torch.equal(got, again))
    print(f"ctc_beta {name}: two calls bit-equal: {bit_equal}")
    check(bit_equal, f"ctc_beta {name}: two calls on the same inputs differ")
    check(bool(torch.isfinite(got).all()), f"ctc_beta {name}: non-finite dlogits")
    mask = torch.arange(T, device=device)[None, :] >= logit_lengths[:, None]
    check(not bool(got[mask].any()), f"ctc_beta {name}: frames past the length not 0")
    check(not bool(got[g == 0].any()), f"ctc_beta {name}: a row with g=0 not 0")

    # the whole Function (alpha with history, then beta), float32 autodiff
    # and float64 autodiff, the witness independent of the posterior form
    def grad_of(fn, x, cot):
        x = x.clone().requires_grad_(True)
        loss_x = fn(x, logit_lengths, labels, label_lengths)
        return loss_x.detach(), torch.autograd.grad(loss_x, x, grad_outputs=cot)[0]

    f_loss, f_grad = grad_of(ctc_cuda.ctc_loss, logits, g)
    a_loss, a_grad = grad_of(ctc.ctc_loss_autodiff, logits, g)
    logits64, g64 = logits.double(), g.double()
    r_loss, r_grad = grad_of(ctc.ctc_loss_autodiff, logits64, g64)
    torch.cuda.synchronize()
    loss_ok = bool(torch.allclose(f_loss, a_loss, rtol=CTC_RTOL, atol=CTC_ATOL))
    witness = {
        side: f64_witness(grad, r_grad, logits64, g64, logit_lengths, r_loss)
        for side, grad in (("Function", f_grad), ("float32 autodiff", a_grad))
    }
    witness_ok = all(share <= 1.0 for _err, share in witness.values())
    result = {
        "shape": f"B={B} T={T} L={L} S={S}",
        "max_abs_err": max_abs,
        "f64_witness": witness,
        "ok": ok and loss_ok and witness_ok,
    }
    print(
        f"ctc_beta {name} [{result['shape']}]: dlogits vs plain max abs err "
        f"{max_abs!r} (tolerance rtol {BETA_RTOL} atol {BETA_ATOL}): "
        + ("ok" if ok else "DISAGREES")
        + f"; Function loss vs autodiff max abs "
        f"{float((f_loss - a_loss).abs().max())!r}: "
        + ("ok" if loss_ok else "DISAGREES")
        + "; grads vs float64 autodiff (bound: mass x "
        f"{WITNESS_ULPS} sqrt(T) ulp(|logP|) + {WITNESS_ATOL}): "
        + ", ".join(f"{side} max abs {err!r}, {share!r} of its bound"
                    for side, (err, share) in witness.items())
        + (": ok" if witness_ok else ": DISAGREES")
    )
    check(result["ok"], f"ctc_beta {name} disagrees")
    if not time_it:
        return result

    ms = time_ms(run_kernel, iters=20)
    plain_ms = time_ms(run_plain, iters=1)
    lp_tbc = logp.transpose(0, 1).detach().requires_grad_(True)
    targets = labels.clamp(min=0).long()
    lengths64, label_lengths64 = logit_lengths.long(), label_lengths.long()

    def library_forward():
        return torch.nn.functional.ctc_loss(
            lp_tbc, targets, lengths64, label_lengths64,
            blank=vocabulary.BLANK_ID, reduction="none", zero_infinity=False,
        )

    lib_loss = library_forward()
    library_ms = time_ms(
        lambda: torch.autograd.grad(lib_loss, lp_tbc, g, retain_graph=True),
        iters=10,
    )
    (lib_grad,) = torch.autograd.grad(lib_loss, lp_tbc, g, retain_graph=True)
    lib_err = float((lib_grad.transpose(0, 1) - got).abs().max())

    def ours_pair():
        ctc_cuda.CTC_ALPHA(logp, logit_lengths, labels, label_lengths, alpha)
        return run_kernel()

    def library_pair():
        return torch.autograd.grad(library_forward(), lp_tbc, g)

    pair_ms = time_ms(ours_pair, iters=10)
    library_pair_ms = time_ms(library_pair, iters=10)
    bound_ms, bound_by = beta_bound_ms(inputs[1], inputs[3], T, C)
    print(
        f"ctc_beta {name}: kernel {ms!r} ms, plain {plain_ms!r} ms, "
        f"F.ctc_loss backward alone {library_ms!r} ms (its grad agrees within "
        f"{lib_err!r}), bound {bound_ms!r} ms ({bound_by}); alpha (with "
        f"history) + beta {pair_ms!r} ms vs F.ctc_loss forward+backward "
        f"{library_pair_ms!r} ms"
    )
    result.update(
        ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
        bound_by=bound_by, pair_ms=pair_ms, library_pair_ms=library_pair_ms,
    )
    return result


# -- phase 2c: the conv0 kernel against its plain version -------------------


def bf16_spacing(t):
    """The gap between neighbouring bfloat16 values at |t| (8 significant
    bits: 2^(e - 8) for |t| = m 2^e, m in [0.5, 1)); 0 at t = 0."""
    m, e = torch.frexp(t.abs().float())
    return torch.ldexp((m > 0).float(), e - 8)


def conv0_inputs(seed, B, T, I, O, dtype, device):
    """Features, a glorot-uniform [O, I, 48] weight and a bias, from a seed."""
    rng = np.random.RandomState(seed)
    limit = math.sqrt(6.0 / (48 * I + 48 * O))
    x = rng.randn(B, T, I).astype(np.float32)
    w = rng.uniform(-limit, limit, size=(O, I, 48)).astype(np.float32)
    b = rng.uniform(-0.05, 0.05, size=O).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device=device, dtype=dtype) for a in (x, w, b))


def conv0_bound_ms(B, T, I, O, dtype):
    """Least time: x, weight, bias and y moved once; 2 B (T/2) O 48 I
    operations (the 48 real taps) at the dense bf16 tensor-core rate, or
    the float32 rate outside the tensor cores (no TF32)."""
    size = 2 if dtype == torch.bfloat16 else 4
    nbytes = size * (B * T * I + O * I * 48 + O + B * (T // 2) * O)
    ops = 2 * B * (T // 2) * O * 48 * I
    peak = PEAK_BF16_OPS_PER_S if dtype == torch.bfloat16 else PEAK_F32_OPS_PER_S
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_conv0(name, B, T, I, O, dtype, device, time_it=True, seed=0):
    """The kernel ([B, O, T/2]) against conv0_plain ([B, T/2, O]) on the
    same inputs. bfloat16: both sum exact products in float32 and round
    once, in another order, so they may differ by one bf16 spacing of the
    output, plus CONV0_F32_ATOL where a sum near 0 has another sign (ReLU).
    float32: the same products summed in another order."""
    from speecht_tpu_torch.ops import conv0, conv0_cuda

    x, w, b = conv0_inputs(seed, B, T, I, O, dtype, device)

    def run_kernel():
        return conv0_cuda.CONV0(x, w, b)

    def run_plain():
        return conv0.conv0_plain(x, w, b)

    got = run_kernel().transpose(1, 2).float()
    want = run_plain().float()
    torch.cuda.synchronize()
    err = (got - want).abs()
    if dtype == torch.bfloat16:
        tol = bf16_spacing(torch.maximum(got.abs(), want.abs())) + CONV0_F32_ATOL
        tol_text = "one bf16 spacing of the output + %g" % CONV0_F32_ATOL
    else:
        tol = CONV0_F32_ATOL + CONV0_F32_RTOL * want.abs()
        tol_text = f"atol {CONV0_F32_ATOL} + rtol {CONV0_F32_RTOL}"
    share = float((err / tol).max())
    ok = share <= 1.0 and bool(torch.isfinite(got).all())
    result = {
        "shape": f"B={B} T={T} I={I} O={O} {str(dtype).split('.')[-1]}",
        "max_abs_err": float(err.max()),
        "unequal_share": float((err > 0).float().mean()),
        "ok": ok,
    }
    print(
        f"conv0 {name} [{result['shape']}]: max abs err {result['max_abs_err']!r}, "
        f"{result['unequal_share']:.4%} of entries differ, {share!r} of the "
        f"tolerance ({tol_text}): " + ("ok" if ok else "DISAGREES")
    )
    check(ok, f"conv0 {name} disagrees with the plain version")
    if not time_it:
        return result

    ms = time_ms(run_kernel, iters=50, warmup=3)
    plain_ms = time_ms(run_plain, iters=5)
    xt = x.transpose(1, 2)

    def run_library():
        return torch.relu(torch.nn.functional.conv1d(xt, w, b, stride=2, padding=23))

    library_ms = time_ms(run_library, iters=50, warmup=3)
    lib_err = float((run_library().transpose(1, 2).float() - want).abs().max())
    bound_ms, bound_by = conv0_bound_ms(B, T, I, O, dtype)
    print(
        f"conv0 {name}: kernel {ms!r} ms ({bound_ms / ms:.1%} of the bound), "
        f"plain {plain_ms!r} ms, F.conv1d + bias + ReLU {library_ms!r} ms "
        f"(agrees within {lib_err!r}), bound {bound_ms!r} ms ({bound_by})"
    )
    result.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                  bound_ms=bound_ms, bound_by=bound_by)
    return result


def check_conv0_bit_equal(device):
    """Two bf16 calls at the main shape on the same inputs are bit-equal:
    the kernel has no atomics, so a difference is a race on the weight
    ring or the slab buffers."""
    from speecht_tpu_torch.ops import conv0_cuda

    x, w, b = conv0_inputs(3, 64, 1024, 128, 250, torch.bfloat16, device)
    first = conv0_cuda.CONV0(x, w, b)
    second = conv0_cuda.CONV0(x, w, b)
    torch.cuda.synchronize()
    equal = torch.equal(first, second)
    print("conv0 two bf16 calls at B=64 T=1024 I=128 O=250: "
          + ("bit-equal" if equal else "DIFFER"))
    check(equal, "conv0: two calls on the same inputs differ")


def check_conv0_grads(device):
    """Conv0Function's (x, w, b) gradients on the card against autograd
    through conv0_plain, float32 with TF32 off, a random cotangent. The
    two ReLU masks must agree entry by entry (a pre-activation within
    rounding of 0 would flip one; the shape keeps that unlikely)."""
    from speecht_tpu_torch.ops import conv0, conv0_cuda

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        x, w, b = conv0_inputs(5, 2, 256, 128, 64, torch.float32, device)
        g = torch.from_numpy(
            np.random.RandomState(6).randn(2, 128, 64).astype(np.float32)
        ).to(device)
        grads = {}
        for side, fn in (("Function", conv0_cuda.conv0), ("plain", conv0.conv0_plain)):
            args = [t.clone().requires_grad_(True) for t in (x, w, b)]
            y = fn(*args)
            grads[side] = (y.detach(), torch.autograd.grad(y, args, g))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    (yf, gf), (yp, gp) = grads["Function"], grads["plain"]
    flips = int(((yf > 0) != (yp > 0)).sum())
    errs = {}
    ok = flips == 0
    for name, a, c in zip(("dx", "dw", "db"), gf, gp):
        errs[name] = float((a - c).abs().max())
        ok = ok and bool(torch.allclose(a, c, rtol=CONV0_GRAD_RTOL, atol=CONV0_GRAD_ATOL))
    print(f"conv0 gradients (Function vs autograd through conv0_plain, float32, "
          f"B=2 T=256 I=128 O=64): max abs err {errs}, ReLU masks differ at "
          f"{flips} entries (tolerance rtol {CONV0_GRAD_RTOL} atol "
          f"{CONV0_GRAD_ATOL}): " + ("ok" if ok else "DISAGREES"))
    check(ok, "conv0 gradients disagree")


# -- phase 2d: the device beam against its plain version ---------------------

BEAM_WIDTH, BEAM_TOP_K = 100, 8  # JAX's defaults
BEAM_WEIGHTS = (0.8, 0.0, 2.3)  # JAX's default lm, word-count, valid-word weights
# kept frames a row at the 1024-frame bucket, as phase 3d's weights keep them
BEAM_FRAMES = (130, 231)
# the kernel vs the plain version on the card: the same float32 operations
# in the same order, so ids and lengths must be equal and the n-best
# scores equal to 1e-6 relative (how many are bit-equal is reported)
BEAM_SCORE_RTOL = 1e-6
# phase 4f: a row the card and the CPU decode otherwise must be a near tie:
# its two hypotheses within this of each other under float64 rescoring
# (the bound of JAX's own tests/test_beam_device.py:300)
BEAM_TIE_MARGIN = 0.1
# operations a candidate costs: its extension score, its LM term, the
# total, the three compares of its masks and the larger of its pb and pnb;
# a log-add-exp whose two arguments are both live and within 110 of each
# other adds a subtract, an abs and an add, and an exp and a log1p on the
# special-function units (any other gives the larger argument, to the bit)
BEAM_OPS_PER_CANDIDATE = 7
BEAM_OPS_PER_LOGADDEXP = 3
BEAM_SFU_OPS_PER_LOGADDEXP = 2
BEAM_LOGADDEXP_SPAN = 110.0
# the 67e12 counts an FMA as two operations (132 SMs x 128 float32 lanes x
# 2 x 1.98 GHz): an add, a compare or a max is one a lane and clock, and
# the special-function units give 16 results a clock an SM against the 128
# lanes (CUDA C++ Programming Guide, arithmetic instruction throughput,
# compute capability 9.0)
PEAK_F32_NON_FMA_OPS_PER_S = PEAK_F32_OPS_PER_S / 2
PEAK_SFU_OPS_PER_S = PEAK_F32_NON_FMA_OPS_PER_S * 16 / 128
BEAM_BYTES_PER_PROBE = 40  # a 32-byte bucket key row and an 8-byte value


def beam_emissions(seed, lengths):
    """Collapsed-like log-probs [B, T, 29] from a numpy seed: each frame
    has one likely char (a letter, 20% the space, 12% the blank) above
    spread alternates, so the beam spells words of the LM's alphabet and
    keeps choices open; zero past each row's length."""
    from speecht_tpu_torch import vocabulary

    rng = np.random.RandomState(seed)
    lengths = np.asarray(lengths, np.int32)
    B = len(lengths)
    T = max(int(lengths.max()), 1)
    logits = rng.randn(B, T, vocabulary.NUM_CLASSES).astype(np.float32) * 1.5
    target = rng.randint(0, 26, size=(B, T))
    u = rng.rand(B, T)
    target[u < 0.2] = vocabulary.SPACE_ID
    target[u > 0.88] = vocabulary.BLANK_ID
    np.put_along_axis(logits, target[..., None],
                      np.take_along_axis(logits, target[..., None], -1) + 7.0, -1)
    logp = torch.log_softmax(torch.from_numpy(logits), dim=-1).numpy()
    logp[np.arange(T)[None, :] >= lengths[:, None]] = 0.0
    return logp, lengths


def tie_emissions(seed, lengths):
    """``beam_emissions`` rounded to whole nats (the likeliest char to -0.0):
    many chars of a frame share a log-prob, so the frame's top-K and the
    pool hold many equal values, and only the index rule orders them."""
    logp, lengths = beam_emissions(seed, lengths)
    return np.round(logp).astype(np.float32), lengths


def write_arpa(path, grams):
    """An ARPA file from {n: [(log10 prob, words, backoff or None)]}."""
    lines = ["\\data\\"] + [f"ngram {n}={len(grams[n])}" for n in sorted(grams)]
    for n in sorted(grams):
        lines += ["", f"\\{n}-grams:"]
        lines += [f"{p:.4f}\t{' '.join(w)}" + ("" if b is None else f"\t{b:.4f}")
                  for p, w, b in grams[n]]
    lines += ["", "\\end\\", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))


def lm_variants(root, lm_dir, seed=5):
    """Two LMs over the phase-3d LM's words, each in a directory with its
    vocabulary file: order 1 (no history), and order 6 (history 5, <s>
    pinned) with 6-word chains, half of them <s>-anchored."""
    from speecht_tpu_torch.ops import beam_device

    _order, word_ids, _entries = beam_device._parse_arpa(os.path.join(lm_dir, "model.arpa"))
    words = [w for w in word_ids if not w.startswith("<")]
    rng = np.random.RandomState(seed)
    uni = [(-3.5, ("<unk>",), None), (-2.0, ("<s>",), -0.4), (-2.1, ("</s>",), None)]
    uni += [(-1.5 - 3 * rng.rand(), (w,), -0.1 - 0.4 * rng.rand()) for w in words]
    dirs = []
    for name, order in (("lm_order1", 1), ("lm_order6", 6)):
        grams = {1: uni}
        if order == 6:
            chains = [[words[i] for i in rng.randint(0, len(words), size=6)]
                      for _ in range(4000)]
            for c in chains[::2]:
                c[0] = "<s>"
            for n in range(2, 7):
                seen = {tuple(c[i:i + n]) for c in chains for i in range(7 - n)}
                grams[n] = [(-0.3 - 2 * rng.rand(), g, None if n == 6 else -0.2)
                            for g in sorted(seen)]
        d = os.path.join(root, name)
        os.makedirs(d)
        write_arpa(os.path.join(d, "model.arpa"), grams)
        with open(os.path.join(d, "vocabulary"), "w") as f:
            f.write("\n".join(words[::2]) + "\n")
        dirs.append(d)
    return dirs


def kenlm_keyed_lm(lm_dir, device):
    """The LM of ``lm_dir`` with its n-gram windows keyed by KenLM's
    chained hash (``key_scheme`` "kenlm", the tables a PROBING binary
    gives; there is no KenLM writer here)."""
    from speecht_tpu_torch.ops import beam_device

    arpa = os.path.join(lm_dir, "model.arpa")
    vocab = os.path.join(lm_dir, "vocabulary")
    order, _word_ids, entries = beam_device._parse_arpa(arpa)
    meta, tables = beam_device._build_np_from_arpa(arpa, vocab)
    keys = [beam_device._np_kenlm_key_hash_rows(entries[n - 1][0])
            for n in range(2, order + 1)]
    ak, av, a2c = beam_device._assemble_arena(
        [k[0] for k in keys], [k[1] for k in keys],
        [entries[n - 1][1] for n in range(2, order + 1)],
        [entries[n - 1][2] for n in range(2, order + 1)],
    )
    meta = dict(meta, key_scheme="kenlm", arena_two_choice=a2c)
    tables = dict(tables, arena_k=ak, arena_v=av)
    return beam_device.DeviceLM._from_np(meta, tables, None, device)


class LogAddExpCount(torch.overrides.TorchFunctionMode):
    """Counts, in a plain search run under it, the log-add-exps that need an
    exp and a log1p: both arguments live (above NEG / 2) and within
    BEAM_LOGADDEXP_SPAN of each other, in each row's own frames (each frame
    makes three calls, the pool's total last, then the final ranking one)."""

    def __init__(self, lengths):
        super().__init__()
        self.lengths = torch.as_tensor(np.asarray(lengths, np.int64))
        self.rows = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.logaddexp:
            from speecht_tpu_torch.ops.beam_device import NEG

            a, b = args[:2]
            need = (a > NEG / 2) & (b > NEG / 2) & ((a - b).abs() <= BEAM_LOGADDEXP_SPAN)
            self.rows.append(need.reshape(need.shape[0], -1).sum(1).cpu())
        return out

    def count(self, T):
        check(len(self.rows) == 3 * T + 1,
              f"the plain search made {len(self.rows)} log-add-exp calls, not {3 * T + 1}")
        frame_of_call = torch.arange(3 * T) // 3
        live = frame_of_call[:, None] < self.lengths[None, :]
        return int((torch.stack(self.rows[:-1]) * live).sum() + self.rows[-1].sum())


def lm_tables(lm):
    """A device LM's tables in a few words: both two-choice flags, the
    arena's and the words table's buckets and the bytes."""
    return (f"arena two-choice {lm.arena_two_choice}, words two-choice "
            f"{lm.words_two_choice}, {lm.tables['arena_k'].shape[0]} arena and "
            f"{lm.tables['words_k'].shape[0]} words buckets, {lm.hbm_bytes()} bytes")


def beam_bound_ms(lengths, W, K, H, n_best, T, table_bytes, logaddexps):
    """Least time for this data: the emissions read once, the outputs
    written once (the backpointers can stay on chip), the LM rows probed
    (a word-table row and the 2H+1 arena rows of a backoff walk for every
    beam and frame) capped at the tables' size. Operations per frame and
    row, by type: the (K+1)·W candidates' arithmetic; the top-W selection of
    the pool, P + W·log2(W) compares; one match a beam for the merge, two
    32-bit key compares; and ``logaddexps``, the run's log-add-exps that
    need an exp and a log1p (LogAddExpCount), those two at the
    special-function units' rate, the rest at the non-FMA float32 rate. The
    two kinds of unit run side by side, so the operations take the longer
    of their two times. Returns (ms, bound_by, the counts)."""
    frames = int(np.asarray(lengths, np.int64).sum())
    B = len(lengths)
    P = (K + 1) * W
    probes = frames * W * (2 + 2 * H) if table_bytes else 0
    nbytes = (frames * 29 * 4 + 4 * B + B * n_best * (4 * T + 8)
              + min(probes * BEAM_BYTES_PER_PROBE, table_bytes))
    sfu = logaddexps * BEAM_SFU_OPS_PER_LOGADDEXP
    alu = (frames * (P * BEAM_OPS_PER_CANDIDATE + P + W * math.ceil(math.log2(W)) + 2 * W)
           + logaddexps * BEAM_OPS_PER_LOGADDEXP)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = max(alu / PEAK_F32_NON_FMA_OPS_PER_S, sfu / PEAK_SFU_OPS_PER_S)
    counts = {"bytes": nbytes, "float32_ops": alu, "sfu_ops": sfu,
              "logaddexps": logaddexps, "all_logaddexps": frames * (P + 2 * W) + B * W}
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            counts)


def host_beam_ms(logp, lengths, lm_dir, W, weights):
    """The port's host C++ beam over the same rows on os.cpu_count()
    threads (the yardstick: no single PyTorch call searches a beam);
    host clock, one call after a warm-up row."""
    import concurrent.futures

    from speecht_tpu_torch import native, vocabulary
    from speecht_tpu_torch.ops.beam import find_lm_files

    lm = native.NGramLM(*find_lm_files(lm_dir)) if lm_dir else None

    def one(i):
        return native.ctc_beam_search(
            logp[i, :lengths[i]], beam_width=W, lm=lm, lm_weight=weights[0],
            word_count_weight=weights[1], valid_word_count_weight=weights[2],
            blank_id=vocabulary.BLANK_ID)

    one(0)
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count()) as pool:
        t0 = time.perf_counter()
        out = list(pool.map(one, range(len(lengths))))
        ms = (time.perf_counter() - t0) * 1e3
    return ms, out


def check_beam(name, lm, logp, lengths, device, W=BEAM_WIDTH, top_k=BEAM_TOP_K,
               n_best=1, weights=BEAM_WEIGHTS, lm_dir=None, time_it=False):
    """The beam kernel against its plain version on the card: ids and
    lengths equal on every row, the n-best scores to BEAM_SCORE_RTOL
    (the count bit-equal reported), two kernel calls bit-equal; with
    ``time_it`` the kernel's time beside the plain version's, the bound
    and the host beam's."""
    from speecht_tpu_torch.ops import beam_device

    fn = beam_device.make_device_beam_search(W, lm=lm, prune_top_k=top_k, n_best=n_best)
    x = torch.from_numpy(logp).to(device)
    n = torch.from_numpy(lengths).to(device)
    got = [t.cpu() for t in fn(x, n, *weights)]
    again = [t.cpu() for t in fn(x, n, *weights)]
    lae = LogAddExpCount(lengths)
    with lae if time_it else contextlib.nullcontext():
        want = [t.cpu() for t in fn.plain(x, n, *weights)]
    same_ids = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
    rows_equal = int((got[0] == want[0]).reshape(len(lengths), -1).all(1).sum())
    bit_equal = all(torch.equal(a, b) for a, b in zip(got, again))
    max_abs = 0.0
    score_note = ""
    scores_bit_equal = None
    ok = same_ids and bit_equal
    if n_best > 1:
        gs, ws = got[2], want[2]
        live = ws > -1e29
        max_abs = float((gs - ws)[live].abs().max()) if live.any() else 0.0
        rel = float(((gs - ws).abs() / ws.abs().clamp(min=1e-30))[live].max()) if live.any() else 0.0
        same_bits = int((gs.view(torch.int32) == ws.view(torch.int32)).sum())
        ok = ok and rel <= BEAM_SCORE_RTOL
        score_note = (f"; n-best scores max rel diff {rel!r} (tolerance {BEAM_SCORE_RTOL}), "
                      f"{same_bits}/{gs.numel()} bit-equal")
        scores_bit_equal = same_bits == gs.numel()
    K = fn.spec.top_k(logp.shape[2])
    H = fn.spec.H
    shape = (f"B={len(lengths)} T={logp.shape[1]} frames {int(lengths.min())}-"
             f"{int(lengths.max())} W={W} K={K} n_best={n_best} "
             + ("no LM" if lm is None else f"LM order {lm.order} ({lm.key_scheme} keys, "
                                           f"{lm_tables(lm)})"))
    print(f"beam_device {name} [{shape}]: rows with equal ids {rows_equal}/{len(lengths)}, "
          f"lengths equal {bool(torch.equal(got[1], want[1]))}{score_note}; two calls "
          f"bit-equal {bit_equal}: " + ("ok" if ok else "DISAGREES"))
    check(ok, f"beam_device {name} disagrees with the plain version")
    result = {"shape": shape, "max_abs_err": max_abs, "ok": ok,
              "scores_bit_equal": scores_bit_equal}
    if not time_it:
        return result
    ms = time_ms(lambda: fn(x, n, *weights), iters=5)
    plain_ms = time_ms(lambda: fn.plain(x, n, *weights), iters=1, warmup=0)
    host_ms, _ = host_beam_ms(logp, lengths, lm_dir, W, weights)
    table_bytes = lm.hbm_bytes() if lm is not None else 0
    bound_ms, bound_by, counts = beam_bound_ms(lengths, W, K, H, n_best, logp.shape[1],
                                               table_bytes, lae.count(logp.shape[1]))
    us_frame = ms * 1e3 / max(int(lengths.max()), 1)
    print(f"beam_device {name}: kernel {ms!r} ms ({us_frame:.3f} µs a frame of the "
          f"longest row), plain {plain_ms!r} ms, host C++ beam "
          f"({os.cpu_count()} threads) {host_ms!r} ms, bound {bound_ms!r} ms ({bound_by}: "
          f"{counts['float32_ops']} float32 operations and compares, {counts['sfu_ops']} "
          f"exp/log1p for the {counts['logaddexps']} of {counts['all_logaddexps']} "
          f"log-add-exps that need them, {counts['bytes']} bytes); LM tables "
          f"{table_bytes} bytes")
    result.update(ms=ms, plain_ms=plain_ms, host_beam_ms=host_ms, bound_ms=bound_ms,
                  bound_by=bound_by, library_ms=None, us_per_frame=us_frame)
    return result


def beam_split(name, lm, logp, lengths, device, W=BEAM_WIDTH, top_k=BEAM_TOP_K,
               weights=BEAM_WEIGHTS):
    """The beam kernel's split build (``-DBEAM_DEVICE_SPLIT``) on the same
    rows: its ids equal to the plain build's, then each phase's µs a frame.
    Thread 0 of each CTA adds up clock64() intervals between the phases'
    barriers, its waits at them and the radix passes; the cycles become µs
    at the clock that the slowest row's cycles over the split build's own
    time (CUDA events) give. Returns {phase: µs a frame} with the waits,
    the passes a frame, the clock and the split build's ms."""
    from speecht_tpu_torch.ops import beam_device, beam_device_cuda

    split = beam_device_cuda.BEAM_DEVICE_SPLIT
    fn = beam_device.make_device_beam_search(W, lm=lm, prune_top_k=top_k)
    x = torch.from_numpy(logp).to(device)
    n = torch.from_numpy(lengths).to(device)

    def run():
        return split(fn.spec, x, n, *weights)

    want = [t.cpu() for t in fn(x, n, *weights)]
    got = [t.cpu() for t in run()]
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"beam_device split build {name}: ids differ from the plain build's")
    ms = time_ms(run, iters=5)
    rows = split.split(len(lengths))
    frames = int(rows[:, -1].sum())
    clock_hz = float(rows[:, -2].max()) / (ms / 1e3)

    def us(column):
        return float(rows[:, column].sum()) / max(frames, 1) / clock_hz * 1e6

    phases = len(beam_device_cuda.SPLIT_PHASES)
    per_frame = {phase: us(i) for i, phase in enumerate(beam_device_cuda.SPLIT_PHASES)}
    waiting = us(phases)
    passes = float(rows[:, phases + 1].sum()) / max(frames, 1)
    print(f"beam_device split {name} (µs a frame, thread 0 of each CTA, clock "
          f"{clock_hz / 1e9:.3f} GHz from the split build's {ms!r} ms): " + ", ".join(
              f"{phase} {value:.3f}" for phase, value in per_frame.items())
          + f"; in all {sum(per_frame.values()):.3f}, of it waiting at barriers "
          f"{waiting:.3f}; radix passes a frame {passes:.3f}")
    per_frame["waiting at barriers"] = waiting
    per_frame["radix passes a frame"] = passes
    return dict(per_frame, clock_ghz=clock_hz / 1e9, split_ms=ms)


def beam_phase(work, device):
    """Phase 2d: the beam kernel against its plain version on the card, at
    the main shape (B=64, 130-230 kept frames, W=100, K=8, the phase-3d
    LM) and on the edges. Returns (the main case's result, the LM's
    directory, its n-gram count)."""
    from speecht_tpu_torch.ops import beam_device, beam_device_cuda

    lm_dir, n_grams = write_lm(work)
    order1_dir, order6_dir = lm_variants(work, lm_dir)

    def load(d):
        return beam_device.DeviceLM(os.path.join(d, "model.arpa"),
                                    os.path.join(d, "vocabulary"), device=device)

    lm = load(lm_dir)
    rng = np.random.RandomState(7)
    logp, lengths = beam_emissions(0, rng.randint(*BEAM_FRAMES, size=MAIN_BATCH))
    main = check_beam("main shape", lm, logp, lengths, device, lm_dir=lm_dir,
                      time_it=True)
    # timed too: the main shape's time less this one is what the LM costs
    no_lm = check_beam("no LM", None, logp, lengths, device, time_it=True)
    main["lm_share"] = (main["ms"] - no_lm["ms"]) / main["ms"]
    print(f"beam_device the LM's share of the main shape: {main['lm_share']:.3f} "
          f"({main['ms'] - no_lm['ms']!r} ms)")
    main["split"] = beam_split("main shape", lm, logp, lengths, device)
    main["split_no_lm"] = beam_split("no LM", None, logp, lengths, device)
    check_beam("n_best=8", lm, logp, lengths, device, n_best=8)
    short, short_len = beam_emissions(1, rng.randint(10, 31, size=8))
    check_beam("W=1024 short rows", lm, short, short_len, device, W=1024)
    check_beam("W=1024 main rows", lm, logp, lengths, device, W=1024)
    tie, tie_len = tie_emissions(3, lengths[:16])
    check_beam("tie-heavy", lm, tie, tie_len, device, n_best=4)
    check_beam("tie-heavy, no LM", None, tie, tie_len, device)
    ragged, ragged_len = beam_emissions(2, [0, 1, 2, 5, 50, 130, 200, 230])
    check_beam("ragged lengths", lm, ragged, ragged_len, device, n_best=4)
    check_beam("order-1 LM", load(order1_dir), logp[:16], lengths[:16], device)
    lm6 = load(order6_dir)
    check(lm6.hist_len == 5 and lm6.bos_id >= 0, "the order-6 LM has no pinned <s>")
    check_beam("order-6 LM (H=5, <s> pinned)", lm6, logp[:16], lengths[:16], device)
    check_beam("kenlm key scheme", kenlm_keyed_lm(lm_dir, device), logp[:16],
               lengths[:16], device)
    lib = beam_device_cuda.BEAM_DEVICE.lib
    print("beam_device dynamic shared memory a CTA (registers and spills: the ptxas "
          "lines of phase 1, one build for every width): " + ", ".join(
              f"W={w} K={k} H={h}: {lib.beam_device_smem_bytes(w, k, h)} bytes, "
              f"{lib.beam_device_threads(w, k)} threads"
              for w, k, h in ((100, 8, 2), (1024, 8, 2), (1024, 8, 5), (128, 29, 5))))
    return main, lm_dir, n_grams


# -- phase 3: the main path -----------------------------------------------


def write_corpus(root, n, feature_width, seed=0, split="test"):
    """``n`` cached utterances: 600-1024 frames, 60-200 letters."""
    rng = np.random.RandomState(seed)
    d = os.path.join(root, "data", "preprocessed-power", split)
    os.makedirs(d)
    for i in range(n):
        frames = rng.randint(600, 1025)
        np.savez(
            os.path.join(d, f"utt{i:04d}"),
            audio_fragments=rng.randn(frames, feature_width).astype(np.float32),
            transcript=rng.randint(0, 28, size=rng.randint(60, 201)).astype(
                np.int64
            ),
        )
    return os.path.join(root, "data")


def write_weights(root, config, seed=0):
    """Glorot-uniform weights from a numpy seed, reference export layout."""
    rng = np.random.RandomState(seed)
    d = os.path.join(root, "weights")
    in_ch = config.input_size
    for i, (width, _stride, out_ch, _relu) in enumerate(config.layer_specs):
        limit = math.sqrt(6.0 / (width * in_ch + width * out_ch))
        layer = os.path.join(d, f"convolution_layer_{i}")
        os.makedirs(layer)
        kernel = rng.uniform(-limit, limit, size=(width, in_ch, out_ch))
        np.save(os.path.join(layer, "filters:0.npy"), kernel.astype(np.float32))
        bias = rng.uniform(-0.05, 0.05, size=out_ch).astype(np.float32)
        np.save(os.path.join(layer, "bias:0.npy"), bias)
        in_ch = out_ch
    return d


def run_cli(argv):
    from speecht_tpu_torch.cli import CLI

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        stats = CLI(argv).run()
    return stats, buf.getvalue()


@contextlib.contextmanager
def batch_marks():
    """Host times at which evaluate starts each batch's metrics, i.e. after
    its results reached the host."""
    from speecht_tpu_torch import evaluation

    marks = []
    track = evaluation.Evaluation._track_batch

    def timed_track(*args, **kwargs):
        marks.append(time.perf_counter())
        return track(*args, **kwargs)

    evaluation.Evaluation._track_batch = staticmethod(timed_track)
    try:
        yield marks
    finally:
        evaluation.Evaluation._track_batch = staticmethod(track)


def batch_period_ms(marks):
    """Steady-state batch period. The last interval is left out: no batch
    is loaded or launched behind the last one."""
    return (marks[-2] - marks[0]) / (len(marks) - 2) * 1e3


@contextlib.contextmanager
def step_marks():
    """Host times of each train step's call."""
    from speecht_tpu_torch.train import step as tstep

    marks = []
    make = tstep.make_train_step_acc

    def timed_make(*args, **kwargs):
        step = make(*args, **kwargs)

        def timed(*a):
            marks.append(time.perf_counter())
            return step(*a)

        return timed

    tstep.make_train_step_acc = timed_make
    try:
        yield marks
    finally:
        tstep.make_train_step_acc = make


def step_period_ms(marks):
    """Steady-state step period over step calls 2 to the last."""
    return (marks[-1] - marks[1]) / (len(marks) - 2) * 1e3


def main_path(work, kernels, card):
    from speecht_tpu_torch.data.features import feature_size
    from speecht_tpu_torch.models.wav2letter import Wav2LetterConfig

    n = MAIN_BATCH * MAIN_STEPS
    t0 = time.perf_counter()
    data_dir = write_corpus(work, n, feature_size("power"))
    weights = write_weights(work, Wav2LetterConfig())
    print(f"main path: wrote {n} utterances and full-width weights in "
          f"{time.perf_counter() - t0:.1f} s")
    argv = [
        "evaluate", "--test", "--no-save",
        "--data-dir", data_dir,
        "--train-dir", os.path.join(work, "train"),
        "--log-dir", os.path.join(work, "log"),
        "--reference-weights", weights,
        "--batch-size", str(MAIN_BATCH),
    ]
    # warm-up run (CUDA context, cuDNN plans, first allocations)
    run_cli(argv + ["--step-count", "1"])

    with batch_marks() as marks:
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats, out = run_cli(argv + ["--step-count", str(MAIN_STEPS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}

    lines = out.splitlines()
    losses = [float(ln.split()[3]) for ln in lines if ln.startswith("validation average loss")]
    n_expected = sum(ln.startswith("expected: ") for ln in lines)
    print("main path: " + " | ".join(lines[lines.index("Begin evaluation") + 1:][:3]))
    print("main path: " + " | ".join(lines[lines.index("Global statistics"):]))
    print(f"main path: losses {losses}")
    check(stats.decodings_counter == n and n_expected == n,
          f"evaluate tracked {stats.decodings_counter} of {n} utterances")
    check(len(losses) == MAIN_STEPS and all(math.isfinite(x) and 0 < x < 1e29 for x in losses),
          f"evaluate losses not well formed: {losses}")
    check(0 <= stats.global_letter_error_rate < 100, "LER not well formed")
    check("precise: LER" in out, "no precise statistics line")
    check(launches["ctc_alpha"] > 0, "ctc_alpha was not launched by evaluate")
    # inference_mode: no gradient, so no alpha history and no backward
    check(launches["ctc_beta"] == 0, "evaluate launched the backward kernel")
    check(launches["conv0"] == 0, "evaluate launched conv0 without SPEECHT_PALLAS_CONV0")
    print(f"main path: kernel launches {launches}")
    steady_ms = batch_period_ms(marks)
    print(
        f"main path: evaluate B={MAIN_BATCH} x {MAIN_STEPS} batches (T=1024 "
        f"frame bucket), whole run with set-up: {wall / MAIN_STEPS * 1e3!r} "
        f"ms/batch, {n / wall!r} utt/s; steady state: {steady_ms!r} ms/batch, "
        f"{MAIN_BATCH / steady_ms * 1e3!r} utt/s; on {card}"
    )
    return launches, data_dir, weights, steady_ms


def read_npz_both_ways(data_dir):
    """The 64 files of one batch read alone through the native reader and
    through ``np.load``, in turns (native, np.load, np.load, native)."""
    from speecht_tpu_torch import native
    from speecht_tpu_torch.data.reader import SpeechCorpusReader

    directory = SpeechCorpusReader(data_dir)._get_directory("power", "test")
    files = sorted(os.listdir(directory))[:MAIN_BATCH]
    paths = [os.path.join(directory, f) for f in files]

    def with_np_load():
        for p in paths:
            with np.load(p) as data:
                data["audio_fragments"], data["transcript"]

    def with_native():
        for p in paths:
            native.npz_load_sample(p)

    times = {"native": [], "np.load": []}
    for name, fn in (("native", with_native), ("np.load", with_np_load),
                     ("np.load", with_np_load), ("native", with_native)):
        t0 = time.perf_counter()
        fn()
        times[name].append((time.perf_counter() - t0) * 1e3)
    feats, transcript = native.npz_load_sample(paths[0])
    with np.load(paths[0]) as data:
        check(np.array_equal(feats, data["audio_fragments"])
              and np.array_equal(transcript, data["transcript"]),
              "the native npz reader and np.load disagree")
    print(f"npz read of {len(paths)} files alone (host clock, in turns): native reader "
          f"{times['native']!r} ms, np.load {times['np.load']!r} ms")


def breakdown(data_dir, weights, steady_ms, card):
    """Where one batch's time goes: each host stage of the main path timed
    alone on the host clock, the eval step (forward, CTC, decode) on the
    card by CUDA events, beside the steady-state batch period."""
    from speecht_tpu_torch.data.features import feature_size
    from speecht_tpu_torch.data.pipeline import build_batch, to_device
    from speecht_tpu_torch.data.reader import SpeechCorpusReader
    from speecht_tpu_torch.evaluation import Evaluation
    from speecht_tpu_torch.execution import build_model
    from speecht_tpu_torch.metrics import EvalStatistics
    from speecht_tpu_torch.train.step import make_eval_step
    from speecht_tpu_torch.weights import load_weight_dir

    model = build_model(feature_size("power"), types.SimpleNamespace())
    model.load_state_dict(load_weight_dir(weights, model))
    step = make_eval_step(model.cuda().eval())
    stages = {}
    t0 = time.perf_counter()
    samples = list(
        SpeechCorpusReader(data_dir).load_samples(
            "test", feature_type="power", seed=0, limit_count=MAIN_BATCH
        )
    )
    t1 = time.perf_counter()
    batch = build_batch(samples)
    t2 = time.perf_counter()
    dev = to_device(batch, torch.device("cuda"))
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    stages["read npz (host, native reader)"] = (t1 - t0) * 1e3
    stages["build_batch (host)"] = (t2 - t1) * 1e3
    read_npz_both_ways(data_dir)
    stages["bf16 cast + pin + H2D"] = (t3 - t2) * 1e3
    stages["eval step (device)"] = time_ms(lambda: step(dev), iters=10)
    _loss, decoded, lengths = step(dev)
    decoded, lengths = decoded.cpu().numpy(), lengths.cpu().numpy()
    t4 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        Evaluation._track_batch(
            EvalStatistics(), batch, decoded, lengths, verbose=True
        )
    stages["metrics + prints (host)"] = (time.perf_counter() - t4) * 1e3
    print(
        f"breakdown B={MAIN_BATCH} T={batch.features.shape[1]}: "
        + ", ".join(f"{k} {v!r} ms" for k, v in stages.items())
        + f"; steady-state batch period {steady_ms!r} ms, device busy "
        f"{stages['eval step (device)'] / steady_ms * 100:.1f}% of it; on {card}"
    )


# -- phase 3b: the train path ---------------------------------------------


def write_port_checkpoint(train_dir, weights):
    """The phase-3 weights as the port's checkpoint at step 0 (fresh Adam
    moments, lr 1e-4), so train starts from them."""
    from speecht_tpu_torch.data.features import feature_size
    from speecht_tpu_torch.execution import build_model
    from speecht_tpu_torch.train.checkpoint import CheckpointManager
    from speecht_tpu_torch.train.state import create_train_state, make_optimizer
    from speecht_tpu_torch.weights import load_weight_dir

    model = build_model(feature_size("power"), types.SimpleNamespace())
    model.load_state_dict(load_weight_dir(weights, model))
    state = create_train_state(dict(model.named_parameters()), make_optimizer(), 1e-4)
    CheckpointManager(train_dir).save(state, step=0)


def train_path(work, data_dir, weights, kernels, card):
    from speecht_tpu_torch.data.features import feature_size
    from speecht_tpu_torch.evaluation import Evaluation
    from speecht_tpu_torch.train.checkpoint import CheckpointManager

    t0 = time.perf_counter()
    write_corpus(work, TRAIN_UTTERANCES, feature_size("power"), seed=1, split="train")
    run_dir = os.path.join(work, "train", "smoke")
    write_port_checkpoint(run_dir, weights)
    print(f"train path: wrote {TRAIN_UTTERANCES} utterances and a step-0 "
          f"checkpoint of the phase-3 weights in {time.perf_counter() - t0:.1f} s")
    common = [
        "--data-dir", data_dir,
        "--train-dir", os.path.join(work, "train"),
        "--log-dir", os.path.join(work, "log"),
        "--run-name", "smoke",
        "--batch-size", str(MAIN_BATCH),
    ]

    with step_marks() as marks:
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _state, out = run_cli(["train", "--max-steps", str(TRAIN_STEPS),
                               "--steps-per-checkpoint", str(TRAIN_INTERVAL),
                               *common])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}

    lines = out.splitlines()
    step_lines = [ln for ln in lines if ln.startswith("global step")]
    print("train path: " + " | ".join(
        ln for ln in lines if ln.startswith(("Restored", "global step", "Done"))
    ))
    losses = [float(ln.split()[10]) for ln in step_lines]
    check("Restored model at step 0" in lines, "train did not start from the checkpoint")
    check(len(losses) == TRAIN_STEPS // TRAIN_INTERVAL
          and all(math.isfinite(x) and 0 < x < 1e29 for x in losses),
          f"train losses not well formed: {losses}")
    check(lines[-1] == "Done training -- step limit reached", "train did not finish")
    mgr = CheckpointManager(run_dir)
    check(mgr.latest_step() == TRAIN_STEPS, f"no checkpoint at step {TRAIN_STEPS}")
    for name in ("ctc_alpha", "ctc_beta"):
        check(launches[name] > 0, f"kernel {name} was not launched on the train path")
    check(launches["conv0"] == 0, "train launched conv0 without SPEECHT_PALLAS_CONV0")
    print(f"train path: kernel launches {launches}; losses {losses}; "
          f"checkpoints {mgr.all_steps()}")
    steady_ms = step_period_ms(marks)
    print(f"train path: B={MAIN_BATCH} x {TRAIN_STEPS} steps, whole run with "
          f"set-up {wall / TRAIN_STEPS * 1e3!r} ms/step; steady state (step "
          f"calls 2-{len(marks)}) {steady_ms!r} ms/step; on {card}")

    # evaluate restores the port's own checkpoint (no --reference-weights)
    argv = ["evaluate", "--test", "--no-save", "--step-count", "1", *common]
    stats, out = run_cli(argv)
    losses = [float(ln.split()[3]) for ln in out.splitlines()
              if ln.startswith("validation average loss")]
    check(len(losses) == 1 and math.isfinite(losses[0]) and 0 < losses[0] < 1e29,
          f"evaluate after train: losses {losses}")
    ev = Evaluation(parsed_flags(argv))
    restored_step = ev.load_weights()
    check(restored_step == TRAIN_STEPS, f"evaluate restored step {restored_step}")
    print(f"train path: evaluate restored the step-{restored_step} checkpoint, "
          f"loss {losses[0]!r}, LER {stats.global_letter_error_rate!r}")
    return launches, steady_ms


def parsed_flags(argv):
    from speecht_tpu_torch.cli import CLI

    return CLI(argv).parsed


def train_step_breakdown(model, tx, state, batch, step_ms, card):
    """Where one train step's device time goes: its stages timed apart by
    CUDA events (the step's own functions, called in its order), then
    the kernels by device time from torch.profiler."""
    from speecht_tpu_torch.train import step as tstep

    params = state.params
    stages = {"forward (bf16 convs)": 0.0, "CTC loss (alpha, with history)": 0.0,
              "backward (CTC beta + conv grads)": 0.0,
              "clip + Adam + update": 0.0}
    n = 3
    for i in range(n + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        logits = model(batch.features)
        ev[1].record()
        with torch.enable_grad():
            losses = ctc_loss_masked(logits, batch)
        ev[2].record()
        grads = dict(zip(params, torch.autograd.grad(losses, list(params.values()))))
        ev[3].record()
        state, _norm = tstep._apply_grads(state, grads, tx)
        ev[4].record()
        torch.cuda.synchronize()
        if i:  # the first round warms up
            for k, name in enumerate(stages):
                stages[name] += ev[k].elapsed_time(ev[k + 1]) / n
    print(f"train step breakdown B={MAIN_BATCH} (CUDA events, mean of {n}): "
          + ", ".join(f"{k} {v!r} ms" for k, v in stages.items())
          + f"; sum {sum(stages.values())!r} ms vs the step {step_ms!r} ms; on {card}")

    # each layer's backward alone: its input, weight and bias gradients
    # (no input gradient for conv_0: the features need none)
    x = batch.features.transpose(1, 2)
    per_layer = []
    for i, name in enumerate(model.layer_names):
        layer = getattr(model, name)
        x_in = x.detach().requires_grad_(i > 0)
        with torch.enable_grad():
            y = layer(x_in, model.compute_dtype)
        dy = torch.randn_like(y)
        wrt = ([x_in] if i > 0 else []) + [layer.weight, layer.bias]
        ms_i = time_ms(
            lambda: torch.autograd.grad(y, wrt, dy, retain_graph=True), iters=3
        )
        per_layer.append(f"{name} (w{layer.width}, {layer.weight.shape[1]}->"
                         f"{layer.weight.shape[0]}) {ms_i:.3f}")
        x = y.detach()
    print("train step backward by layer (ms, CUDA events): " + ", ".join(per_layer))

    step = tstep.make_train_step(model, tx)
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(2):
            state, _m = step(state, batch)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t > 0:
            rows.append((t / 2 / 1e3, e.count // 2, e.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    print(f"train step profile: device time {total!r} ms per step over "
          f"{len(rows)} kernels/ops (torch.profiler, 2 steps); top 12:")
    for t, count, key in rows[:12]:
        print(f"  {t:9.3f} ms  x{count:<4d} {key[:110]}")


def ctc_loss_masked(logits, batch):
    """The train loss from logits: the loss function's CTC and masking."""
    from speecht_tpu_torch.models.wav2letter import output_length
    from speecht_tpu_torch.ops import ctc_cuda

    losses = ctc_cuda.ctc_loss(
        logits, output_length(batch.seq_lengths), batch.labels, batch.label_lengths
    )
    real = (batch.seq_lengths > 0) & (losses < 1e29)
    return torch.where(real, losses, 0.0).sum() / real.sum().clamp(min=1)


def train_step_device(data_dir, weights, card):
    """One train step on a resident batch by CUDA events and its share of
    the dense bf16 peak."""
    from speecht_tpu_torch.data.features import feature_size
    from speecht_tpu_torch.data.pipeline import build_batch, to_device
    from speecht_tpu_torch.data.reader import SpeechCorpusReader
    from speecht_tpu_torch.execution import build_model
    from speecht_tpu_torch.train import step as tstep
    from speecht_tpu_torch.train.state import create_train_state, make_optimizer
    from speecht_tpu_torch.weights import load_weight_dir

    model = build_model(feature_size("power"), types.SimpleNamespace())
    model.load_state_dict(load_weight_dir(weights, model))
    model.cuda().train()
    tx = make_optimizer()
    state = create_train_state(dict(model.named_parameters()), tx, 1e-4)
    samples = SpeechCorpusReader(data_dir).load_samples(
        "train", feature_type="power", seed=0, limit_count=MAIN_BATCH
    )
    batch = to_device(build_batch(list(samples)), torch.device("cuda"))
    step = tstep.make_train_step_acc(model, tx)
    acc = tstep.init_metrics_acc(torch.device("cuda"))
    box = [state, acc]

    def one():
        box[0], box[1] = step(box[0], box[1], batch)

    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(one, iters=5, warmup=2)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    train_step_breakdown(model, tx, box[0], batch, ms, card)
    # the port leaves cuDNN's algorithm choice at its default; how much a
    # benchmarked choice would change the step (measured, not used)
    torch.backends.cudnn.benchmark = True
    try:
        bench_ms = time_ms(one, iters=5, warmup=2)
    finally:
        torch.backends.cudnn.benchmark = False
    print(f"train step (device) with torch.backends.cudnn.benchmark = True: "
          f"{bench_ms!r} ms (default: {ms!r} ms); on {card}")

    # a report, not a check: cuDNN's default algorithms need not be
    # deterministic, while the CTC kernels are
    def step_from_start():
        model.load_state_dict(load_weight_dir(weights, model))
        fresh = create_train_state(dict(model.named_parameters()), tx, 1e-4)
        fresh, _ = step(fresh, tstep.init_metrics_acc(torch.device("cuda")), batch)
        return {k: v.detach().clone() for k, v in fresh.params.items()}

    for deterministic in (False, True):
        torch.backends.cudnn.deterministic = deterministic
        try:
            first, second = step_from_start(), step_from_start()
        finally:
            torch.backends.cudnn.deterministic = False
        differ = [k for k in first if not torch.equal(first[k], second[k])]
        worst = max((float((first[k] - second[k]).abs().max()) for k in differ),
                    default=0.0)
        print(f"train step (device), torch.backends.cudnn.deterministic = "
              f"{deterministic}: two steps from the same state leave bit-equal "
              f"parameters: {not differ} ({len(differ)} of {len(first)} tensors "
              f"differ, max abs diff {worst!r}: {differ[:6]})")
    flop = 3 * FORWARD_FLOP_PER_UTT * MAIN_BATCH
    share = flop / (ms * 1e-3) / PEAK_BF16_OPS_PER_S
    print(
        f"train step (device) B={MAIN_BATCH} T={batch.features.shape[1]} bf16: "
        f"{ms!r} ms by CUDA events, {flop / 1e12:.2f} TFLOP (computed: 3 x 25.3 "
        f"GFLOP per utterance) = {share * 100:.2f}% of 989 TFLOP/s dense bf16; "
        f"peak memory {peak_gb:.2f} GB; on {card}"
    )


# -- phase 3c: the conv0 path ------------------------------------------------


def event_payloads(path):
    """The payloads of a TFRecord event file (length, crc, data, crc)."""
    with open(path, "rb") as f:
        data = f.read()
    out, at = [], 0
    while at < len(data):
        (n,) = struct.unpack("<Q", data[at: at + 8])
        out.append(data[at + 12: at + 12 + n])
        at += 16 + n
    return out


def conv0_path(work, data_dir, weights, kernels, card, default_eval_ms,
               default_train_ms):
    """``train --spec-augment --verbose-summaries --profile-steps 2:4`` and
    then ``evaluate`` restoring its step-8 checkpoint, both with
    SPEECHT_PALLAS_CONV0=1 set for this phase only; the launch counts set
    to 0 just before each command and read just after."""
    from speecht_tpu_torch.evaluation import Evaluation
    from speecht_tpu_torch.ops import conv0

    run_dir = os.path.join(work, "train", "conv0")
    write_port_checkpoint(run_dir, weights)
    log_dir = os.path.join(work, "log")
    common = [
        "--data-dir", data_dir,
        "--train-dir", os.path.join(work, "train"),
        "--log-dir", log_dir,
        "--run-name", "conv0",
        "--batch-size", str(MAIN_BATCH),
    ]
    eval_argv = ["evaluate", "--test", "--no-save", "--step-count", str(MAIN_STEPS),
                 *common]
    os.environ[conv0.ENV_VAR] = "1"
    try:
        with step_marks() as marks:
            for k in kernels:
                k.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _state, out = run_cli([
                "train", "--spec-augment", "--verbose-summaries",
                "--profile-steps", "2:4", "--max-steps", str(TRAIN_STEPS),
                "--steps-per-checkpoint", str(TRAIN_INTERVAL), *common,
            ])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        train_launches = {k.name: k.launches for k in kernels}
        with batch_marks() as bmarks:
            for k in kernels:
                k.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats, eout = run_cli(eval_argv)
            torch.cuda.synchronize()
            ewall = time.perf_counter() - t0
        eval_launches = {k.name: k.launches for k in kernels}
    finally:
        os.environ.pop(conv0.ENV_VAR, None)

    lines = out.splitlines()
    print("conv0 path: " + " | ".join(ln for ln in lines if ln.startswith(
        ("Restored", "SpecAugment", "global step", "Profiler", "Done"))))
    losses = [float(ln.split()[10]) for ln in lines if ln.startswith("global step")]
    check(any(ln.startswith("SpecAugment on:") for ln in lines), "no SpecAugment line")
    check(len(losses) == TRAIN_STEPS // TRAIN_INTERVAL
          and all(math.isfinite(x) and 0 < x < 1e29 for x in losses),
          f"conv0 path: train losses not well formed: {losses}")
    check(lines[-1] == "Done training -- step limit reached", "conv0 path: train did not finish")
    summaries = TRAIN_STEPS // TRAIN_INTERVAL  # activation-summary forwards
    check(train_launches["conv0"] == TRAIN_STEPS + summaries,
          f"conv0 path: {train_launches['conv0']} conv0 launches in train, not "
          f"{TRAIN_STEPS} steps + {summaries} summary forwards")
    for name in ("ctc_alpha", "ctc_beta"):
        check(train_launches[name] > 0, f"conv0 path: {name} did not run in train")

    (events,) = os.listdir(os.path.join(log_dir, "conv0_train"))
    payloads = event_payloads(os.path.join(log_dir, "conv0_train", events))
    n_images = sum(b"\x89PNG" in p for p in payloads)
    n_acts = sum(b"activations/conv_0" in p for p in payloads)
    check(n_images > 0 and n_acts > 0,
          f"conv0 path: event file has {n_images} image and {n_acts} activation records")
    trace = os.path.join(log_dir, "profile", "conv0_steps_2-4.pt.trace.json")
    check(f"Profiler trace written to {log_dir}/profile" in lines and os.path.exists(trace),
          "conv0 path: no profiler trace")
    with open(trace) as f:
        trace_events = json.load(f)["traceEvents"]
    kernel_events = [e for e in trace_events if e.get("cat") == "kernel"]
    # the wrapper's two launches: the weight rearrangement, then the conv
    conv0_us = {
        part: [e["dur"] for e in kernel_events if part in e.get("name", "")]
        for part in ("conv0_phase_weights_kernel", "conv0_bf16_kernel")
    }
    print(f"conv0 path: event file {len(payloads)} records, {n_images} with images, "
          f"{n_acts} with activations/conv_0; profiler trace "
          f"{os.path.getsize(trace)} bytes, {len(kernel_events)} device kernel "
          f"events over 2 steps; device us per launch: {conv0_us}")

    elosses = [float(ln.split()[3]) for ln in eout.splitlines()
               if ln.startswith("validation average loss")]
    check(len(elosses) == MAIN_STEPS and all(math.isfinite(x) and 0 < x < 1e29 for x in elosses),
          f"conv0 path: evaluate losses {elosses}")
    restored = Evaluation(parsed_flags(eval_argv)).load_weights()
    check(restored == TRAIN_STEPS, f"conv0 path: evaluate restored step {restored}")
    check(eval_launches["conv0"] == MAIN_STEPS,
          f"conv0 path: {eval_launches['conv0']} conv0 launches in evaluate, "
          f"not {MAIN_STEPS}")
    check(eval_launches["ctc_alpha"] > 0, "conv0 path: ctc_alpha did not run in evaluate")
    print(f"conv0 path: launches train {train_launches}, evaluate {eval_launches}; "
          f"train losses {losses}; evaluate restored step {restored}, losses "
          f"{elosses}, LER {stats.global_letter_error_rate!r}")
    print(f"conv0 path: train (with SpecAugment, summaries, profiler 2:4) whole run "
          f"{wall / TRAIN_STEPS * 1e3!r} ms/step, steady state {step_period_ms(marks)!r} "
          f"ms/step (default path, phase 3b: {default_train_ms!r}); evaluate whole run "
          f"{ewall / MAIN_STEPS * 1e3!r} ms/batch, steady state "
          f"{batch_period_ms(bmarks)!r} ms/batch (default path, phase 3: "
          f"{default_eval_ms!r}); on {card}")
    return train_launches, eval_launches


def conv0_device_steps(data_dir, weights, card):
    """The train and eval steps, and the model's conv_0 layer forward alone
    (no grad), on one resident batch by CUDA events, the default path and
    the conv0 path in turns (default, conv0, conv0, default)."""
    from speecht_tpu_torch.data.features import feature_size
    from speecht_tpu_torch.data.pipeline import build_batch, to_device
    from speecht_tpu_torch.data.reader import SpeechCorpusReader
    from speecht_tpu_torch.execution import build_model
    from speecht_tpu_torch.ops import conv0
    from speecht_tpu_torch.train import step as tstep
    from speecht_tpu_torch.train.state import create_train_state, make_optimizer
    from speecht_tpu_torch.weights import load_weight_dir

    model = build_model(feature_size("power"), types.SimpleNamespace())
    model.load_state_dict(load_weight_dir(weights, model))
    model.cuda()
    tx = make_optimizer()
    box = [create_train_state(dict(model.named_parameters()), tx, 1e-4),
           tstep.init_metrics_acc(torch.device("cuda"))]
    samples = SpeechCorpusReader(data_dir).load_samples(
        "train", feature_type="power", seed=0, limit_count=MAIN_BATCH
    )
    batch = to_device(build_batch(list(samples)), torch.device("cuda"))
    train_step = tstep.make_train_step_acc(model, tx)
    eval_step = tstep.make_eval_step(model)

    def one():
        box[0], box[1] = train_step(box[0], box[1], batch)

    def layer0():
        with torch.no_grad():
            model.conv_0(batch.features.transpose(1, 2), model.compute_dtype)

    times = {"default": [], "conv0": []}
    try:
        for path in ("default", "conv0", "conv0", "default"):
            if path == "conv0":
                os.environ[conv0.ENV_VAR] = "1"
            else:
                os.environ.pop(conv0.ENV_VAR, None)
            model.train()
            t = time_ms(one, iters=5, warmup=1)
            model.eval()
            e = time_ms(lambda: eval_step(batch), iters=20)
            c = time_ms(layer0, iters=20)
            times[path].append((t, e, c))
    finally:
        os.environ.pop(conv0.ENV_VAR, None)
    print("device step times B=64 T=%d bf16 (CUDA events; train ms, eval ms, conv_0 "
          "layer forward ms; in turns default, conv0, conv0, default): default %r, "
          "conv0 %r; on %s"
          % (batch.features.shape[1], times["default"], times["conv0"], card))
    for i, label in enumerate(("train step", "eval step", "conv_0 layer forward")):
        default = [t[i] for t in times["default"]]
        kernel = [t[i] for t in times["conv0"]]
        faster = max(kernel) < min(default)
        print(f"{label}: the conv0 path is "
              + ("faster than" if faster else "not faster than (ranges overlap or it is slower)")
              + f" the default path: conv0 {min(kernel)!r}-{max(kernel)!r} ms, default "
              f"{min(default)!r}-{max(default)!r} ms")
    return times


# -- phases 3d and 3e: the LM-fused host beam ----------------------------------

# the synthetic LM: order 3, a few thousand words and about 10^5 n-grams,
# so the beam's lookups do not all hit the same few cache lines
LM_WORDS, LM_BIGRAMS, LM_TRIGRAMS = 4000, 48000, 48000
LM_LETTERS = np.array(list("abcdefghijklmnopqrstuvwxyz"))
# share of the logit frames the blank collapse keeps, as a trained
# model's emissions keep them: the calibration aims at the middle
LM_KEEP_RANGE, LM_KEEP_AIM = (0.10, 0.40), (0.20, 0.30)
# the LM weights' logits, spread from frame to frame (standard deviation
# per class), as a trained model's peaky emissions spread
LM_LOGIT_STD = 3.0
LM_STEPS = 4
SEARCH_GENERATIONS = 4
# phase 4d: the collapsed log-probs, card vs CPU in float32, each entry to
# 1e-4 of itself plus 1e-4: 11 conv layers summed in another order leave
# an error relative to the logits, and log-probs of unlikely classes
# reach -50 on these weights
BEAM_LOGP_RTOL, BEAM_LOGP_ATOL = 1e-4, 1e-4
# phase 3j: two ranks against one process on the same rows, bf16 compute
# (the default) on both sides: the convs sum another split of the batch
# (DP), of the wide layers' channels (TP: bf16 partial sums reduced in
# float32) or of time (SP: VALID convs on halo'd slabs), a few bf16
# roundings (2^-8 relative each) apart. A step's loss averages 64 rows:
# 5e-3 relative. After 4 steps the parameters' movement from the start
# (Adam with eps 1e-3 moves each by about lr g / (|g| + 1e-3), so a small
# gradient difference moves it a little) agrees to 5% of its norm.
# Decodes: phase 4's share of equal tokens, and each global edit-distance
# sum within the summed edit distance between the two decodes of a row.
PARALLEL_LOSS_RTOL = 5e-3
PARALLEL_UPDATE_RTOL = 5e-2
PARALLEL_MIN_TOKEN_SHARE = 0.99
PARALLEL_STEPS = 4
# SP's forward is another computation (VALID convs on halo'd slabs, so
# cuDNN picks other algorithms and bf16 rounds elsewhere): its logits on
# one batch must lie within 2% of the batch's largest |logit| of the dense
# forward's (a few bf16 spacings, 2^-8 relative, at the top of the range),
# and every frame whose argmax differs must be a near tie, its dense top-2
# margin within twice that largest difference; the share of equal tokens
# is reported, not checked (a flip early in a row shifts the rest of it)
PARALLEL_LOGIT_RTOL = 2e-2


def write_lm(root, seed=0):
    """A synthetic order-3 ARPA LM from a numpy seed and its vocabulary
    file (every other word, so the valid-word bonus tells words apart).
    Returns (directory, number of n-grams)."""
    rng = np.random.RandomState(seed)
    words = set()
    while len(words) < LM_WORDS:
        words.add("".join(rng.choice(LM_LETTERS, size=rng.randint(2, 8))))
    words = sorted(words)

    def tuples(count, width):
        ids = rng.randint(0, len(words), size=(2 * count, width))
        _, first = np.unique(ids, axis=0, return_index=True)
        return ids[np.sort(first)][:count]

    bi, tri = tuples(LM_BIGRAMS, 2), tuples(LM_TRIGRAMS, 3)
    lines = ["\\data\\", f"ngram 1={len(words) + 3}", f"ngram 2={len(bi)}",
             f"ngram 3={len(tri)}", "", "\\1-grams:",
             "-3.5\t<unk>", "-2.0\t<s>\t-0.4", "-2.1\t</s>"]
    lines += [f"{p:.4f}\t{w}\t{b:.4f}" for w, p, b in zip(
        words, -1.5 - 3 * rng.rand(len(words)), -0.1 - 0.4 * rng.rand(len(words)))]
    lines += ["", "\\2-grams:"]
    lines += [f"{p:.4f}\t{words[i]} {words[j]}\t{b:.4f}" for (i, j), p, b in zip(
        bi, -0.5 - 3 * rng.rand(len(bi)), -0.1 - 0.3 * rng.rand(len(bi)))]
    lines += ["", "\\3-grams:"]
    lines += [f"{p:.4f}\t{words[i]} {words[j]} {words[k]}" for (i, j, k), p in zip(
        tri, -0.3 - 3 * rng.rand(len(tri)))]
    lines += ["", "\\end\\", ""]
    d = os.path.join(root, "lm")
    os.makedirs(d)
    with open(os.path.join(d, "model.arpa"), "w") as f:
        f.write("\n".join(lines))
    with open(os.path.join(d, "vocabulary"), "w") as f:
        f.write("\n".join(words[::2]) + "\n")
    return d, len(words) + 3 + len(bi) + len(tri)


def lm_model(weights, device, compute_dtype="bfloat16"):
    from speecht_tpu_torch.data.features import feature_size
    from speecht_tpu_torch.execution import build_model
    from speecht_tpu_torch.weights import load_weight_dir

    model = build_model(
        feature_size("power"), types.SimpleNamespace(compute_dtype=compute_dtype)
    )
    model.load_state_dict(load_weight_dir(weights, model))
    return model.to(device).eval()


def one_batch(data_dir, split="test", n=MAIN_BATCH):
    from speecht_tpu_torch.data.pipeline import build_batch
    from speecht_tpu_torch.data.reader import SpeechCorpusReader

    return build_batch(list(SpeechCorpusReader(data_dir).load_samples(
        split, feature_type="power", seed=0, limit_count=n
    )))


def kept_share(lengths, seq_lengths):
    from speecht_tpu_torch.models.wav2letter import output_length

    frames = output_length(torch.as_tensor(seq_lengths)).sum()
    return float(torch.as_tensor(lengths).sum() / frames)


def lm_weights_for(work, data_dir, weights, device=torch.device("cuda"),
                   keep_aim=LM_KEEP_AIM, keep_range=LM_KEEP_RANGE, name="lm_weights"):
    """The phase-3 weights made to emit like a trained CTC model, written
    as a new weight directory ``<work>/<name>``. The random weights'
    logits barely move from frame to frame (the biases dominate them: a
    per-frame spread of about 0.006, below bfloat16's spacing), so no
    blank bias alone makes the collapse keep a share of the frames. So
    conv_0's filters take a gain (as ``bench.py`` scales its input) that
    spreads the logits by about LM_LOGIT_STD, measured on one batch; then
    the last layer's blank bias is moved until the collapse at 0.999
    keeps a share within ``keep_aim`` (20-30% by default) of that batch's
    frames (bisection; the share falls as the bias rises). Returns (the
    directory, the share kept)."""
    from speecht_tpu_torch import vocabulary
    from speecht_tpu_torch.data.pipeline import to_device
    from speecht_tpu_torch.models.wav2letter import output_length
    from speecht_tpu_torch.ops.beam import BeamSearchDecoder, LanguageModelConfig

    batch = one_batch(data_dir)
    dev = to_device(batch, device)

    def logit_spread(model):
        with torch.inference_mode():
            logits = model(dev.features).float()
        frames = torch.arange(logits.shape[1], device=device)[None, :]
        valid = logits[frames < output_length(dev.seq_lengths)[:, None]]
        return float(valid.std(0).mean())

    spread = logit_spread(lm_model(weights, device))
    gain = np.float32(LM_LOGIT_STD / spread)
    out = os.path.join(work, name)
    shutil.copytree(weights, out)
    first = os.path.join(out, "convolution_layer_0", "filters:0.npy")
    np.save(first, np.load(first) * gain)

    model = lm_model(out, device)
    new_spread = logit_spread(model)
    bias = getattr(model, model.layer_names[-1]).bias
    base = float(bias[vocabulary.BLANK_ID].detach())
    decoder = BeamSearchDecoder(model, LanguageModelConfig(), num_threads=1)

    def share(raise_by):
        with torch.no_grad():
            bias[vocabulary.BLANK_ID] = base + raise_by
        _loss, _logp, lengths = decoder.device_part(dev)
        return kept_share(lengths.cpu(), batch.seq_lengths)

    lo, hi = -8.0, 8.0
    while share(lo) < keep_aim[1] and lo > -1e4:
        lo *= 2
    while share(hi) > keep_aim[0] and hi < 1e4:
        hi *= 2
    raise_by = (lo + hi) / 2
    kept = share(raise_by)
    for _ in range(24):
        if keep_aim[0] <= kept <= keep_aim[1]:
            break
        if kept > keep_aim[1]:
            lo = raise_by
        else:
            hi = raise_by
        raise_by = (lo + hi) / 2
        kept = share(raise_by)
    decoder.close()
    check(keep_range[0] <= kept <= keep_range[1],
          f"LM weights: the blank collapse keeps {kept!r} of the frames")
    last = os.path.join(
        out, f"convolution_layer_{len(model.layer_names) - 1}", "bias:0.npy"
    )
    values = np.load(last)
    values[vocabulary.BLANK_ID] += np.float32(raise_by)
    np.save(last, values)
    print(f"LM path ({name}): the logits spread {spread!r} from frame to frame; with "
          f"conv_0's filters times {float(gain)!r} they spread {new_spread!r}; "
          f"blank bias raised by {raise_by!r}: the collapse at 0.999 keeps "
          f"{kept!r} of one batch's frames (B={MAIN_BATCH})")
    return out, kept


@contextlib.contextmanager
def candidate_durations():
    """Host seconds of each candidate's scoring in ``search``."""
    from speecht_tpu_torch.parameter_search import LanguageModelParameterSearch

    durations = []
    score = LanguageModelParameterSearch._score_candidate

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return score(*args, **kwargs)
        finally:
            durations.append(time.perf_counter() - t0)

    LanguageModelParameterSearch._score_candidate = timed
    try:
        yield durations
    finally:
        LanguageModelParameterSearch._score_candidate = score


def lm_eval_path(work, data_dir, lm_weights, lm_dir, kernels, card, *extra,
                 steps=LM_STEPS, beam_launches=0):
    """``evaluate --language-model`` at full width, B=64, beam width 100,
    top-k 8, with the flags ``extra`` (``--device-beam`` ...); the launch
    counts set to 0 just before and read just after: ``ctc_alpha`` once a
    batch, ``beam_device`` ``beam_launches`` times, the others never.
    Returns (launches, steady-state ms a batch, the run's output)."""
    n = MAIN_BATCH * steps
    label = " ".join(["evaluate --language-model", *extra])
    argv = [
        "evaluate", "--test", "--no-save",
        "--data-dir", data_dir,
        "--train-dir", os.path.join(work, "train"),
        "--log-dir", os.path.join(work, "log"),
        "--reference-weights", lm_weights,
        "--batch-size", str(MAIN_BATCH),
        "--language-model", lm_dir,
        "--step-count", str(steps),
        *extra,
    ]
    with batch_marks() as marks:
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats, out = run_cli(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}

    lines = out.splitlines()
    losses = [float(ln.split()[3]) for ln in lines if ln.startswith("validation average loss")]
    n_expected = sum(ln.startswith("expected: ") for ln in lines)
    print(f"{label}: " + " | ".join(lines[lines.index("Begin evaluation") + 1:][:3]))
    print(f"{label}: " + " | ".join(lines[lines.index("Global statistics"):]))
    print(f"{label}: losses {losses}; kernel launches {launches}")
    check(stats.decodings_counter == n and n_expected == n,
          f"{label} tracked {stats.decodings_counter} of {n} utterances")
    check(len(losses) == steps and all(math.isfinite(x) and 0 < x < 1e29 for x in losses),
          f"{label} losses not well formed: {losses}")
    check(0 <= stats.global_letter_error_rate < 100, f"{label}: LER not well formed")
    check("precise: LER" in out, f"{label}: no precise statistics line")
    check(launches["ctc_alpha"] == steps,
          f"{label} launched ctc_alpha {launches['ctc_alpha']} times for {steps} batches")
    check(launches["beam_device"] == beam_launches,
          f"{label} launched beam_device {launches['beam_device']} times, not "
          f"{beam_launches}, for {steps} batches")
    check(launches["ctc_beta"] == 0, f"{label} launched the backward kernel")
    check(launches["conv0"] == 0, f"{label} launched conv0")
    steady_ms = batch_period_ms(marks) if steps > 2 else float("nan")
    print(
        f"{label}: B={MAIN_BATCH} x {steps} batches (T=1024 frame bucket, beam width "
        f"100, top-k 8), whole run with set-up (LM load included): "
        f"{wall / steps * 1e3!r} ms/batch, {n / wall!r} utt/s; steady state: "
        f"{steady_ms!r} ms/batch, {MAIN_BATCH / steady_ms * 1e3!r} utt/s; on {card}"
    )
    return launches, steady_ms, out


def lm_breakdown(data_dir, lm_weights, lm_dir, n_grams, steady_ms, card,
                 device=torch.device("cuda")):
    """Where one LM batch's time goes: the LM load, the device part
    (forward, CTC alpha, blank collapse; CUDA events), the readback of
    the collapsed log-probs and the host beam, each alone."""
    from speecht_tpu_torch.data.pipeline import to_device
    from speecht_tpu_torch.execution import finish_readback, start_readback
    from speecht_tpu_torch.ops.beam import BeamSearchDecoder, LanguageModelConfig

    model = lm_model(lm_weights, device)
    t0 = time.perf_counter()
    decoder = BeamSearchDecoder(model, LanguageModelConfig(language_model=lm_dir))
    load_ms = (time.perf_counter() - t0) * 1e3
    try:
        batch = one_batch(data_dir)
        dev = to_device(batch, device)
        device_ms = time_ms(lambda: decoder.device_part(dev), iters=10)
        out = decoder.device_part(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _loss, logp, lengths = finish_readback(*start_readback(out))
        readback_ms = (time.perf_counter() - t0) * 1e3
        beam_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            decoder.decode_emissions(logp, lengths)
            beam_ms.append((time.perf_counter() - t0) * 1e3)
        threads = decoder.num_threads
    finally:
        decoder.close()
    print(
        f"LM breakdown B={MAIN_BATCH} T={batch.features.shape[1]}: LM load "
        f"({n_grams} n-grams, ARPA) {load_ms!r} ms; device part (forward + CTC "
        f"alpha + blank collapse) {device_ms!r} ms; readback of the collapsed "
        f"log-probs ({logp.nbytes} bytes) {readback_ms!r} ms; host beam (width "
        f"100, top-k 8, {threads} threads, os.cpu_count() {os.cpu_count()}) "
        f"{beam_ms!r} ms (3 calls); frames kept {kept_share(lengths, batch.seq_lengths)!r}; "
        f"steady-state batch period {steady_ms!r} ms, device busy "
        f"{device_ms / steady_ms * 100:.1f}% of it; on {card}"
    )


def search_path(work, data_dir, lm_weights, lm_dir, kernels, card, *extra):
    """``search --generations 4 --step-count 1`` on a synthetic dev split
    (one batch of 64, written at the first call), from a port checkpoint
    of the LM weights, with the flags ``extra``. Returns (launches, ms per
    candidate)."""
    from speecht_tpu_torch.data.features import feature_size

    run_dir = os.path.join(work, "train", "lmsearch")
    if not os.path.exists(run_dir):
        write_corpus(work, MAIN_BATCH, feature_size("power"), seed=2, split="dev")
        write_port_checkpoint(run_dir, lm_weights)
    label = " ".join(["search", *extra])
    beam_launches = (SEARCH_GENERATIONS + 1) if "--device-beam" in extra else 0
    argv = [
        "search",
        "--data-dir", data_dir,
        "--train-dir", os.path.join(work, "train"),
        "--log-dir", os.path.join(work, "log"),
        "--run-name", "lmsearch",
        "--batch-size", str(MAIN_BATCH),
        "--language-model", lm_dir,
        "--generations", str(SEARCH_GENERATIONS),
        "--step-count", "1",
        *extra,
    ]
    with candidate_durations() as durations:
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        candidates, out = run_cli(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}

    lines = [ln for ln in out.splitlines() if ln.startswith("candidate-precise:")]
    for ln in lines:
        print(f"{label}: {ln}")
    scores = [c.score for c in candidates]
    check(len(lines) == SEARCH_GENERATIONS + 1 and len(durations) == len(lines),
          f"{label} scored {len(lines)} candidates")
    check(len(candidates) == SEARCH_GENERATIONS + 1 and scores == sorted(scores)
          and all(math.isfinite(s) for s in scores),
          f"{label} candidates not scored and sorted: {scores}")
    check(all(c.stats.decodings_counter == MAIN_BATCH for c in candidates),
          f"{label} did not decode the dev batch for every candidate")
    check(launches["ctc_alpha"] == 1,
          f"{label} launched ctc_alpha {launches['ctc_alpha']} times for 1 dev batch")
    check(launches["beam_device"] == beam_launches,
          f"{label} launched beam_device {launches['beam_device']} times for "
          f"{SEARCH_GENERATIONS + 1} candidates")
    check(launches["ctc_beta"] == 0 and launches["conv0"] == 0,
          f"{label} launched other kernels: {launches}")
    per_candidate = float(np.mean(durations)) * 1e3
    where = ("the beam kernel over the emissions left on the card" if beam_launches
             else "host beam over the cached emissions")
    print(f"{label}: kernel launches {launches}; B={MAIN_BATCH}, "
          f"{len(durations)} candidates: {per_candidate!r} ms per candidate ({where}; "
          f"each {[d * 1e3 for d in durations]!r}); whole run with set-up "
          f"{wall!r} s; on {card}")
    return launches, per_candidate


# -- phase 3g: the device beam through the entry points ------------------------


def device_beam_paths(work, data_dir, lm_weights, lm_dir, kernels, card, host_lm_ms,
                      host_search_ms, device=torch.device("cuda")):
    """``evaluate --language-model --device-beam`` (4 batches), with
    ``--rescore 8``, ``search --device-beam`` and ``--device-lm-hbm-gb``
    too small for the LM (the host beam, with JAX's message); each run's
    launch counts reset just before and read just after. Returns ({path:
    its launch counts}, ms a batch, the kernel's ms in one batch)."""
    from speecht_tpu_torch.data.pipeline import to_device
    from speecht_tpu_torch.ops.beam import BeamSearchDecoder, LanguageModelConfig

    runs = {}
    runs["evaluate --language-model --device-beam"], fused_ms, _out = lm_eval_path(
        work, data_dir, lm_weights, lm_dir, kernels, card, "--device-beam",
        beam_launches=LM_STEPS)
    runs["evaluate --language-model --device-beam --rescore 8"], rescore_ms, _out = (
        lm_eval_path(work, data_dir, lm_weights, lm_dir, kernels, card, "--device-beam",
                     "--rescore", "8", beam_launches=LM_STEPS))
    runs["search --device-beam"], search_ms = search_path(
        work, data_dir, lm_weights, lm_dir, kernels, card, "--device-beam")
    fallback, _ms, out = lm_eval_path(
        work, data_dir, lm_weights, lm_dir, kernels, card, "--device-beam",
        "--device-lm-hbm-gb", "0.000001", steps=1, beam_launches=0)
    check("falling back to the host beam" in out,
          "--device-lm-hbm-gb 0.000001 did not print the fall-back message")
    print("device beam: --device-lm-hbm-gb 0.000001: " + next(
        ln for ln in out.splitlines() if "falling back" in ln))
    runs["evaluate --device-beam --device-lm-hbm-gb 0.000001 (the host beam)"] = fallback

    # the kernel alone on one batch of the calibrated emissions
    decoder = BeamSearchDecoder(
        lm_model(lm_weights, device),
        LanguageModelConfig(language_model=lm_dir, device_beam=True),
    )
    try:
        batch = one_batch(data_dir)
        _loss, logp, lengths = decoder.device_part(to_device(batch, device))
        host_lengths = lengths.cpu().numpy()
        t_bucket = min(logp.shape[1], max(32, -(-int(host_lengths.max()) // 32) * 32))
        emissions = logp[:, :t_bucket].contiguous()
        print(f"device beam: the CLI's decoder's LM: {lm_tables(decoder._beam_fn.spec.lm)}")
        cfg = decoder.lm_config
        kernel_ms = time_ms(lambda: decoder._beam_fn(
            emissions, lengths, cfg.lm_weight, cfg.word_count_weight,
            cfg.valid_word_count_weight), iters=10)
    finally:
        decoder.close()
    print(f"device beam: evaluate --language-model --device-beam {fused_ms!r} ms/batch "
          f"({MAIN_BATCH / fused_ms * 1e3!r} utt/s) against the host beam's "
          f"{host_lm_ms!r} (phase 3d, this run); --rescore 8 {rescore_ms!r} ms/batch; "
          f"search --device-beam {search_ms!r} ms per candidate against "
          f"{host_search_ms!r} (phase 3e); the beam kernel on one batch "
          f"(B={MAIN_BATCH}, {int(host_lengths.min())}-{int(host_lengths.max())} kept "
          f"frames, T={t_bucket}) {kernel_ms!r} ms by CUDA events; on {card}")
    return runs, fused_ms, kernel_ms


# -- phase 3f: the audio front end ------------------------------------------
#
# A FLAC writer for the synthetic corpora of phase 3f and of the port's
# tests. It writes what the decoders in the repo read: a STREAMINFO block,
# then frames of VERBATIM or FIXED (order 0-4, rice-coded residual, any
# partition order, 4- or 5-bit parameters) subframes, mono or stereo
# (independent, left/side, right/side or mid/side), 16-bit samples, with
# the frame header's CRC-8 and the frame's CRC-16.


def _crc_table(poly: int, width: int) -> list[int]:
    top, mask = 1 << (width - 1), (1 << width) - 1
    table = []
    for i in range(256):
        c = i << (width - 8)
        for _ in range(8):
            c = ((c << 1) ^ poly) & mask if c & top else (c << 1) & mask
        table.append(c)
    return table


_CRC8, _CRC16 = _crc_table(0x07, 8), _crc_table(0x8005, 16)


def _crc(data: bytes, table: list[int], width: int) -> int:
    crc, mask = 0, (1 << width) - 1
    for b in data:
        crc = ((crc << 8) & mask) ^ table[(crc >> (width - 8)) ^ b]
    return crc


class _Bits:
    """MSB-first bit fields, packed with numpy."""

    def __init__(self):
        self.values, self.widths = [], []

    def add(self, values, width) -> None:
        values = np.atleast_1d(np.asarray(values, np.int64))
        width = np.broadcast_to(np.asarray(width, np.int64), values.shape)
        mask = np.where(width >= 63, -1, (np.int64(1) << np.minimum(width, 62)) - 1)
        self.values.append((values & mask).astype(np.uint64))
        self.widths.append(width)

    def tobytes(self) -> bytes:
        """The fields, zero-padded to a whole byte."""
        values, widths = np.concatenate(self.values), np.concatenate(self.widths)
        idx = np.repeat(np.arange(len(widths)), widths)
        start = np.cumsum(widths) - widths
        k = np.arange(int(widths.sum())) - np.repeat(start, widths)
        shift = (widths[idx] - 1 - k).astype(np.uint64)
        bits = ((values[idx] >> shift) & np.uint64(1)).astype(np.uint8)
        return np.packbits(bits).tobytes()


def _utf8_number(n: int) -> bytes:
    """A frame number in FLAC's extended UTF-8 code."""
    if n < 0x80:
        return bytes([n])
    extra = 1
    while n >= 1 << (5 * extra + 6):
        extra += 1
    out = [0x80 | ((n >> (6 * i)) & 0x3F) for i in range(extra)][::-1]
    first = ((0xFF << (7 - extra)) & 0xFF) | (n >> (6 * extra))
    return bytes([first] + out)


def _rice(bits: _Bits, residual: np.ndarray, order: int, block: int,
          partition_order: int, param_bits: int) -> None:
    """The residual section: coding method, partition order and, for each
    partition, its rice parameter and codes (unary quotient, then the low
    bits), the parameter chosen from the partition's mean."""
    u = np.where(residual >= 0, 2 * residual, -2 * residual - 1)
    bits.add(param_bits - 4, 2)
    bits.add(partition_order, 4)
    per = block >> partition_order
    escape = (1 << param_bits) - 1
    start = 0
    for p in range(1 << partition_order):
        part = u[start:start + per - (order if p == 0 else 0)]
        start += len(part)
        mean = float(part.mean()) if len(part) else 0.0
        k = int(min(escape - 1, max(0, math.floor(math.log2(mean + 1)))))
        bits.add(k, param_bits)
        if len(part):
            q = part >> k
            fields = np.stack([np.ones_like(q), part & ((1 << k) - 1)], 1).ravel()
            widths = np.stack([q + 1, np.full_like(q, k)], 1).ravel()
            bits.add(fields, widths)


def _subframe(bits: _Bits, x: np.ndarray, bps: int, subframe: str, order: int,
              partition_order: int, param_bits: int) -> None:
    block = len(x)
    if subframe == "verbatim" or block <= order:
        bits.add(1 << 1, 8)  # zero pad bit, type 000001, no wasted bits
        bits.add(x, bps)
        return
    bits.add((8 + order) << 1, 8)  # type 001xxx: FIXED of this order
    bits.add(x[:order], bps)
    po = partition_order
    while po and (block % (1 << po) or (block >> po) <= order):
        po -= 1
    _rice(bits, np.diff(x, order), order, block, po, param_bits)


def write_flac(path, pcm, sample_rate, subframe="fixed", order=2,
               block_size=4096, partition_order=0, param_bits=4,
               stereo="independent"):
    """Write 16-bit PCM (int16 ``[n]``, or ``[n, 2]`` for stereo) as FLAC.

    ``subframe`` is "fixed" (a FIXED predictor of ``order`` with a
    rice-coded residual in ``2 ** partition_order`` partitions and
    ``param_bits``-bit parameters) or "verbatim"; ``stereo`` is
    "independent", "left_side", "right_side" or "mid_side". Every decoder
    in the repo reads the file as mono float32 ``mean(channels) / 32768``.
    """
    pcm = np.asarray(pcm, np.int64)
    channels = 1 if pcm.ndim == 1 else pcm.shape[1]
    pcm = pcm.reshape(len(pcm), channels)
    n = len(pcm)
    info = _Bits()
    for value, width in ((block_size, 16), (block_size, 16), (0, 24), (0, 24),
                         (sample_rate, 20), (channels - 1, 3), (15, 5),
                         (n >> 32, 4), (n & 0xFFFFFFFF, 32), (0, 64), (0, 64)):
        info.add(value, width)
    out = [b"fLaC", bytes([0x80, 0, 0, 34]), info.tobytes()]
    code = {"independent": channels - 1, "left_side": 8, "right_side": 9,
            "mid_side": 10}[stereo if channels == 2 else "independent"]
    for number, first in enumerate(range(0, n, block_size)):
        block = pcm[first:first + block_size]
        left, right = block.T if channels == 2 else (block[:, 0], None)
        if channels == 1:
            subs = [(left, 16)]
        elif code == 1:
            subs = [(left, 16), (right, 16)]
        elif code == 8:
            subs = [(left, 16), (left - right, 17)]
        elif code == 9:
            subs = [(left - right, 17), (right, 16)]
        elif code == 10:
            subs = [((left + right) >> 1, 16), (left - right, 17)]
        head = _Bits()
        head.add(0x3FFE, 14)
        head.add(0, 2)  # reserved, fixed block size
        head.add(7, 4)  # block size - 1 in 16 bits after the frame number
        head.add(0, 4)  # sample rate from STREAMINFO
        head.add(code, 4)
        head.add(4, 3)  # 16 bits a sample
        head.add(0, 1)
        header = head.tobytes() + _utf8_number(number)
        header += (len(block) - 1).to_bytes(2, "big")
        header += bytes([_crc(header, _CRC8, 8)])
        body = _Bits()
        for x, bps in subs:
            _subframe(body, x, bps, subframe, order, partition_order, param_bits)
        frame = header + body.tobytes()
        out.append(frame + _crc(frame, _CRC16, 16).to_bytes(2, "big"))
    with open(path, "wb") as f:
        f.write(b"".join(out))


AUDIO_SR = 16000  # LibriSpeech's rate: the device resample 16000 -> 22050 runs
AUDIO_UTTERANCES = 64
# 4.4-7.4 s: 600-1024 frames at 22050 Hz, so every utterance falls in the
# 1024-frame bucket
AUDIO_SECONDS = (4.4, 7.4)
AUDIO_LETTERS = (60, 200)
AUDIO_LM_STEPS = 1


def synthetic_speech(rng, n, sample_rate=AUDIO_SR) -> np.ndarray:
    """``n`` int16 samples of voiced-speech-like audio from ``rng``: eight
    harmonics of a wandering pitch (100-250 Hz), a syllable-rate envelope
    (3-5 Hz) and a noise floor about 30 dB down."""
    t = np.arange(n) / sample_rate
    f0 = rng.uniform(100, 250) * (1 + 0.1 * np.sin(2 * np.pi * rng.uniform(0.5, 2) * t))
    phase = 2 * np.pi * np.cumsum(f0) / sample_rate
    voiced = sum(np.sin(k * phase) / k for k in range(1, 9))
    envelope = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(3, 5) * t + rng.uniform(0, 6.3)))
    x = 0.3 * envelope * voiced / np.abs(voiced).max() + 0.01 * rng.randn(n)
    return np.clip(np.rint(x * 32767), -32768, 32767).astype(np.int16)


def transcript_words(rng, letters):
    """A transcript of about ``letters`` characters: words of 2-9 letters."""
    words, size = [], 0
    while size < letters:
        words.append("".join(rng.choice(LM_LETTERS, size=rng.randint(2, 10))))
        size += len(words[-1]) + 1
    return " ".join(words).upper()


def write_flac_corpus(data_dir, split, n, seed=0, seconds=AUDIO_SECONDS,
                      letters=AUDIO_LETTERS, sample_rate=AUDIO_SR, **flac_options):
    """``n`` FLAC utterances of ``seconds`` at ``sample_rate`` under
    ``<data_dir>/<split>/<speaker>/<chapter>/`` with their ``*.trans.txt``
    (``letters`` letters each), LibriSpeech's layout; the corpus sets are
    marked as extracted, so ``preprocess`` downloads nothing."""
    from speecht_tpu_torch import corpus

    rng = np.random.RandomState(seed)
    chapter = os.path.join(data_dir, split, f"{seed + 19}", "198")
    os.makedirs(chapter, exist_ok=True)
    lines = []
    for i in range(n):
        uid = f"{seed + 19}-198-{i:04d}"
        samples = int(rng.uniform(*seconds) * sample_rate)
        write_flac(os.path.join(chapter, uid + ".flac"),
                   synthetic_speech(rng, samples, sample_rate), sample_rate,
                   **flac_options)
        lines.append(f"{uid} {transcript_words(rng, rng.randint(letters[0], letters[1] + 1))}")
    with open(os.path.join(chapter, f"{seed + 19}-198.trans.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    for set_type, set_name in corpus.DATA_SETS:
        os.makedirs(os.path.join(data_dir, set_type, set_name), exist_ok=True)


@contextlib.contextmanager
def npz_reads():
    """Counts the cache files read by the native reader."""
    from speecht_tpu_torch import native

    count = [0]
    read = native.npz_load_sample

    def counted(path):
        out = read(path)
        count[0] += 1
        return out

    native.npz_load_sample = counted
    try:
        yield count
    finally:
        native.npz_load_sample = read


def audio_path(work, weights, lm_weights, lm_dir, kernels, card):
    """Phase 3f: ``preprocess`` (host, then ``--device``), ``evaluate
    --from-audio`` (greedy and with the LM) and ``evaluate`` on the cache
    ``preprocess --device`` wrote, on a synthetic 16 kHz FLAC corpus."""
    t_phase = time.perf_counter()
    host_dir = os.path.join(work, "audio_host", "data")
    device_dir = os.path.join(work, "audio_device", "data")
    t0 = time.perf_counter()
    write_flac_corpus(host_dir, "test", AUDIO_UTTERANCES, seed=0)
    write_flac_corpus(host_dir, "dev", AUDIO_UTTERANCES, seed=1)
    shutil.copytree(host_dir, device_dir)
    print(f"audio path: wrote {2 * AUDIO_UTTERANCES} FLAC utterances "
          f"({AUDIO_SR} Hz, 16-bit mono, {AUDIO_SECONDS[0]}-{AUDIO_SECONDS[1]} s, "
          f"FIXED order 2, rice) in {time.perf_counter() - t0:.1f} s")

    common = ["--train-dir", os.path.join(work, "train"),
              "--log-dir", os.path.join(work, "log")]
    for label, data_dir, extra in (("host", host_dir, []),
                                   ("--device", device_dir, ["--device"])):
        argv = ["preprocess", "--test-only", "--data-dir", data_dir, *common, *extra]
        t0 = time.perf_counter()
        if extra:
            run_cli(argv)
        else:
            # its own process, as a user runs it: the spawned pool's workers
            # then import the package and numpy, not this script and torch
            proc = subprocess.run([sys.executable, "-m", "speecht_tpu_torch", *argv],
                                  timeout=600, capture_output=True, text=True)
            check(proc.returncode == 0, f"preprocess failed: {proc.stderr[-3000:]}")
        seconds = time.perf_counter() - t0
        written = os.listdir(os.path.join(data_dir, "preprocessed-power", "test"))
        check(len(written) == AUDIO_UTTERANCES,
              f"preprocess {label} wrote {len(written)} of {AUDIO_UTTERANCES} files")
        where = ("python -m speecht_tpu_torch, a pool of one spawned process a core"
                 if not extra else "in this process, the card already initialised")
        print(f"audio path: preprocess {label} ({where}; {os.cpu_count()} cores): "
              f"{AUDIO_UTTERANCES} files in {seconds!r} s, "
              f"{AUDIO_UTTERANCES / seconds!r} files/s; on {card}")

    def evaluate(label, data_dir, split, weights_dir, *extra, steps=1):
        argv = ["evaluate", f"--{split}", "--no-save", "--data-dir", data_dir, *common,
                "--reference-weights", weights_dir, "--batch-size", str(MAIN_BATCH),
                *extra]
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats, out = run_cli(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        lines = out.splitlines()
        losses = [float(ln.split()[3]) for ln in lines
                  if ln.startswith("validation average loss")]
        print(f"audio path: evaluate {label}: " + " | ".join(
            lines[lines.index("Global statistics"):]))
        check(stats.decodings_counter == AUDIO_UTTERANCES,
              f"evaluate {label} tracked {stats.decodings_counter} of {AUDIO_UTTERANCES}")
        check(len(losses) == steps and all(math.isfinite(x) and 0 < x < 1e29 for x in losses),
              f"evaluate {label}: losses not well formed: {losses}")
        check(0 <= stats.global_letter_error_rate < 100, f"evaluate {label}: LER not well formed")
        check(launches["ctc_alpha"] == steps,
              f"evaluate {label} launched ctc_alpha {launches['ctc_alpha']} times "
              f"for {steps} batches")
        check(launches["ctc_beta"] == 0 and launches["conv0"] == 0,
              f"evaluate {label} launched other kernels: {launches}")
        beam_launches = steps if "--device-beam" in extra else 0
        check(launches["beam_device"] == beam_launches,
              f"evaluate {label} launched beam_device {launches['beam_device']} times "
              f"for {steps} batches")
        print(f"audio path: evaluate {label} B={MAIN_BATCH} x {steps} batch: losses {losses}; "
              f"kernel launches {launches}; whole run with set-up {wall * 1e3 / steps!r} "
              f"ms/batch, {AUDIO_UTTERANCES / wall!r} utt/s; on {card}")
        return launches, out

    # warm-up (cuFFT plans, cuDNN plans at this bucket)
    run_cli(["evaluate", "--test", "--no-save", "--data-dir", host_dir, *common,
             "--reference-weights", weights, "--batch-size", str(MAIN_BATCH),
             "--from-audio"])
    greedy, out = evaluate("--from-audio", host_dir, "test", weights, "--from-audio")
    check("resampling to 22050 Hz on device" in out,
          "evaluate --from-audio did not take the device resample")
    lm, _out = evaluate("--from-audio --language-model", host_dir, "dev", lm_weights,
                        "--from-audio", "--language-model", lm_dir,
                        steps=AUDIO_LM_STEPS)
    # phase 3g's from-audio run: the same batch through the device beam
    beam, _out = evaluate("--from-audio --language-model --device-beam", host_dir, "dev",
                          lm_weights, "--from-audio", "--language-model", lm_dir,
                          "--device-beam", steps=AUDIO_LM_STEPS)
    with npz_reads() as reads:
        cached, _out = evaluate("on the --device cache", device_dir, "test", weights)
    # the input-size probe reads one file before the batch reads them all
    check(reads[0] == AUDIO_UTTERANCES + 1,
          f"evaluate read {reads[0]} cache files natively, not 1 + {AUDIO_UTTERANCES}")
    print(f"audio path: evaluate read the --device cache's {AUDIO_UTTERANCES} files "
          "(and the input-size probe's one) through the native npz reader")
    audio_breakdown(host_dir, weights, card)
    print(f"audio path: phase 3f wall time {time.perf_counter() - t_phase:.1f} s")
    return greedy, lm, beam, cached, host_dir, device_dir


def audio_samples(data_dir, split="test", n=MAIN_BATCH):
    """``n`` utterances of a FLAC split, decoded at their own rate."""
    from speecht_tpu_torch.data.reader import SpeechCorpusReader

    return list(SpeechCorpusReader(data_dir).load_raw_samples(
        split, limit_count=n, seed=0, sample_rate=AUDIO_SR))


def audio_bucket():
    """The evaluate loader's sample bucket at 16 kHz (1024-frame steps
    of 256 frames at 22050 Hz)."""
    from speecht_tpu_torch.native import DEFAULT_SR
    from speecht_tpu_torch.ops import resample as resample_mod

    return resample_mod.input_bucket(160 * 256, AUDIO_SR, DEFAULT_SR)


def audio_breakdown(data_dir, weights, card):
    """Where one from-audio batch's time goes: each host stage alone on the
    host clock, the front end and the eval step on the card by CUDA events."""
    from speecht_tpu_torch.data import features_device
    from speecht_tpu_torch.data.pipeline import build_audio_batch, to_device
    from speecht_tpu_torch.evaluation import Evaluation
    from speecht_tpu_torch.metrics import EvalStatistics
    from speecht_tpu_torch.train.step import make_audio_eval_step

    stages = {}
    t0 = time.perf_counter()
    samples = audio_samples(data_dir)
    t1 = time.perf_counter()
    batch = build_audio_batch(samples, audio_bucket())
    t2 = time.perf_counter()
    dev = to_device(batch, torch.device("cuda"))
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    stages[f"FLAC decode of {len(samples)} files at 16 kHz (host)"] = (t1 - t0) * 1e3
    stages["build_audio_batch (host)"] = (t2 - t1) * 1e3
    stages["int16 cast + pin + H2D"] = (t3 - t2) * 1e3
    front_end = features_device.make_front_end("power", wire_sr=AUDIO_SR)
    step = make_audio_eval_step(lm_model(weights, torch.device("cuda")), front_end)
    with torch.inference_mode():
        stages["front end on the card (resample + DSP)"] = time_ms(
            lambda: front_end(dev.audio, dev.num_samples), iters=10)
    stages["eval step on the card (front end + model + CTC + decode)"] = time_ms(
        lambda: step(dev), iters=10)
    _loss, decoded, lengths = step(dev)
    decoded, lengths = decoded.cpu().numpy(), lengths.cpu().numpy()
    t4 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        Evaluation._track_batch(EvalStatistics(), batch, decoded, lengths, verbose=True)
    stages["metrics + prints (host)"] = (time.perf_counter() - t4) * 1e3
    print(
        f"audio breakdown B={MAIN_BATCH} S={batch.audio.shape[1]} samples at "
        f"{AUDIO_SR} Hz: " + ", ".join(f"{k} {v!r} ms" for k, v in stages.items())
        + f"; on {card}"
    )


# -- phase 3h: export, the serving artifact ----------------------------------

# the exported program and the eager eval step run the same bf16 model on
# the same card; phase 4's share of equal tokens and phase 4d's tolerance
# (1e-4 of each value plus 1e-4) hold the program to the eager step
EXPORT_SECOND_SHAPE = (16, 768)  # a second batch size and frame count


def token_share(ids_a, lens_a, ids_b, lens_b):
    """Equal tokens over each row's longer decode, as phase 4 counts."""
    total = same = 0
    for i in range(ids_a.shape[0]):
        width = int(max(lens_a[i], lens_b[i]))
        total += width
        same += int((ids_a[i, :width] == ids_b[i, :width]).sum())
    return same / max(total, 1), same, total


def check_program(label, got, want_ids, want_lens, want_logits=None):
    """The loaded program's (ids, lengths, logits) against the eager
    step's: phase 4's token share, phase 4d's tolerance on the logits."""
    ids, lens, logits = (t.cpu().numpy() for t in got)
    share, same, total = token_share(ids, lens, want_ids, want_lens)
    err = None
    if want_logits is not None:
        err = float(np.abs(logits - want_logits).max())
        bad = np.abs(logits - want_logits) > BEAM_LOGP_ATOL + BEAM_LOGP_RTOL * np.abs(want_logits)
        check(not bad.any(), f"export {label}: logits off the eager step's by up to {err!r}")
    print(f"export {label}: decoded tokens equal {same}/{total} = {share!r} (at least "
          f"{PARITY_MIN_TOKEN_SHARE}); logits max abs diff {err!r} (tolerance "
          f"{BEAM_LOGP_ATOL} + {BEAM_LOGP_RTOL} x |value|)")
    check(share >= PARITY_MIN_TOKEN_SHARE, f"export {label}: decodes disagree")


def export_path(work, data_dir, weights, audio_dir, kernels, card):
    """Phase 3h: ``export --weights --stablehlo`` and ``--from-audio
    --wire-sr 16000`` through the CLI on a port checkpoint of the phase-3
    weights; the loaded cuda programs against the eager steps."""
    from speecht_tpu_torch import serving
    from speecht_tpu_torch.data import features_device
    from speecht_tpu_torch.data.pipeline import build_audio_batch, to_device
    from speecht_tpu_torch.train.step import make_audio_eval_step, make_eval_step
    from speecht_tpu_torch.weights import load_weight_dir

    train_dir = os.path.join(work, "export_train")
    write_port_checkpoint(os.path.join(train_dir, "exp"), weights)
    base = ["export", "--train-dir", train_dir, "--run-name", "exp", "--data-dir", data_dir,
            "--log-dir", os.path.join(work, "log"), "--export-platforms", "cuda,cpu"]
    artifact = os.path.join(work, "artifact")
    audio_artifact = os.path.join(work, "artifact_audio")
    weights_out = os.path.join(work, "exported_weights")
    seconds = {}
    for label, extra in (
            ("features", ["--weights", weights_out, "--stablehlo", artifact]),
            ("from audio", ["--stablehlo", audio_artifact, "--from-audio",
                            "--wire-sr", str(AUDIO_SR)])):
        t0 = time.perf_counter()
        _results, out = run_cli(base + extra)
        seconds[label] = time.perf_counter() - t0
        print(f"export {label}: " + " | ".join(out.strip().splitlines()))
    model = lm_model(weights, torch.device("cuda"))
    for name, value in load_weight_dir(weights_out, model).items():
        check(torch.equal(value, dict(model.named_parameters())[name].cpu()),
              f"export --weights: {name} is not the checkpoint's")

    program, manifest = serving.load_stablehlo(artifact, torch.device("cuda"))
    print(f"export features: artifact {manifest['bytes']} bytes, platforms "
          f"{manifest['platforms']}, export {seconds['features']!r} s (both platforms, "
          f"with --weights); conv_0: {manifest['conv0_path']}")
    eval_step = make_eval_step(model)
    batch = to_device(one_batch(data_dir), torch.device("cuda"), "float32")
    B2, T2 = EXPORT_SECOND_SHAPE
    small = types.SimpleNamespace(
        features=batch.features[:B2, :T2].contiguous(),
        seq_lengths=batch.seq_lengths[:B2].clamp(max=T2),
        labels=batch.labels[:B2, :T2 // 4].contiguous(),
        label_lengths=batch.label_lengths[:B2].clamp(max=T2 // 4))
    forward = serving.make_infer_fn(model)
    for k in kernels:
        k.launches = 0
    results = {}
    for label, b in (("B=64, T=1024", batch), (f"B={B2}, T={T2}", small)):
        results[label] = program(b.features, b.seq_lengths)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    check(not any(launches.values()), f"the exported program launched kernels: {launches}")
    for label, b in (("B=64, T=1024", batch), (f"B={B2}, T={T2}", small)):
        _loss, ids, lens = eval_step(b)
        logits = forward(b.features, b.seq_lengths)[2]
        check_program(f"features {label}", results[label], ids.cpu().numpy(),
                      lens.cpu().numpy(), logits.cpu().numpy())
    program_ms = time_ms(lambda: program(batch.features, batch.seq_lengths), 10)
    eager_ms = time_ms(lambda: eval_step(batch), 10)
    print(f"export features: the loaded program {program_ms!r} ms a batch (B=64, T=1024), "
          f"the eager eval step (with its CTC loss) {eager_ms!r} ms; on {card}")
    cpu_program, _ = serving.load_stablehlo(artifact, "cpu")
    cpu_out = cpu_program(batch.features[:1, :128].cpu(),
                          batch.seq_lengths[:1].cpu().clamp(max=128))
    check(cpu_out[0].shape == (1, 64) and cpu_out[0].device.type == "cpu",
          "the cpu program did not run on the CPU")

    audio_program, audio_manifest = serving.load_stablehlo(audio_artifact, torch.device("cuda"))
    print(f"export from audio: artifact {audio_manifest['bytes']} bytes, export "
          f"{seconds['from audio']!r} s (both platforms); granularity "
          f"{audio_manifest['audio_granularity_samples']} samples at {audio_manifest['wire_sr']} Hz")
    audio_batch = to_device(build_audio_batch(audio_samples(audio_dir), audio_bucket()),
                            torch.device("cuda"))
    for k in kernels:
        k.launches = 0
    got = audio_program(audio_batch.audio, audio_batch.num_samples)
    torch.cuda.synchronize()
    audio_launches = {k.name: k.launches for k in kernels}
    check(not any(audio_launches.values()),
          f"the from-audio program launched kernels: {audio_launches}")
    front_end = features_device.make_front_end("power", wire_sr=AUDIO_SR)
    _loss, ids, lens = make_audio_eval_step(model, front_end)(audio_batch)
    logits = serving.make_audio_infer_fn(model, "power", AUDIO_SR)(
        audio_batch.audio, audio_batch.num_samples)[2]
    check_program("from audio, phase 3f's 64 FLACs against evaluate --from-audio's step", got,
                  ids.cpu().numpy(), lens.cpu().numpy(), logits.cpu().numpy())
    audio_ms = time_ms(lambda: audio_program(audio_batch.audio, audio_batch.num_samples), 5)
    print(f"export from audio: the loaded program {audio_ms!r} ms a batch of 64 (16 kHz int16, "
          f"{audio_batch.audio.shape[1]} samples); on {card}")
    return {name: launches[name] + audio_launches[name] for name in launches}


# -- phase 3i: record ---------------------------------------------------------

RECORD_FILES = 4


@contextlib.contextmanager
def chunk_times():
    """Per streamed chunk: the host seconds from one read of the audio
    source to the next (the resample, the recognizer's features and window,
    the fused partial and the print) and the chunk's audio seconds."""
    from speecht_tpu_torch.record_utils import FileAudioSource

    times = []
    open_stream = FileAudioSource.open_input_stream

    @contextlib.contextmanager
    def timed_stream(self):
        with open_stream(self) as read_chunk:
            last = [None]

            def read():
                now = time.perf_counter()
                if last[0] is not None:
                    times[-1] = (now - last[0], times[-1][1])
                chunk = read_chunk()
                last[0] = time.perf_counter()
                times.append((None, len(chunk) / self.rate))
                return chunk

            yield read

    FileAudioSource.open_input_stream = timed_stream
    try:
        yield times
    finally:
        FileAudioSource.open_input_stream = open_stream
        # the last chunk's iteration ends in the source's end, not a read
        if times and times[-1][0] is None:
            times.pop()


def offline_transcripts(model, flacs, beam=None):
    """The one-shot composition by hand: the post chain, the resample to
    22050, the host features, a batch of one, the eval step (or the
    beam decoder); one transcript a file."""
    from speecht_tpu_torch import native, vocabulary
    from speecht_tpu_torch.data.pipeline import single_batch, to_device
    from speecht_tpu_torch.record_utils import FileAudioSource
    from speecht_tpu_torch.recording import host_features
    from speecht_tpu_torch.train.step import make_eval_step

    step = beam.eval_step if beam is not None else make_eval_step(model)
    source = FileAudioSource(flacs, rate=AUDIO_SR)
    out = []
    for _ in flacs:
        audio = native.resample(source.record()[0], AUDIO_SR, 22050)
        batch = to_device(single_batch(host_features(audio, "power", 22050)),
                          torch.device("cuda"), "float32")
        _loss, ids, lens = step(batch)
        ids, lens = (np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t) for t in (ids, lens))
        out.append(vocabulary.ids_to_sentence(ids[0, :lens[0]]))
    return out


def record_breakdown(model, flac, lm_dir, card):
    """Where one recording's time goes: the resample and the host features
    on the host clock, the eval step on the card (H2D included, then a
    synchronise), the decode (greedy: the readback and the text; with the
    LM: the host beam over the collapsed log-probs)."""
    from speecht_tpu_torch import native, vocabulary
    from speecht_tpu_torch.data.pipeline import single_batch, to_device
    from speecht_tpu_torch.ops.beam import BeamSearchDecoder, LanguageModelConfig
    from speecht_tpu_torch.record_utils import FileAudioSource
    from speecht_tpu_torch.recording import host_features
    from speecht_tpu_torch.train.step import make_eval_step

    audio = FileAudioSource([flac], rate=AUDIO_SR).record()[0]
    step = make_eval_step(model)
    beam = BeamSearchDecoder(model, LanguageModelConfig(language_model=lm_dir))
    stages = {}
    for _ in range(2):  # the second pass is the one kept
        t0 = time.perf_counter()
        resampled = native.resample(audio, AUDIO_SR, 22050)
        t1 = time.perf_counter()
        feats = host_features(resampled, "power", 22050)
        t2 = time.perf_counter()
        batch = to_device(single_batch(feats), torch.device("cuda"), "float32")
        _loss, ids, lens = step(batch)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        vocabulary.ids_to_sentence(ids[0, :lens[0]].cpu().numpy())
        t4 = time.perf_counter()
        launched = beam.launch(batch)
        _loss, logp, lengths = beam.finish(launched)
        t5 = time.perf_counter()
        beam.decode_emissions(logp, lengths)
        t6 = time.perf_counter()
        stages = {"resample 16000 -> 22050": t1 - t0, "host features": t2 - t1,
                  "eval step on the card": t3 - t2, "greedy decode readback + text": t4 - t3,
                  "LM device part + readback": t5 - t4, "host beam (LM)": t6 - t5}
    # the same step back to back on the card (CUDA events): set beside the
    # single call that follows the host's work above
    stages["eval step, 10 calls back to back (each)"] = time_ms(lambda: step(batch), 10) / 1e3
    beam.close()
    print(f"record breakdown, one recording of {len(audio) / AUDIO_SR:.2f} s ({feats.shape[0]} "
          "frames): " + ", ".join(f"{k} {v * 1e3!r} ms" for k, v in stages.items())
          + f"; on {card}")


def record_path(work, weights, lm_dir, audio_dir, audio_cache, kernels, card):
    """Phase 3i: ``record --audio-source`` on 4 of phase 3f's FLACs through
    the CLI: one-shot greedy, with the LM (host beam), with
    ``--device-beam``, and ``--device-beam`` on a KenLM binary written by
    ``native.lm_write_binary``; ``--streaming`` greedy and with the LM;
    one-shot and streaming with SPEECHT_PALLAS_CONV0=1. The LM runs take
    the phase-3 weights calibrated as phase 3d's, but on the features of
    phase 3f's FLACs (``audio_cache``, the ``preprocess --device`` cache),
    so the collapse keeps about a quarter of a recording's frames and the
    beams have letters to search."""
    import glob
    from speecht_tpu_torch import native
    from speecht_tpu_torch.ops import conv0
    from speecht_tpu_torch.ops.beam import BeamSearchDecoder, LanguageModelConfig
    from speecht_tpu_torch.ops.streaming import StreamingRecognizer
    from speecht_tpu_torch.record_utils import AudioSourceExhausted, FileAudioSource

    t_phase = time.perf_counter()
    lm_weights, _kept = lm_weights_for(os.path.join(work, "record"), audio_cache, weights)
    flacs = sorted(glob.glob(os.path.join(audio_dir, "test", "*", "*", "*.flac")))[:RECORD_FILES]
    check(len(flacs) == RECORD_FILES, f"record: {len(flacs)} FLACs found")
    bin_dir = os.path.join(work, "lm_binary")
    os.makedirs(bin_dir)
    t0 = time.perf_counter()
    native.lm_write_binary(os.path.join(lm_dir, "model.arpa"),
                           os.path.join(bin_dir, "kenlm-model.binary"))
    shutil.copy(os.path.join(lm_dir, "vocabulary"), bin_dir)
    print(f"record: wrote the phase-3d LM as a KenLM binary "
          f"({os.path.getsize(os.path.join(bin_dir, 'kenlm-model.binary'))} bytes) in "
          f"{time.perf_counter() - t0:.2f} s")
    common = ["record", "--audio-source", *flacs, "--train-dir", os.path.join(work, "train"),
              "--log-dir", os.path.join(work, "log"), "--data-dir", audio_dir]
    runs, results = {}, {}

    def record(label, weights_dir, *extra, env=False):
        argv = common + ["--reference-weights", weights_dir, *extra]
        if env:
            os.environ[conv0.ENV_VAR] = "1"
        try:
            for k in kernels:
                k.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with chunk_times() as chunks:
                result, out = run_cli(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            os.environ.pop(conv0.ENV_VAR, None)
        runs[label] = {k.name: k.launches for k in kernels}
        results[label] = result
        decoded = [ln for ln in out.replace("\r", "\n").splitlines() if ln.startswith("decoded:")]
        if "--streaming" in extra:
            check(isinstance(result, str) and decoded == [f"decoded: {result}"],
                  f"record {label}: no final transcript")
            busy = sum(t for t, _ in chunks)
            audio_s = sum(a for _, a in chunks)
            print(f"record {label}: final {result[:60]!r}; {len(chunks)} chunks of "
                  f"{audio_s / len(chunks) * 1e3:.1f} ms of 16 kHz audio, "
                  f"{busy / len(chunks) * 1e3!r} ms a chunk (read to read: resample, "
                  f"features, window, partial), real-time factor {busy / audio_s!r}; "
                  f"whole run with set-up {wall!r} s; kernel launches {runs[label]}; "
                  f"on {card}")
        else:
            check(len(result) == RECORD_FILES and len(decoded) == RECORD_FILES,
                  f"record {label}: {len(result)} transcripts for {RECORD_FILES} files")
            print(f"record {label}: {[r[:30] for r in result]}; whole run with set-up "
                  f"{wall / RECORD_FILES * 1e3!r} ms a recording; kernel launches "
                  f"{runs[label]}; on {card}")
        return result

    # warm-up (cuDNN plans at these buckets)
    record("warm-up", weights)
    greedy = record("record", weights)
    lm_flags = ["--language-model", lm_dir]
    lm = record("record --language-model", lm_weights, *lm_flags)
    beam = record("record --device-beam", lm_weights, *lm_flags, "--device-beam")
    beam_bin = record("record --device-beam (KenLM binary)", lm_weights,
                      "--language-model", bin_dir, "--device-beam")
    stream = record("record --streaming", weights, "--streaming")
    stream_lm = record("record --streaming --language-model", lm_weights, "--streaming",
                       *lm_flags)
    record("record (SPEECHT_PALLAS_CONV0=1)", weights, env=True)
    record("record --streaming (SPEECHT_PALLAS_CONV0=1)", weights, "--streaming", env=True)

    for label in ("record", "record --language-model", "record --device-beam",
                  "record --device-beam (KenLM binary)", "record (SPEECHT_PALLAS_CONV0=1)"):
        n = runs[label]
        check(n["ctc_alpha"] == RECORD_FILES and n["ctc_beta"] == 0,
              f"{label}: launches {n} (ctc_alpha once a recording)")
        check(n["beam_device"] == (RECORD_FILES if "device-beam" in label else 0),
              f"{label}: beam_device launches {n['beam_device']}")
        check(n["conv0"] == (RECORD_FILES if "CONV0" in label else 0),
              f"{label}: conv0 launches {n['conv0']}")
    for label in ("record --streaming", "record --streaming --language-model",
                  "record --streaming (SPEECHT_PALLAS_CONV0=1)"):
        n = runs[label]
        check(n["ctc_alpha"] == n["ctc_beta"] == n["beam_device"] == 0,
              f"{label}: launches {n} (the forward alone)")
        check((n["conv0"] > 0) == ("CONV0" in label), f"{label}: conv0 launches {n['conv0']}")

    # each one-shot transcript against the offline decode of the same
    # post-processed audio; the streaming finals against finalize's
    check(all(any(results[label]) for label in (
        "record", "record --language-model", "record --device-beam",
        "record --streaming", "record --streaming --language-model")),
        "record: a run decoded nothing, so its check would be vacuous")
    model = lm_model(weights, torch.device("cuda"))
    model_lm = lm_model(lm_weights, torch.device("cuda"))
    check(greedy == offline_transcripts(model, flacs), "record: not the offline decode")
    # conv_0's two bf16 paths round differently (one rounding after the
    # bias against cuDNN's), so near ties may flip: reported, not checked
    alike = sum(a == b for a, b in zip(results["record (SPEECHT_PALLAS_CONV0=1)"], greedy))
    print(f"record: the conv0 kernel path decodes {alike} of {RECORD_FILES} recordings as "
          "the cuDNN path does")
    for label, got, cfg in (
            ("record --language-model", lm, {}),
            ("record --device-beam", beam, {"device_beam": True}),
            ("record --device-beam (KenLM binary)", beam_bin,
             {"device_beam": True, "language_model": bin_dir})):
        decoder = BeamSearchDecoder(model_lm, LanguageModelConfig(**{"language_model": lm_dir,
                                                                      **cfg}))
        want = offline_transcripts(model_lm, flacs, decoder)
        decoder.close()
        check(got == want, f"{label}: not the offline decode: {got} vs {want}")
    check(beam_bin == beam, "record --device-beam: the KenLM binary decodes otherwise than "
          "the ARPA source")

    def streamed(m):
        """A recognizer holding the whole stream, resampled in one piece
        (the streaming resampler is sample-exact against it)."""
        chunks = []
        with FileAudioSource(flacs, rate=AUDIO_SR).open_input_stream() as read:
            while True:
                try:
                    chunks.append(read())
                except AudioSourceExhausted:
                    break
        whole = native.resample(np.concatenate(chunks), AUDIO_SR, 22050)
        rec = StreamingRecognizer(m, sample_rate=22050)
        rec.accept_chunk(whole)
        return rec

    check(stream == streamed(model).finalize(), "record --streaming: not finalize's offline "
          "transcript")
    decoder = BeamSearchDecoder(model_lm, LanguageModelConfig(language_model=lm_dir))
    check(stream_lm == streamed(model_lm).finalize(beam=decoder),
          "record --streaming --language-model: not finalize's offline transcript")
    decoder.close()
    record_breakdown(model_lm, flacs[0], lm_dir, card)
    print(f"record: phase 3i wall time {time.perf_counter() - t_phase:.1f} s")
    return runs


# -- phase 3j: parallel/, two ranks sharing the card ---------------------------

# (name, command, grid flags) of the paths two ranks run, in this order
PARALLEL_PATHS = (
    ("train --data-parallel 2", "train", ["--data-parallel", "2"]),
    ("train --model-parallel 2", "train", ["--model-parallel", "2"]),
    ("train --seq-parallel 2", "train", ["--seq-parallel", "2"]),
    ("evaluate --data-parallel 2", "evaluate", ["--data-parallel", "2"]),
    ("evaluate --seq-parallel 2", "evaluate", ["--seq-parallel", "2"]),
)
PARALLEL_RUNS = {"train --data-parallel 2": "dp", "train --model-parallel 2": "tp",
                 "train --seq-parallel 2": "sp"}
PARALLEL_TIMEOUT_S = 600


@contextlib.contextmanager
def seeded_reader():
    """One process reads the cache and the FLACs in the order the ranks
    share (seed 0), so that its step k holds the rows of the ranks' step k
    together."""
    from speecht_tpu_torch.data.reader import SpeechCorpusReader

    saved = {}
    for name in ("load_samples", "load_raw_samples"):
        saved[name] = load = getattr(SpeechCorpusReader, name)

        def seeded(self, *args, seed=None, _load=load, **kwargs):
            return _load(self, *args, seed=0 if seed is None else seed, **kwargs)

        setattr(SpeechCorpusReader, name, seeded)
    try:
        yield
    finally:
        for name, load in saved.items():
            setattr(SpeechCorpusReader, name, load)


@contextlib.contextmanager
def step_losses():
    """Each train step's host time and loss: the growth of the metrics'
    loss sum, read back after the step (a sync a step)."""
    from speecht_tpu_torch.train import step as tstep

    rec = {"marks": [], "losses": []}
    make = tstep.make_train_step_acc

    def recorded_make(*args, **kwargs):
        step = make(*args, **kwargs)
        last = [0.0]

        def recorded(*a):
            rec["marks"].append(time.perf_counter())
            out = step(*a)
            total = out[-1]["loss_sum"].item()
            rec["losses"].append(total - last[0])
            last[0] = total
            return out

        return recorded

    tstep.make_train_step_acc = recorded_make
    try:
        yield rec
    finally:
        tstep.make_train_step_acc = make


@contextlib.contextmanager
def eval_rows():
    """Every row evaluate tracks, as {expected text: decoded ids}, the
    host times of each batch's tracking (``batch_marks``), each batch's
    loss unrounded, and the host ms of each search of the LM decoder
    (``decode_emissions``: the host beam, or the device beam and its
    readback)."""
    from speecht_tpu_torch import evaluation, vocabulary
    from speecht_tpu_torch.ops.beam import BeamSearchDecoder

    rec = {"rows": {}, "marks": [], "losses": [], "search_ms": []}
    track = evaluation.Evaluation._track_batch
    results = evaluation.Evaluation._result_iterator
    search = BeamSearchDecoder.decode_emissions

    def recorded(stats, batch, decoded, dec_lengths, verbose=False):
        rec["marks"].append(time.perf_counter())
        lengths = getattr(batch, "seq_lengths", None)
        lengths = batch.num_samples if lengths is None else lengths
        for i in range(decoded.shape[0]):
            if lengths[i]:
                expected = vocabulary.ids_to_sentence(
                    batch.labels[i, : batch.label_lengths[i]])
                rec["rows"][expected] = [int(x) for x in decoded[i, : dec_lengths[i]]]
        return track(stats, batch, decoded, dec_lengths, verbose)

    def losses(self, eval_step, loader):
        for item in results(self, eval_step, loader):
            rec["losses"].append(float(item[1]))
            yield item

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return search(*args, **kwargs)
        finally:
            rec["search_ms"].append((time.perf_counter() - t0) * 1e3)

    evaluation.Evaluation._track_batch = staticmethod(recorded)
    evaluation.Evaluation._result_iterator = losses
    BeamSearchDecoder.decode_emissions = timed
    try:
        yield rec
    finally:
        evaluation.Evaluation._track_batch = staticmethod(track)
        evaluation.Evaluation._result_iterator = results
        BeamSearchDecoder.decode_emissions = search


def stats_fields(stats):
    return {"utterances": stats.decodings_counter,
            "sum_led": stats.sum_letter_edit_distance,
            "sum_wed": stats.sum_word_edit_distance,
            "ler": stats.global_letter_error_rate, "wer": stats.global_word_error_rate}


def collective_times(n_params, reps=5):
    """ms of each collective the paths run, at their shapes, on this card
    (CUDA synchronised around each call; host clock)."""
    import torch.distributed as dist

    from speecht_tpu_torch.parallel import comm

    world, rank = dist.group.WORLD, dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    grads = torch.ones(n_params, device=dev)
    row_out = torch.ones(MAIN_BATCH, 2000, 512, device=dev)
    col_in = torch.ones(MAIN_BATCH, 250, 512, device=dev)
    logits = torch.ones(MAIN_BATCH, 256, 29, device=dev)
    slab = torch.ones(MAIN_BATCH, 128, 512, dtype=torch.bfloat16, device=dev)
    prev, nxt = (None, 1) if rank == 0 else (0, None)
    B, C, T = slab.shape
    calls = {
        f"gradient all-reduce, float32 [{n_params}] (DP; SP over both ranks)":
            lambda: comm.all_reduce_(grads, world),
        "TP forward all-reduce of the row-parallel layer's partial output, "
        f"float32 {list(row_out.shape)}": lambda: comm.all_reduce_(row_out, world),
        "TP backward all-reduce of the column-parallel layer's input gradient, "
        f"float32 {list(col_in.shape)}": lambda: comm.all_reduce_(col_in, world),
        f"SP logits all-gather over time, float32 {list(logits.shape)} a rank":
            lambda: comm.all_gather(logits, world, 1),
        f"SP halo exchange of conv_0 (23 + 24 frames of bf16 {list(slab.shape)})":
            lambda: comm.exchange(slab[..., :24], slab[..., T - 23:], prev, nxt,
                                  ((B, C, 23), (B, C, 24)), slab),
    }
    out = {}
    for name, fn in calls.items():
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = times
    return out


def first_batch(data_dir):
    """The first evaluate batch of phase 3j (the cache in seed-0 order)."""
    from speecht_tpu_torch.data.pipeline import build_batch, to_device
    from speecht_tpu_torch.data.reader import SpeechCorpusReader

    samples = SpeechCorpusReader(data_dir).load_samples(
        "test", feature_type="power", seed=0, limit_count=MAIN_BATCH)
    return to_device(build_batch(list(samples)), torch.device("cuda"))


def phase3_model(weights):
    from speecht_tpu_torch.data.features import feature_size
    from speecht_tpu_torch.execution import build_model
    from speecht_tpu_torch.weights import load_weight_dir

    model = build_model(feature_size("power"), types.SimpleNamespace())
    model.load_state_dict(load_weight_dir(weights, model))
    return model.cuda().eval()


def sp_logits(data_dir, weights):
    """The sequence-parallel forward's logits of the first batch on this
    rank's grid (bf16, as evaluate runs it)."""
    from speecht_tpu_torch.parallel import mesh as pmesh
    from speecht_tpu_torch.parallel.seq_parallel import make_sp_forward

    mesh = pmesh.make_mesh(1, 2)
    mesh.seq_parallel = True
    batch = first_batch(data_dir)
    with torch.inference_mode():
        return make_sp_forward(phase3_model(weights), mesh)(batch.features).cpu().numpy()


def check_sp_logits(path, data_dir, weights):
    """SP's logits against the dense forward's on the same batch
    (``PARALLEL_LOGIT_RTOL``), and every argmax flip a near tie."""
    from speecht_tpu_torch.train.step import make_forward_step

    got = np.load(path)
    batch = first_batch(data_dir)
    want = make_forward_step(phase3_model(weights))(batch.features).cpu().numpy()
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    valid = np.arange(want.shape[1])[None, :] < (batch.seq_lengths.cpu().numpy() // 2)[:, None]
    flips = (got.argmax(-1) != want.argmax(-1)) & valid
    top2 = np.sort(want, axis=-1)[..., -2:]
    margins = (top2[..., 1] - top2[..., 0])[flips]
    worst = float(margins.max()) if margins.size else 0.0
    print(f"parallel: SP logits of one batch against the dense forward's (bf16): max abs "
          f"diff {err!r} (tolerance {PARALLEL_LOGIT_RTOL} x the largest |logit| "
          f"{scale!r}); argmax differs on {int(flips.sum())} of {int(valid.sum())} frames, "
          f"the largest dense top-2 margin among them {worst!r} (at most twice the max "
          f"diff)")
    check(err <= PARALLEL_LOGIT_RTOL * scale, "parallel: SP logits off the dense forward's")
    check(worst <= 2 * err, "parallel: an SP argmax flip that is no near tie")


def rank_worker(spec_path: str) -> int:
    """One rank of phase 3j or 3k, started by ``torchrun``: each path
    through ``CLI([...]).run()``, the kernels' launch counts set to 0 just
    before and read just after; for phase 3j then the collectives' times
    and the SP logits. The results go to a JSON file of this rank. With
    ``ieee_float32`` in the spec, TF32 is off in this process."""
    from speecht_tpu_torch.ops import beam_device_cuda, conv0_cuda, ctc_cuda

    with open(spec_path) as f:
        spec = json.load(f)
    if spec.get("ieee_float32"):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    kernels = (list(ctc_cuda.KERNELS) + list(conv0_cuda.KERNELS)
               + list(beam_device_cuda.KERNELS))
    rank = int(os.environ["RANK"])
    out = {"paths": {}}
    for name, argv in spec["paths"]:
        with step_losses() as steps, eval_rows() as rows:
            for k in kernels:
                k.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats, stdout = run_cli(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        entry = {
            "launches": {k.name: k.launches for k in kernels},
            "wall_s": wall,
            "distributed": [ln for ln in stdout.splitlines() if ln.startswith("distributed:")],
            "lines": [ln for ln in stdout.splitlines() if ln.startswith(
                ("global step", "validation average loss", "seq-parallel", "Restored",
                 "Done", "LED:", "precise:"))][-12:],
            "step_marks": steps["marks"], "losses": steps["losses"],
            "batch_marks": rows["marks"], "batch_losses": rows["losses"],
            "search_ms": rows["search_ms"],
            # what evaluate prints on rank 0 alone
            "prints": sum(ln.startswith(("expected: ", "Global statistics", "validation",
                                         "from-audio:", "device beam", "device LM"))
                          for ln in stdout.splitlines()),
        }
        if argv[0] == "evaluate":
            entry["stats"] = stats_fields(stats)
            entry["rows"] = rows["rows"]
        out["paths"][name] = entry
    if "n_params" in spec:  # phase 3j
        out["collectives_ms"] = collective_times(spec["n_params"])
        logits = sp_logits(spec["data_dir"], spec["weights"])
        if rank == 0:
            np.save(spec["sp_logits"], logits)
    with open(spec["out"].format(rank=rank), "w") as f:
        json.dump(out, f)
    return 0


def launch_ranks(spec, work, phase="3j"):
    """``torchrun --standalone --nproc-per-node 2 chip_smoke.py --rank-worker``,
    the two ranks sharing the card (SPEECHT_SHARE_CARD=1); its whole process
    group is killed if it outlives the time limit."""
    spec_path = os.path.join(work, f"{phase}-spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", os.path.abspath(__file__), "--rank-worker", spec_path]
    env = dict(os.environ, SPEECHT_SHARE_CARD="1")
    proc = subprocess.Popen(cmd, env=env, cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        output, _ = proc.communicate(timeout=PARALLEL_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        output, _ = proc.communicate()
        print(output[-6000:])
        raise SmokeFailure(f"phase {phase}: the ranks outlived {PARALLEL_TIMEOUT_S} s")
    if proc.returncode != 0:
        print(output[-6000:])
        raise SmokeFailure(f"phase {phase}: torchrun exited {proc.returncode}")
    return [json.load(open(spec["out"].format(rank=r))) for r in range(2)]


def rows_against(label, got, want):
    """Decoded tokens equal (phase 4's count) and the edit distance
    between the two decodes of each row, summed in letters and words."""
    from speecht_tpu_torch import vocabulary
    from speecht_tpu_torch.metrics import levenshtein

    check(set(got) == set(want), f"{label}: the ranks tracked other rows than one process")
    same = total = lev_letters = lev_words = 0
    for expected, ids in want.items():
        a, b = np.asarray(got[expected], np.int64), np.asarray(ids, np.int64)
        width = max(len(a), len(b))
        pa = np.pad(a, (0, width - len(a)), constant_values=-1)
        pb = np.pad(b, (0, width - len(b)), constant_values=-1)
        same += int((pa == pb).sum())
        total += width
        sa, sb = vocabulary.ids_to_sentence(a), vocabulary.ids_to_sentence(b)
        lev_letters += levenshtein(sa, sb)
        lev_words += levenshtein(sa.split(), sb.split())
    return same / max(total, 1), same, total, lev_letters, lev_words


def update_error(start, got, want):
    """||(got - start) - (want - start)|| / ||want - start|| over every
    parameter: how far two runs' parameter movements differ."""
    num = den = 0.0
    for name, p0 in start.items():
        d_got, d_want = got[name] - p0, want[name] - p0
        num += float(((d_got - d_want).double() ** 2).sum())
        den += float((d_want.double() ** 2).sum())
    return math.sqrt(num / max(den, 1e-30))


def parallel_path(work, data_dir, weights, kernels, card):
    """Phase 3j: the three grids of ``train`` and two of ``evaluate`` on
    two ranks sharing the card, each against one process on the same rows;
    a one-process evaluate restoring the DP run's checkpoint. Returns the
    kernels' launches by path, summed over the ranks."""
    from speecht_tpu_torch.evaluation import Evaluation
    from speecht_tpu_torch.train.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    # the phase-3 corpus (256 utterances) as the train and test splits
    cache = os.path.join(work, "data3j", "preprocessed-power")
    os.makedirs(cache)
    for split in ("train", "test"):
        os.symlink(os.path.join(data_dir, "preprocessed-power", "test"),
                   os.path.join(cache, split))
    data3j, train_dir = os.path.join(work, "data3j"), os.path.join(work, "train3j")
    for run in ("ref", *PARALLEL_RUNS.values()):
        write_port_checkpoint(os.path.join(train_dir, run), weights)
    common = ["--data-dir", data3j, "--train-dir", train_dir,
              "--log-dir", os.path.join(work, "log3j"), "--batch-size", str(MAIN_BATCH)]

    def argv(command, grid, run="ref"):
        if command == "train":
            return ["train", "--max-steps", str(PARALLEL_STEPS), "--steps-per-checkpoint",
                    str(PARALLEL_STEPS), *common, "--run-name", run, *grid]
        return ["evaluate", "--test", "--no-save", "--step-count", str(MAIN_STEPS),
                "--reference-weights", weights, *common, *grid]

    n_params = sum(int(np.load(os.path.join(root, f), mmap_mode="r").size)
                   for root, _d, files in os.walk(weights) for f in files)
    spec = {"paths": [[name, argv(cmd, grid, PARALLEL_RUNS.get(name, "ref"))]
                      for name, cmd, grid in PARALLEL_PATHS],
            "out": os.path.join(work, "3j-rank{rank}.json"), "n_params": n_params,
            "data_dir": data3j, "weights": weights,
            "sp_logits": os.path.join(work, "3j-sp-logits.npy")}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch_ranks(spec, work)
    ranks_s = time.perf_counter() - t0

    # one process on the same rows
    with seeded_reader(), step_losses() as ref_steps:
        run_cli(argv("train", []))
    with seeded_reader(), eval_rows() as ref_rows:
        ref_stats, _out = run_cli(argv("evaluate", []))
    ref_stats = stats_fields(ref_stats)
    ref_ms = step_period_ms(ref_steps["marks"])
    print(f"parallel: one process: train {ref_ms!r} ms/step (a loss readback a step), "
          f"losses {ref_steps['losses']!r}; evaluate {batch_period_ms(ref_rows['marks'])!r} "
          f"ms/batch, {ref_stats}")

    for line in ranks[0]["paths"][PARALLEL_PATHS[0][0]]["distributed"] + \
            ranks[1]["paths"][PARALLEL_PATHS[0][0]]["distributed"]:
        print(f"parallel: {line}")
    check(all("backend gloo" in ln and "share cuda:0" in ln
              for r in ranks for ln in r["paths"][PARALLEL_PATHS[0][0]]["distributed"]),
          "parallel: the ranks did not report gloo on the shared card")
    ckpt_of = lambda run: torch.load(  # noqa: E731
        CheckpointManager(os.path.join(train_dir, run)).path(PARALLEL_STEPS),
        map_location="cpu", weights_only=True)["params"]
    start = torch.load(CheckpointManager(os.path.join(train_dir, "ref")).path(0),
                       map_location="cpu", weights_only=True)["params"]
    ref_params = ckpt_of("ref")
    launches = {}
    for name, command, _grid in PARALLEL_PATHS:
        per_rank = [r["paths"][name] for r in ranks]
        launches[name] = {k: sum(p["launches"][k] for p in per_rank) for k in per_rank[0]["launches"]}
        for r, p in enumerate(per_rank):
            for k in ("ctc_alpha", "ctc_beta") if command == "train" else ("ctc_alpha",):
                check(p["launches"][k] > 0, f"parallel {name}: rank {r} never launched {k}")
            check(p["launches"]["conv0"] == 0 and p["launches"]["beam_device"] == 0,
                  f"parallel {name}: rank {r} launched {p['launches']}")
            if command == "evaluate":
                check(p["launches"]["ctc_beta"] == 0, f"parallel {name}: the backward ran")
        print(f"parallel {name}: rank 0: " + " | ".join(per_rank[0]["lines"]))
        if command == "train":
            run = PARALLEL_RUNS[name]
            losses = per_rank[0]["losses"]
            check(len(losses) == PARALLEL_STEPS and losses == per_rank[1]["losses"],
                  f"parallel {name}: the ranks' losses {losses} {per_rank[1]['losses']}")
            rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_steps["losses"])]
            err = update_error(start, ckpt_of(run), ref_params)
            ms = step_period_ms(per_rank[0]["step_marks"])
            print(f"parallel {name}: losses {losses!r}, one process {ref_steps['losses']!r}, "
                  f"rel diff {rel!r} (tolerance {PARALLEL_LOSS_RTOL}); parameters after "
                  f"{PARALLEL_STEPS} steps: movement off one process's by {err!r} of its "
                  f"norm (tolerance {PARALLEL_UPDATE_RTOL}); {ms!r} ms/step (one process "
                  f"{ref_ms!r}); kernel launches (both ranks) {launches[name]}; on {card}")
            check(max(rel) <= PARALLEL_LOSS_RTOL, f"parallel {name}: losses disagree")
            check(err <= PARALLEL_UPDATE_RTOL, f"parallel {name}: parameters disagree")
        else:
            stats = per_rank[0]["stats"]
            check(stats == per_rank[1]["stats"], f"parallel {name}: the ranks' statistics differ")
            share, same, total, lev_l, lev_w = rows_against(name, per_rank[0]["rows"],
                                                            ref_rows["rows"])
            ms = batch_period_ms(per_rank[0]["batch_marks"])
            floor = "reported" if "--seq-parallel" in name else f"at least {PARALLEL_MIN_TOKEN_SHARE}"
            print(f"parallel {name}: {stats}, one process {ref_stats}; decoded tokens equal "
                  f"{same}/{total} = {share!r} ({floor}); the "
                  f"decodes' own edit distance {lev_l} letters, {lev_w} words; {ms!r} "
                  f"ms/batch; kernel launches (both ranks) {launches[name]}; on {card}")
            check(stats["utterances"] == ref_stats["utterances"],
                  f"parallel {name}: {stats['utterances']} utterances tracked")
            if "--seq-parallel" not in name:  # SP: check_sp_logits below
                check(share >= PARALLEL_MIN_TOKEN_SHARE, f"parallel {name}: decodes disagree")
            check(abs(stats["sum_led"] - ref_stats["sum_led"]) <= lev_l
                  and abs(stats["sum_wed"] - ref_stats["sum_wed"]) <= lev_w,
                  f"parallel {name}: statistics off by more than the decodes differ")
    check_sp_logits(spec["sp_logits"], data3j, weights)
    for r, rank in enumerate(ranks):
        for name, times in rank["collectives_ms"].items():
            print(f"parallel collectives, rank {r}: {name}: {times!r} ms (gloo, staged through "
                  f"host memory: two ranks share one card, so NCCL cannot run; not NCCL's "
                  f"times); on {card}")

    # one process restores the DP run's checkpoint
    eval_argv = ["evaluate", "--test", "--no-save", "--step-count", "1", *common,
                 "--run-name", PARALLEL_RUNS["train --data-parallel 2"]]
    stats, out = run_cli(eval_argv)
    losses = [float(ln.split()[3]) for ln in out.splitlines()
              if ln.startswith("validation average loss")]
    restored = Evaluation(parsed_flags(eval_argv)).load_weights()
    check(restored == PARALLEL_STEPS and len(losses) == 1 and math.isfinite(losses[0]),
          f"parallel: one process restored step {restored}, losses {losses}")
    print(f"parallel: one process restored the DP run's step-{restored} checkpoint, "
          f"loss {losses[0]!r}; the ranks' run {ranks_s:.1f} s with start-up; phase 3j "
          f"wall time {time.perf_counter() - t_phase:.1f} s")
    return launches


# -- phase 3k: evaluate with the LM and from audio on two ranks ---------------

# the LM forms and the grids of phase 3k; the from-audio paths run on the
# data-parallel grid
PARALLEL_DECODE_FORMS = (("host beam", []), ("--device-beam", ["--device-beam"]),
                         ("--device-beam --rescore 8", ["--device-beam", "--rescore", "8"]))
PARALLEL_DECODE_GRIDS = (("--data-parallel 2", ["--data-parallel", "2"]),
                         ("--model-parallel 2", ["--model-parallel", "2"]))
# float32 with TF32 off on both sides: the two ranks sum each batch's loss
# over another split of its rows (DP) or each wide layer over another
# split of its channels (TP), a few float32 roundings apart
PARALLEL_DECODE_LOSS_RTOL = 1e-5
# phase 3k's own LM weights: the collapse keeps most frames, so the beam
# decodes dozens of letters a row (the phase-3d weights keep a quarter,
# where the beam decodes almost nothing) and the tokens compared are many
PARALLEL_DECODE_KEEP_RANGE, PARALLEL_DECODE_KEEP_AIM = (0.6, 0.95), (0.75, 0.85)


@contextlib.contextmanager
def ieee_float32():
    """TF32 off for cuDNN's convolutions and float32 matmuls, restored
    after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def parallel_decode_path(work, data_dir, weights, lm_dir, audio_dir, kernels, card):
    """Phase 3k: ``evaluate --language-model`` (host beam, ``--device-beam``,
    ``--device-beam --rescore 8``) on the DP and TP grids, and ``evaluate
    --from-audio`` (greedy, and with the LM on the device beam) on the DP
    grid, two ranks sharing the card, each against one process on the
    same rows: float32 with TF32 off on both sides. The LM paths take
    weights calibrated as phase 3d's, to keep ``PARALLEL_DECODE_KEEP_AIM``
    of the frames. Returns each rank's kernel launches by path."""
    t_phase = time.perf_counter()
    lm_weights, _kept = lm_weights_for(
        work, data_dir, weights, keep_aim=PARALLEL_DECODE_KEEP_AIM,
        keep_range=PARALLEL_DECODE_KEEP_RANGE, name="lm_weights_3k")
    common = ["--train-dir", os.path.join(work, "train3k"), "--log-dir",
              os.path.join(work, "log3k"), "--batch-size", str(MAIN_BATCH),
              "--compute-dtype", "float32", "--no-save", "--test"]
    lm = ["--language-model", lm_dir]
    # (the one-process run's key, its flags, batches)
    references = {
        **{f"evaluate --language-model ({form})":
           (["--data-dir", data_dir, "--reference-weights", lm_weights, *lm,
             "--step-count", str(MAIN_STEPS), *flags], MAIN_STEPS)
           for form, flags in PARALLEL_DECODE_FORMS},
        "evaluate --from-audio": (["--data-dir", audio_dir, "--reference-weights",
                                   weights, "--from-audio"], 1),
        "evaluate --from-audio --language-model --device-beam": (
            ["--data-dir", audio_dir, "--reference-weights", lm_weights, "--from-audio",
             *lm, "--device-beam"], 1),
    }
    paths = [(f"{ref} {grid}", ref, grid_flags) for ref in references
             for grid, grid_flags in PARALLEL_DECODE_GRIDS
             if "--from-audio" not in ref or "--data-parallel" in grid]
    spec = {"paths": [[name, ["evaluate", *common, *references[ref][0], *grid]]
                      for name, ref, grid in paths],
            "out": os.path.join(work, "3k-rank{rank}.json"), "ieee_float32": True}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch_ranks(spec, work, phase="3k")
    ranks_s = time.perf_counter() - t0

    # one process on the same rows
    refs = {}
    with ieee_float32(), seeded_reader():
        for ref, (flags, steps) in references.items():
            with eval_rows() as rows:
                t0 = time.perf_counter()
                stats, _out = run_cli(["evaluate", *common, *flags])
                wall = time.perf_counter() - t0
            refs[ref] = {"stats": stats_fields(stats), "wall_s": wall, **rows}
            check(len(rows["losses"]) == steps and stats.decodings_counter == MAIN_BATCH * steps,
                  f"parallel decode: one process's {ref} ran {len(rows['losses'])} batches")

    def ms_a_batch(marks, wall_s, steps):
        return batch_period_ms(marks) if steps > 2 else wall_s * 1e3 / steps

    launches = {}
    for name, ref, _grid in paths:
        want, steps = refs[ref], references[ref][1]
        per_rank = [r["paths"][name] for r in ranks]
        device_beam = "--device-beam" in name
        launches[name] = [p["launches"] for p in per_rank]
        for r, p in enumerate(per_rank):
            got = p["launches"]
            check(got["ctc_alpha"] == steps and got["beam_device"] == (steps if device_beam else 0)
                  and got["ctc_beta"] == 0 and got["conv0"] == 0,
                  f"parallel decode {name}: rank {r} launched {got} for {steps} batches")
            share, same, total, lev_l, lev_w = rows_against(name, p["rows"], want["rows"])
            # the calibration aims at the cached features; on the FLACs'
            # features the LM weights may decode little
            check(total >= len(want["rows"]) or "--from-audio --language-model" in name,
                  f"parallel decode {name}: {total} tokens in {len(want['rows'])} rows")
            rel = [abs(a - b) / abs(b) for a, b in zip(p["batch_losses"], want["losses"])]
            print(f"parallel decode {name}: rank {r}: {p['stats']}; decoded tokens equal "
                  f"{same}/{total} (the decodes' own edit distance {lev_l} letters, {lev_w} "
                  f"words); batch losses {p['batch_losses']!r} rel diff {rel!r} (tolerance "
                  f"{PARALLEL_DECODE_LOSS_RTOL}); search ms a batch (host clock) "
                  f"{p['search_ms']!r}; kernel launches {got}")
            check(p["rows"] == want["rows"], f"parallel decode {name}: rank {r}'s decodes differ")
            check({k: v for k, v in p["stats"].items() if k not in ("ler", "wer")}
                  == {k: v for k, v in want["stats"].items() if k not in ("ler", "wer")}
                  and all(math.isclose(p["stats"][k], want["stats"][k], rel_tol=1e-12)
                          for k in ("ler", "wer")),
                  f"parallel decode {name}: rank {r}'s statistics differ")
            check(len(rel) == steps and len(p["batch_losses"]) == steps
                  and max(rel) <= PARALLEL_DECODE_LOSS_RTOL,
                  f"parallel decode {name}: rank {r}'s losses disagree")
        check(per_rank[0]["prints"] > 0 and per_rank[1]["prints"] == 0,
              f"parallel decode {name}: prints on rank 0 {per_rank[0]['prints']}, "
              f"rank 1 {per_rank[1]['prints']}")
        rank0 = per_rank[0]
        print(f"parallel decode {name}: "
              f"{ms_a_batch(rank0['batch_marks'], rank0['wall_s'], steps)!r} ms a batch on "
              f"rank 0 (B={MAIN_BATCH} global, {steps} batches), one process "
              f"{ms_a_batch(want['marks'], want['wall_s'], steps)!r} (search "
              f"{want['search_ms']!r} ms a batch); "
              f"gloo on one shared card, float32, TF32 off; on {card}")
    print(f"parallel decode: the ranks' run {ranks_s:.1f} s with start-up; phase 3k wall "
          f"time {time.perf_counter() - t_phase:.1f} s")
    return launches


# -- phase 4: one batch, card vs CPU ----------------------------------------


def parity(data_dir, weights, conv0_path=False):
    """One eval batch on the card and on the CPU, float32, TF32 off. With
    ``conv0_path``, SPEECHT_PALLAS_CONV0=1: the conv0 kernel on the card,
    conv0_plain on the CPU."""
    from speecht_tpu_torch.data.features import feature_size
    from speecht_tpu_torch.data.pipeline import build_batch, to_device
    from speecht_tpu_torch.data.reader import SpeechCorpusReader
    from speecht_tpu_torch.execution import build_model
    from speecht_tpu_torch.ops import conv0, conv0_cuda
    from speecht_tpu_torch.train.step import make_eval_step
    from speecht_tpu_torch.weights import load_weight_dir

    label = "parity (conv0 path)" if conv0_path else "parity"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"{label}: float32 compute, torch.backends.cudnn.allow_tf32 = False, "
          "torch.backends.cuda.matmul.allow_tf32 = False")
    samples = SpeechCorpusReader(data_dir).load_samples(
        "test", feature_type="power", seed=0, limit_count=8
    )
    batch = build_batch(list(samples))

    flags = types.SimpleNamespace(compute_dtype="float32")
    outs = {}
    before = (conv0_cuda.CONV0.launches, conv0_cuda.CONV0.plain_calls)
    if conv0_path:
        os.environ[conv0.ENV_VAR] = "1"
    try:
        for name in ("cuda", "cpu"):
            device = torch.device(name)
            model = build_model(feature_size("power"), flags)
            model.load_state_dict(load_weight_dir(weights, model))
            step = make_eval_step(model.to(device).eval())
            loss, decoded, lengths = step(to_device(batch, device, "float32"))
            outs[name] = (float(loss), decoded.cpu().numpy(), lengths.cpu().numpy())
    finally:
        os.environ.pop(conv0.ENV_VAR, None)
    taken = (conv0_cuda.CONV0.launches - before[0], conv0_cuda.CONV0.plain_calls - before[1])
    check(taken == ((1, 1) if conv0_path else (0, 0)),
          f"{label}: conv0 kernel launches and plain calls {taken}")
    (lg, dg, ng), (lc, dc, nc) = outs["cuda"], outs["cpu"]
    share, same, total = token_share(dg, ng, dc, nc)
    loss_rel = abs(lg - lc) / abs(lc)
    print(f"{label}: loss cuda {lg!r} cpu {lc!r} rel diff {loss_rel!r} "
          f"(tolerance {PARITY_LOSS_RTOL}); decoded tokens equal {same}/{total} "
          f"= {share!r} (at least {PARITY_MIN_TOKEN_SHARE})")
    check(loss_rel <= PARITY_LOSS_RTOL, f"{label}: card and CPU losses disagree")
    check(share >= PARITY_MIN_TOKEN_SHARE, f"{label}: card and CPU decodes disagree")


def parity_train(data_dir, weights):
    """One train step, card vs CPU: float32, TF32 off, B=8."""
    from speecht_tpu_torch.data.features import feature_size
    from speecht_tpu_torch.data.pipeline import build_batch, to_device
    from speecht_tpu_torch.data.reader import SpeechCorpusReader
    from speecht_tpu_torch.execution import build_model
    from speecht_tpu_torch.train import step as tstep
    from speecht_tpu_torch.train.state import create_train_state, make_optimizer
    from speecht_tpu_torch.weights import load_weight_dir

    samples = SpeechCorpusReader(data_dir).load_samples(
        "train", feature_type="power", seed=0, limit_count=8
    )
    batch = build_batch(list(samples))
    flags = types.SimpleNamespace(compute_dtype="float32")
    outs = {}
    for name in ("cuda", "cpu"):
        device = torch.device(name)
        model = build_model(feature_size("power"), flags)
        model.load_state_dict(load_weight_dir(weights, model))
        model.to(device).train()
        tx = make_optimizer()
        state = create_train_state(dict(model.named_parameters()), tx, 1e-4)
        t0 = time.perf_counter()
        state, m = tstep.make_train_step(model, tx)(
            state, to_device(batch, device, "float32")
        )
        params = {k: v.detach().cpu() for k, v in state.params.items()}
        outs[name] = (float(m["loss"]), float(m["grad_norm"]), params)
        print(f"parity train: {name} step {time.perf_counter() - t0:.1f} s")
    (lg, ng, pg), (lc, nc, pc) = outs["cuda"], outs["cpu"]
    loss_rel = abs(lg - lc) / abs(lc)
    norm_rel = abs(ng - nc) / abs(nc)
    param_err = max(float((pg[k] - pc[k]).abs().max()) for k in pg)
    print(f"parity train: B=8 T={batch.features.shape[1]}: loss cuda {lg!r} cpu "
          f"{lc!r} rel diff {loss_rel!r} (tolerance {PARITY_LOSS_RTOL}); grad "
          f"norm cuda {ng!r} cpu {nc!r} rel diff {norm_rel!r} (tolerance "
          f"{PARITY_GRAD_NORM_RTOL}); updated parameters max abs diff "
          f"{param_err!r} (tolerance {PARITY_PARAM_ATOL})")
    check(loss_rel <= PARITY_LOSS_RTOL, "card and CPU train losses disagree")
    check(norm_rel <= PARITY_GRAD_NORM_RTOL, "card and CPU grad norms disagree")
    check(param_err <= PARITY_PARAM_ATOL, "card and CPU updated parameters disagree")


def parity_beam(data_dir, lm_weights, lm_dir, devices=("cuda", "cpu")):
    """One batch through the beam decoder's device part on the card and
    on the CPU (float32, TF32 off), then the host beam on each side's
    emissions."""
    from speecht_tpu_torch.data.pipeline import to_device
    from speecht_tpu_torch.execution import finish_readback, start_readback
    from speecht_tpu_torch.ops.beam import BeamSearchDecoder, LanguageModelConfig

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = one_batch(data_dir, n=8)
    outs = {}
    for name in devices:
        device = torch.device(name)
        decoder = BeamSearchDecoder(
            lm_model(lm_weights, device, "float32"),
            LanguageModelConfig(language_model=lm_dir),
        )
        try:
            loss, logp, lengths = finish_readback(*start_readback(
                decoder.device_part(to_device(batch, device, "float32"))
            ))
            outs[name] = (float(loss), logp, lengths,
                          *decoder.decode_emissions(logp, lengths))
        finally:
            decoder.close()
    (lg, pg, ng, dg, mg), (lc, pc, nc, dc, mc) = (outs[name] for name in devices)
    loss_err = abs(lg - lc)
    print(f"parity beam: B=8 T={batch.features.shape[1]}, float32, TF32 off: "
          f"loss cuda {lg!r} cpu {lc!r} abs diff {loss_err!r} (tolerance "
          f"{CTC_ATOL} + {CTC_RTOL} x |loss|); collapsed lengths cuda "
          f"{ng.tolist()} cpu {nc.tolist()}")
    check(loss_err <= CTC_ATOL + CTC_RTOL * abs(lc), "beam parity: losses disagree")
    check(np.array_equal(ng, nc), "beam parity: collapsed lengths disagree")
    kept = [(pg[i, :n], pc[i, :n]) for i, n in enumerate(nc) if n]
    logp_err = max((float(np.abs(g - c).max()) for g, c in kept), default=0.0)
    logp_ratio = max((float((np.abs(g - c) / (BEAM_LOGP_ATOL + BEAM_LOGP_RTOL * np.abs(c))).max())
                      for g, c in kept), default=0.0)
    lowest = min((float(c.min()) for _g, c in kept), default=0.0)
    same = sum(
        int(mg[i] == mc[i] and np.array_equal(dg[i, :mg[i]], dc[i, :mc[i]]))
        for i in range(len(mg))
    )
    print(f"parity beam: kept log-probs (down to {lowest!r}) max abs diff "
          f"{logp_err!r}, at most {logp_ratio!r} of the tolerance {BEAM_LOGP_ATOL} + "
          f"{BEAM_LOGP_RTOL} x |log-prob|; decoded rows equal {same}/{len(mg)} "
          "(reported, not checked: a near tie in the beam may flip on a 1e-6 "
          "difference)")
    check(logp_ratio <= 1.0, "beam parity: kept log-probs disagree")
    parity_device_beam(pg, ng, lm_dir, devices)


def ctc_logp_f64(logp, labels):
    """Exact ln P(labels | emissions) in float64 (the CTC forward)."""
    from speecht_tpu_torch import vocabulary

    blank = vocabulary.BLANK_ID
    ext = [blank]
    for lab in labels:
        ext += [lab, blank]
    S = len(ext)

    def ladd(x, y):
        if x == -math.inf:
            return y
        if y == -math.inf:
            return x
        m = max(x, y)
        return m + math.log1p(math.exp(min(x, y) - m))

    a = [-math.inf] * S
    a[0] = logp[0, ext[0]]
    if S > 1:
        a[1] = logp[0, ext[1]]
    for t in range(1, len(logp)):
        na = [-math.inf] * S
        for s in range(S):
            v = a[s]
            if s >= 1:
                v = ladd(v, a[s - 1])
            if s >= 2 and ext[s] != blank and ext[s] != ext[s - 2]:
                v = ladd(v, a[s - 2])
            na[s] = v + logp[t, ext[s]]
        a = na
    return ladd(a[S - 1], a[S - 2] if S > 1 else -math.inf)


def lm_bonus_f64(host_lm, labels, lm_weight, wc_weight, vwc_weight):
    """The fusion bonus of a whole hypothesis in float64: per word
    lm_weight ln 10 log10 P(w | the last 4 words) + the two counts."""
    from speecht_tpu_torch import vocabulary

    total, hist = 0.0, ""
    for w in (w for w in vocabulary.ids_to_sentence(labels).split(" ") if w):
        total += wc_weight + (vwc_weight if host_lm.has_word(w) else 0.0)
        total += lm_weight * math.log(10) * host_lm.score_word(hist, w)
        hist = " ".join((hist + " " + w).split()[-4:])
    return total


def parity_device_beam(logp, lengths, lm_dir, devices=("cuda", "cpu"),
                       weights=BEAM_WEIGHTS):
    """Phase 4f: the card's collapsed log-probs of phase 4d through the beam
    kernel on the card and the plain version on the CPU (width 100, top-k
    8, the phase-3d LM); every row decoded otherwise must be a near tie:
    its two hypotheses within BEAM_TIE_MARGIN under float64 rescoring."""
    from speecht_tpu_torch import native
    from speecht_tpu_torch.ops import beam_device

    arpa, vocab = os.path.join(lm_dir, "model.arpa"), os.path.join(lm_dir, "vocabulary")
    rows = []
    for name in devices:
        device = torch.device(name)
        fn = beam_device.make_device_beam_search(
            BEAM_WIDTH, lm=beam_device.DeviceLM(arpa, vocab, device=device))
        ids, lens = (t.cpu() for t in fn(torch.from_numpy(logp).to(device),
                                         torch.from_numpy(lengths).to(device), *weights))
        rows.append([ids[i, :lens[i]].tolist() for i in range(len(lengths))])
    host_lm = native.NGramLM(arpa, vocab)
    same, margins = 0, []
    for i, (g, c) in enumerate(zip(*rows)):
        if g == c:
            same += 1
            continue
        row = logp[i, :lengths[i]].astype(np.float64)
        sg = ctc_logp_f64(row, g) + lm_bonus_f64(host_lm, g, *weights)
        sc = ctc_logp_f64(row, c) + lm_bonus_f64(host_lm, c, *weights)
        margins.append(abs(sg - sc))
    print(f"parity device beam: B={len(lengths)}, {int(lengths.min())}-{int(lengths.max())} "
          f"kept frames, W={BEAM_WIDTH}, K={BEAM_TOP_K}: the kernel on the card and the "
          f"plain version on the CPU decode {same}/{len(lengths)} rows alike; the others' "
          f"float64 score margins {margins!r} (each below {BEAM_TIE_MARGIN})")
    check(all(m < BEAM_TIE_MARGIN for m in margins),
          "parity device beam: a row the card and the CPU decode otherwise is no near tie")


# phase 4e: the front end, card vs CPU, each float32. On this synthetic
# speech the float32 features are within 1e-4 of the host's float64 DSP
# (tests/test_torch_features.py), so two float32 sides may differ by
# about 2e-4; 1e-3 allows 5x more. The resample alone is held to JAX's own
# test tolerance against the host resampler (1e-5), which a product
# rounded to TF32 (10-bit mantissas: about 1e-4 here) misses.
FRONT_END_RTOL, FRONT_END_ATOL = 1e-3, 1e-3
RESAMPLE_ATOL = 1e-5
# the --device cache against the host cache: JAX's device-against-host
# feature tolerance (tests/test_features.py) plus one bfloat16 spacing of
# the value for the bf16 download
CACHE_RTOL, CACHE_ATOL = 1e-2, 1e-2


@contextlib.contextmanager
def tf32_matmuls():
    """TF32 on for float32 matmuls process-wide (the setting phase 4e
    proves the front end ignores), restored after."""
    matmul = torch.backends.cuda.matmul
    name, on, off = (("fp32_precision", "tf32", "ieee")
                     if hasattr(matmul, "fp32_precision")
                     else ("allow_tf32", True, False))
    setattr(matmul, name, on)
    try:
        yield f"torch.backends.cuda.matmul.{name} = {on!r}"
    finally:
        setattr(matmul, name, off)


def parity_audio(host_dir, device_dir, weights):
    """Phase 4e: the front end and the from-audio eval step on the card and
    on the CPU, and the --device cache against the host cache."""
    from speecht_tpu_torch.data import features_device
    from speecht_tpu_torch.data.pipeline import build_audio_batch, to_device
    from speecht_tpu_torch.data.reader import SpeechCorpusReader
    from speecht_tpu_torch.native import DEFAULT_SR
    from speecht_tpu_torch.ops import resample as resample_mod
    from speecht_tpu_torch.train.step import make_audio_eval_step

    batch = build_audio_batch(audio_samples(host_dir, n=8), audio_bucket(),
                              pad_to_batch=9)
    audio = {name: to_device(batch, torch.device(name)) for name in ("cuda", "cpu")}
    with tf32_matmuls() as setting, torch.inference_mode():
        x = {name: b.audio.float() / 32768.0 for name, b in audio.items()}
        with resample_mod.float32_matmuls():
            y = {name: resample_mod.batch_resample(v, AUDIO_SR, DEFAULT_SR).cpu()
                 for name, v in x.items()}
        err = float((y["cuda"] - y["cpu"]).abs().max())
        print(f"parity audio: {setting} process-wide; resample {AUDIO_SR} -> "
              f"{DEFAULT_SR} B=9 (one padding row) card vs CPU max abs diff {err!r} "
              f"(tolerance {RESAMPLE_ATOL})")
        check(err <= RESAMPLE_ATOL, "parity audio: the resample differs card vs CPU")
        for feature_type in ("power", "mfcc"):
            front_end = features_device.make_front_end(feature_type, wire_sr=AUDIO_SR)
            (fg, lg), (fc, lc) = (
                [t.cpu() for t in front_end(b.audio, b.num_samples)]
                for b in (audio["cuda"], audio["cpu"]))
            nan_equal = torch.equal(fg.isnan(), fc.isnan())
            ok = ~fc.isnan()
            diff = (fg[ok] - fc[ok]).abs()
            share = float((diff / (FRONT_END_ATOL + FRONT_END_RTOL * fc[ok].abs())).max())
            print(f"parity audio: {feature_type} features {tuple(fg.shape)} card vs CPU "
                  f"max abs diff {float(diff.max())!r}, at most {share!r} of the tolerance "
                  f"{FRONT_END_ATOL} + {FRONT_END_RTOL} x |value|; frame lengths equal "
                  f"{torch.equal(lg, lc)}; NaN where the CPU has NaN (the padding row) "
                  f"{nan_equal}")
            check(torch.equal(lg, lc) and nan_equal and share <= 1.0,
                  f"parity audio: {feature_type} features differ card vs CPU")

    torch.backends.cudnn.allow_tf32 = False
    outs = {}
    for name in ("cuda", "cpu"):
        model = lm_model(weights, torch.device(name), "float32")
        step = make_audio_eval_step(
            model, features_device.make_front_end("power", wire_sr=AUDIO_SR))
        loss, decoded, lengths = step(audio[name])
        outs[name] = (float(loss), decoded.cpu().numpy(), lengths.cpu().numpy())
    (lg, dg, ng), (lc, dc, nc) = outs["cuda"], outs["cpu"]
    total = sum(int(max(a, b)) for a, b in zip(ng, nc))
    same = sum(int((dg[i, :max(ng[i], nc[i])] == dc[i, :max(ng[i], nc[i])]).sum())
               for i in range(len(ng)))
    loss_rel = abs(lg - lc) / abs(lc)
    print(f"parity audio: eval step from audio, float32, TF32 off: loss cuda {lg!r} "
          f"cpu {lc!r} rel diff {loss_rel!r} (tolerance {PARITY_LOSS_RTOL}); decoded "
          f"tokens equal {same}/{total} (at least {PARITY_MIN_TOKEN_SHARE}); padding "
          f"row decoded lengths {ng[-1]} / {nc[-1]}")
    check(loss_rel <= PARITY_LOSS_RTOL, "parity audio: card and CPU losses disagree")
    check(same >= PARITY_MIN_TOKEN_SHARE * max(total, 1),
          "parity audio: card and CPU decodes disagree")
    check(ng[-1] == nc[-1] == 0, "parity audio: the padding row was decoded")

    host = SpeechCorpusReader(host_dir)._get_directory("power", "test")
    device = SpeechCorpusReader(device_dir)._get_directory("power", "test")
    names = sorted(os.listdir(host))
    check(names == sorted(os.listdir(device)), "the two caches hold other files")
    worst = 0.0
    for name in names:
        with np.load(os.path.join(host, name)) as a, np.load(os.path.join(device, name)) as b:
            check(a["audio_fragments"].shape == b["audio_fragments"].shape
                  and np.array_equal(a["transcript"], b["transcript"]),
                  f"cache {name}: shapes or transcripts differ")
            ref = torch.from_numpy(a["audio_fragments"])
            got = torch.from_numpy(b["audio_fragments"])
            bound = CACHE_ATOL + CACHE_RTOL * ref.abs() + bf16_spacing(ref)
            worst = max(worst, float(((got - ref).abs() / bound).max()))
    print(f"parity audio: the --device cache against the host cache, {len(names)} "
          f"files: at most {worst!r} of the tolerance {CACHE_ATOL} + {CACHE_RTOL} x "
          "|value| + one bfloat16 spacing")
    check(worst <= 1.0, "parity audio: the --device cache differs from the host cache")


# -- phase 5: the drills -------------------------------------------------------

# the drills' batches: B=16, time padded to a multiple of 128 frames (logit
# frames 64-320); the device train step is timed on the 512-frame bucket
DRILL_BATCH, DRILL_BUCKET, DRILL_STEP_BUCKET = 16, 128, 512
DRILL_LAUNCH_TIMEOUT_S = 600
# the beam weights of the drills' LM paths (lm, word count, valid word count)
DRILL_BEAM_WEIGHTS = (0.4, 0.0, 2.3)
DRILL_ROW_LINES = ("expected: ", "decoded: ", "LED: ")


def drill_ctc_shapes(device):
    """Phases 2 and 2b's comparisons at the drills' shapes (B=16, 64 and
    320 logit frames, labels of 6-28 letters in the label widths the
    128- and 640-frame buckets give)."""
    rng = np.random.RandomState(9)
    for name, T, L, frames in (("drill shape T=64", 64, 32, (59, 65)),
                               ("drill shape T=320", 320, 160, (60, 321))):
        inputs = ctc_inputs(8, B=DRILL_BATCH, T=T, L=L, label_range=(6, 29),
                            frame_range=frames)
        check_ctc(name, inputs, device, time_it=False, history=True)
        check_beta(name, inputs, rng.uniform(0.5, 1.5, DRILL_BATCH).astype(np.float32),
                   device, time_it=False)


@contextlib.contextmanager
def counted_cli(kernels):
    """Each CLI run of a drill (``synthetic_convergence.run_cli``, which
    both drills call) with the launch counts set to 0 just before and read
    just after; yields [(argv, counts)]."""
    from speecht_tpu_torch.tools import synthetic_convergence as module

    runs = []
    run_cli_ = module.run_cli

    def counted(argv):
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        out = run_cli_(argv)
        torch.cuda.synchronize()
        runs.append((argv, {k.name: k.launches for k in kernels}))
        return out

    module.run_cli = counted
    try:
        yield runs
    finally:
        module.run_cli = run_cli_


def drill_path_name(drill, argv):
    """``<drill>: evaluate --language-model --device-beam --rescore 8``..."""
    words = [argv[0]]
    for flag in ("--spec-augment", "--grad-accum", "--language-model", "--device-beam",
                 "--rescore"):
        if flag in argv:
            value = argv[argv.index(flag) + 1] if flag in ("--grad-accum", "--rescore") else ""
            words.append(f"{flag} {value}".strip())
    return f"{drill}: " + " ".join(words)


def print_drill_log(out, prefix="drills"):
    """A drill's output without the per-row lines of its evaluates."""
    for line in out.splitlines():
        if line and not line.startswith(DRILL_ROW_LINES):
            print(f"{prefix}: {line}")


def drill_model(root, run_name, device, train=False):
    """The full-width model and its train state restored from the drill's
    newest checkpoint under ``<root>/train/<run_name>``."""
    from speecht_tpu_torch.data.features import feature_size
    from speecht_tpu_torch.execution import build_model
    from speecht_tpu_torch.train.checkpoint import CheckpointManager
    from speecht_tpu_torch.train.state import create_train_state, make_optimizer

    model = build_model(feature_size("power"), types.SimpleNamespace()).to(device)
    tx = make_optimizer()
    state = create_train_state(dict(model.named_parameters()), tx, 3e-4)
    # the checkpoint's tensors are copied into the model's own parameters
    state = CheckpointManager(os.path.join(root, "train", run_name)).restore(state)
    return (model.train() if train else model.eval()), tx, state


def drill_samples(root, split):
    from speecht_tpu_torch.data.reader import SpeechCorpusReader

    return list(SpeechCorpusReader(os.path.join(root, "data")).load_samples(
        split, feature_type="power", seed=0))


def drill_device_step(root, period_ms, card, device=torch.device("cuda")):
    """The trained drill model's train step on one resident batch of the
    512-frame bucket (B=16) by CUDA events, beside the drill's period."""
    from speecht_tpu_torch.data.pipeline import build_batch, to_device
    from speecht_tpu_torch.train import step as tstep

    model, tx, state = drill_model(root, "synth", device, train=True)
    rows = [s for s in drill_samples(root, "train")
            if DRILL_STEP_BUCKET - DRILL_BUCKET < len(s[0]) <= DRILL_STEP_BUCKET]
    check(len(rows) >= DRILL_BATCH, f"drills: {len(rows)} rows in the 512-frame bucket")
    batch = to_device(build_batch(rows[:DRILL_BATCH], time_bucket=DRILL_BUCKET), device)
    step = tstep.make_train_step_acc(model, tx)
    box = [state, tstep.init_metrics_acc(device)]

    def one():
        box[0], box[1] = step(box[0], box[1], batch)

    ms = time_ms(one, iters=10, warmup=2)
    flop = 3 * FORWARD_FLOP_PER_UTT * DRILL_STEP_BUCKET / 1024 * DRILL_BATCH
    print(f"drills: train step (device) B={DRILL_BATCH} T={batch.features.shape[1]} bf16, "
          f"the trained model: {ms!r} ms by CUDA events, {flop / 1e12:.3f} TFLOP "
          f"(computed: 3 x 25.3 GFLOP x 512/1024 an utterance) = "
          f"{flop / (ms * 1e-3) / PEAK_BF16_OPS_PER_S * 100:.2f}% of 989 TFLOP/s dense "
          f"bf16; the drill's period {period_ms!r} ms/step (B={DRILL_BATCH}, buckets "
          f"128-640, step calls 2 to the last); on {card}")
    return ms


def drill_emissions(root, card, device=torch.device("cuda")):
    """The beams on the trained model's emissions: on one evaluate batch
    (B=16) the share of frames the blank collapse keeps, the beam kernel's
    ms (fused with the LM, and the n-best of ``--rescore 8``) by CUDA
    events and the host beam's and the rescoring path's ms on the host
    clock; then every held-out row through the host beam and the device
    beam, the rows decoded otherwise printed with their float64 scores."""
    from speecht_tpu_torch import native, vocabulary
    from speecht_tpu_torch.data.pipeline import build_batch, to_device
    from speecht_tpu_torch.ops.beam import BeamSearchDecoder, LanguageModelConfig
    from speecht_tpu_torch.tools.synthetic_corpus import WORDS

    model, _tx, _state = drill_model(root, "synth", device)
    lm_dir = os.path.join(root, "lm")
    lm_w, wc_w, vwc_w = DRILL_BEAM_WEIGHTS
    config = dict(language_model=lm_dir, lm_weight=lm_w, word_count_weight=wc_w,
                  valid_word_count_weight=vwc_w)
    host = BeamSearchDecoder(model, LanguageModelConfig(**config))
    fused = BeamSearchDecoder(model, LanguageModelConfig(**config, device_beam=True))
    rescore = BeamSearchDecoder(
        model, LanguageModelConfig(**config, device_beam=True, rescore_n=8))
    samples = drill_samples(root, "test")

    def host_ms(fn):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    try:
        batch = build_batch(samples[:DRILL_BATCH], time_bucket=DRILL_BUCKET)
        _loss, logp, lengths = fused.device_part(to_device(batch, device))
        host_lengths = lengths.cpu().numpy()
        kept = kept_share(lengths.cpu(), batch.seq_lengths)
        t_bucket = min(logp.shape[1], max(32, -(-int(host_lengths.max()) // 32) * 32))
        emissions = logp[:, :t_bucket].contiguous()
        fused_ms = time_ms(lambda: fused._beam_fn(emissions, lengths, *DRILL_BEAM_WEIGHTS),
                           iters=10)
        nbest_ms = time_ms(lambda: rescore._beam_fn(emissions, lengths, 0.0, 0.0, 0.0),
                           iters=10)
        host_logp = logp.cpu().numpy()
        host_beam_ms = host_ms(lambda: host.decode_emissions(host_logp, host_lengths))
        rescore_ms = host_ms(lambda: rescore.decode_emissions(logp, host_lengths))
        print(f"drills: trained emissions, one evaluate batch (B={DRILL_BATCH}, "
              f"T={batch.features.shape[1]}): the collapse keeps {kept!r} of the frames "
              f"({int(host_lengths.min())}-{int(host_lengths.max())} a row); --device-beam: "
              f"the beam kernel {fused_ms!r} ms a batch (W={BEAM_WIDTH}, K={BEAM_TOP_K}, "
              f"the order-1 LM of {len(WORDS)} words and <unk>, T={t_bucket}); "
              f"--rescore 8: the n-best kernel {nbest_ms!r} ms, the whole rescoring "
              f"decode {rescore_ms!r} ms (3 calls); the host beam {host_beam_ms!r} ms "
              f"a batch (3 calls, {host.num_threads} threads); on {card}")

        # every held-out row: the host beam against the device beam
        batch = build_batch(samples, time_bucket=DRILL_BUCKET)
        _loss, logp, lengths = fused.device_part(to_device(batch, device))
        host_lengths = lengths.cpu().numpy()
        all_kept = kept_share(lengths.cpu(), batch.seq_lengths)
        host_logp = logp.cpu().numpy()
        ids_h, len_h = host.decode_emissions(host_logp, host_lengths)
        ids_d, len_d = fused.decode_emissions(logp, host_lengths)
    finally:
        for decoder in (host, fused, rescore):
            decoder.close()
    host_lm = native.NGramLM(os.path.join(lm_dir, "model.arpa"),
                             os.path.join(lm_dir, "vocabulary"))
    differ = []
    for i in range(len(samples)):
        h, d = ids_h[i, :len_h[i]].tolist(), ids_d[i, :len_d[i]].tolist()
        if h == d:
            continue
        row = host_logp[i, :host_lengths[i]].astype(np.float64)
        scores = [ctc_logp_f64(row, x) + lm_bonus_f64(host_lm, x, *DRILL_BEAM_WEIGHTS)
                  for x in (h, d)]
        differ.append(i)
        expected = vocabulary.ids_to_sentence(batch.labels[i, :batch.label_lengths[i]])
        print(f"drills: row {i} decoded otherwise: expected {expected!r}; host beam "
              f"{vocabulary.ids_to_sentence(h)!r} (float64 score {scores[0]!r}); device "
              f"beam {vocabulary.ids_to_sentence(d)!r} ({scores[1]!r})")
    print(f"drills: trained emissions, all {len(samples)} held-out rows: the collapse "
          f"keeps {all_kept!r} of the frames; the host beam and the device beam decode "
          f"{len(samples) - len(differ)}/{len(samples)} rows alike")
    return {"kept_share": kept, "kept_share_all_rows": all_kept,
            "beam_kernel_ms": fused_ms, "nbest_kernel_ms": nbest_ms,
            "host_beam_ms": host_beam_ms, "rescore_decode_ms": rescore_ms,
            "rows_alike": len(samples) - len(differ)}


def drills_path(work, kernels, card):
    """Phase 5: ``speecht_tpu_torch.tools.synthetic_convergence`` and
    ``train_features_check`` at full width in ``<work>/drill*``, each
    CLI run's launch counts set to 0 just before and read just after;
    then the trained model's device train step and its emissions through
    the beams. Returns {path: launch counts}."""
    import functools

    from speecht_tpu_torch.tools import synthetic_convergence, train_features_check

    t_phase = time.perf_counter()
    drill_ctc_shapes(torch.device("cuda"))
    root = os.path.join(work, "drill")
    buf = io.StringIO()
    with counted_cli(kernels) as plain_runs, step_marks() as marks:
        with contextlib.redirect_stdout(buf):
            plain = synthetic_convergence.main(root=root)
    print_drill_log(buf.getvalue())
    period_ms = step_period_ms(marks)
    features_root = os.path.join(work, "drill_features")
    buf = io.StringIO()
    with counted_cli(kernels) as feature_runs:
        with contextlib.redirect_stdout(buf):
            features = train_features_check.main(
                root=features_root, launch=functools.partial(
                    train_features_check.signal_launch, timeout=DRILL_LAUNCH_TIMEOUT_S))
    print_drill_log(buf.getvalue())

    n_test = synthetic_convergence.N_TEST
    batches = -(-n_test // DRILL_BATCH)
    facts = features["relaunch"]
    runs = {}
    for drill, found in (("synthetic convergence", plain_runs),
                         ("train features", feature_runs)):
        for argv, n in found:
            name = drill_path_name(drill, argv)
            if argv[0] == "train":
                steps = int(argv[argv.index("--max-steps") + 1])
                if drill == "train features":
                    name += f" (relaunch at step {facts['crash_step']})"
                want = {"ctc_alpha": steps, "ctc_beta": steps, "conv0": 0, "beam_device": 0}
            else:
                want = {"ctc_alpha": batches, "ctc_beta": 0, "conv0": 0,
                        "beam_device": batches if "--device-beam" in argv else 0}
            runs[name] = n
            check(n == want, f"drills: {name} launched {n}, not {want}")
    # the plain drill's train and 4 evaluates; the relaunch and 1 evaluate
    check(len(plain_runs) == 5 and len(feature_runs) == 2,
          f"drills: counted the CLI runs {list(runs)}")
    print(f"drills: kernel launches {runs} (the first train-features launch runs in a "
          f"process of its own: its launches are that process's)")
    for key, path in (("greedy", "evaluate"), ("host_lm", "evaluate --language-model"),
                      ("device_lm", "evaluate --language-model --device-beam"),
                      ("rescore", "evaluate --language-model --device-beam --rescore 8")):
        r = plain[key]
        print(f"drills: synthetic convergence, held-out {path} ({r['rows']} rows): LER "
              f"{r['ler']!r} WER {r['wer']!r} (the CLI's sums in its read order: "
              f"{r['cli_ler']!r}, {r['cli_wer']!r}) in {r['seconds']!r} s")
    print(f"drills: synthetic convergence, train {len(marks)} steps in "
          f"{plain['train_seconds']!r} s with set-up; interval losses "
          f"{plain['interval_losses']}; gates {plain['gates']}")
    print(f"drills: train features, held-out greedy LER {features['ler']!r} WER "
          f"{features['wer']!r} (the CLI's: {features['cli_ler']!r}, "
          f"{features['cli_wer']!r}); relaunch: S={facts['crash_step']} (optimizer step "
          f"{facts['saved_optimizer_step']}), restored learning rate "
          f"{facts['restored_learning_rate']!r}, interval loss {facts['loss_before']} "
          f"before and {facts['loss_after']} after, optimizer step "
          f"{facts['final_optimizer_step']} at the end; interval losses "
          f"{facts['interval_losses']}; {facts['checks']}; seconds {features['seconds']}; "
          f"gates {features['gates']}")
    drill_device_step(root, period_ms, card)
    drill_emissions(root, card)
    print(f"drills: phase 5 wall time {time.perf_counter() - t_phase:.1f} s")
    check(plain["ok"], f"drills: a synthetic convergence gate failed: {plain['gates']}")
    check(features["ok"], f"drills: a train features gate failed: {features['gates']}")
    return runs

# -- phase 6a: the kernels under compute-sanitizer and the guard allocator -----

SANITIZER_TOOLS = ("memcheck", "synccheck", "racecheck")
SANITIZE_TIMEOUT_S = 600
SANITIZER_REFUSAL = "Device not supported"
SANITIZE_REPEATS = 8
SANITIZE_DONE = "sanitize worker: done"
# the guard allocator's poison: 0xFF bytes are a NaN in float32 and bf16
# and -1 in int32, so a read of memory no kernel wrote shows in a result
GUARD_SOURCE = r"""
// A CUDA allocator for torch.cuda.memory.CUDAPluggableAllocator that puts
// 64 KiB of poison (0xFF) before and after every allocation and poisons the
// allocation itself. Each free (and guard_check_all) reads both guards back
// after a device synchronize: a byte that changed is a write out of bounds.
#include <cuda_runtime.h>
#include <sys/types.h>
#include <cstdio>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {
constexpr size_t kGuard = 1 << 16;
constexpr unsigned char kPoison = 0xFF;
struct Block { char* base; size_t size; };
std::mutex mu;
std::unordered_map<void*, Block> live;
long long n_alloc = 0, n_checked = 0, n_bad = 0;
char first_bad[256] = "";

void check_block(void* user, const Block& b) {
  std::vector<unsigned char> host(kGuard);
  for (int side = 0; side < 2; ++side) {
    const char* dev = side ? b.base + kGuard + b.size : b.base;
    if (cudaMemcpy(host.data(), dev, kGuard, cudaMemcpyDeviceToHost) != cudaSuccess) {
      ++n_bad;
      snprintf(first_bad, sizeof first_bad, "cudaMemcpy of a guard failed");
      return;
    }
    for (size_t i = 0; i < kGuard; ++i) {
      if (host[i] != kPoison) {
        if (!n_bad++)
          snprintf(first_bad, sizeof first_bad,
                   "allocation %p of %zu bytes: byte %zu %s it is 0x%02x",
                   user, b.size, side ? i : kGuard - i, side ? "after" : "before",
                   host[i]);
        break;
      }
    }
  }
  ++n_checked;
}
}  // namespace

extern "C" void* guard_malloc(ssize_t size, int device, cudaStream_t stream) {
  char* base = nullptr;
  size_t total = (size_t)size + 2 * kGuard;
  if (cudaMalloc(&base, total) != cudaSuccess) return nullptr;
  cudaMemset(base, kPoison, total);
  cudaDeviceSynchronize();
  std::lock_guard<std::mutex> lock(mu);
  ++n_alloc;
  live[base + kGuard] = Block{base, (size_t)size};
  return base + kGuard;
}

extern "C" void guard_free(void* ptr, ssize_t size, int device, cudaStream_t stream) {
  cudaDeviceSynchronize();
  std::lock_guard<std::mutex> lock(mu);
  auto it = live.find(ptr);
  if (it == live.end()) {
    if (!n_bad++) snprintf(first_bad, sizeof first_bad, "free of unknown %p", ptr);
    return;
  }
  check_block(ptr, it->second);
  cudaFree(it->second.base);
  live.erase(it);
}

extern "C" long long guard_check_all() {
  cudaDeviceSynchronize();
  std::lock_guard<std::mutex> lock(mu);
  for (auto& kv : live) check_block(kv.first, kv.second);
  return n_bad;
}
extern "C" long long guard_allocations() { return n_alloc; }
extern "C" long long guard_checks() { return n_checked; }
extern "C" long long guard_violations() { return n_bad; }
extern "C" const char* guard_first_violation() { return first_bad; }
"""


def build_guard(work):
    """The guard allocator, compiled with nvcc into ``work``."""
    from speecht_tpu_torch.ops import cuda_build

    src = os.path.join(work, "guard_alloc.cu")
    lib = os.path.join(work, "libguard_alloc.so")
    with open(src, "w") as f:
        f.write(GUARD_SOURCE)
    proc = subprocess.run([cuda_build.nvcc(), "-O2", "-std=c++17", "-shared", "-Xcompiler",
                           "-fPIC", "-o", lib, src], capture_output=True, text=True,
                          timeout=300)
    check(proc.returncode == 0, f"the guard allocator did not build:\n{proc.stderr}")
    return lib


def sanitize_cases(device, lm_dir):
    """Each kernel at small shapes against its plain version (the checks of
    phases 2-2d without their timings): ctc_alpha (with and without the
    history) and ctc_beta on the edge rows and at B=4, conv0 bf16 and
    float32 at T=50 and T=1000, beam_device at B=4 with the phase-2d LM,
    its best path and its n-best. Returns the number of cases."""
    from speecht_tpu_torch.ops import beam_device

    small = ctc_inputs(10, B=4, T=64, L=24, label_range=(5, 24), frame_range=(30, 65))
    lm = beam_device.DeviceLM(os.path.join(lm_dir, "model.arpa"),
                              os.path.join(lm_dir, "vocabulary"), device=device)
    logp, lengths = beam_emissions(4, np.random.RandomState(4).randint(*BEAM_FRAMES, size=4))
    cases = [
        lambda: check_ctc("sanitize edge rows", edge_inputs(), device, time_it=False,
                          history=True),
        lambda: check_ctc("sanitize B=4", small, device, time_it=False, history=True),
        lambda: check_beta("sanitize edge rows", edge_inputs(), edge_grad(7), device,
                           time_it=False),
        lambda: check_beta("sanitize B=4", small, np.linspace(0.5, 1.5, 4).astype(np.float32),
                           device, time_it=False),
        *(lambda T=T, dtype=dtype: check_conv0(f"sanitize T={T}", 2, T, 128, 250, dtype,
                                               device, time_it=False)
          for T in (50, 1000) for dtype in (torch.bfloat16, torch.float32)),
        lambda: check_beam("sanitize B=4", lm, logp, lengths, device),
        lambda: check_beam("sanitize B=4 n_best=4", lm, logp, lengths, device, n_best=4),
    ]
    for case in cases:
        case()
    return len(cases)


def repeat_probe(device, lm_dir, repeats=SANITIZE_REPEATS):
    """Each kernel ``repeats`` times on the same inputs, every other call
    beside bf16 matmuls on a second stream that contend for the SMs (in
    this process: the guard allocator synchronizes the card at every
    allocation): every result bit-equal to the first (no kernel has
    atomics, so a difference is a race in a ring, a barrier or the beam's
    shared tables)."""
    from speecht_tpu_torch.ops import beam_device, conv0_cuda, ctc_cuda

    logits, logit_lengths, labels, label_lengths = (
        torch.from_numpy(a).to(device) for a in ctc_inputs(
            11, B=8, T=320, L=160, label_range=(20, 120), frame_range=(200, 321)))
    logp = torch.log_softmax(logits, dim=-1).contiguous()
    T, B, S = logp.shape[1], logp.shape[0], 2 * labels.shape[1] + 1
    g = torch.linspace(0.5, 1.5, B, device=device)

    def alpha():
        hist = torch.empty(T, B, S, device=device)
        loss = ctc_cuda.CTC_ALPHA(logp, logit_lengths, labels, label_lengths, hist)
        return loss, hist

    def beta():
        loss, hist = alpha()
        return ctc_cuda.CTC_BETA(logp, logit_lengths, labels, label_lengths, hist, loss, g)

    x, w, b = conv0_inputs(12, 2, 1000, 128, 250, torch.bfloat16, device)
    lm = beam_device.DeviceLM(os.path.join(lm_dir, "model.arpa"),
                              os.path.join(lm_dir, "vocabulary"), device=device)
    beam_fn = beam_device.make_device_beam_search(BEAM_WIDTH, lm=lm, prune_top_k=BEAM_TOP_K,
                                                  n_best=4)
    blogp, blengths = beam_emissions(5, np.random.RandomState(5).randint(*BEAM_FRAMES, size=4))
    bx, bn = torch.from_numpy(blogp).to(device), torch.from_numpy(blengths).to(device)
    side = torch.cuda.Stream(device)
    load = torch.randn(4096, 4096, device=device, dtype=torch.bfloat16)
    product = torch.empty_like(load)
    for name, fn in (("ctc_alpha", alpha), ("ctc_beta", beta),
                     ("conv0", lambda: conv0_cuda.CONV0(x, w, b)),
                     ("beam_device", lambda: beam_fn(bx, bn, *BEAM_WEIGHTS))):
        first = fn()
        first = first if isinstance(first, tuple) else (first,)
        differ = 0
        for i in range(repeats):
            if i % 2:
                side.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(side):
                    for _ in range(20):
                        torch.matmul(load, load, out=product)
            out = fn()
            out = out if isinstance(out, tuple) else (out,)
            torch.cuda.synchronize()
            differ += not all(torch.equal(a, c) for a, c in zip(first, out))
        print(f"sanitize repeat {name}: {repeats} calls, half of them beside matmuls on a "
              f"second stream: {repeats - differ}/{repeats} bit-equal to the first")
        check(differ == 0, f"sanitize: {name} differs from call to call")


def sanitize_worker(spec_path: str) -> int:
    """``--sanitize-worker SPEC``: the kernels of phase 6a in a process of
    their own; with a guard library in the spec every CUDA allocation goes
    through it (set before the first allocation), and the process ends
    without tearing down CUDA (``os._exit``) once the guards are checked."""
    with open(spec_path) as f:
        spec = json.load(f)
    guard = None
    if spec.get("guard_lib"):
        import ctypes

        torch.cuda.memory.change_current_allocator(torch.cuda.memory.CUDAPluggableAllocator(
            spec["guard_lib"], "guard_malloc", "guard_free"))
        guard = ctypes.CDLL(spec["guard_lib"])
        for fn in ("guard_check_all", "guard_allocations", "guard_checks",
                   "guard_violations"):
            getattr(guard, fn).restype = ctypes.c_longlong
        guard.guard_first_violation.restype = ctypes.c_char_p
    os.environ["SPEECHT_DEVICE_LM_CACHE"] = spec["device_lm_cache"]
    device = torch.device("cuda")
    cases = sanitize_cases(device, spec["lm_dir"])
    if guard is not None:
        bad = guard.guard_check_all()
        print(f"sanitize guard allocator: {guard.guard_allocations()} allocations, "
              f"{guard.guard_checks()} guard checks, {bad} out-of-bounds writes"
              + (f" (first: {guard.guard_first_violation().decode()})" if bad else ""))
        check(bad == 0, "sanitize: a kernel wrote outside its allocations")
    print(f"{SANITIZE_DONE}: {cases} kernel cases equal to their plain versions", flush=True)
    if guard is not None:
        os._exit(0)
    return 0


def sanitizer_binary():
    from speecht_tpu_torch.ops import cuda_build

    path = os.path.join(os.path.dirname(cuda_build.nvcc()), "compute-sanitizer")
    check(os.access(path, os.X_OK), f"compute-sanitizer is not beside nvcc ({path})")
    return path


def run_sanitize_worker(work, spec, name, prefix=()):
    """The worker under ``prefix`` (a sanitizer's command line, with the
    caching allocator off: it would hide an overrun inside its pool); its
    output goes to ``<work>/sanitize-<name>.log``. Returns (exit code,
    output)."""
    spec_path = os.path.join(work, f"sanitize-{name}.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, **({"PYTORCH_NO_CUDA_MEMORY_CACHING": "1"} if prefix else {}))
    proc = subprocess.run([*prefix, sys.executable, os.path.abspath(__file__),
                           "--sanitize-worker", spec_path], env=env, capture_output=True,
                          text=True, timeout=SANITIZE_TIMEOUT_S)
    out = proc.stdout + proc.stderr
    with open(os.path.join(work, f"sanitize-{name}.log"), "w") as f:
        f.write(out)
    return proc.returncode, out


def sanitize_phase(work, lm_dir, card):
    """Phase 6a: the sanitize worker under compute-sanitizer's memcheck,
    synccheck and racecheck, then under the guard allocator with the repeat
    probe. A sanitizer's report of an error fails the run (racecheck's
    hazards are printed); a sanitizer that refuses the card is reported as
    such, and the guard run, which needs no tool, is the check that runs.
    Returns {tool: verdict}."""
    import concurrent.futures

    t_phase = time.perf_counter()
    spec = {"lm_dir": lm_dir, "device_lm_cache": os.environ["SPEECHT_DEVICE_LM_CACHE"]}
    binary = sanitizer_binary()
    version = subprocess.run([binary, "--version"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
    print(f"sanitize: {binary} ({version[-1] if version else 'no version'})")
    verdicts = {}

    def under(tool):
        t0 = time.perf_counter()
        flags = ["--tool", tool] + ([] if tool == "racecheck" else ["--error-exitcode", "1"])
        return (*run_sanitize_worker(work, spec, tool, (binary, *flags)),
                time.perf_counter() - t0)

    # the three tools' workers side by side (each a process of its own)
    with concurrent.futures.ThreadPoolExecutor(len(SANITIZER_TOOLS)) as pool:
        runs = list(pool.map(under, SANITIZER_TOOLS))
    for tool, (code, out, seconds) in zip(SANITIZER_TOOLS, runs):
        report = [ln for ln in out.splitlines() if ln.startswith("========")]
        for line in [ln for ln in report if "Host Frame" not in ln][:30]:
            print(f"sanitize {tool}: {line}")
        refused = [ln for ln in report if SANITIZER_REFUSAL in ln]
        passed = SANITIZE_DONE in out
        if refused:
            verdicts[tool] = f"not run: the tool refused this card ({refused[0].strip('= ')})"
        elif tool == "racecheck" and passed:
            summary = [ln for ln in report if "RACECHECK SUMMARY" in ln]
            verdicts[tool] = summary[-1].strip("= ") if summary else "no hazard reported"
        else:
            check(code == 0 and passed, f"sanitize: {tool} reported errors or the worker "
                  f"failed (exit {code}); see the lines above")
            verdicts[tool] = "no error"
        print(f"sanitize {tool}: {verdicts[tool]} ({seconds:.1f} s, the three side by side)")
    t0 = time.perf_counter()
    code, out = run_sanitize_worker(
        work, {**spec, "guard_lib": build_guard(work)}, "guard")
    for line in out.splitlines():
        if line.startswith(("sanitize ", "ctc_", "conv0 ", "beam_device ")):
            print(f"sanitize guard: {line}")
    check(code == 0 and SANITIZE_DONE in out,
          f"sanitize: the guard run failed (exit {code}):\n{out[-3000:]}")
    verdicts["guard allocator"] = "no out-of-bounds write, every case equal to its plain version"
    print(f"sanitize: guard run {time.perf_counter() - t0:.1f} s")
    repeat_probe(torch.device("cuda"), lm_dir)
    verdicts["repeat probe"] = f"{SANITIZE_REPEATS} calls a kernel bit-equal"
    print(f"sanitize: phase 6a wall time "
          f"{time.perf_counter() - t_phase:.1f} s; {verdicts}; on {card}")
    return verdicts


# -- phase 6b: the native sanitizer drill ---------------------------------------


def sanitizer_flacs(directory):
    """Short 16-bit FLACs in every layout ``write_flac`` writes: FIXED
    orders 0-4 and verbatim (mono, 16 kHz) and each stereo mode (22.05
    kHz), 5000 samples in blocks of 1152 (the last one short)."""
    rng = np.random.RandomState(0)
    mono = synthetic_speech(rng, 5000)
    stereo = np.stack([mono, synthetic_speech(rng, 5000)], 1)
    paths = []
    for order in range(5):
        paths.append(os.path.join(directory, f"fixed{order}.flac"))
        write_flac(paths[-1], mono, 16000, order=order, block_size=1152, partition_order=2)
    paths.append(os.path.join(directory, "verbatim.flac"))
    write_flac(paths[-1], mono, 16000, subframe="verbatim", block_size=1152)
    for mode in ("independent", "left_side", "right_side", "mid_side"):
        paths.append(os.path.join(directory, f"stereo_{mode}.flac"))
        write_flac(paths[-1], stereo, 22050, block_size=1152, stereo=mode)
    return paths


def start_native_sanitize(work):
    """Phase 6b, started: ``python -m speecht_tpu_torch.tools.native_sanitize_check``
    on ``sanitizer_flacs`` in a process of its own (g++ builds beside the
    phase-6a runs). Returns (the process, its start time)."""
    directory = os.path.join(work, "asan")
    os.makedirs(directory)
    flacs = sanitizer_flacs(directory)
    env = dict(os.environ, TMPDIR=directory)
    proc = subprocess.Popen(
        [sys.executable, "-m", "speecht_tpu_torch.tools.native_sanitize_check", "--flac",
         *flacs], cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, time.perf_counter()


def finish_native_sanitize(started, card):
    """Phase 6b, joined: the drill's summary lines; it must print ``ALL ASAN
    CHECKS PASSED`` and exit 0."""
    from speecht_tpu_torch.tools import native_sanitize_check

    proc, t0 = started
    try:
        out, _ = proc.communicate(timeout=SANITIZE_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    for line in out.splitlines():
        if line.startswith(("fuzz ", "calls: ", "crc32c ", "lm ok", "kenlm dump", "beam ok",
                            "npz ok", "the sanitizer", "ALL ")) or "runtime error" in line \
                or "AddressSanitizer" in line:
            print(f"native sanitize: {line}")
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True).stdout
    print(f"native sanitize: {gxx.splitlines()[0] if gxx else 'g++'}; exit {proc.returncode}; "
          f"phase 6b wall time {time.perf_counter() - t0:.1f} s (beside phase 6a)")
    check(proc.returncode == 0 and native_sanitize_check.PASSED in out.splitlines(),
          f"native sanitize: the drill failed:\n{out[-3000:]}")


# -- phase 7: the hard corpus on the card ---------------------------------------

HARD_N_TEST = 128
# the pilot's batch and buckets, and its LM weights (lm, word count, valid word)
HARD_BATCH, HARD_BUCKET = 64, 256
HARD_BEAM_WEIGHTS = (0.6, 0.0, 2.3)
# JAX's pilot reached greedy dev LER 0.05 at step 1500, 0.73 before the
# alignment set in at step 1000 (TPU record): below 0.5 says it set in
HARD_GREEDY_LER_GATE = 0.5
HARD_SEARCH_SEED = 16


def hard_args(root):
    """The pilot's arguments: JAX's defaults, a test split, kept in ``root``."""
    from speecht_tpu_torch.tools import hard_corpus

    return hard_corpus.parse_args(["pilot", "--n-test", str(HARD_N_TEST), "--keep", root])


def timed_hard_corpus(root):
    """``hard_corpus.write_pilot_corpus`` at the pilot's arguments (in a
    process of its own, beside phases 6a and 6b); returns (its statistics,
    seconds, its log)."""
    from speecht_tpu_torch.tools import hard_corpus

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        stats = hard_corpus.write_pilot_corpus(root, hard_args(root))
    return stats, time.perf_counter() - t0, buf.getvalue()


def hard_device_step(root, card, device=torch.device("cuda")):
    """The pilot's trained model's train step on the 64 longest training
    rows, padded to their 256-frame bucket (the largest), by CUDA events."""
    from speecht_tpu_torch.data.pipeline import build_batch, to_device
    from speecht_tpu_torch.train import step as tstep

    model, tx, state = drill_model(root, "pilot", device, train=True)
    rows = sorted(drill_samples(root, "train"), key=lambda s: len(s[0]))[-HARD_BATCH:]
    batch = to_device(build_batch(rows, time_bucket=HARD_BUCKET), device)
    step = tstep.make_train_step_acc(model, tx)
    box = [state, tstep.init_metrics_acc(device)]

    def one():
        box[0], box[1] = step(box[0], box[1], batch)

    ms = time_ms(one, iters=5, warmup=2)
    T = batch.features.shape[1]
    flop = 3 * FORWARD_FLOP_PER_UTT * T / 1024 * HARD_BATCH
    print(f"hard: train step (device) B={HARD_BATCH} T={T} bf16 (the largest bucket; "
          f"rows of {len(rows[0][0])}-{len(rows[-1][0])} frames), the trained model, no "
          f"SpecAugment: {ms!r} ms by CUDA events, {flop / 1e12:.3f} TFLOP (computed: 3 x "
          f"25.3 GFLOP x {T}/1024 an utterance) = "
          f"{flop / (ms * 1e-3) / PEAK_BF16_OPS_PER_S * 100:.2f}% of 989 TFLOP/s dense bf16; "
          f"on {card}")
    return ms


def hard_emissions(root, card, device=torch.device("cuda")):
    """The trained model's emissions on one dev batch of 64: the share of
    frames the blank collapse keeps and the beam kernel's ms (the pilot's
    LM weights, W=100, K=8) by CUDA events."""
    from speecht_tpu_torch.data.pipeline import build_batch, to_device
    from speecht_tpu_torch.ops.beam import BeamSearchDecoder, LanguageModelConfig

    model, _tx, _state = drill_model(root, "pilot", device)
    lm_w, wc_w, vwc_w = HARD_BEAM_WEIGHTS
    fused = BeamSearchDecoder(model, LanguageModelConfig(
        language_model=os.path.join(root, "lm"), lm_weight=lm_w, word_count_weight=wc_w,
        valid_word_count_weight=vwc_w, device_beam=True))
    try:
        batch = build_batch(drill_samples(root, "dev")[:HARD_BATCH], time_bucket=HARD_BUCKET)
        _loss, logp, lengths = fused.device_part(to_device(batch, device))
        host_lengths = lengths.cpu().numpy()
        kept = kept_share(lengths.cpu(), batch.seq_lengths)
        t_bucket = min(logp.shape[1], max(32, -(-int(host_lengths.max()) // 32) * 32))
        emissions = logp[:, :t_bucket].contiguous()
        ms = time_ms(lambda: fused._beam_fn(emissions, lengths, *HARD_BEAM_WEIGHTS), iters=10)
    finally:
        fused.close()
    print(f"hard: trained emissions, one dev batch (B={HARD_BATCH}, T={batch.features.shape[1]}"
          f"): the collapse keeps {kept!r} of the frames ({int(host_lengths.min())}-"
          f"{int(host_lengths.max())} a row); the beam kernel {ms!r} ms a batch (W="
          f"{BEAM_WIDTH}, K={BEAM_TOP_K}, the corpus's unigram LM, weights "
          f"{HARD_BEAM_WEIGHTS}, T={t_bucket}; "
          f"{ms * 1e3 / max(int(host_lengths.max()), 1):.2f} µs a frame of the longest "
          f"row); on {card}")
    return {"kept_share": kept, "beam_kernel_ms": ms,
            "kept_frames": (int(host_lengths.min()), int(host_lengths.max()))}


def hard_launches(drill, found, labels, seg, generations):
    """{path: launch counts} of phase 7's CLI runs (each path named with
    its label from ``labels``), each checked: ``ctc_alpha`` and ``ctc_beta``
    once a train micro-step, ``ctc_alpha`` once an evaluate batch (2 of 64
    on dev and on test) and once a dev batch of ``search``, ``beam_device``
    once a ``--device-beam`` batch and once a candidate's batch, conv0
    never."""
    check(len(found) == len(labels), f"hard: {len(found)} CLI runs of {drill}, not "
          f"{len(labels)}")
    runs = {}
    for (argv, n), label in zip(found, labels):
        name = drill_path_name(drill, argv) + (f" ({label})" if label else "")
        if argv[0] == "train":
            want = {"ctc_alpha": seg, "ctc_beta": seg, "conv0": 0, "beam_device": 0}
        else:
            beams = 2 * (generations + 1) if argv[0] == "search" else 2
            want = {"ctc_alpha": 2, "ctc_beta": 0, "conv0": 0,
                    "beam_device": beams if "--device-beam" in argv else 0}
        runs[name] = n
        check(n == want, f"hard: {name} launched {n}, not {want}")
    return runs


def hard_path(work, root, corpus, kernels, card):
    """Phase 7: ``hard_corpus.run_pilot`` on the corpus ``timed_hard_corpus``
    wrote under ``root`` (1500 steps in 3 segments at full width from the
    port's seeded initial weights), then ``hard_search_drill.run`` with
    ``--device-beam`` on it, each CLI run's launch counts set to 0 just
    before and read just after; then the trained model's device step at
    the largest bucket and its emissions. Gates: the drill's two, and the
    pilot's final greedy dev LER below ``HARD_GREEDY_LER_GATE``. Returns
    {path: launch counts}."""
    import random

    from speecht_tpu_torch.tools import hard_corpus, hard_search_drill

    t_phase = time.perf_counter()
    stats, corpus_s, corpus_log = corpus
    for line in corpus_log.splitlines():
        print(f"hard: {line}")
    print(f"hard: corpus {json.dumps(stats)} under {root}: {corpus_s:.1f} s in a process of "
          f"its own beside phases 6a and 6b")
    args = hard_args(root)
    seg = args.steps // args.segments
    buf = io.StringIO()
    t0 = time.perf_counter()
    with counted_cli(kernels) as pilot_runs, step_marks() as marks:
        with contextlib.redirect_stdout(buf):
            pilot = hard_corpus.run_pilot(root, args)
    pilot_s = time.perf_counter() - t0
    print_drill_log(buf.getvalue(), "hard")
    random.seed(HARD_SEARCH_SEED)
    np.random.seed(HARD_SEARCH_SEED)
    print(f"hard: the search's mutations seeded: random.seed({HARD_SEARCH_SEED}), "
          f"np.random.seed({HARD_SEARCH_SEED})")
    drill_args = hard_search_drill.parse_args(["--root", root, "--device-beam"])
    buf = io.StringIO()
    t0 = time.perf_counter()
    with counted_cli(kernels) as drill_runs, contextlib.redirect_stdout(buf):
        drill = hard_search_drill.run(drill_args)
    drill_s = time.perf_counter() - t0
    print_drill_log(buf.getvalue(), "hard")

    pilot_labels = [label for k in range(1, args.segments + 1)
                    for label in (f"segment {k}", f"after segment {k}")] + ["final", ""]
    runs = hard_launches("hard pilot", pilot_runs, pilot_labels, seg, drill_args.generations)
    runs.update(hard_launches("hard search drill", drill_runs,
                              ["", "seed weights", "found weights"], seg,
                              drill_args.generations))
    print(f"hard: kernel launches {runs}")
    check(len(marks) == args.steps, f"hard: {len(marks)} train steps, not {args.steps}")
    for i, s in enumerate(pilot["segments"]):
        seg_marks = marks[i * seg:(i + 1) * seg]
        period = step_period_ms(seg_marks) if len(seg_marks) > 2 else None
        d = s["dev"]
        print(f"hard: segment {i + 1}: checkpoint at global step {s['global_step']}, "
              f"optimizer step {s['optimizer_step']}, learning rate {s['learning_rate']!r}; "
              f"interval losses {s['interval_losses']}; {s['train_seconds']!r} s with set-up, "
              f"period {period!r} ms/step; greedy dev LER {d['ler']!r} WER {d['wer']!r} "
              f"(the CLI's {d['cli_ler']!r}, {d['cli_wer']!r})")
    g, lm = pilot["greedy"], pilot["beam_lm"]
    print(f"hard: pilot dev ({g['rows']} rows): greedy LER {g['ler']!r} WER {g['wer']!r}; "
          f"beam + LM (--device-beam, weights {HARD_BEAM_WEIGHTS}) LER {lm['ler']!r} WER "
          f"{lm['wer']!r} (the CLI's: {g['cli_ler']!r} / {g['cli_wer']!r}, {lm['cli_ler']!r} / "
          f"{lm['cli_wer']!r}); {g['seconds']!r} s and {lm['seconds']!r} s")
    seed, best = drill["test_runs"]["seed"], drill["test_runs"]["best"]
    print(f"hard: search drill: dev score seed {drill['seed']['score']!r} -> best "
          f"{drill['best']['score']!r} at lm={drill['best']['lm_weight']!r} wc="
          f"{drill['best']['word_count_weight']!r} vwc="
          f"{drill['best']['valid_word_count_weight']!r}; best so far "
          f"{drill['best_score_trajectory']}; test ({seed['rows']} rows) seed LER "
          f"{seed['ler']!r} WER {seed['wer']!r}, found LER {best['ler']!r} WER "
          f"{best['wer']!r} (the CLI's: {seed['cli_ler']!r} / {seed['cli_wer']!r}, "
          f"{best['cli_ler']!r} / {best['cli_wer']!r}); gates {drill['gates']}")
    step_ms = hard_device_step(root, card)
    emissions = hard_emissions(root, card)
    train_s = sum(s["train_seconds"] for s in pilot["segments"])
    print(f"hard: wall times: corpus {corpus_s:.1f} s (beside phase 6), training "
          f"{train_s:.1f} s, the pilot {pilot_s:.1f} s, search {drill['search_wall_s']} s, "
          f"the drill {drill_s:.1f} s; phase 7 {time.perf_counter() - t_phase:.1f} s")
    check(drill["ok"], f"hard: a search drill gate failed: {drill['gates']}")
    check(g["ler"] < HARD_GREEDY_LER_GATE,
          f"hard: the pilot's greedy dev LER {g['ler']!r} is not below {HARD_GREEDY_LER_GATE}")
    return runs, {"device_step_ms": step_ms, **emissions}


# -- phase 8: the device beam on a 10^7-n-gram LM ------------------------------

# large_lm_probe.py's defaults; a budget below the tables' ~0.5 GiB
LARGE_LM_NGRAMS, LARGE_LM_VOCAB = 10_000_000, 100_000
LARGE_LM_BUDGET_GB = "0.25"


def timed_large_lm(root, cache_dir):
    """``large_lm_probe.synthesize`` at the probe's defaults under
    ``root`` (a PROBING binary alone in it), then the tables built cold
    into ``cache_dir`` (the npz every later load reads), in a process of
    its own beside phases 6a, 6b and 9. Returns (the binary, the facts, the wall
    seconds, the log)."""
    from speecht_tpu_torch.ops import beam_device
    from speecht_tpu_torch.tools import large_lm_probe

    t0 = time.perf_counter()
    os.makedirs(root, exist_ok=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        binary, facts = large_lm_probe.synthesize(root, LARGE_LM_NGRAMS, LARGE_LM_VOCAB)
        t1 = time.perf_counter()
        meta, tables = beam_device._cached_np_tables(binary, None, cache_dir)
        facts["cold_build_s"] = time.perf_counter() - t1
    facts.update({k: bool(meta[k]) for k in ("arena_two_choice", "words_two_choice")})
    facts["table_bytes"] = sum(int(a.size) * 4 for a in tables.values())
    return binary, facts, time.perf_counter() - t0, buf.getvalue()


def large_lm_path(work, built, data_dir, lm_weights, kernels, card,
                  device=torch.device("cuda")):
    """Phase 8: the 10^7-n-gram LM that ``timed_large_lm`` built: the warm
    load (gated on both two-choice flags), the probe's scorer check, the
    beam kernel against its plain version on the probe's emissions with
    this LM (and n-best 8), the tiny LM and no LM, each timed, the split
    of a frame, then ``evaluate --language-model --device-beam`` on it
    through the CLI and with ``--device-lm-hbm-gb 0.25`` (the host beam).
    Returns ({path: launch counts}, the large-LM facts)."""
    from speecht_tpu_torch.ops import beam_device
    from speecht_tpu_torch.tools import large_lm_probe

    t_phase = time.perf_counter()
    binary, facts, build_s, log = built
    for line in log.splitlines():
        print(f"large LM: {line}")
    print(f"large LM: {binary}: {os.path.getsize(binary)} bytes; tables built cold in "
          f"{facts['cold_build_s']!r} s ({facts['table_bytes']} bytes, arena two-choice "
          f"{facts['arena_two_choice']}, words two-choice {facts['words_two_choice']}); "
          f"{build_s:.1f} s in a process of its own beside phases 6a, 6b and 9")
    t0 = time.perf_counter()
    lm = beam_device.DeviceLM.cached(binary, device=device)
    large_lm_probe.sync(lm)
    warm_s = time.perf_counter() - t0
    print(f"large LM: warm load (the npz and the upload, synchronised) {warm_s!r} s: "
          f"{lm_tables(lm)} ({lm.hbm_bytes() / 1e6:.1f} MB on the card); on {card}")
    check(lm.arena_two_choice and lm.words_two_choice,
          "large LM: two-choice placement is off at 10^7 n-grams")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        checked, bad = large_lm_probe.spot_check(lm, binary)
    print(f"large LM: {buf.getvalue().strip()}")
    check(checked == 30 and bad == 0, f"large LM: the scorer disagrees on {bad} of {checked}")

    lm_dir = os.path.dirname(binary)
    tiny_dir = os.path.join(work, "tiny_lm")
    os.makedirs(tiny_dir)
    with open(os.path.join(tiny_dir, "model.arpa"), "w") as f:
        f.write(large_lm_probe.TINY_ARPA)
    tiny_lm = beam_device.DeviceLM(os.path.join(tiny_dir, "model.arpa"), device=device)
    logp, lengths = large_lm_probe.probe_emissions()
    weights = large_lm_probe.BEAM_WEIGHTS
    main = check_beam("10^7-n-gram LM", lm, logp, lengths, device, weights=weights,
                      lm_dir=lm_dir, time_it=True)
    nbest = check_beam("10^7-n-gram LM, n_best=8", lm, logp, lengths, device, n_best=8,
                       weights=weights)
    check(nbest["scores_bit_equal"], "large LM: the n-best scores are not bit-equal")
    tiny = check_beam("tiny LM", tiny_lm, logp, lengths, device, weights=weights,
                      lm_dir=tiny_dir, time_it=True)
    no_lm = check_beam("no LM, the probe's emissions", None, logp, lengths, device,
                       weights=weights, time_it=True)
    split = beam_split("10^7-n-gram LM", lm, logp, lengths, device, weights=weights)
    split_tiny = beam_split("tiny LM", tiny_lm, logp, lengths, device, weights=weights)
    T = logp.shape[1]
    lm_share = (main["ms"] - no_lm["ms"]) / main["ms"]
    print(f"large LM: the beam kernel at B={len(lengths)} T={T} W={BEAM_WIDTH} K={BEAM_TOP_K}: "
          f"{main['ms']!r} ms with the 10^7-n-gram LM ({main['ms'] * 1e3 / T:.3f} µs a "
          f"frame, {len(lengths) / main['ms'] * 1e3:.1f} utt/s), tiny LM {tiny['ms']!r} "
          f"({tiny['ms'] * 1e3 / T:.3f}), no LM {no_lm['ms']!r} ({no_lm['ms'] * 1e3 / T:.3f}); "
          f"the LM's share {lm_share:.3f}, the large tables' cost over the tiny LM's "
          f"{main['ms'] - tiny['ms']!r} ms; bound {main['bound_ms']!r} ms "
          f"({main['bound_by']}); plain {main['plain_ms']!r} ms; on {card}")

    runs = {}
    name = "evaluate --language-model --device-beam (10^7 n-grams)"
    runs[name], cli_ms, _out = lm_eval_path(work, data_dir, lm_weights, lm_dir, kernels,
                                            card, "--device-beam", beam_launches=LM_STEPS)
    fallback, _ms, out = lm_eval_path(
        work, data_dir, lm_weights, lm_dir, kernels, card, "--device-beam",
        "--device-lm-hbm-gb", LARGE_LM_BUDGET_GB, steps=1, beam_launches=0)
    message = [ln for ln in out.splitlines() if "falling back to the host beam" in ln]
    check(bool(message) and "--device-lm-hbm-gb" in message[0],
          f"large LM: --device-lm-hbm-gb {LARGE_LM_BUDGET_GB} printed no budget message")
    print(f"large LM: --device-lm-hbm-gb {LARGE_LM_BUDGET_GB}: {message[0]}")
    runs[f"evaluate --device-beam --device-lm-hbm-gb {LARGE_LM_BUDGET_GB} (10^7 n-grams, "
         "the host beam)"] = fallback
    print(f"large LM: phase 8 wall time {time.perf_counter() - t_phase:.1f} s (the LM's "
          f"build {build_s:.1f} s beside phases 6a, 6b and 9)")
    return runs, {
        "shape": main["shape"], "ms": main["ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "plain_ms": main["plain_ms"],
        "host_beam_ms": main["host_beam_ms"], "no_lm_ms": no_lm["ms"],
        "tiny_lm_ms": tiny["ms"], "lm_share": lm_share,
        "us_per_frame": main["ms"] * 1e3 / T, "hbm_mb": lm.hbm_bytes() / 1e6,
        "arena_buckets": int(lm.tables["arena_k"].shape[0]),
        "arena_two_choice": lm.arena_two_choice, "words_two_choice": lm.words_two_choice,
        "split_us_per_frame": {"10^7-n-gram LM": split, "tiny LM": split_tiny},
        "warm_load_s": warm_s, "cold_build_s": facts["cold_build_s"],
        "evaluate_device_beam_ms_per_batch": cli_ms,
    }


# -- phase 9: the multi-process drill ---------------------------------------------

MP_DRILL_TIMEOUT_S = 900


def drill_launch_wants(summary):
    """{kernel: launches} each rank of a drill launch must report (None
    for a rank that may have reported nothing or stopped early: the
    SIGTERM run's)."""
    argv = summary["argv"]
    if summary["name"].startswith("killmp") and not summary["name"].endswith("_resume"):
        return [None] * summary["ranks"]
    if argv[0] == "train":
        steps = int(argv[argv.index("--max-steps") + 1])
        want = {"ctc_alpha": steps, "ctc_beta": steps, "conv0": 0, "beam_device": 0}
    else:
        want = {"ctc_alpha": 1, "ctc_beta": 0, "conv0": 0, "beam_device": 0}
    return [want] * summary["ranks"]


def start_multiprocess_drill(work):
    """Phase 9, started: ``python -m speecht_tpu_torch.tools.multiprocess_drill``
    at full width in a process group of its own (beside phases 6a and 6b),
    its ranks sharing the card. Returns (the process, its log's path, its
    start time)."""
    log_path = os.path.join(work, "mp_drill.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "speecht_tpu_torch.tools.multiprocess_drill",
             "--root", os.path.join(work, "mp_drill")],
            stdout=log, stderr=subprocess.STDOUT,
            cwd=os.path.dirname(os.path.abspath(__file__)), start_new_session=True)
    return proc, log_path, time.perf_counter()


def finish_multiprocess_drill(started, kernels, card):
    """Phase 9, joined. Gates: exit code 0 and every PASS line; each
    launch's ranks' kernel launches (every complete train launch
    ``ctc_alpha`` and ``ctc_beta`` once a micro-batch on every rank, an
    evaluate ``ctc_alpha`` once, conv0 and ``beam_device`` never; the
    SIGTERM run's signalled rank stopped between its first step and its
    last). Returns ({path: launch counts summed over the ranks}, the
    launches' summaries)."""
    from speecht_tpu_torch.tools import multiprocess_drill

    proc, log_path, t_phase = started
    try:
        code = proc.wait(timeout=max(MP_DRILL_TIMEOUT_S - (time.perf_counter() - t_phase), 1))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.wait()
        code = None
    with open(log_path) as f:
        out = f.read()
    summaries = []
    for line in out.splitlines():
        if line.startswith('{"multiprocess_drill"'):
            summaries = json.loads(line)["multiprocess_drill"]
        else:
            print(f"mp drill: {line}")
    check(code == 0, f"mp drill: exit code {code} (time limit {MP_DRILL_TIMEOUT_S} s)")
    for line in multiprocess_drill.PASS_LINES:
        check(line in out, f"mp drill: no '{line}' line")
    runs = {}
    for s in summaries:
        wants = drill_launch_wants(s)
        ranks = s["ranks"]
        if ranks > 1:
            check(s["backend"].startswith("gloo, device cuda:0;")
                  and f"{ranks} ranks share cuda:0" in s["backend"],
                  f"mp drill: {s['name']}: backend {s['backend']}")
        for r, (got, want) in enumerate(zip(s["launches"], wants)):
            if want is not None:
                check(got == want, f"mp drill: {s['name']} rank {r} launched {got}, not {want}")
        if s["name"].startswith("killmp") and not s["name"].endswith("_resume"):
            signalled = s["launches"][1]
            check(signalled is not None and 1 <= signalled["ctc_alpha"] == signalled["ctc_beta"]
                  < multiprocess_drill.KILL_STEPS,
                  f"mp drill: the signalled rank of {s['name']} launched {signalled}")
        reported = [n for n in s["launches"] if n is not None]
        runs[f"multiprocess drill: {s['argv'][0]} {s['name']} ({ranks} rank"
             + ("s)" if ranks > 1 else ")")] = {
            k.name: sum(n[k.name] for n in reported) for k in kernels}
    check(len(summaries) >= 12, f"mp drill: {len(summaries)} launches reported")
    print(f"mp drill: phase 9 wall time {time.perf_counter() - t_phase:.1f} s (beside "
          f"phases 6a and 6b), {len(summaries)} launches; every launch's kernel counts "
          f"as expected; on {card}")
    return runs, summaries


# -- phase 10: the corpus-scale soak, shortened -----------------------------------

SOAK_N_TRAIN, SOAK_SEGMENT_STEPS, SOAK_INTERVAL, SOAK_SEGMENTS = 1000, 48, 8, 3
SOAK_ARGS = ["--hard", "--n-train", str(SOAK_N_TRAIN), "--segment-steps",
             str(SOAK_SEGMENT_STEPS), "--steps-per-checkpoint", str(SOAK_INTERVAL),
             "--max-segments", str(SOAK_SEGMENTS)]
SOAK_TIMEOUT_S = 900
# the checkpoint manager's max_to_keep, and the slack of the directory's size
SOAK_KEEP, SOAK_SIZE_SLACK = 5, 1.01
# the dev evaluates' batches (--step-count 2) and the test split's (256 / 64)
SOAK_DEV_BATCHES, SOAK_TEST_BATCHES = 2, 4


def start_soak(work):
    """Phase 10, started: ``python -m speecht_tpu_torch.tools.librispeech_scale_soak``
    with ``SOAK_ARGS`` in ``<work>/soak``, in a process group of its own
    (beside phases 6a, 6b, 8's build and 9), each CLI process through
    ``multiprocess_drill``'s ``rank`` entry (its report in
    ``<work>/soak_reports/<name>.json``). Returns (the process, its log's
    path, the reports' directory, the soak's root, its start time)."""
    root = os.path.join(work, "soak")
    reports = os.path.join(work, "soak_reports")
    os.makedirs(reports)
    log_path = os.path.join(work, "soak.log")
    launcher = f"speecht_tpu_torch.tools.multiprocess_drill rank {reports}/{{name}}.json"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "speecht_tpu_torch.tools.librispeech_scale_soak",
             *SOAK_ARGS, "--out", root, "--launcher", launcher],
            stdout=log, stderr=subprocess.STDOUT,
            cwd=os.path.dirname(os.path.abspath(__file__)), start_new_session=True)
    return proc, log_path, reports, root, time.perf_counter()


def soak_wants():
    """{process name: the kernel launches its report must hold}."""
    train = {"ctc_alpha": SOAK_SEGMENT_STEPS, "ctc_beta": SOAK_SEGMENT_STEPS, "conv0": 0,
             "beam_device": 0}
    wants = {}
    for k in range(1, SOAK_SEGMENTS + 1):
        wants[f"seg{k}-train"] = train
        wants[f"seg{k}-dev"] = {"ctc_alpha": SOAK_DEV_BATCHES, "ctc_beta": 0, "conv0": 0,
                                "beam_device": 0}
        if k % 3 == 0:
            wants[f"seg{k}-dev-beam"] = {"ctc_alpha": SOAK_DEV_BATCHES, "ctc_beta": 0,
                                         "conv0": 0, "beam_device": SOAK_DEV_BATCHES}
    wants["final-test"] = {"ctc_alpha": SOAK_TEST_BATCHES, "ctc_beta": 0, "conv0": 0,
                           "beam_device": 0}
    wants["final-test-beam"] = {"ctc_alpha": SOAK_TEST_BATCHES, "ctc_beta": 0, "conv0": 0,
                                "beam_device": SOAK_TEST_BATCHES}
    return wants


def soak_widest_bucket(root, bucket, step, device=torch.device("cuda")):
    """The widest bucket's rows through the model restored from the soak's
    last checkpoint, and their log-probs through ``ctc_alpha`` (with the
    history) and ``ctc_beta`` against the plain versions, timed (phases 2
    and 2b's ``check_ctc``, ``check_beta``). Returns (alpha's result,
    beta's)."""
    from speecht_tpu_torch.data.pipeline import build_batch, to_device
    from speecht_tpu_torch.models.wav2letter import output_length

    split = os.path.join(root, "data", "preprocessed-power", "train")
    rows = []
    for name in sorted(os.listdir(split)):
        with np.load(os.path.join(split, name)) as z:
            if bucket - step < z["audio_fragments"].shape[0] <= bucket:
                rows.append((z["audio_fragments"], z["transcript"]))
    check(bool(rows), f"soak: no train row in the widest bucket T{bucket}")
    model, _tx, _state = drill_model(root, "soak", device)
    batch = build_batch(rows, time_bucket=step)
    with torch.inference_mode():
        logits = model(to_device(batch, device).features).float().cpu().numpy()
    logit_lengths = output_length(torch.from_numpy(batch.seq_lengths)).numpy()
    inputs = (logits, logit_lengths.astype(np.int32), batch.labels.astype(np.int32),
              batch.label_lengths.astype(np.int32))
    print(f"soak: the widest bucket T{bucket}: {len(rows)} rows of "
          f"{[len(r[0]) for r in rows]} frames, labels of "
          f"{batch.label_lengths.tolist()} letters; logits {logits.shape} from the model "
          f"restored from the last checkpoint")
    name = f"soak widest bucket T{bucket}"
    alpha = check_ctc(name, inputs, device, history=True)
    g = np.random.RandomState(10).uniform(0.5, 1.5, len(rows)).astype(np.float32)
    beta = check_beta(name, inputs, g, device)
    return alpha, beta


def finish_soak(started, kernels, card, t_block_end):
    """Phase 10, joined (see the module's docstring for its gates). Returns
    ({path: launch counts}, the widest bucket's alpha and beta results)."""
    from speecht_tpu_torch.tools import soak_report

    proc, log_path, reports, root, t_phase = started
    try:
        code = proc.wait(timeout=max(SOAK_TIMEOUT_S - (time.perf_counter() - t_phase), 1))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.wait()
        code = None
    soak_s = time.perf_counter() - t_phase
    waited_s = time.perf_counter() - t_block_end
    with open(log_path) as f:
        out = f.read()
    for line in out.splitlines():
        if line and not line.startswith(DRILL_ROW_LINES):
            print(f"soak: {line}")
    check(code == 0, f"soak: exit code {code} (time limit {SOAK_TIMEOUT_S} s)")
    done = [ln for ln in out.splitlines() if ln.startswith("SOAK DONE: ")]
    check(len(done) == 1, "soak: no SOAK DONE line")
    final = json.loads(done[0][len("SOAK DONE: "):])
    check(sorted(final) == ["steps", "test_beam_lm_ler", "test_beam_lm_wer", "test_ler",
                            "test_wer"], f"soak: final record {final}")

    with open(os.path.join(root, "soak_log.jsonl")) as f:
        records = [json.loads(line) for line in f]
    by = {}
    for r in records:
        by.setdefault(r["kind"], []).append(r)
    corpus, buckets = by["corpus"][0], by["buckets"][0]
    widest = max(int(k) for k in buckets["occupancy"])
    print(f"soak: corpus {json.dumps(corpus)}")
    print(f"soak: buckets {json.dumps(buckets)}")
    print(f"soak: the widest bucket T{widest} ({buckets['occupancy'][str(widest)]} rows; "
          f"{widest // 2} logit frames)")

    run_dir = os.path.join(root, "train", "soak")
    ckpts = [n for n in os.listdir(run_dir) if re.fullmatch(r"ckpt-\d+\.pt", n)]
    largest_mb = max(os.path.getsize(os.path.join(run_dir, n)) for n in ckpts) / (1 << 20)
    check(len(ckpts) <= SOAK_KEEP, f"soak: {len(ckpts)} checkpoints kept: {sorted(ckpts)}")
    segs, devs = by.get("train_segment", []), by.get("dev_greedy", [])
    check(len(segs) == SOAK_SEGMENTS and len(devs) == SOAK_SEGMENTS,
          f"soak: {len(segs)} segments and {len(devs)} dev evaluates logged")
    saves = SOAK_SEGMENT_STEPS // SOAK_INTERVAL
    for k, (seg, dev) in enumerate(zip(segs, devs), start=1):
        steps = [i["step"] for i in seg["intervals"]]
        # segment k resumed at step (k-1) x 150 and printed its 6 intervals
        check(steps == [(k - 1) * SOAK_SEGMENT_STEPS + SOAK_INTERVAL * j
                        for j in range(1, saves + 1)],
              f"soak: segment {k}'s intervals at steps {steps}")
        losses = [i["loss"] for i in seg["intervals"]]
        check(all(math.isfinite(x) for x in losses), f"soak: segment {k} losses {losses}")
        check(seg["ckpt_mb"] <= SOAK_KEEP * largest_mb * SOAK_SIZE_SLACK,
              f"soak: segment {k}: the run directory {seg['ckpt_mb']} MB, over "
              f"{SOAK_KEEP} x {largest_mb:.1f} MB x {SOAK_SIZE_SLACK}")
        times = [i["step_time_s"] for i in seg["intervals"]]
        stall_n = sum(e["n"] for e in seg["stall_events"])
        stall_s = sum(e["s"] for e in seg["stall_events"])
        print(f"soak: segment {k} (to step {seg['target_step']}): wall {seg['wall_s']} s; "
              f"step time p50 {soak_report.pct(times, 0.5)!r} s, p95 "
              f"{soak_report.pct(times, 0.95)!r} s; prefetch stalls {stall_n} ({stall_s!r} s); "
              f"the run directory {seg['ckpt_mb']} MB ({saves} saves; a checkpoint "
              f"{largest_mb:.1f} MB); interval losses {losses}; learning rates "
              f"{[i['lr'] for i in seg['intervals']]}; dev greedy LER {dev['ler']} WER "
              f"{dev['wer']} in {dev['wall_s']} s")
    first_loss, last_loss = segs[0]["intervals"][0]["loss"], segs[-1]["intervals"][-1]["loss"]
    check(last_loss < first_loss,
          f"soak: segment {SOAK_SEGMENTS}'s last loss {last_loss} not below segment 1's "
          f"first {first_loss}")
    for beam in by.get("dev_beam_lm", []):
        print(f"soak: dev --device-beam + LM at step {beam['step']}: LER {beam['ler']} WER "
              f"{beam['wer']} in {beam['wall_s']} s")
    print(f"soak: final {json.dumps(final)}")

    runs = {}
    for name, want in soak_wants().items():
        path = os.path.join(reports, f"{name}.json")
        check(os.path.exists(path), f"soak: the process {name} wrote no report")
        with open(path) as f:
            report = json.load(f)
        got = {k.name: report["launches"][k.name] for k in kernels}
        check(got == want, f"soak: {name} launched {got}, not {want}")
        runs[f"soak: {name}"] = got
        if name.endswith("-train"):
            allocated, reserved = report["peak_mb"]
            print(f"soak: {name}: peak card memory {allocated:.0f} MB allocated, "
                  f"{reserved:.0f} MB reserved")
    check(len(os.listdir(reports)) == len(runs),
          f"soak: reports {sorted(os.listdir(reports))}")
    print(f"soak: kernel launches {runs}")

    rendered = subprocess.run(
        [sys.executable, "-m", "speecht_tpu_torch.tools.soak_report", "--out", root],
        capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    for line in rendered.stdout.splitlines():
        print(f"soak report: {line}")
    check(rendered.returncode == 0 and "final held-out test, device-beam+LM" in rendered.stdout
          and f"| {SOAK_SEGMENTS} | {SOAK_SEGMENTS * SOAK_SEGMENT_STEPS} |" in rendered.stdout,
          f"soak: soak_report failed: {rendered.stderr[-2000:]}")
    alpha, beta = soak_widest_bucket(root, widest, buckets["bucket_step"])
    shutil.rmtree(root)
    print(f"soak: phase 10 wall time {soak_s:.1f} s (beside phases 6a, 6b and 9; "
          f"{waited_s:.1f} s after they ended), the widest bucket's kernels "
          f"{time.perf_counter() - t_phase - soak_s:.1f} s; on {card}")
    return runs, alpha, beta


def kernel_entry(name, source, replaces, launches, r):
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": r["max_abs_err"],
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
        "shape": r["shape"],
        "check": "ok" if r["ok"] else "failed",
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--rank-worker"]:  # a rank of phase 3j or 3k, under torchrun
        return rank_worker(sys.argv[2])
    if sys.argv[1:2] == ["--sanitize-worker"]:  # phase 6a's kernels, under a sanitizer
        return sanitize_worker(sys.argv[2])
    import concurrent.futures
    import multiprocessing

    from speecht_tpu_torch import native
    from speecht_tpu_torch.ops import beam_device_cuda, conv0, conv0_cuda, ctc_cuda, cuda_build

    kernels = (list(ctc_cuda.KERNELS) + list(conv0_cuda.KERNELS)
               + list(beam_device_cuda.KERNELS))
    device = torch.device("cuda")
    # the default phases run without the opt-in conv0 path; phases 3c and
    # 4c set it for themselves
    os.environ.pop(conv0.ENV_VAR, None)

    # 1. environment
    t_start = time.perf_counter()
    marks = [t_start]

    def phase_time(name):
        now = time.perf_counter()
        print(f"wall time: phases {name} {now - marks[-1]:.1f} s; the script so far "
              f"{now - t_start:.1f} s")
        marks.append(now)

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    # the host library (g++) builds beside the kernels (one nvcc each)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        host_build = pool.submit(native.build)
        # with phase 2d's split build of the beam kernel
        cuda_build.build([k.name for k in kernels]
                         + [("beam_device", beam_device_cuda.BEAM_DEVICE_SPLIT.defines)])
        print(f"kernel build: {time.perf_counter() - t0:.1f} s for {[k.name for k in kernels]}")
        host_lib = host_build.result()
    print(f"host library build (g++: FLAC decode, resample, npz reader, beam search "
          f"and n-gram LM): {time.perf_counter() - t0:.1f} s from the start of the "
          f"builds, {os.path.basename(host_lib)}")
    exported = sorted(
        line.split()[-1] for line in subprocess.run(
            ["nm", "-D", "--defined-only", host_lib], capture_output=True, text=True,
            check=True, timeout=60,
        ).stdout.splitlines() if line.split()[1] == "T"
    )
    print(f"host library exports: {exported}")
    check(exported and all(name.startswith("stt_") for name in exported),
          f"the host library exports more than its stt_ C API: {exported}")
    for k in kernels:
        with open(cuda_build.log_path(k.name)) as f:
            for line in f:
                if any(part in line for part in (
                        "entry function", "registers", "spill", "Performance Loss")):
                    print(f"ptxas {k.name}: {line.strip()}")
    print("conv0 dynamic shared memory a CTA: bf16 kernel %d bytes, float32 kernel %d "
          "bytes" % (conv0_cuda.CONV0.lib.conv0_smem_bytes(1),
                     conv0_cuda.CONV0.lib.conv0_smem_bytes(0)))
    beta_lib = ctc_cuda.CTC_BETA.lib
    most = (beta_lib.ctc_beta_max_states() - 1) // 2
    print("ctc_beta dynamic shared memory a CTA: " + ", ".join(
        f"L={L} {beta_lib.ctc_beta_smem_bytes(L, 29)} bytes"
        for L in (256, 1088, most)))
    alpha_lib = ctc_cuda.CTC_ALPHA.lib
    most = (alpha_lib.ctc_alpha_max_states() - 1) // 2
    print("ctc_alpha dynamic shared memory a CTA (with the history ring): " + ", ".join(
        f"L={L} {alpha_lib.ctc_alpha_smem_bytes(L, 29)} bytes"
        for L in (256, 1088, FIRST_KERNEL_WIDEST_LABELS, most)))
    phase_time("1")

    # 2. the alpha kernel against its plain version
    train_inputs = ctc_inputs(
        0, B=64, T=512, L=256, label_range=(60, 201), frame_range=(300, 513)
    )
    largest = ctc_inputs(
        1, B=8, T=2176, L=1088, label_range=(300, 1001), frame_range=(1500, 2177)
    )
    alpha_main = check_ctc("evaluate shape", train_inputs, device, history=True)
    alpha_largest = check_ctc("largest bucket", largest, device, history=True)
    check_ctc("edge rows", edge_inputs(), device, time_it=False, history=True)
    alpha_wide_rows(device)

    # 2b. the beta kernel against its plain version
    rng = np.random.RandomState(2)
    beta_main = check_beta(
        "train shape", train_inputs,
        rng.uniform(0.5, 1.5, 64).astype(np.float32), device,
    )
    beta_largest = check_beta("largest bucket", largest,
                              rng.uniform(0.5, 1.5, 8).astype(np.float32), device)
    check_beta("edge rows", edge_inputs(), edge_grad(7), device, time_it=False)

    # 2c. the conv0 kernel against its plain version
    bf16, f32 = torch.bfloat16, torch.float32
    conv0_main = check_conv0("main shape", 64, 1024, 128, 250, bf16, device)
    check_conv0("main shape", 64, 1024, 128, 250, f32, device)
    conv0_largest = check_conv0("largest bucket", 8, 4352, 128, 250, bf16, device)
    for name, B, T, I, O in (("T=48", 2, 48, 128, 250), ("T=50", 2, 50, 128, 250),
                             ("T=1000", 2, 1000, 128, 250), ("B=1", 1, 1024, 128, 250),
                             ("O=16", 2, 256, 128, 16), ("O=29", 2, 256, 128, 29),
                             ("O=300", 2, 256, 128, 300), ("I=64", 2, 256, 64, 250),
                             ("I=256", 2, 256, 256, 250)):
        for dtype in (bf16, f32):
            check_conv0(name, B, T, I, O, dtype, device, time_it=False)
    check_conv0_bit_equal(device)
    check_conv0_grads(device)
    phase_time("2-2c")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        # the device beam's LM tables are cached here, not in $HOME
        os.environ["SPEECHT_DEVICE_LM_CACHE"] = os.path.join(work, "device_lm")
        # 2d. the beam kernel against its plain version
        beam_main, lm_dir, n_grams = beam_phase(work, device)
        print("kernel launches in the comparisons: "
              + str({k.name: k.launches for k in kernels}))
        phase_time("2d")

        # 3. evaluate; 3b. train; 3c. the conv0 path; 3d, 3e. the LM paths;
        # 3f. the audio front end; 3g. the device beam; 3h. export; 3i.
        # record; 4-4f. card vs CPU
        eval_launches, data_dir, weights, steady_ms = main_path(work, kernels, card)
        breakdown(data_dir, weights, steady_ms, card)
        train_launches, train_ms = train_path(work, data_dir, weights, kernels, card)
        train_step_device(data_dir, weights, card)
        conv0_train, conv0_eval = conv0_path(
            work, data_dir, weights, kernels, card, steady_ms, train_ms
        )
        conv0_device_steps(data_dir, weights, card)
        phase_time("3-3c")
        lm_weights, _kept = lm_weights_for(work, data_dir, weights)
        lm_launches, lm_ms, _out = lm_eval_path(work, data_dir, lm_weights, lm_dir,
                                                kernels, card)
        lm_breakdown(data_dir, lm_weights, lm_dir, n_grams, lm_ms, card)
        search_launches, search_ms = search_path(work, data_dir, lm_weights, lm_dir,
                                                 kernels, card)
        beam_runs, beam_lm_ms, beam_kernel_ms = device_beam_paths(
            work, data_dir, lm_weights, lm_dir, kernels, card, lm_ms, search_ms)
        phase_time("3d, 3e, 3g")
        parity(data_dir, weights)
        parity_train(data_dir, weights)
        parity(data_dir, weights, conv0_path=True)
        phase_time("4-4c")
        (audio_greedy, audio_lm, audio_beam, audio_cached, host_dir,
         device_dir) = audio_path(work, weights, lm_weights, lm_dir, kernels, card)
        beam_runs["evaluate --from-audio --language-model --device-beam"] = audio_beam
        phase_time("3f")
        # 3h. export and the loaded program; 3i. record
        export_launches = export_path(work, data_dir, weights, host_dir, kernels, card)
        record_runs = record_path(work, weights, lm_dir, host_dir, device_dir, kernels, card)
        record_runs["export (loaded program)"] = export_launches
        phase_time("3h, 3i")
        # 3j. parallel/: train and evaluate on two ranks sharing the card
        parallel_runs = parallel_path(work, data_dir, weights, kernels, card)
        # 3k. evaluate --language-model and --from-audio on two ranks
        decode_runs = parallel_decode_path(work, data_dir, weights, lm_dir, host_dir,
                                           kernels, card)
        phase_time("3j, 3k")
        parity_beam(data_dir, lm_weights, lm_dir)
        parity_audio(host_dir, device_dir, weights)
        phase_time("4d-4f")
        # 5. the drills: a model trained to held-out convergence, decoded
        # four ways; the training features across a SIGTERM and a relaunch
        drill_runs = drills_path(work, kernels, card)
        phase_time("5")
        # 6a. the kernels under the sanitizers; 6b. the host C++ under ASan
        # and UBSan; 9. the multi-process drill; 10. the soak; phase 7's
        # corpus and phase 8's LM written beside them
        hard_root = os.path.join(work, "hard")
        spawn = multiprocessing.get_context("spawn")
        torch.cuda.empty_cache()
        with concurrent.futures.ProcessPoolExecutor(2, mp_context=spawn) as pool:
            hard_corpus_future = pool.submit(timed_hard_corpus, hard_root)
            large_lm_future = pool.submit(timed_large_lm, os.path.join(work, "large_lm"),
                                          os.environ["SPEECHT_DEVICE_LM_CACHE"])
            native_sanitize = start_native_sanitize(work)
            mp_drill = start_multiprocess_drill(work)
            soak = start_soak(work)
            try:
                sanitizer_verdicts = sanitize_phase(work, lm_dir, card)
                finish_native_sanitize(native_sanitize, card)
                mp_drill_runs, _summaries = finish_multiprocess_drill(mp_drill, kernels, card)
                hard_corpus_written = hard_corpus_future.result()
                large_lm_built = large_lm_future.result()
                soak_runs, soak_alpha, soak_beta = finish_soak(
                    soak, kernels, card, time.perf_counter())
            finally:
                # a phase that failed leaves no process of 6b, 9 or 10 running
                if native_sanitize[0].poll() is None:
                    native_sanitize[0].kill()
                for started in (mp_drill, soak):
                    if started[0].poll() is None:
                        os.killpg(started[0].pid, 9)
        phase_time("6a, 6b, 9 and 10 (phase 7's corpus and phase 8's LM beside them)")
        # 7. the hard corpus: the pilot, then the search drill on its model
        hard_runs, hard_facts = hard_path(work, hard_root, hard_corpus_written, kernels,
                                          card)
        phase_time("7")
        # 8. the device beam on the 10^7-n-gram LM
        large_lm_runs, large_lm = large_lm_path(work, large_lm_built, data_dir, lm_weights,
                                                kernels, card)
        phase_time("8")

    # 11. kernels line, then the result line
    alpha_entry = kernel_entry(
        "ctc_alpha", "speecht_tpu_torch/csrc/ctc_alpha.cu",
        "speecht_tpu/ops/ctc_pallas.py:145", eval_launches["ctc_alpha"], alpha_main,
    )
    alpha_entry["launches_by_path"] = {
        "evaluate": eval_launches["ctc_alpha"], "train": train_launches["ctc_alpha"],
        "evaluate --language-model": lm_launches["ctc_alpha"],
        "search": search_launches["ctc_alpha"],
        "evaluate --from-audio": audio_greedy["ctc_alpha"],
        "evaluate --from-audio --language-model": audio_lm["ctc_alpha"],
        "evaluate (the preprocess --device cache)": audio_cached["ctc_alpha"],
    }
    alpha_entry["history"] = alpha_main["history"]
    alpha_entry["largest_bucket"] = {
        key: alpha_largest[key] for key in ("shape", "ms", "library_ms", "bound_ms", "history")
    }
    beta_entry = kernel_entry(
        "ctc_beta", "speecht_tpu_torch/csrc/ctc_beta.cu",
        "speecht_tpu/ops/ctc_pallas.py:200", train_launches["ctc_beta"], beta_main,
    )
    beta_entry["launches_by_path"] = {
        "evaluate": eval_launches["ctc_beta"], "train": train_launches["ctc_beta"],
        "evaluate --from-audio": audio_greedy["ctc_beta"],
        "evaluate --from-audio --language-model": audio_lm["ctc_beta"],
    }
    for path, n in parallel_runs.items():
        alpha_entry["launches_by_path"][f"{path} (2 ranks)"] = n["ctc_alpha"]
        beta_entry["launches_by_path"][f"{path} (2 ranks)"] = n["ctc_beta"]
    beta_entry["largest_bucket"] = {
        key: beta_largest[key] for key in ("shape", "ms", "library_ms", "bound_ms")
    }
    conv0_entry = kernel_entry(
        "conv0", "speecht_tpu_torch/csrc/conv0.cu",
        "speecht_tpu/ops/conv0_pallas.py:84", conv0_train["conv0"], conv0_main,
    )
    conv0_entry["largest_bucket"] = {
        key: conv0_largest[key] for key in ("shape", "ms", "library_ms", "bound_ms")
    }
    conv0_entry["launches_by_path"] = {
        "evaluate": conv0_eval["conv0"], "train": conv0_train["conv0"],
        "evaluate (default path)": eval_launches["conv0"],
        "train (default path)": train_launches["conv0"],
        "evaluate --from-audio": audio_greedy["conv0"],
        "evaluate --from-audio --language-model": audio_lm["conv0"],
    }
    alpha_entry["launches_by_path"].update(
        {path: n["ctc_alpha"] for path, n in beam_runs.items()})
    for path, per_rank in decode_runs.items():
        for r, n in enumerate(per_rank):
            alpha_entry["launches_by_path"][f"{path} (rank {r})"] = n["ctc_alpha"]
    beam_entry = kernel_entry(
        "beam_device", "speecht_tpu_torch/csrc/beam_device.cu",
        "speecht_tpu/ops/beam_device.py:1228 (XLA lax.scan, no Pallas kernel)",
        beam_runs["evaluate --language-model --device-beam"]["beam_device"], beam_main,
    )
    beam_entry["launches_by_path"] = {
        "evaluate --language-model": lm_launches["beam_device"],
        **{path: n["beam_device"] for path, n in beam_runs.items()},
        **{f"{path} (rank {r})": n["beam_device"]
           for path, per_rank in decode_runs.items() for r, n in enumerate(per_rank)},
    }
    serving_paths = ("record", "record --device-beam", "record --streaming",
                     "record --language-model", "record --device-beam (KenLM binary)",
                     "record --streaming --language-model", "record (SPEECHT_PALLAS_CONV0=1)",
                     "record --streaming (SPEECHT_PALLAS_CONV0=1)", "export (loaded program)")
    for entry in (alpha_entry, conv0_entry, beam_entry):
        entry["launches_by_path"].update(
            {path: record_runs[path][entry["name"]] for path in serving_paths})
    for entry in (alpha_entry, beta_entry, conv0_entry, beam_entry):
        entry["launches_by_path"].update(
            {path: n[entry["name"]] for path, n in drill_runs.items()})
        entry["launches_by_path"].update(
            {path: n[entry["name"]] for path, n in hard_runs.items()})
        entry["sanitize"] = sanitizer_verdicts
    for entry in (alpha_entry, beta_entry):
        entry["launches_by_path"].update(
            {path: n[entry["name"]] for path, n in mp_drill_runs.items()})
    for entry in (alpha_entry, beam_entry):
        entry["launches_by_path"].update(
            {path: n[entry["name"]] for path, n in large_lm_runs.items()})
    for entry in (alpha_entry, beta_entry, conv0_entry, beam_entry):
        entry["launches_by_path"].update(
            {path: n[entry["name"]] for path, n in soak_runs.items()})
    alpha_entry["soak_widest_bucket"] = {
        key: soak_alpha[key] for key in ("shape", "max_abs_err", "ms", "plain_ms", "library_ms",
                                         "bound_ms", "bound_by", "history")}
    beta_entry["soak_widest_bucket"] = {
        key: soak_beta[key] for key in ("shape", "max_abs_err", "ms", "plain_ms", "library_ms",
                                        "bound_ms", "bound_by", "pair_ms", "library_pair_ms")}
    beam_entry["large_lm"] = large_lm
    beam_entry["host_beam_ms"] = beam_main["host_beam_ms"]
    beam_entry["us_per_frame"] = beam_main["us_per_frame"]
    beam_entry["lm_share"] = beam_main["lm_share"]
    beam_entry["split_us_per_frame"] = {"main shape": beam_main["split"],
                                        "no LM": beam_main["split_no_lm"]}
    beam_entry["ms_in_evaluate_batch"] = beam_kernel_ms
    beam_entry["evaluate_device_beam_ms_per_batch"] = beam_lm_ms
    beam_entry["evaluate_host_beam_ms_per_batch"] = lm_ms
    beam_entry["hard_emissions"] = {key: hard_facts[key]
                                    for key in ("beam_kernel_ms", "kept_share", "kept_frames")}
    print(f"chip_smoke.py wall time {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": [alpha_entry, beta_entry, conv0_entry, beam_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
