"""Hardware-validation drills and measurement tools of the port: the
counterparts of the repo's ``tools/``, the drills driving
``speecht_tpu_torch.cli.CLI`` end to end.

- ``synthetic_corpus``: the tone-speech corpus (each character a tone
  burst) and its unigram LM, the same files as ``tools/synthetic_convergence.py``
  writes for the same seed;
- ``synthetic_convergence``: train the full-width model on that corpus,
  then check the held-out split greedy, on the host beam with the LM, with
  ``--device-beam`` and with ``--device-beam --rescore 8``;
- ``train_features_check``: ``tools/train_features_check.py``'s gate
  (``--spec-augment`` with narrow masks, ``--grad-accum 2``, greedy LER
  < 0.05) on the same synthetic corpus, with a SIGTERM crash-save and a
  relaunch in the middle;
- ``native_sanitize_check``: the port's host C++ built with ASan and
  UBSan, every ``stt_`` entry point driven and three parsers fuzzed (the
  CPU alone);
- ``hard_corpus``: the hard synthetic corpus (speaker variation, noise,
  confusable letters, a minimal-pair lexicon; the JAX tool's files for the
  same seed, plus a test split) and its ``pilot``;
- ``hard_search_drill``: ``search`` on the pilot's model, gated on dev and
  on the held-out split;
- ``multiprocess_drill``: ``train`` and ``evaluate`` on 2 and 4 ranks (a
  2x2 grid), each a process of its own, against one process: data
  parallel, a resume from a 2-rank checkpoint, mixed buckets,
  ``--grad-accum``, a worker's SIGTERM and the job's relaunch;
- ``large_lm_probe``: a 10^7-n-gram LM (the JAX tool's ARPA, converted to
  a PROBING binary) through the device LM tables, the scorer and the beam,
  timed against a tiny LM;
- ``librispeech_scale_soak``: the corpus-scale soak (20,000 utterances
  with LibriSpeech's durations, the JAX tool's files for the same seed;
  training in segments, each segment and evaluate a process of its own
  resuming from the rotated checkpoints), and ``soak_report``, its log
  as markdown;
- the measurement tools: ``layer_breakdown`` (the forward's ms layer by
  layer, from timed prefixes, beside each layer's FLOPs), ``perf_probe``
  (the eval step, the forward, the beam's device part, one host-beam
  utterance, the readback and the front end), ``device_beam_probe`` (the
  device beam on a 350,000-n-gram LM), ``pipeline_soak`` (the sustained
  train loop through the loader) and ``arpa_to_kenlm_binary`` (an ARPA LM
  to a KenLM PROBING binary, on the host).

Each runs on the card unless ``--device cpu`` is given. ``tools/``'s
``overfit_check``, ``train_features_check`` on its own corpus,
``device_beam_check`` and ``record_check`` train on one bundled
LibriSpeech utterance that the repository does not hold, so they wait for
it.
"""
