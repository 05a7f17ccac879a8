"""The plain references, one module an architecture.

A configuration file names its architecture by its ``"model"`` key, and
``manifest.architecture(config)`` returns ``reference/<model>.py``. A new
architecture comes in as that module, its configuration, a cell's limits
and the entries of ``BENCHMARK.json``; no file that is there is edited.

Each module provides, every size and setting read from the
configuration:

- ``program_flags(config) -> list[str]``: the port's ``train`` flags that
  give the model its shape (the harness adds the flags every cell shares:
  features, batch, buckets, precisions, optimizer);
- ``make_weights(config, seed, device)``: the weights, drawn from the
  seed on the device, float32, named as the port's ``state.params``;
- ``train_steps(params, batches, config, quantize, rows)``: the steps of
  ``batches`` from ``params``; each step's loss, the per-leaf norms of the
  first step's clipped gradient and of each leaf's change after the last
  step (``check.py`` compares them). ``quantize`` rounds wherever the
  program rounds to its compute precision (``common.fp8_quantize`` for
  the control), ``rows`` picks the rows a step trains on;
- ``logit_lengths(config, seq_lengths)``: each row's logit frames, the
  lengths the CTC loss gets, from its input frames (an array or a tensor);
- ``logit_frames(config, frames) -> int``: the logits' padded length at a
  padded input length;
- ``train_flops_valid(config, seq_lengths) -> float``: the operations one
  train step needs on these rows' valid frames (``train_mfu``);
- ``conv_flops_padded(config, batch, frames) -> (forward, backward)``,
  optional: the convolutions' operations at the padded shape as run
  (``conv_roofline.train``, which reads nothing where it is missing).

A module imports nothing of the program and nothing of JAX. What the
architectures share (float32 without TF32, the float8 control, the
optimizer) is in ``common.py``, and each imports it from there.
"""
