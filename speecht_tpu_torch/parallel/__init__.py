"""Parallelism of the port: the grid of ranks, its collectives, sequence parallelism.

Counterpart of ``speecht_tpu/parallel/``. ``mesh.py`` launches and lays
out the ranks (``init_distributed``, ``make_mesh``/``auto_mesh``) and holds
the host-side helpers; ``comm.py`` holds the collectives and the rule for
where their tensors live under each backend; ``seq_parallel.py`` shards
the conv stack over time. Tensor parallelism lives in the model
(``models/wav2letter.py``), the sharded loss and gradients in
``train/step.py``.
"""

from speecht_tpu_torch.parallel.mesh import (
    Mesh,
    auto_mesh,
    init_distributed,
    make_mesh,
)

__all__ = ["Mesh", "auto_mesh", "init_distributed", "make_mesh"]
