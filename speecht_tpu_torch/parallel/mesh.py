"""The ``('data', 'model')`` grid of ranks, and the host-side multi-process helpers.

Counterpart of ``speecht_tpu/parallel/mesh.py`` and of
``speecht_tpu/runtime.py::init_distributed``. JAX's mesh is a grid of
devices inside one program; here each rank is a process with one device,
launched by ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``). Rank ``r`` sits at
``(r // mp, r % mp)``: ranks with one model index form a data group, ranks
with one data index a model group, and every group is made on every rank
in the same order.

- **DP**: each data rank reads its own shard of the corpus (equal shards,
  ``data/reader.py::_equal_shard``) and builds ``--batch-size / dp`` rows;
  the train step all-reduces the loss's sum and row count and the
  gradients over the data group.
- **TP**: the ranks of a model group read the same rows and each holds its
  channel shard of the wide layers (``models/wav2letter.py``).
- **SP** (``parallel/seq_parallel.py``): the model axis shards time.

``make_mesh``/``auto_mesh`` keep JAX's checks and messages. One
difference: JAX accepts an explicit ``--data-parallel`` that leaves
devices out of the mesh (a sub-mesh); here every launched rank must be in
the grid, so a sub-grid is refused.

With one process (no launcher environment) the mesh is ``1 x 1``, has no
groups, and every helper is the identity.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from speecht_tpu_torch.parallel import comm

DATA_AXIS = "data"
MODEL_AXIS = "model"
SHARE_CARD_ENV = "SPEECHT_SHARE_CARD"


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else default


def local_rank() -> int:
    return _env_int("LOCAL_RANK", comm.rank())


def local_world_size() -> int:
    return _env_int("LOCAL_WORLD_SIZE", comm.world_size())


def placement(device: str) -> tuple[str, torch.device, str]:
    """(backend, this rank's device, a note) for ``--device``.

    NCCL with ``cuda:<local rank>`` when every local rank has a card of its
    own; gloo on the CPU; gloo with ``cuda:<local rank % cards>`` when
    ranks share cards, which ``SPEECHT_SHARE_CARD=1`` must allow
    (otherwise RuntimeError): NCCL refuses two ranks on one card.
    """
    if device == "cpu":
        return "gloo", torch.device("cpu"), ""
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError(
            "--device cuda: no CUDA device is available "
            "(pass --device cpu to run on the CPU)"
        )
    lrank, lworld = local_rank(), local_world_size()
    if lworld <= cards:
        return "nccl", torch.device("cuda", lrank), ""
    if os.environ.get(SHARE_CARD_ENV) != "1":
        raise RuntimeError(
            f"{lworld} ranks on this host but {cards} CUDA card(s): set "
            f"{SHARE_CARD_ENV}=1 to let ranks share cards (gloo backend, "
            "collectives staged through host memory), or launch at most "
            f"{cards} ranks a host"
        )
    card = lrank % cards
    return "gloo", torch.device("cuda", card), (
        f"; {math.ceil(lworld / cards)} ranks share cuda:{card} "
        f"({SHARE_CARD_ENV}=1: gloo stages collectives through host memory)"
    )


def destroy_at_exit() -> None:
    """Ends the process group, if one is left, before the interpreter's
    own teardown: left to it, gloo's threads can abort a rank whose run
    succeeded ("terminate called without an active exception")."""
    if dist.is_initialized():
        dist.destroy_process_group()


def init_distributed(device: str = "cuda") -> bool:
    """Joins the process group when launched under ``torchrun``'s
    environment with ``WORLD_SIZE`` above 1 (or when the caller already
    initialized ``torch.distributed``), makes the host groups and prints
    the ``distributed:`` line. Returns False, doing nothing, for one
    process. A group joined here is destroyed at the process's exit
    (:func:`destroy_at_exit`); a caller's own group is left to it."""
    if not comm.initialized():
        if _env_int("WORLD_SIZE", 1) <= 1 or "RANK" not in os.environ:
            return False
        backend, dev, _note = placement(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method="env://", rank=_env_int("RANK", 0),
            world_size=_env_int("WORLD_SIZE", 1),
            timeout=datetime.timedelta(minutes=10),
        )
        atexit.register(destroy_at_exit)
    comm.setup_host_groups()
    backend, dev, note = placement(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    print(
        f"distributed: rank {comm.rank()} of {comm.world_size()}, backend "
        f"{dist.get_backend()}, device {dev}{note}",
        flush=True,
    )
    return True


def rank_device(device: str) -> torch.device:
    """This rank's device for ``--device`` (the device itself for one
    process)."""
    if not comm.initialized():
        return torch.device(device)
    return placement(device)[1]


def grid_shape(
    data_parallel: int = 0, model_parallel: int = 1, n: int | None = None
) -> tuple[int, int]:
    """``(dp, mp)`` of a grid over ``n`` ranks (default: the world).

    ``data_parallel=0`` means every rank left over goes on the data axis.
    """
    n = comm.world_size() if n is None else n
    if model_parallel < 1:
        raise ValueError(f"model_parallel={model_parallel} must be >= 1")
    if not data_parallel and n % model_parallel:
        raise ValueError(
            f"model_parallel={model_parallel} must divide device count {n} "
            "when data_parallel is auto (0)"
        )
    dp = data_parallel or n // model_parallel
    if dp * model_parallel > n:
        raise ValueError(
            f"mesh {dp}x{model_parallel} exceeds {n} available devices"
            + (" (one a rank: launch the ranks with torchrun "
               f"--nproc-per-node {dp * model_parallel})" if n == 1 else "")
        )
    if dp * model_parallel < n:
        raise ValueError(
            f"mesh {dp}x{model_parallel} leaves {n - dp * model_parallel} of "
            f"{n} ranks out; every launched rank must be in the grid"
        )
    return dp, model_parallel


def auto_grid_shape(
    batch_size: int, data_parallel: int = 0, model_parallel: int = 1,
    n: int | None = None,
) -> tuple[int, int]:
    """``grid_shape`` with the data axis clamped so it divides
    ``batch_size``: 0 picks gcd(ranks // model_parallel, batch_size)."""
    n = comm.world_size() if n is None else n
    if data_parallel:
        return grid_shape(data_parallel, model_parallel, n)
    dp = math.gcd(n // model_parallel, max(batch_size, 1))
    return grid_shape(dp, model_parallel, n)


@dataclasses.dataclass
class Mesh:
    """This rank's place in the grid and its groups (None on an axis of
    size 1, where every collective is the identity)."""

    dp: int = 1
    mp: int = 1
    rank: int = 0
    data_group: object = None
    model_group: object = None
    world_group: object = None
    # the model axis shards time (parallel/seq_parallel.py), not channels
    seq_parallel: bool = False

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.dp, MODEL_AXIS: self.mp}

    @property
    def data_index(self) -> int:
        return self.rank // self.mp

    @property
    def model_index(self) -> int:
        return self.rank % self.mp

    @property
    def primary(self) -> bool:
        return self.rank == 0

    def model_ranks(self) -> list[int]:
        """Global ranks of this rank's model group, in model order."""
        base = self.data_index * self.mp
        return [base + j for j in range(self.mp)]

    def group(self, axis: str):
        return {DATA_AXIS: self.data_group, MODEL_AXIS: self.model_group,
                "world": self.world_group}[axis]

    def all_reduce_(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """In-place sum over ``axis`` (``data``, ``model`` or ``world``)."""
        group = self.group(axis)
        return t if group is None else comm.all_reduce_(t, group)

    def all_gather(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        group = self.group(axis)
        return t if group is None else comm.all_gather(t, group, dim)


def make_mesh(data_parallel: int = 0, model_parallel: int = 1) -> Mesh:
    """The grid over every launched rank, with its groups."""
    dp, mp = grid_shape(data_parallel, model_parallel)
    mesh = Mesh(dp=dp, mp=mp, rank=comm.rank())
    if dp * mp == 1:
        return mesh
    grid = np.arange(dp * mp).reshape(dp, mp)
    for j in range(mp):
        g = dist.new_group(grid[:, j].tolist()) if dp > 1 else None
        if j == mesh.model_index:
            mesh.data_group = g
    for i in range(dp):
        g = dist.new_group(grid[i].tolist()) if mp > 1 else None
        if i == mesh.data_index:
            mesh.model_group = g
    mesh.world_group = dist.group.WORLD
    return mesh


def auto_mesh(
    batch_size: int, data_parallel: int = 0, model_parallel: int = 1
) -> Mesh:
    dp, mp = auto_grid_shape(batch_size, data_parallel, model_parallel)
    return make_mesh(dp, mp)


def sync_bucket_dims(*dims: int) -> tuple[int, ...]:
    """Elementwise max of ``dims`` over every rank (identity for one process).

    Each rank buckets its own shard, so without this one rank could pad
    a step's batch to 768 frames while another pads it to 1024, and the
    padded frames change the loss (after conv_0 a zero frame is
    ``relu(bias)``, which reaches the valid frames near the end). Every
    rank calls this once per built batch, on the batch builder's thread.
    """
    if not comm.initialized():
        return dims
    gathered = comm.host_all_gather(np.asarray(dims, np.int64), thread="loader")
    return tuple(int(x) for x in np.max(np.stack(gathered), axis=0))


def allgather_host_rows(x: np.ndarray, mesh: Mesh) -> np.ndarray:
    """The data ranks' rows of ``x`` concatenated in data order (identity
    for one process). Ranks of one model group hold the same rows, so only
    the first of each is kept."""
    if not comm.initialized():
        return np.asarray(x)
    parts = comm.host_all_gather(np.asarray(x))
    return np.concatenate(parts[:: mesh.mp], axis=0)


def host_global(x: np.ndarray, mesh: Mesh) -> np.ndarray:
    """The whole batch's rows of an array each rank holds its own rows of
    (labels, lengths, decodes): every rank calls it in lockstep. JAX's
    ``host_global`` replicates a global device array; here the rows are
    already on the host, so it is :func:`allgather_host_rows`."""
    return allgather_host_rows(x, mesh)


def local_rows(x: np.ndarray, mesh: Mesh) -> np.ndarray:
    """This rank's block of rows of a global array (the inverse of
    :func:`allgather_host_rows`)."""
    per = x.shape[0] // mesh.dp
    return x[mesh.data_index * per: (mesh.data_index + 1) * per]


def beam_rows(x, mesh: Mesh):
    """This rank's contiguous share of its data block ``x`` (numpy or
    torch, rows on dim 0), which every rank of its model group holds
    alike: the block split by ``mesh.model_index``, as JAX's
    ``local_rows`` splits replicated rows, so the ranks of a model group
    beam different rows. A block that does not divide by ``mp`` is padded
    with zero rows (length 0), which :func:`gather_beam_rows` drops."""
    per = -(-x.shape[0] // mesh.mp)
    lo = min(mesh.model_index * per, x.shape[0])
    share = x[lo: lo + per]
    missing = per - share.shape[0]
    if not missing:
        return share
    if isinstance(share, torch.Tensor):
        return torch.cat([share, share.new_zeros((missing, *share.shape[1:]))])
    return np.concatenate([share, np.zeros((missing, *share.shape[1:]), share.dtype)])


def gather_beam_rows(x: np.ndarray, mesh: Mesh, block_rows: int) -> np.ndarray:
    """Every rank's share (:func:`beam_rows`) of a host array concatenated
    in rank order, which is the global row order, less the padding rows:
    each data block keeps its first ``block_rows``. A collective on the
    main thread's gloo group; the identity for one process."""
    if not comm.initialized():
        return np.asarray(x)
    parts = comm.host_all_gather(np.asarray(x), thread="host")
    return np.concatenate([
        np.concatenate(parts[i * mesh.mp: (i + 1) * mesh.mp])[:block_rows]
        for i in range(mesh.dp)
    ])
