"""The collectives of the port's parallel paths, and where their tensors live.

One process is one rank. ``init_distributed`` (``parallel/mesh.py``) picks
the backend once:

- **NCCL** when every local rank has a card of its own;
- **gloo** on the CPU, and when ranks share a card (``SPEECHT_SHARE_CARD=1``;
  NCCL refuses two ranks on one card).

This module holds the one rule that follows from the choice. NCCL takes
CUDA tensors in every collective. Under gloo only ``all_reduce`` and
``broadcast`` take CUDA tensors; ``all_gather`` and the halo's
point-to-point exchange copy a CUDA tensor to the host, run there and copy
the result back (:func:`host_staged`).

Host-side values (the batch's bucket dims, decodes and labels, checkpoint
flags, barriers) go through gloo groups over every rank, whatever the
backend: ``host`` for the main thread and ``loader`` for the batch
builder's thread, so that the two threads never issue collectives on one
group in an order that differs between ranks.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

# gloo groups over every rank, made by setup_host_groups()
_HOST_GROUPS: dict[str, object] = {}


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def setup_host_groups() -> None:
    """Creates the ``host`` and ``loader`` gloo groups, once a process;
    every rank calls it at the same point (a collective)."""
    if not _HOST_GROUPS:
        for name in ("host", "loader"):
            _HOST_GROUPS[name] = dist.new_group(backend="gloo")


def host_staged(t: torch.Tensor) -> bool:
    """True when a collective other than all_reduce/broadcast must take
    ``t`` through host memory: a CUDA tensor under gloo."""
    return t.is_cuda and dist.get_backend() == "gloo"


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum of ``t`` over ``group`` (float32 or integer tensors)."""
    dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``t`` (equal shapes) concatenated along ``dim`` in
    group-rank order."""
    src = t.detach().to("cpu") if host_staged(t) else t.detach()
    src = src.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def exchange(to_prev, to_next, prev_rank, next_rank, recv_shapes, like):
    """Point-to-point: sends ``to_prev`` to global rank ``prev_rank`` and
    ``to_next`` to ``next_rank`` (None: no such neighbour); returns what
    (prev, next) sent back, zeros where there is no neighbour.
    ``recv_shapes`` are the shapes received from (prev, next); ``like``
    gives dtype and device."""
    staged = host_staged(like)
    where = torch.device("cpu") if staged else like.device
    recv = [torch.zeros(s, dtype=like.dtype, device=where) for s in recv_shapes]
    ops = []
    for peer, out, inbox in (
        (prev_rank, to_prev, recv[0]), (next_rank, to_next, recv[1])
    ):
        if peer is None:
            continue
        out = out.detach().contiguous()
        if staged:
            out = out.to("cpu")
        ops.append(dist.P2POp(dist.isend, out, peer))
        ops.append(dist.P2POp(dist.irecv, inbox, peer))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return tuple(r.to(like.device) for r in recv)


def host_all_gather(array: np.ndarray, thread: str = "host") -> list[np.ndarray]:
    """Every rank's ``array`` (equal shapes and dtypes), in rank order,
    through the gloo group of the calling thread (``host`` or ``loader``)."""
    array = np.ascontiguousarray(array)
    src = torch.from_numpy(array)
    parts = [torch.empty_like(src) for _ in range(world_size())]
    dist.all_gather(parts, src, group=_HOST_GROUPS[thread])
    return [p.numpy() for p in parts]


def barrier() -> None:
    if initialized():
        dist.barrier(group=_HOST_GROUPS["host"])
