"""The data-parallel mesh of the port: one process per card.

Counterpart of ``gaze_tpu/parallel/mesh.py``. JAX's mesh is an array of
devices driven by one program, and its ``NamedSharding``s tell XLA how
each array is laid out over it. The port runs one process per card over
``torch.distributed``, so its mesh is this process's place in a process
group: the group, its ``size``, this process's ``rank`` in it and the
card it computes on (``device``). The model is replicated (every rank
holds all of it and updates it identically); batches are split by rows.

JAX's two sharding objects have no torch counterpart and are replaced by
what the port needs of them:

- ``batch_sharding`` -> the rank's rows: :func:`shard_batch` here,
  ``local_batch_slice``, ``local_batch_rows`` and ``local_rows`` in
  ``core/distributed.py``;
- ``replicated`` -> nothing: every rank builds the same parameters
  from one seed or one file, and the data-parallel step keeps them equal
  (every rank applies the same all-reduced gradient).

Which rows a meshed entry point takes follows from what it returns:

- a train step returns one global loss, and takes this rank's rows of
  the global batch, as ``shard_batch`` or ``device_prefetch(mesh=)``
  stage them (each rank loads only its own rows);
- an entry point that returns a result per row of the batch (the eval
  steps, ``StreamServer(mesh=)``, the rollouts) takes the global batch
  on every rank, as JAX's single controller does, computes its rows and
  all-gathers the results, so every rank returns all of them;
- ``DistributedStreamServer`` is one server per rank: each rank feeds
  and reads its own slots.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from gaze_tpu_torch.core.device import resolve_device

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data mesh: ``size`` ranks of ``group``; this process is
    ``rank`` (-1 when it lies outside the mesh) and computes on
    ``device``. ``group`` is None for the size-1 mesh of a process that
    joined no process group."""

    group: Any
    size: int
    rank: int
    device: torch.device
    axis_name: str = DATA_AXIS

    @property
    def member(self) -> bool:
        return self.rank >= 0


def checked(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """``mesh`` itself, after the checks of every entry point that takes
    one: None passes, anything but a :class:`Mesh` is a TypeError, and a
    process outside the mesh a ValueError."""
    if mesh is None:
        return None
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a gaze_tpu_torch.parallel.mesh.Mesh (make_mesh), "
                        f"got {type(mesh).__name__}")
    if not mesh.member:
        raise ValueError(
            f"this process is outside the {mesh.size}-rank mesh: "
            f"start {mesh.size} processes, or make the mesh over all of them")
    return mesh


def rank_device(device=None) -> torch.device:
    """The card of this process: ``device`` when given, else
    ``cuda:<local rank>`` (``LOCAL_RANK`` as torchrun sets it, else the
    global rank) modulo the visible cards, so ranks that outnumber the
    cards share them. Raises without CUDA, as every entry point does."""
    if device is not None:
        return resolve_device(device)
    dev = resolve_device(None)
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device(dev.type, local % torch.cuda.device_count())


def make_mesh(num_devices: Optional[int] = None, axis_name: str = DATA_AXIS,
              device=None) -> Mesh:
    """A mesh over the first ``num_devices`` ranks (default all) of the
    default process group, one card per rank.

    Every process of the group must call it (a mesh smaller than the
    group is a new group, whose creation is collective); a process
    outside the mesh gets ``rank`` -1. Without a process group it is the
    size-1 mesh of this process."""
    dev = rank_device(device)
    if not dist.is_initialized():
        if num_devices not in (None, 1):
            raise ValueError(f"a {num_devices}-rank mesh needs an initialized process "
                             "group (core.distributed.initialize)")
        return Mesh(None, 1, 0, dev, axis_name)
    world = dist.get_world_size()
    n = world if num_devices is None else int(num_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a {n}-rank mesh over a process group of {world}")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    rank = dist.get_rank()
    return Mesh(group, n, rank if rank < n else -1, dev, axis_name)


def shard_batch(mesh: Mesh, batch: Dict[str, Any], num_microbatches: int = 1
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch (a dict of arrays with the
    batch leading), as tensors on the rank's card. With
    ``num_microbatches`` K > 1 the rows are the rank's share of each of
    the K global microbatches (``core.distributed.local_batch_rows``)."""
    from gaze_tpu_torch.core.distributed import local_rows

    rows = local_rows(batch, checked(mesh), num_microbatches)
    return {k: torch.as_tensor(v).to(mesh.device) for k, v in rows.items()}
