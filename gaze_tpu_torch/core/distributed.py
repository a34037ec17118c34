"""Process-group start-up, the global mesh, each rank's rows of a
batch, and the collectives of the data-parallel paths.

Counterpart of ``gaze_tpu/core/distributed.py``. JAX runs one program
over every chip and XLA inserts the collectives; the port runs one
process per card over ``torch.distributed`` (NCCL between cards, gloo on
the CPU and for ranks that share a card) and calls its few collectives
itself:

- training: one SUM all-reduce of the flattened gradient and the loss
  per step, the all-reduced denominators of masked means, and the
  BatchNorm sums (``all_reduce_sum_grad``, whose backward is itself an
  all-reduce);
- the sharded server and rollouts: an all-gather of each rank's rows.

A run without a process group needs no start-up: ``global_mesh()`` is
then the size-1 mesh of this process, and each collective here is the
identity on it.

gloo takes CUDA tensors for every collective used here (all-reduce,
all-gather, broadcast) and moves them through host memory itself; the
port adds no transport of its own.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from gaze_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, checked, make_mesh


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None) -> None:
    """Join the job's process group; a no-op for one process.

    ``coordinator_address`` is ``host:port`` (rank 0 listens there), a
    ``tcp://`` or ``file://`` URL, or None for torchrun's environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), which
    also fills a missing ``num_processes`` and ``process_id``.
    ``backend`` defaults to NCCL when CUDA is available, else gloo; two
    ranks on one card need gloo (NCCL refuses them). With NCCL each
    rank's current card becomes ``cuda:<local rank>``."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        return
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        init = "env://"
    elif "://" in coordinator_address:
        init = coordinator_address
    else:
        init = f"tcp://{coordinator_address}"
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id)
    if backend == "nccl":
        from gaze_tpu_torch.parallel.mesh import rank_device

        torch.cuda.set_device(rank_device())


def global_mesh(axis_name: str = DATA_AXIS, device=None) -> Mesh:
    """The mesh over every rank of the job (the size-1 mesh of this
    process without a process group)."""
    return make_mesh(None, axis_name, device)


def _place(mesh: Optional[Mesh]):
    if checked(mesh) is not None:
        return mesh.size, mesh.rank
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def local_batch_slice(global_batch: int, mesh: Optional[Mesh] = None) -> slice:
    """The [start, stop) rows of the global batch this rank feeds: its
    contiguous 1/size share (of the default group without a mesh)."""
    n, idx = _place(mesh)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} hosts")
    per = global_batch // n
    return slice(idx * per, (idx + 1) * per)


def local_batch_rows(global_batch: int, num_microbatches: int = 1,
                     mesh: Optional[Mesh] = None) -> np.ndarray:
    """The global rows this rank holds when a step splits the global
    batch into ``num_microbatches`` K microbatches.

    The JAX step reshapes the global batch (B, ...) into (K, B/K, ...)
    and shards each microbatch over the mesh, so microbatch i is global
    rows [i B/K, (i+1) B/K) and rank r holds its 1/size of each:
    [i B/K + r B/(K size), i B/K + (r+1) B/(K size)) for every i. The
    rank then splits its B/size rows into K consecutive chunks, and
    chunk i is its share of global microbatch i; a contiguous block of
    B/size rows would mix the microbatches. K = 1 is
    :func:`local_batch_slice`'s block."""
    n, idx = _place(mesh)
    k = max(1, num_microbatches)
    if global_batch % (k * n):
        raise ValueError(f"global batch {global_batch} not divisible by grad_accum={k} "
                         f"x {n} ranks")
    per = global_batch // (k * n)
    base = np.arange(k)[:, None] * (global_batch // k) + idx * per
    return (base + np.arange(per)[None, :]).reshape(-1)


def local_rows(batch: Dict[str, Any], mesh: Optional[Mesh], num_microbatches: int = 1
               ) -> Dict[str, Any]:
    """This rank's rows (:func:`local_batch_rows`) of a global batch, a
    dict of arrays or tensors with the batch leading, left where they
    are; the batch itself without a mesh."""
    if checked(mesh) is None:
        return batch
    sizes = {len(v) for v in batch.values()}
    if len(sizes) != 1:
        raise ValueError(f"batch entries of different lengths {sorted(sizes)}")
    rows = local_batch_rows(sizes.pop(), num_microbatches, mesh)
    return {k: v[torch.from_numpy(rows)] if isinstance(v, torch.Tensor) else v[rows]
            for k, v in batch.items()}


def host_sharded_array(local_rows, mesh: Mesh) -> torch.Tensor:
    """This rank's local rows as a tensor on its card. The port keeps no
    global array: each rank holds its rows, and the collectives here
    combine what crosses ranks."""
    return torch.as_tensor(local_rows).to(checked(mesh).device)


def _reduces(mesh: Optional[Mesh]) -> bool:
    return checked(mesh) is not None and mesh.group is not None


def all_reduce_sum_(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """SUM all-reduce of ``t`` in place over the mesh; returns ``t``."""
    if _reduces(mesh):
        dist.all_reduce(t, group=mesh.group)
    return t


def all_reduce_sum_grad(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """SUM all-reduce that autograd differentiates: its backward
    all-reduces the incoming gradient, so a rank's gradient through a
    global statistic carries every rank's use of it."""
    if not _reduces(mesh):
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, group=mesh.group)


def all_reduce_flat_(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]
                     ) -> List[torch.Tensor]:
    """SUM all-reduce of tensors of one dtype and device as one flat
    buffer (one collective); returns them as new tensors."""
    tensors = list(tensors)
    if not _reduces(mesh):
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    return [f.view_as(t) for f, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def all_gather_rows(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along dim 0 in rank
    order: the unsharded array of which ``t`` is the rank's rows."""
    if not _reduces(mesh):
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.cat(parts)


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait until every rank of the mesh is here."""
    if _reduces(mesh):
        if dist.get_backend(mesh.group) == "nccl":
            dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
        else:
            dist.barrier(group=mesh.group)
