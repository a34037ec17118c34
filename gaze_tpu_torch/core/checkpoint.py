"""Per-stage checkpoints of a training state, with best tracking.

Counterpart of ``gaze_tpu/core/checkpoint.py`` in the port's own format
(it reads no orbax checkpoint): ``<dir>/<step>.pt`` is a ``torch.save``
of the module's state dict (parameters and BatchNorm statistics), the
optimizer's count and moments and the step, all on the CPU. A write goes
to a temporary file in the same directory and is renamed into place, so
a reader sees a whole checkpoint or none. The three newest steps are
kept. Best tracking keeps the JAX layout: the sibling ``<dir>_best``
holds the best-metric state and ``<dir>_best.metric.json`` its metric
(lower is better).

Under a data ``mesh`` (every rank holding the same state) rank 0 writes
and the others wait at a barrier until the files are whole; every rank
reads.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional, Tuple, Union

import torch

from gaze_tpu_torch.core.distributed import barrier
from gaze_tpu_torch.parallel.mesh import Mesh, checked
from gaze_tpu_torch.train.common import TrainState

MAX_TO_KEEP = 3
_NAME = re.compile(r"^(\d+)\.pt$")


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(directory)) if m)


def _atomic_write(path: str, write) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def writes(mesh: Optional[Mesh]) -> bool:
    """Whether this process writes the shared files: rank 0 of the mesh,
    or the only process."""
    return mesh is None or checked(mesh).rank == 0


def save_checkpoint(directory: str, step: int, state: TrainState,
                    mesh: Optional[Mesh] = None) -> None:
    """Save ``state`` as ``<directory>/<step>.pt``; older steps beyond the
    newest three are removed. Under a ``mesh``, rank 0 writes and every
    rank returns once the file is whole."""
    if writes(mesh):
        _write_checkpoint(directory, step, state)
    barrier(mesh)


def _write_checkpoint(directory: str, step: int, state: TrainState) -> None:
    os.makedirs(directory, exist_ok=True)
    payload = {
        "step": int(state.step),
        "module": {k: _cpu(v) for k, v in state.module.state_dict().items()},
        "opt": {"count": int(state.opt_state.count),
                "mu": [_cpu(t) for t in state.opt_state.mu],
                "nu": [_cpu(t) for t in state.opt_state.nu]},
    }
    _atomic_write(os.path.join(directory, f"{step}.pt"), lambda p: torch.save(payload, p))
    for old in _steps(directory)[:-MAX_TO_KEEP]:
        os.remove(os.path.join(directory, f"{old}.pt"))


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, state: TrainState, step: Optional[int] = None) -> TrainState:
    """Load ``<directory>/<step>.pt`` (default the latest) into ``state``
    in place, onto its module's device. Returns ``state``, unchanged when
    no checkpoint exists (a fresh start)."""
    step = latest_step(directory) if step is None else step
    if step is None:
        return state
    payload = torch.load(os.path.join(directory, f"{step}.pt"), map_location="cpu",
                         weights_only=True)
    state.module.load_state_dict(payload["module"])
    opt = payload["opt"]
    if len(opt["mu"]) != len(state.opt_state.mu):
        raise ValueError(f"{directory}/{step}.pt holds {len(opt['mu'])} moments, "
                         f"the state {len(state.opt_state.mu)}")
    with torch.no_grad():
        for dst, src in zip(state.opt_state.mu + state.opt_state.nu, opt["mu"] + opt["nu"]):
            dst.copy_(src)
    state.opt_state.count = int(opt["count"])
    state.step = int(payload["step"])
    return state


def _best_dir(directory: str) -> str:
    return directory.rstrip("/") + "_best"


def _best_metric_path(directory: str) -> str:
    return _best_dir(directory) + ".metric.json"


def best_metric(directory: str) -> Optional[float]:
    """The tracked best validation metric of a stage directory, if any."""
    try:
        with open(_best_metric_path(directory)) as f:
            return float(json.load(f)["metric"])
    except (OSError, ValueError, KeyError):
        return None


def save_best_checkpoint(directory: str, step: int, state: TrainState, metric: float,
                         mesh: Optional[Mesh] = None) -> bool:
    """Save ``state`` under ``<directory>_best`` when ``metric`` is lower
    than the tracked best (or none is tracked); True iff it was saved.
    Under a ``mesh`` every rank reads the tracked best before rank 0
    writes, and returns once the files are whole."""
    prev = best_metric(directory)
    barrier(mesh)
    better = prev is None or metric < prev
    if better and writes(mesh):
        _write_checkpoint(_best_dir(directory), step, state)
        payload = json.dumps({"metric": float(metric), "step": int(step)})

        def write(p):
            with open(p, "w") as f:
                f.write(payload)

        _atomic_write(_best_metric_path(directory), write)
    barrier(mesh)
    return better


def restore_best_or_latest(directory: str, state: TrainState, *,
                           report: bool = False) -> Union[TrainState, Tuple[TrainState, bool]]:
    """Restore the best-metric checkpoint when one is tracked, else the
    latest periodic one, else leave ``state`` as it is. With ``report``
    returns ``(state, restored)``."""
    restored = False
    for d in (_best_dir(directory), directory):
        step = latest_step(d)
        if step is not None:
            restore_checkpoint(d, state, step)
            restored = True
            break
    return (state, restored) if report else state
