"""Shared training scaffolding: the train state, AdamW with global-norm
clipping and learning-rate schedules, microbatch accumulation.

Counterpart of ``gaze_tpu/train/common.py``. A stage's state is one of
the pipeline's modules (its trainable parameters and its BatchNorm
running statistics) plus the optimizer's moments and the step count; a
step function updates it in place on the module's device.

Data parallelism (a step made with ``mesh=``) keeps the JAX step's
global-batch semantics without ``DistributedDataParallel``, whose
reducer hooks never fire under the ``torch.autograd.grad`` the steps
use. Each rank feeds its rows of the global batch
(``core.distributed.local_batch_rows``) and computes its share of the
global loss: every mean over the batch is a sum over the rank's rows
divided by the global denominator (``floss``, the AT masked MSE), and
train-mode BatchNorm normalizes with the global batch's statistics. The
shares add up to the global loss, so one SUM all-reduce of the
flattened gradients and the loss (:func:`dp_reduce`), before AdamW,
gives every rank the global gradient: the clip reads its global norm,
and the parameters, moments and BatchNorm statistics stay equal on
every rank, bit for bit.

The optimizer is optax's, written out (``optax.adamw`` behind
``optax.clip_by_global_norm``), not ``torch.optim.AdamW``, whose update
differs:

- AdamW: ``p <- p - lr_t * (m_hat / (sqrt(v_hat) + eps) + wd * p)``
  with ``eps`` outside the square root (``eps_root`` 0), the moments
  ``(1 - b) * g + b * m``, the bias corrections ``1 - b^count`` in
  float32 at the incremented count;
- the schedule is read at the count before the update: step 0 of a
  warmup has lr 0;
- clipping scales by ``max_norm / g_norm`` only when ``g_norm >=
  max_norm`` (``torch.nn.utils.clip_grad_norm_`` divides by
  ``g_norm + 1e-6`` whenever it clips);
- the schedules compute in float32 as optax's do.

Spans (``utils/profiling.py``, recorded only inside a ``recording()``),
the same in every stage's step: ``train.upload`` (:func:`to_device`, the
batch to the card), ``train.forward`` (the loss, with the inputs'
preprocessing), ``train.backward`` (``torch.autograd.grad``),
``train.reduce`` (:func:`dp_reduce`, under a mesh) and
``train.optimizer`` (:meth:`TrainState.apply_gradients`); counter
``train.steps``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from gaze_tpu_torch.core.config import TrainConfig
from gaze_tpu_torch.core.distributed import all_reduce_flat_
from gaze_tpu_torch.parallel.mesh import Mesh, checked
from gaze_tpu_torch.utils.profiling import count, span

Schedule = Callable[[int], float]
LearningRate = Union[float, Schedule]

_F32 = np.float32


# ------------------------------------------------------------ schedules ----
def _linear_schedule(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule (a polynomial of power 1)."""
    if steps <= 0:
        return lambda count: init

    def schedule(count: int) -> float:
        c = min(max(count, 0), steps)
        frac = _F32(1) - _F32(c) / _F32(steps)
        return float(_F32(init - end) * frac + _F32(end))

    return schedule


def _cosine_schedule(init: float, decay_steps: int) -> Schedule:
    """optax.cosine_decay_schedule with alpha 0 and exponent 1."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs decay_steps > 0, got {decay_steps}")

    def schedule(count: int) -> float:
        c = _F32(min(count, decay_steps))
        cos = _F32(0.5) * (_F32(1) + np.cos(_F32(np.pi) * c / _F32(decay_steps)))
        return float(_F32(init) * cos)

    return schedule


def _staircase_schedule(init: float, steps: int, rate: float) -> Schedule:
    """optax.exponential_decay(staircase=True)."""
    if steps <= 0 or rate == 0:
        return lambda count: init

    def schedule(count: int) -> float:
        if count <= 0:
            return init
        p = np.floor(_F32(count) / _F32(steps))
        return float(_F32(init) * np.power(_F32(rate), p))

    return schedule


def _join(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    """optax.join_schedules: each schedule counts from its boundary."""

    def schedule(count: int) -> float:
        out = schedules[0](count)
        for b, s in zip(boundaries, schedules[1:]):
            if count >= b:
                out = s(count - b)
        return out

    return schedule


def make_lr_schedule(cfg: TrainConfig) -> Schedule:
    """The learning rate by optimizer count: "constant", "cosine" (linear
    warmup, then cosine decay to 0 by ``lr_decay_steps``) or "step" (x
    ``lr_decay_rate`` every ``lr_decay_steps``); warmup applies to all."""
    base = cfg.learning_rate
    warm = max(0, cfg.warmup_steps)
    if cfg.lr_schedule == "constant":
        sched: Schedule = lambda count: base
    elif cfg.lr_schedule == "cosine":
        if cfg.lr_decay_steps <= 0:
            raise ValueError("cosine schedule needs lr_decay_steps > 0")
        decay = max(cfg.lr_decay_steps, warm + 1)
        return _join([_linear_schedule(0.0 if warm else base, base, warm),
                      _cosine_schedule(base, decay - warm)], [warm])
    elif cfg.lr_schedule == "step":
        if cfg.lr_decay_steps <= 0:
            raise ValueError("step schedule needs lr_decay_steps > 0")
        sched = _staircase_schedule(base, cfg.lr_decay_steps, cfg.lr_decay_rate)
    else:
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    if warm:
        sched = _join([_linear_schedule(0.0, base, warm), sched], [warm])
    return sched


# ------------------------------------------------------------ optimizer ----
@dataclasses.dataclass
class AdamWState:
    """The optimizer's state: the update count and the first and second
    moments, one tensor per trainable parameter."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class AdamW:
    """optax's ``adamw`` (b1 0.9, b2 0.999, eps 1e-8) behind
    ``clip_by_global_norm`` when ``clip_norm > 0``."""

    def __init__(self, learning_rate: LearningRate, weight_decay: float,
                 clip_norm: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def lr(self, count: int) -> float:
        """The learning rate of the update made at optimizer count ``count``."""
        lr = self.learning_rate
        return float(_F32(lr(count) if callable(lr) else lr))

    def init(self, params: Sequence[torch.Tensor]) -> AdamWState:
        return AdamWState(0, [torch.zeros_like(p) for p in params],
                          [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               state: AdamWState) -> None:
        """One update of ``params`` and ``state`` in place."""
        params, grads = list(params), list(grads)
        if self.clip_norm > 0:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = g_norm < self.clip_norm
            grads = [torch.where(keep, g, (g / g_norm) * self.clip_norm) for g in grads]
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_add_(state.nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
        lr = self.lr(state.count)
        state.count += 1
        bc1 = float(1 - _F32(b1) ** _F32(state.count))
        bc2 = float(1 - _F32(b2) ** _F32(state.count))
        mu_hat = torch._foreach_div(state.mu, bc1)
        den = torch._foreach_sqrt(torch._foreach_div(state.nu, bc2))
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu_hat, den)
        torch._foreach_add_(upd, torch._foreach_mul(params, self.weight_decay))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(params, upd)


def make_optimizer(cfg: TrainConfig) -> AdamW:
    """AdamW on the configured schedule (a plain float for constant with
    no warmup), behind global-norm clipping when ``grad_clip_norm > 0``."""
    if cfg.lr_schedule == "constant" and cfg.warmup_steps <= 0:
        lr: LearningRate = cfg.learning_rate
    else:
        lr = make_lr_schedule(cfg)
    return AdamW(lr, cfg.weight_decay, cfg.grad_clip_norm)


# ---------------------------------------------------------------- state ----
BATCH_STAT_SUFFIXES = (".running_mean", ".running_var")


class TrainState:
    """A module trained in place, its optimizer and the step count.

    ``params`` are the module's parameters that require grad, in module
    order; ``batch_stats`` its BatchNorm running statistics (empty for
    AT and LF).
    """

    def __init__(self, module: nn.Module, tx: AdamW, step: int = 0):
        self.module = module
        self.tx = tx
        self.step = step
        self.param_names = [n for n, p in module.named_parameters() if p.requires_grad]
        self.opt_state = tx.init(self.params)

    @property
    def params(self) -> List[torch.Tensor]:
        named = dict(self.module.named_parameters())
        return [named[n] for n in self.param_names]

    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return {n: b for n, b in self.module.named_buffers()
                if n.endswith(BATCH_STAT_SUFFIXES)}

    @torch.no_grad()
    def apply_gradients(self, grads: Sequence[torch.Tensor],
                        new_batch_stats: Optional[Dict[str, torch.Tensor]] = None
                        ) -> "TrainState":
        """One optimizer update; the BatchNorm statistics become
        ``new_batch_stats`` when given."""
        count("train.steps")
        with span("train.optimizer"):
            self.tx.update(self.params, grads, self.opt_state)
            if new_batch_stats:
                stats = self.batch_stats()
                for k, v in new_batch_stats.items():
                    stats[k].copy_(v)
        self.step += 1
        return self


def make_state(module: nn.Module, tx: AdamW) -> TrainState:
    return TrainState(module, tx)


def microbatch_value_and_grad(
    loss_fn: Callable[[Dict[str, torch.Tensor]], Tuple[torch.Tensor, Any]],
    params: Sequence[torch.Tensor],
    batch: Dict[str, torch.Tensor],
    num_microbatches: int,
    mesh: Optional[Mesh] = None,
) -> Tuple[Tuple[torch.Tensor, Any], List[torch.Tensor]]:
    """Gradient accumulation: ``batch`` split into ``num_microbatches``
    equal leading-dim slices, ``loss_fn(microbatch) -> (loss, aux)``
    differentiated per slice (one slice's activations alive at a time).

    Returns ``((mean loss, aux of the last microbatch), mean gradients)``.
    With train-mode BatchNorm each microbatch normalizes with its own
    statistics, and ``aux``, the new running statistics, is the last
    microbatch's update taken from the step's initial statistics (the
    forward does not store them).

    With a ``mesh``, ``batch`` is the rank's rows in the microbatch
    layout (``local_batch_rows``: slice i is its share of global
    microbatch i), ``loss_fn`` returns the rank's share of the global
    loss, and the loss and gradients come back all-reduced
    (:func:`dp_reduce`): the global ones, on every rank."""
    params = list(params)
    k = max(1, num_microbatches)
    for key, v in batch.items():
        if v.shape[0] % k:
            raise ValueError(f"batch dim {v.shape[0]} of {key!r} not divisible by "
                             f"grad_accum={k}")
    loss_sum = grad_sum = aux = None
    for i in range(k):
        mb = batch if k == 1 else {key: v.chunk(k)[i] for key, v in batch.items()}
        with span("train.forward"):
            loss, aux = loss_fn(mb)
        with span("train.backward"):
            grads = torch.autograd.grad(loss, params, allow_unused=True,
                                        materialize_grads=True)
        loss = loss.detach()
        if k == 1:
            loss, grads = dp_reduce(loss, grads, mesh)
            return (loss, aux), grads
        loss_sum = loss if loss_sum is None else loss_sum + loss
        grad_sum = list(grads) if grad_sum is None else torch._foreach_add(grad_sum, grads)
    loss, grads = dp_reduce(loss_sum / k, torch._foreach_div(grad_sum, k), mesh)
    return (loss, aux), grads


def dp_reduce(loss: torch.Tensor, grads: Sequence[torch.Tensor], mesh: Optional[Mesh]
              ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The global loss and gradients from the rank's shares: one SUM
    all-reduce of the flattened gradients with the loss appended.
    Without a mesh they pass through."""
    if mesh is None:
        return loss, list(grads)
    with span("train.reduce"):
        out = all_reduce_flat_([g.detach() for g in grads] + [loss.detach().reshape(1)], mesh)
    return out[-1].reshape(()), out[:-1]


def jit_dp_step(step_fn: Callable, mesh: Optional[Mesh] = None) -> Callable:
    """The step as it runs (the port compiles nothing). A step made for
    a ``mesh`` does its own reductions (:func:`dp_reduce`, the global
    denominators, BatchNorm's global statistics) and takes this rank's
    rows of each global batch; a process outside the mesh is refused
    here."""
    checked(mesh)
    return step_fn


def to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    with span("train.upload"):
        return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
