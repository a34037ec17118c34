"""Multi-stream gaze serving on the card.

Counterpart of ``gaze_tpu/serve.py::StreamServer``. A fixed pool of S
video streams advances in lockstep through one pipeline step per tick
(flow -> SP -> AT -> LF), with each stream's recurrent state (LSTM
carries, last attention weights, previous frame) kept on the device
between ticks. The pool size is fixed at construction; inactive slots
are masked, so attaching and detaching streams changes no shape.

``submit()`` pipelines the host-to-device copy of the next frame batch
behind the current tick: on the card the copy runs from pinned host
memory on a side CUDA stream, and the compute stream waits on its event
before the tick that consumes it.

Across cards, one process per card (``core.distributed``):

- ``StreamServer(mesh=)``: every rank is handed the whole pool's frames,
  as the JAX server's single program sees the whole array, computes its
  contiguous ``max_streams / size`` slots, and the per-slot results are
  all-gathered, so every rank returns the whole pool's;
- ``DistributedStreamServer``: each rank owns ``streams_per_host``
  slots, is handed only their frames and returns only their results.
  Its tick holds no collective (the streams are independent), so a rank
  may attach, detach or drain a pending submit without the others.

Not ported: the JAX server's ahead-of-time layout path, which has no
counterpart here.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional

import numpy as np
import torch

from gaze_tpu_torch.core.config import PipelineConfig
from gaze_tpu_torch.core.distributed import all_gather_rows, global_mesh, local_batch_slice
from gaze_tpu_torch.models.pipeline import GazePipeline, StreamState
from gaze_tpu_torch.models.quant import QuantSP
from gaze_tpu_torch.models.weights import StateDict
from gaze_tpu_torch.parallel.mesh import Mesh, checked


def _map_state(fn, a: StreamState, b: StreamState) -> StreamState:
    """``fn(x, y)`` over the matching tensors of two StreamStates."""
    return StreamState(
        carries=[(fn(ac, bc), fn(ah, bh)) for (ac, ah), (bc, bh) in zip(a.carries, b.carries)],
        w_hat=fn(a.w_hat, b.w_hat),
        prev_fix=fn(a.prev_fix, b.prev_fix),
        prev_gaze=fn(a.prev_gaze, b.prev_gaze),
    )


class StreamServer:
    """Stateful server over a fixed pool of ``max_streams`` video streams.

    Args:
      config: the pipeline config (``preset_config(...)`` etc.).
      weights: ``{"sp", "at", "lf"}`` state dicts, as
        ``GazePipeline.state_dicts()`` or the weight bridge give them.
      max_streams: the pool size S.
      dtype: activation type (float32 or bfloat16).
      keep_heatmaps: also return the three maps of every tick.
      fixation_source: what gates the AT LSTM when a tick gets no
        fixation bits (explicit ``fixations`` always win):
        - "idt": online I-DT on each stream's own predicted gaze: a slot
          is in fixation when its last ``idt_window`` predictions exist
          and their dispersion (x-extent + y-extent) is at most
          ``idt_dispersion_px`` model-grid pixels;
        - "static": every frame a fixation, so the onset-gated LSTM
          advances once per stream and its attention stays frozen
          ("always" is a deprecated alias that warns).
      quant_sp, at_pool, decoder_impl, quant_conv: as ``GazePipeline``.
      mesh: a data mesh (``parallel.mesh.make_mesh``): the pool splits
        into ``size`` contiguous blocks of slots (``max_streams`` must
        divide evenly) and this rank computes its block on
        ``mesh.device``. Every rank makes the same calls with the whole
        pool's frames and gets the whole pool's results (all-gathered),
        so the calls are collective: every rank makes them in the same
        order.
      device: ``None`` means ``cuda`` (raises without it); ``"cpu"`` runs
        the plain path; under a ``mesh``, the mesh's device.
    """

    def __init__(
        self,
        config: PipelineConfig,
        weights: Dict[str, StateDict],
        max_streams: int,
        dtype: torch.dtype = torch.float32,
        keep_heatmaps: bool = False,
        fixation_source: str = "idt",
        idt_dispersion_px: float = 8.0,
        idt_window: int = 3,
        quant_sp: QuantSP | None = None,
        at_pool: str = "sp_argmax",
        decoder_impl: str = "deconv",
        quant_conv: str = "xla",
        mesh: Mesh | None = None,
        device=None,
    ):
        if fixation_source == "always":
            warnings.warn(
                'fixation_source="always" advances the LSTM exactly once per stream '
                '(onset gating): it is named "static"; the "always" alias will be removed.',
                DeprecationWarning,
                stacklevel=2,
            )
            fixation_source = "static"
        if fixation_source not in ("idt", "static"):
            raise ValueError(f"unknown fixation_source {fixation_source!r}")
        self.mesh = self._gather = checked(mesh)
        # the slots this process computes: its block of the pool under a
        # mesh, else all of them
        self._rows = slice(0, max_streams)
        if mesh is not None:
            if max_streams % mesh.size:
                raise ValueError(
                    f"max_streams={max_streams} must divide evenly over the "
                    f"{mesh.size}-rank mesh (one equal block of slots per rank)")
            self._rows = local_batch_slice(max_streams, mesh)
            device = mesh.device
        self.pipeline = GazePipeline(
            config, dtype=dtype, device=device, quant_sp=quant_sp, at_pool=at_pool,
            decoder_impl=decoder_impl, quant_conv=quant_conv,
        )
        self.pipeline.load_state_dicts(weights)
        self.device = self.pipeline.device
        self.max_streams = max_streams
        self.keep_heatmaps = keep_heatmaps
        self.fixation_source = fixation_source
        self._idt_dispersion = idt_dispersion_px
        self._idt_window = idt_window
        h, w = config.image.height, config.image.width
        rows = self._rows.stop - self._rows.start
        self._state = self.pipeline.init_state(rows)
        self._prev = torch.zeros((rows, h, w, 3), dtype=torch.uint8, device=self.device)
        self._active = np.zeros((max_streams,), bool)
        self._seen_first = np.zeros((max_streams,), bool)
        # trailing predicted-gaze window for online I-DT (NaN = no sample)
        self._gaze_hist = np.full((max_streams, idt_window, 2), np.nan, np.float32)
        # submit(): the staged frame batch (its copy may be in flight), the
        # event that ends its copy, and its fixation bits
        self._pending = None
        self._pending_fix = None
        # the result of a drain forced by attach()/detach(), handed out by
        # the next submit() or flush()
        self._stash = None
        self._copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    # ------------------------------------------------------- control ----
    def attach(self, slot: int) -> None:
        """Claim a stream slot; its recurrent state starts fresh."""
        self._drain_pending()
        self._active[slot] = True
        self._seen_first[slot] = False
        self._gaze_hist[slot] = np.nan
        self._reset_slot(slot)

    def detach(self, slot: int) -> None:
        self._drain_pending()
        self._active[slot] = False

    def active_slots(self) -> np.ndarray:
        return np.flatnonzero(self._active)

    def _drain_pending(self) -> None:
        """An attach or detach while a submit() is pending: the pending
        batch was staged under the old slot bookkeeping, so it is ticked
        first and its result kept for the caller."""
        if self._pending is not None:
            self._stash = self.flush()

    def _idt_labels(self) -> np.ndarray:
        """Per-slot fixation bits from the trailing predicted-gaze window:
        full (no NaN sample) and dispersion within the threshold."""
        g = self._gaze_hist
        full = ~np.isnan(g).any(axis=(1, 2))
        ext = np.nan_to_num(g.max(axis=1) - g.min(axis=1), nan=np.inf)
        disp = ext[:, 0] + ext[:, 1]
        return (full & (disp <= self._idt_dispersion)).astype(np.float32)

    @torch.inference_mode()
    def _reset_slot(self, slot: int) -> None:
        if not self._rows.start <= slot < self._rows.stop:
            return   # another rank's slot
        slot -= self._rows.start
        fresh = self.pipeline.init_state(1)

        def put(cur, new):   # a new tensor: state tensors may alias each other
            out = cur.clone()
            out[slot:slot + 1] = new
            return out

        self._state = _map_state(put, self._state, fresh)

    # ---------------------------------------------------------- tick ----
    def _stage(self, frames):
        """Start the host-to-device copy of this process's slots of a (S,
        H, W, 3) uint8 batch. Returns (device tensor, the event that ends
        its copy or None).

        On the card the batch goes through pinned host memory on the side
        stream. The copy's destination is allocated on that stream and
        used on the compute stream, so the consuming tick records it
        there (``record_stream``) before the allocator may reuse it; the
        pinned source is held by the caching host allocator until its
        copy has run. A batch already on the server's device is copied too:
        the caller may refill its buffer before the tick that reads it."""
        frames = frames[self._rows]
        if torch.is_tensor(frames) and frames.device == self.device:
            return frames.clone(), None
        host = torch.as_tensor(np.asarray(frames, dtype=np.uint8))
        if self._copy_stream is None:
            return host.clone(), None       # the caller may reuse its buffer
        host = host.pin_memory()
        with torch.cuda.stream(self._copy_stream):
            dev = host.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return dev, done

    def _consume(self, staged):
        dev, done = staged
        if done is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(done)
            dev.record_stream(compute)
        return dev

    @torch.inference_mode()
    def _advance(self, cur: torch.Tensor, fixations) -> Dict[str, np.ndarray]:
        if fixations is None:
            if self.fixation_source == "idt":
                fixations = self._idt_labels()
            else:   # "static": one LSTM onset per stream, ever
                fixations = np.ones(self._active.shape, np.float32)
        fix = np.asarray(fixations, np.float32) * self._active.astype(np.float32)
        # streams without a previous frame keep their fresh state: the flow
        # of their first pair (against a stale or zero prev) is garbage
        first_np = ~self._seen_first & self._active
        first = torch.from_numpy(first_np[self._rows]).to(self.device)
        new_state, out = self.pipeline.step(self._state, self._prev, cur, fix[self._rows])

        def keep_old(new, old):
            return torch.where(first.reshape((-1,) + (1,) * (new.dim() - 1)), old, new)

        self._state = _map_state(keep_old, new_state, self._state)
        self._prev.copy_(cur)   # the server's own buffer, never the caller's tensor

        gaze = all_gather_rows(out["gaze"], self._gather).cpu().numpy().copy()
        gaze[first_np] = -1.0
        gaze[~self._active] = -1.0
        self._seen_first |= self._active
        # slide the I-DT window: sentinel and inactive frames stay NaN, so
        # they never complete a fixation window
        self._gaze_hist = np.roll(self._gaze_hist, -1, axis=1)
        self._gaze_hist[:, -1] = np.where(gaze[:, :1] < 0, np.nan, gaze)

        result = {"gaze": gaze}
        if self.keep_heatmaps:
            for k in ("heatmap", "saliency", "attention"):
                result[k] = all_gather_rows(out[k].float(), self._gather).cpu().numpy()
        return result

    def tick(self, frames, fixations: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """Advance every active stream by one frame.

        Args:
          frames: (S, H, W, 3) uint8, the current frame per slot (an
            inactive slot's content is ignored). S is ``max_streams``; on
            a ``DistributedStreamServer`` it is this rank's
            ``streams_per_host``.
          fixations: optional (S,) fixation bits; without them the server
            derives them per ``fixation_source``.

        Returns:
          "gaze" (S, 2) float32 and, with ``keep_heatmaps``, "heatmap",
          "saliency" and "attention" (S, H, W). A slot seeing its first
          frame, and an inactive one, returns gaze (-1, -1).
        """
        return self._advance(self._consume(self._stage(frames)), fixations)

    def submit(self, frames, fixations: Optional[np.ndarray] = None):
        """Pipelined tick: start this batch's host-to-device copy, then
        advance every stream by the batch of the previous call and return
        its result (results lag one submit; None on the first call)."""
        staged = self._stage(frames)
        result, self._stash = self._stash, None
        if self._pending is not None:
            result = self._advance(self._consume(self._pending), self._pending_fix)
        self._pending, self._pending_fix = staged, fixations
        return result

    def flush(self):
        """Drain the submit() pipeline: tick the pending batch and return
        its result. With none pending, return the result a drain by
        attach()/detach() kept, if any (the JAX server drops it)."""
        if self._pending is None:
            result, self._stash = self._stash, None
            return result
        staged, fix = self._pending, self._pending_fix
        self._pending = self._pending_fix = None
        return self._advance(self._consume(staged), fix)


class DistributedStreamServer(StreamServer):
    """One stream pool over every rank of a mesh, each rank owning a
    contiguous block of ``streams_per_host`` slots (counterpart of
    ``gaze_tpu/serve.py::DistributedStreamServer``).

    A rank is handed only its slots' frames, (streams_per_host, H, W, 3)
    uint8, and returns only their results; ``attach``/``detach`` take
    its local slot indices, and the I-DT fixations run per local slot.
    So every array a rank passes or gets back covers its ``s_local =
    streams_per_host`` slots, while ``max_streams`` is the whole pool's
    size, ``streams_per_host x size``, as on the JAX server; nothing in
    the rank's tick reads it.

    The streams are independent, so the tick holds no collective: the
    ranks need not tick in lockstep, and an ``attach``/``detach`` that
    drains a pending ``submit()`` ticks this rank alone. (The JAX
    server's tick is one program over a global array, so its drain is
    collective, and a rank that attaches while the others do not shifts
    their sequence of ticks; the port has no such hazard.) A reattached
    slot starts from a fresh state and its first frame keeps it fresh,
    as the JAX server's per-slot reset and first-frame revert do; the
    reset is made at ``attach``, which touches only this rank's state
    (the JAX server defers it into the tick, where an update of its
    global state array is collective). ``quant_sp`` takes a ``QuantSP``
    as ``StreamServer`` does. At one rank it is ``StreamServer`` with
    ``max_streams = streams_per_host``.
    """

    def __init__(
        self,
        config: PipelineConfig,
        weights: Dict[str, StateDict],
        streams_per_host: int,
        mesh: Mesh | None = None,
        dtype: torch.dtype = torch.float32,
        keep_heatmaps: bool = False,
        fixation_source: str = "idt",
        idt_dispersion_px: float = 8.0,
        idt_window: int = 3,
        quant_sp: QuantSP | None = None,
        at_pool: str = "sp_argmax",
        decoder_impl: str = "deconv",
        quant_conv: str = "xla",
    ):
        if fixation_source not in ("idt", "static"):
            raise ValueError(f"unknown fixation_source {fixation_source!r}")
        if streams_per_host < 1:
            raise ValueError(f"streams_per_host={streams_per_host}: need at least one slot")
        mesh = checked(mesh if mesh is not None else global_mesh())
        super().__init__(
            config, weights, streams_per_host, dtype=dtype, keep_heatmaps=keep_heatmaps,
            fixation_source=fixation_source, idt_dispersion_px=idt_dispersion_px,
            idt_window=idt_window, quant_sp=quant_sp, at_pool=at_pool,
            decoder_impl=decoder_impl, quant_conv=quant_conv, device=mesh.device)
        self.mesh = mesh
        self.n_proc, self.rank = mesh.size, mesh.rank
        self.s_local = streams_per_host
        self.max_streams = streams_per_host * mesh.size
