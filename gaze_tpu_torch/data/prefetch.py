"""Host-side prefetch: the next batches are staged on the card while the
current step runs.

Counterpart of ``gaze_tpu/data/prefetch.py``. A daemon thread takes
batches (dicts of numpy arrays or tensors) from the host iterator, and
for a CUDA device copies each entry from pinned host memory on a side
CUDA stream, recording an event after the copies; the consumer makes
its current stream wait on that event and marks the tensors as used
there, so the allocator cannot hand their memory out early. For a CPU
device the entries only become tensors. An exception in the producer
(a corrupt input, a failed copy) is relayed to the consumer and raised
there, not swallowed as an early end of the epoch. With a data ``mesh``
only this rank's rows of each global batch are staged, on the rank's
card.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional

import torch

from gaze_tpu_torch.core.device import resolve_device
from gaze_tpu_torch.core.distributed import local_rows
from gaze_tpu_torch.parallel.mesh import Mesh, checked

_END = object()


def device_prefetch(it: Iterator[Dict[str, Any]], device=None, buffer_size: int = 2,
                    mesh: Optional[Mesh] = None, num_microbatches: int = 1
                    ) -> Iterator[Dict[str, torch.Tensor]]:
    """Wrap a host batch iterator; up to ``buffer_size`` batches are in
    flight. ``device=None`` means ``cuda``. With a ``mesh`` each batch
    is cut to this rank's rows (``local_batch_rows`` for
    ``num_microbatches``) and staged on ``mesh.device``."""
    dev = checked(mesh).device if mesh is not None else resolve_device(device)
    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def stage(batch):
        batch = local_rows(batch, mesh, num_microbatches)
        if side is None:
            return {k: torch.as_tensor(v) for k, v in batch.items()}, None
        with torch.cuda.stream(side):
            out = {k: torch.as_tensor(v).pin_memory().to(dev, non_blocking=True)
                   for k, v in batch.items()}
            ev = torch.cuda.Event()
            ev.record(side)
        return out, ev

    def producer():
        try:
            for batch in it:
                q.put(stage(batch))
            q.put(_END)
        except BaseException as e:  # noqa: BLE001 — relayed to the consumer, not dropped
            q.put(e)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        batch, ev = item
        if ev is not None:
            cur = torch.cuda.current_stream(dev)
            cur.wait_event(ev)
            for t in batch.values():
                t.record_stream(cur)
        yield batch
