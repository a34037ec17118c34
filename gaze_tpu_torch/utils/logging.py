"""Structured step logging and heatmap image dumps.

Counterpart of ``gaze_tpu/utils/logging.py``: ``StepLogger`` writes one
JSON line per logged step, ``{"stage", "step", "steps_per_sec",
<metrics>}``, where steps/s counts the steps since the previous logged
line, and with ``tboard_dir`` mirrors every logged scalar into a
TensorBoard events file under ``<tboard_dir>/<name>/``
(``utils/tboard.py``). A metric may be a tensor on the card: it is
copied to the host only on a logged step. ``dump_heatmap_png`` writes a
predicted heatmap, optionally blended over its frame, as a PNG.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional

import numpy as np


class StepLogger:
    def __init__(self, name: str, every: int = 50, stream=None,
                 tboard_dir: Optional[str] = None):
        self.name = name
        self.every = every
        self.stream = stream or sys.stdout
        self._t0 = time.perf_counter()
        self._last_step = 0
        self._tb = None
        if tboard_dir:
            from gaze_tpu_torch.utils.tboard import SummaryWriter

            self._tb = SummaryWriter(os.path.join(tboard_dir, name))

    def log(self, step: int, metrics: Dict[str, Any], force: bool = False) -> None:
        if not force and step % self.every != 0:
            return
        now = time.perf_counter()
        dt = now - self._t0
        sps = (step - self._last_step) / dt if dt > 0 else 0.0
        self._t0, self._last_step = now, step
        vals = {k: float(v) for k, v in metrics.items()}
        line = {"stage": self.name, "step": step, "steps_per_sec": round(sps, 2), **vals}
        self.stream.write(json.dumps(line) + "\n")
        self.stream.flush()
        if self._tb is not None:
            self._tb.add_scalars(vals, step)
            self._tb.flush()


def dump_heatmap_png(path: str, heatmap: np.ndarray, frame: Optional[np.ndarray] = None) -> None:
    """Write a (H, W) heatmap, min-max normalized, as a grayscale PNG, or
    blended as red over the (H, W, 3) uint8 ``frame``."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    hm = np.asarray(heatmap, dtype=np.float32)
    hm = (hm - hm.min()) / (hm.max() - hm.min() + 1e-8)
    if frame is not None:
        img = np.asarray(frame, dtype=np.float32)
        red = np.zeros_like(img)
        red[..., 0] = 255.0
        out = (0.5 * img + 0.5 * red * hm[..., None]).clip(0, 255).astype(np.uint8)
    else:
        out = (hm * 255).astype(np.uint8)
    Image.fromarray(out).save(path)
