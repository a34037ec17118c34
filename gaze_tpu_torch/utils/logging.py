"""Structured step logging: one JSON line per logged step.

Counterpart of ``gaze_tpu/utils/logging.py:StepLogger`` with the same
line format, ``{"stage", "step", "steps_per_sec", <metrics>}``, where
steps/s counts the steps since the previous logged line. A metric may be
a tensor on the card: it is copied to the host only on a logged step.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict


class StepLogger:
    def __init__(self, name: str, every: int = 50, stream=None):
        self.name = name
        self.every = every
        self.stream = stream or sys.stdout
        self._t0 = time.perf_counter()
        self._last_step = 0

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
