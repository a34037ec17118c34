"""Fixation/saccade segmentation from raw gaze (I-DT dispersion).

The port's own copy of ``gaze_tpu/data/fixation.py``: the standard I-DT
dispersion-threshold algorithm (Salvucci & Goldberg 2000). A window of
samples is a fixation while its dispersion (x-extent + y-extent) stays
under a threshold and it lasts at least ``min_duration`` frames. Host
numpy: labels are data preparation, not device work.
"""

from __future__ import annotations

import numpy as np


def detect_fixations_idt(
    gaze: np.ndarray,
    dispersion_px: float = 25.0,
    min_duration: int = 3,
    valid: np.ndarray | None = None,
) -> np.ndarray:
    """I-DT fixation labeling.

    Args:
      gaze: (T, 2) gaze points in pixels (native resolution).
      dispersion_px: max (x-extent + y-extent) of a fixation window.
      min_duration: minimum fixation length in frames.
      valid: optional (T,) bool — untracked frames. Invalid frames are
        always labeled saccade and split fixation windows, so garbage
        coordinates can neither seed nor extend a fixation.

    Returns:
      (T,) float32 labels: 1.0 fixation, 0.0 saccade — the reference's
      fixsac format.
    """
    gaze = np.asarray(gaze, dtype=np.float64)
    if valid is not None:
        valid = np.asarray(valid, bool)
        labels = np.zeros((len(gaze),), np.float32)
        # Run I-DT independently on each contiguous tracked run.
        start = None
        for t in range(len(gaze) + 1):
            if t < len(gaze) and valid[t]:
                if start is None:
                    start = t
            elif start is not None:
                labels[start:t] = detect_fixations_idt(
                    gaze[start:t], dispersion_px, min_duration
                )
                start = None
        return labels
    T = len(gaze)
    labels = np.zeros((T,), np.float32)

    def dispersion(lo: int, hi: int) -> float:  # window [lo, hi)
        g = gaze[lo:hi]
        return float(
            (g[:, 0].max() - g[:, 0].min()) + (g[:, 1].max() - g[:, 1].min())
        )

    i = 0
    while i <= T - min_duration:
        j = i + min_duration
        if dispersion(i, j) > dispersion_px:
            i += 1
            continue
        # grow the window while dispersion stays under threshold
        while j < T and dispersion(i, j + 1) <= dispersion_px:
            j += 1
        labels[i:j] = 1.0
        i = j
    return labels


def fixation_segments(fixsac: np.ndarray) -> list[tuple[int, int]]:
    """[start, end) frame ranges of each fixation run in a fixsac track."""
    segs = []
    start = None
    for t, v in enumerate(np.asarray(fixsac)):
        if v > 0 and start is None:
            start = t
        elif v <= 0 and start is not None:
            segs.append((start, t))
            start = None
    if start is not None:
        segs.append((start, len(fixsac)))
    return segs
