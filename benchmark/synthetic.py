"""Synthetic moving-dot sequences (numpy, host side).

A copy of ``gaze_tpu_torch/data/synthetic.py:generate_sequence`` (its
single-blob corpus), so the benchmark's traffic does not move when the
program's copy does. A bright Gaussian blob moves over a static textured
background in fixation/saccade alternation; the blob centre is the gaze
point and the frames where it holds still are fixations. One seed gives
the same frames, gaze and fixation bits every time.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

BLOB_SIGMA = 8.0
FIXATION_LEN = 8
SACCADE_LEN = 2
BACKGROUND_SCALE = 0.25


def generate_sequence(num_frames: int, height: int, width: int, seed: int,
                      background_scale: float = BACKGROUND_SCALE
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(frames (T, H, W, 3) uint8, gaze (T, 2) float32 (x, y) pixels,
    fixsac (T,) float32: 1 on fixation frames) of one sequence; the
    background's texture is uniform in [0, ``background_scale``)."""
    rng = np.random.default_rng(seed)
    T, H, W = num_frames, height, width
    bg = rng.uniform(0.0, background_scale, size=(H, W, 3)).astype(np.float32)
    gaze = np.zeros((T, 2), np.float32)
    fixsac = np.zeros((T,), np.float32)
    margin = min(4 * BLOB_SIGMA, min(H, W) / 4.0)
    cur = rng.uniform([margin, margin], [W - margin, H - margin])
    t = 0
    while t < T:
        for _ in range(FIXATION_LEN):
            if t >= T:
                break
            gaze[t] = cur + rng.normal(0.0, 0.3, size=2)
            fixsac[t] = 1.0
            t += 1
        nxt = rng.uniform([margin, margin], [W - margin, H - margin])
        for k in range(SACCADE_LEN):
            if t >= T:
                break
            a = (k + 1) / (SACCADE_LEN + 1)
            gaze[t] = (1 - a) * cur + a * nxt
            t += 1
        cur = nxt
    ys = np.arange(H, dtype=np.float32)[:, None]
    xs = np.arange(W, dtype=np.float32)[None, :]
    frames = np.zeros((T, H, W, 3), np.uint8)
    for i in range(T):
        d2 = (xs - gaze[i, 0]) ** 2 + (ys - gaze[i, 1]) ** 2
        blob = np.exp(-d2 / (2 * BLOB_SIGMA ** 2)).astype(np.float32)
        frames[i] = (np.clip(bg + blob[..., None], 0.0, 1.0) * 255.0).astype(np.uint8)
    return frames, gaze, fixsac


def sequence_seeds(seed: int, n: int) -> np.ndarray:
    """``n`` distinct numpy seeds drawn from a run's ``--seed`` (any
    non-negative whole number, wider than 32 bits too)."""
    seeds = np.random.default_rng(seed).integers(0, 2 ** 62, size=n)
    if len(set(seeds.tolist())) != n:
        raise ValueError(f"seed {seed} drew a repeated sequence seed")
    return seeds
