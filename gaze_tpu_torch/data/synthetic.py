"""Synthetic moving-dot gaze dataset (numpy, host side).

The port's own copy of ``gaze_tpu/data/synthetic.py``, line for line in
its generator, so one seed gives the same frames, gaze and fixation bits
in both packages (``tests/test_torch_evaluation.py`` holds them equal).
A bright Gaussian blob moves over a textured background in
fixation/saccade alternation: the blob centre is the gaze point, and the
frames where it holds still are fixations. ``num_blobs > 1`` gives the
task-cycle corpus (distinct-colour blobs visited in a fixed order).

Frames are uint8 HWC, like decoded video frames, so the pipeline's
on-device preprocessing runs end to end.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    num_frames: int = 64
    height: int = 224
    width: int = 224
    blob_sigma: float = 8.0
    # Frames per fixation segment / per saccade transition.
    fixation_len: int = 8
    saccade_len: int = 2
    background_scale: float = 0.25
    seed: int = 0
    # num_blobs > 1 switches to the TASK-CYCLE corpus: K distinct-color
    # blobs, all equally bright/mobile (no bottom-up cue singles one
    # out), with gaze visiting them in a fixed color order shared by
    # every seed — the task structure the AT LSTM can learn and
    # bottom-up saliency cannot (the paper's thesis, made testable
    # offline; see docs/STATUS.md ablation). num_blobs == 1 keeps the
    # original moving-dot corpus bit-exactly (pinned goldens).
    num_blobs: int = 1
    # Per-frame random-walk std of each blob center (px); > 0 gives the
    # temporal stream flow signal at every blob equally.
    blob_drift: float = 0.6
    # Task-cycle bottom-up cue: with probability cue_prob a fixation
    # segment renders its target blob at cue_gain x brightness. The cue
    # is the phase evidence: SP can exploit it only on cued segments,
    # while the AT transition LSTM can carry phase THROUGH uncued ones
    # (and re-lock after a desync) — this is what separates the full
    # model from bottom-up saliency without making the task impossible
    # (cue_prob 0 leaves the cycle phase unobservable: anti-phase
    # rollouts are self-consistent and no model can beat chance).
    cue_prob: float = 0.5
    cue_gain: float = 1.35


# Fixed palette for the task-cycle corpus: the color ORDER is the task
# (identical across seeds — learnable); positions are per-seed.
BLOB_PALETTE = (
    (1.0, 0.25, 0.25),
    (0.25, 1.0, 0.25),
    (0.35, 0.45, 1.0),
    (1.0, 1.0, 0.3),
    (1.0, 0.4, 1.0),
    (0.4, 1.0, 1.0),
)


def generate_sequence(spec: SyntheticSpec) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Generate one video sequence.

    Returns:
      frames: (T, H, W, 3) uint8.
      gaze:   (T, 2) float32 (x, y) pixel coords of the blob center.
      fixsac: (T,) float32 — 1.0 on fixation frames, 0.0 during saccades
              (the reference's per-frame fixation labels, SURVEY.md §2
              "Fixation labels" [M]).
    """
    if spec.num_blobs > 1:
        return _generate_task_cycle(spec)
    rng = np.random.default_rng(spec.seed)
    T, H, W = spec.num_frames, spec.height, spec.width

    # Static textured background so optical flow has signal.
    bg = rng.uniform(0.0, spec.background_scale, size=(H, W, 3)).astype(np.float32)

    gaze = np.zeros((T, 2), np.float32)
    fixsac = np.zeros((T,), np.float32)

    # Keep the blob inside the frame; clamp for small test frames.
    margin = min(4 * spec.blob_sigma, min(H, W) / 4.0)
    cur = rng.uniform([margin, margin], [W - margin, H - margin])
    t = 0
    while t < T:
        # Fixation: hold position (with sub-pixel jitter).
        for _ in range(spec.fixation_len):
            if t >= T:
                break
            jitter = rng.normal(0.0, 0.3, size=2)
            gaze[t] = cur + jitter
            fixsac[t] = 1.0
            t += 1
        # Saccade: jump toward a new target over a few frames.
        nxt = rng.uniform([margin, margin], [W - margin, H - margin])
        for k in range(spec.saccade_len):
            if t >= T:
                break
            a = (k + 1) / (spec.saccade_len + 1)
            gaze[t] = (1 - a) * cur + a * nxt
            fixsac[t] = 0.0
            t += 1
        cur = nxt

    ys = np.arange(H, dtype=np.float32)[:, None]
    xs = np.arange(W, dtype=np.float32)[None, :]
    frames = np.zeros((T, H, W, 3), np.uint8)
    for i in range(T):
        d2 = (xs - gaze[i, 0]) ** 2 + (ys - gaze[i, 1]) ** 2
        blob = np.exp(-d2 / (2 * spec.blob_sigma**2)).astype(np.float32)
        img = np.clip(bg + blob[..., None], 0.0, 1.0)
        frames[i] = (img * 255.0).astype(np.uint8)
    return frames, gaze, fixsac


def _generate_task_cycle(
    spec: SyntheticSpec,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Task-cycle corpus: K distinct-color blobs; gaze cycles them in
    the FIXED palette order (0 -> 1 -> ... -> K-1 -> 0), starting at a
    per-seed phase.

    Why this separates the full model from bottom-up saliency: the
    blobs are equally sized and drift with identical statistics, and
    the only per-frame evidence of WHICH blob is fixated is a weak,
    UNRELIABLE brightness cue (present on ~cue_prob of fixation
    segments). SP can exploit the cue only where it exists — on uncued
    segments its argmax is ~chance across blobs. The color transition
    order (fixed across seeds) is the persistent signal, and it lives
    exactly where the reference puts it: in the attention-transition
    LSTM — channel weights pooled at a fixation encode the fixated
    blob's color, the LSTM learns color c -> next color, and the
    anticipation map carries phase through uncued segments (re-locking
    from any cued one).
    """
    rng = np.random.default_rng(spec.seed)
    T, H, W = spec.num_frames, spec.height, spec.width
    K = spec.num_blobs
    if K > len(BLOB_PALETTE):
        raise ValueError(f"num_blobs <= {len(BLOB_PALETTE)} (palette size)")

    bg = rng.uniform(0.0, spec.background_scale, size=(H, W, 3)).astype(np.float32)
    margin = min(4 * spec.blob_sigma, min(H, W) / 4.0)
    min_sep = max(6.0 * spec.blob_sigma, 2.0 * margin)

    # Rejection-sample well-separated starting centers (best effort on
    # tiny frames: keep the most-separated draw seen).
    best, best_d = None, -1.0
    for _ in range(200):
        pos = rng.uniform([margin, margin], [W - margin, H - margin], size=(K, 2))
        d = np.inf if K == 1 else np.min(
            np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
            + np.eye(K) * 1e9
        )
        if d > best_d:
            best, best_d = pos, d
        if d >= min_sep:
            break
    centers = np.asarray(best, np.float32)  # (K, 2) x,y

    gaze = np.zeros((T, 2), np.float32)
    fixsac = np.zeros((T,), np.float32)
    all_centers = np.zeros((T, K, 2), np.float32)

    amp = np.ones((T, K), np.float32)  # per-frame blob brightness

    cur_blob = int(rng.integers(K))  # per-seed phase; order is fixed
    t = 0
    sacc_from = centers[cur_blob].copy()
    while t < T:
        cued = rng.random() < spec.cue_prob
        for _ in range(spec.fixation_len):
            if t >= T:
                break
            _drift(centers, rng, spec.blob_drift, margin, W, H)
            all_centers[t] = centers
            gaze[t] = centers[cur_blob] + rng.normal(0.0, 0.3, size=2)
            fixsac[t] = 1.0
            if cued:
                amp[t, cur_blob] = spec.cue_gain
            t += 1
        sacc_from = centers[cur_blob].copy()
        nxt_blob = (cur_blob + 1) % K
        for k in range(spec.saccade_len):
            if t >= T:
                break
            _drift(centers, rng, spec.blob_drift, margin, W, H)
            all_centers[t] = centers
            a = (k + 1) / (spec.saccade_len + 1)
            gaze[t] = (1 - a) * sacc_from + a * centers[nxt_blob]
            fixsac[t] = 0.0
            t += 1
        cur_blob = nxt_blob

    ys = np.arange(H, dtype=np.float32)[:, None]
    xs = np.arange(W, dtype=np.float32)[None, :]
    palette = np.asarray(BLOB_PALETTE[:K], np.float32)
    frames = np.zeros((T, H, W, 3), np.uint8)
    for i in range(T):
        img = bg.copy()
        for k in range(K):
            d2 = (xs - all_centers[i, k, 0]) ** 2 + (ys - all_centers[i, k, 1]) ** 2
            blob = np.exp(-d2 / (2 * spec.blob_sigma**2)).astype(np.float32)
            img = img + blob[..., None] * palette[k] * amp[i, k]
        frames[i] = (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
    return frames, gaze, fixsac


def _drift(
    centers: np.ndarray, rng, std: float, margin: float, W: int, H: int
) -> None:
    """One random-walk step per blob center, reflected at the margins.
    All blobs share the same statistics — drift must not become a
    bottom-up cue for which blob is fixated."""
    if std <= 0:
        return
    centers += rng.normal(0.0, std, size=centers.shape).astype(np.float32)
    lo = np.asarray([margin, margin], np.float32)
    hi = np.asarray([W - margin, H - margin], np.float32)
    np.clip(centers, lo, hi, out=centers)


def clip_iterator(
    spec: SyntheticSpec,
    batch_size: int,
    clip_len: int,
    num_batches: int,
    seed: int = 0,
    num_videos: int = 1,
) -> Iterator[dict]:
    """Yield contiguous-clip batches for rollout-mode LF training:
    frames (B, clip_len+1, H, W, 3) — index 0 seeds the flow pair —
    with per-frame gaze/fixsac/valid aligned to frames[1:]'s labels.

    ``num_videos > 1`` draws clips uniformly across that many sequences
    (seeds ``seed .. seed+num_videos-1``) — per-video blob positions and
    backgrounds differ while the task structure (palette order) is
    shared, so a model cannot memorize one layout. ``num_videos == 1``
    keeps the original single-sequence sampling bit-exactly."""
    videos = [
        generate_sequence(dataclasses.replace(spec, seed=seed + v))
        for v in range(num_videos)
    ]
    T = videos[0][0].shape[0]
    if T < clip_len + 1:
        raise ValueError(f"need >= {clip_len + 1} frames, have {T}")
    rng = np.random.default_rng(seed + 1)
    for _ in range(num_batches):
        starts = rng.integers(0, T - clip_len, size=batch_size)
        idx = starts[:, None] + np.arange(clip_len + 1)[None, :]
        if num_videos == 1:
            frames, gaze, fixsac = videos[0]
            yield {
                "frames": frames[idx],
                "gaze": gaze[idx],
                "fixsac": fixsac[idx],
                "valid": np.ones((batch_size, clip_len + 1), np.float32),
            }
            continue
        vid = rng.integers(0, num_videos, size=batch_size)
        yield {
            "frames": np.stack([videos[v][0][idx[i]] for i, v in enumerate(vid)]),
            "gaze": np.stack([videos[v][1][idx[i]] for i, v in enumerate(vid)]),
            "fixsac": np.stack([videos[v][2][idx[i]] for i, v in enumerate(vid)]),
            "valid": np.ones((batch_size, clip_len + 1), np.float32),
        }


def batch_iterator(
    spec: SyntheticSpec,
    batch_size: int,
    num_batches: int,
    seed: int = 0,
    num_videos: int = 1,
) -> Iterator[dict]:
    """Yield SP-style training batches of (rgb_pair, gaze, fixsac).

    Each element pairs consecutive frames (for on-device TV-L1) with the
    current frame's gaze point. Mirrors the reference's STdatas pairing
    of (RGB, flow, GT-heatmap) [M], with the flow computed on device.

    ``num_videos > 1`` samples frames uniformly across that many
    sequences (seeds ``seed .. seed+num_videos-1``); ``num_videos == 1``
    keeps the original single-sequence sampling bit-exactly.
    """
    videos = [
        generate_sequence(dataclasses.replace(spec, seed=seed + v))
        for v in range(num_videos)
    ]
    T = videos[0][0].shape[0]
    rng = np.random.default_rng(seed + 1)
    for _ in range(num_batches):
        idx = rng.integers(1, T, size=batch_size)
        if num_videos == 1:
            frames, gaze, fixsac = videos[0]
            yield {
                "prev": frames[idx - 1],
                "cur": frames[idx],
                "gaze": gaze[idx],
                "fixsac": fixsac[idx],
                # Synthetic gaze is always tracked; key kept so jit
                # signatures match the GTEA loader's (which masks
                # untracked frames).
                "valid": np.ones((batch_size,), np.float32),
            }
            continue
        vid = rng.integers(0, num_videos, size=batch_size)
        yield {
            "prev": np.stack([videos[v][0][i - 1] for v, i in zip(vid, idx)]),
            "cur": np.stack([videos[v][0][i] for v, i in zip(vid, idx)]),
            "gaze": np.stack([videos[v][1][i] for v, i in zip(vid, idx)]),
            "fixsac": np.asarray(
                [videos[v][2][i] for v, i in zip(vid, idx)], np.float32
            ),
            "valid": np.ones((batch_size,), np.float32),
        }
