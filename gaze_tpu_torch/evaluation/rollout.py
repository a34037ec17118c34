"""Sequential full-pipeline rollout evaluation (§3.4 of the paper).

Counterpart of ``gaze_tpu/evaluation/rollout.py`` for in-memory videos.
Per video, frames run in order with streaming semantics:

- the AT LSTM state is carried across the whole video and advances only
  at fixation onsets;
- AT pools at the SP map's argmax, the model's own prediction, never at
  the ground-truth gaze;
- the scored map's argmax is held against the ground truth with AAE and
  AUC.

V videos advance in lockstep as a batch. The recurrent state and the
previous frame stay on the device between chunks of ``chunk_len``
frames; per chunk the host copies the frames in and one (3, V) tensor of
metric sums out. Untracked frames and the tail padding are masked out of
the sums on the device, with ``where``: a masked frame may carry NaN
gaze, and NaN * 0 would poison the sum. The sums accumulate in float64
in frame order, so they do not depend on ``chunk_len``.

Not ported yet: ``rollout_eval_videos`` (decoding GTEA videos chunk by
chunk) and the ``mesh=`` option.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from gaze_tpu_torch.evaluation.metrics import aae, auc_judd
from gaze_tpu_torch.models.pipeline import GazePipeline, StreamState

SCORE_KEYS = ("heatmap", "saliency", "attention")
# The padding of a chunk's tail: frames and labels 0, flow images 128
# (zero motion in the 8-bit flow format), so the masked steps stay benign.
FLOW_PAD = 128


def make_rollout_chunk_fn(
    pipeline: GazePipeline,
    with_flow: bool = False,
    mesh=None,
    score_key: str = "heatmap",
) -> Callable:
    """The chunk evaluator ``(state, prev, frames, fixsac, gaze, valid
    [, flow_img]) -> (state, prev, sums)``, all tensors on the
    pipeline's device:

      state:    StreamState carried across chunks (one slot per video),
      prev:     (V, H, W, 3) uint8, the last frame of the previous chunk,
      frames:   (V, T, H, W, 3) uint8 chunk,
      fixsac:   (V, T) fixation bits (0 on padding),
      gaze:     (V, T, 2) GT gaze in model-grid pixels,
      valid:    (V, T) 1.0 where the frame exists and its gaze is tracked,
      flow_img: (V, T, h, w, 2) uint8 precomputed flow (``with_flow``),
      sums:     (3, V) float64: AAE sum, AUC sum, frame count.

    ``score_key`` picks the scored map: "heatmap" (the LF fusion, the
    reported metric), "saliency" (SP only) or "attention" (AT only). The
    rollout itself is the same in all three.
    """
    if score_key not in SCORE_KEYS:
        raise ValueError(f"unknown score_key {score_key!r}")
    if mesh is not None:
        raise NotImplementedError("mesh: the sharded rollout is not ported")
    cam = pipeline.config.camera

    @torch.inference_mode()
    def chunk_fn(state: StreamState, prev, frames, fixsac, gaze, valid, flow_img=None):
        if with_flow != (flow_img is not None):
            raise ValueError(f"this chunk function was made with with_flow={with_flow}")
        per_frame = []
        for t in range(frames.shape[1]):
            fl = flow_img[:, t] if with_flow else None
            cur = frames[:, t]
            state, out = pipeline.step(state, prev, cur, fixsac[:, t], flow_img=fl)
            gz = gaze[:, t]
            keep = valid[:, t] > 0
            a = torch.where(keep, aae(out[score_key], gz, cam), 0.0)
            u = torch.where(keep, auc_judd(out[score_key], gz), 0.0)
            per_frame.append(torch.stack([a, u, valid[:, t]]))
            prev = cur
        sums = torch.zeros_like(per_frame[0], dtype=torch.float64)
        for v in per_frame:   # in frame order: chunk_len does not change the sums
            sums += v
        return state, prev, sums

    return chunk_fn


def rollout_eval_arrays(
    pipeline: GazePipeline,
    frames: np.ndarray,
    gaze: np.ndarray,
    fixsac: np.ndarray,
    valid: Optional[np.ndarray] = None,
    chunk_len: int = 32,
    mesh=None,
    score_key: str = "heatmap",
    flow_img: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rollout-evaluate V equal-length in-memory videos with the
    pipeline's weights, on its device.

    Args:
      frames: (V, T, H, W, 3) uint8. Frame 0 seeds the flow pair and is
        not scored.
      gaze:   (V, T, 2) GT gaze in model-grid pixels.
      fixsac: (V, T) fixation bits.
      valid:  optional (V, T) gaze-validity mask (default all valid).
      flow_img: optional (V, T, h, w, 2) uint8 precomputed flow images:
        the TV-L1 solve is skipped and frame t consumes flow_img[:, t].

    Returns:
      (aae_sum, auc_sum, count) float64 arrays of shape (V,); divide for
      means. A video of fewer than two frames has nothing to score: its
      count is 0.
    """
    chunk_fn = make_rollout_chunk_fn(pipeline, with_flow=flow_img is not None, mesh=mesh,
                                     score_key=score_key)
    V, T = frames.shape[:2]
    totals = np.zeros((3, V), np.float64)
    if T < 2:
        return totals[0], totals[1], totals[2]
    if valid is None:
        valid = np.ones((V, T), np.float32)
    dev = pipeline.device

    def chunk(x, s, e, fill=0, dtype=None):
        x = x[:, s:e] if dtype is None else x[:, s:e].astype(dtype)
        pad = chunk_len - (e - s)
        if pad:
            x = np.concatenate([x, np.full((V, pad) + x.shape[2:], fill, x.dtype)], axis=1)
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    state = pipeline.init_state(V)
    prev = torch.from_numpy(np.ascontiguousarray(frames[:, 0])).to(dev)
    for s in range(1, T, chunk_len):
        e = min(s + chunk_len, T)
        extra = () if flow_img is None else (chunk(flow_img, s, e, fill=FLOW_PAD),)
        state, prev, sums = chunk_fn(
            state, prev, chunk(frames, s, e), chunk(fixsac, s, e, dtype=np.float32),
            chunk(gaze, s, e, dtype=np.float32), chunk(valid, s, e, dtype=np.float32), *extra)
        totals += sums.cpu().numpy()   # the chunk's one device-to-host copy
    return totals[0], totals[1], totals[2]

