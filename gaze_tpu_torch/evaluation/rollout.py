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

``rollout_eval_arrays`` takes videos as arrays; ``rollout_eval_videos``
decodes GTEA videos (``data/gtea.py`` records) chunk by chunk on a
worker thread while the card runs the previous chunk.

With a data ``mesh`` (one process per card) the video slots split into
contiguous blocks, one per rank: each rank copies in, or decodes, only
its own videos and rolls them out on its card, and the per-video sums
are all-gathered, so every rank returns the unsharded call's results.
The calls are collective: every rank makes the same ones.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gaze_tpu_torch.core.distributed import all_gather_rows, local_batch_slice
from gaze_tpu_torch.data.gtea import FrameRecord, _decode_flow_images, _decode_images
from gaze_tpu_torch.evaluation.metrics import aae, auc_judd
from gaze_tpu_torch.models.pipeline import GazePipeline, StreamState
from gaze_tpu_torch.parallel.mesh import Mesh, checked
from gaze_tpu_torch.utils.profiling import span

SCORE_KEYS = ("heatmap", "saliency", "attention")
# The padding of a chunk's tail: frames and labels 0, flow images 128
# (zero motion in the 8-bit flow format), so the masked steps stay benign.
FLOW_PAD = 128


def make_rollout_chunk_fn(
    pipeline: GazePipeline,
    with_flow: bool = False,
    mesh: Optional[Mesh] = None,
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

    The returned ``prev`` is a copy of the chunk's last frame, so a
    caller may refill its ``frames`` buffer in place for the next chunk.

    ``score_key`` picks the scored map: "heatmap" (the LF fusion, the
    reported metric), "saliency" (SP only) or "attention" (AT only). The
    rollout itself is the same in all three.

    With a ``mesh`` every per-video argument is this rank's block of
    the video slots (on ``mesh.device``, where the pipeline must run),
    and ``sums`` is every rank's, all-gathered: (3, V x size) in rank
    order.
    """
    if score_key not in SCORE_KEYS:
        raise ValueError(f"unknown score_key {score_key!r}")
    checked(mesh)
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
        prev = prev.clone()   # not a view of the caller's frames
        sums = torch.zeros_like(per_frame[0], dtype=torch.float64)
        for v in per_frame:   # in frame order: chunk_len does not change the sums
            sums += v
        return state, prev, all_gather_rows(sums.T, mesh).T

    return chunk_fn


def rollout_eval_arrays(
    pipeline: GazePipeline,
    frames: np.ndarray,
    gaze: np.ndarray,
    fixsac: np.ndarray,
    valid: Optional[np.ndarray] = None,
    chunk_len: int = 32,
    mesh: Optional[Mesh] = None,
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
      mesh: optional data mesh: V is padded up to a multiple of its
        size with inactive slots, and each rank rolls out its block of
        the videos; every rank returns every video's sums.

    Returns:
      (aae_sum, auc_sum, count) float64 arrays of shape (V,); divide for
      means. A video of fewer than two frames has nothing to score: its
      count is 0.
    """
    chunk_fn = make_rollout_chunk_fn(pipeline, with_flow=flow_img is not None, mesh=mesh,
                                     score_key=score_key)
    V_real, T = frames.shape[:2]
    totals = np.zeros((3, V_real), np.float64)
    if T < 2:
        return totals[0], totals[1], totals[2]
    if valid is None:
        valid = np.ones((V_real, T), np.float32)
    rows = slice(0, V_real)
    if mesh is not None:
        pad_v = -V_real % mesh.size
        if pad_v:   # inactive slots: no frames, labels 0, zero-motion flow
            frames, gaze, fixsac, valid = (
                np.concatenate([x, np.zeros((pad_v,) + x.shape[1:], x.dtype)])
                for x in (frames, gaze, fixsac, valid))
            if flow_img is not None:
                flow_img = np.concatenate([flow_img, np.full(
                    (pad_v,) + flow_img.shape[1:], FLOW_PAD, flow_img.dtype)])
        rows = local_batch_slice(V_real + pad_v, mesh)
    V = rows.stop - rows.start
    dev = pipeline.device

    def chunk(x, s, e, fill=0, dtype=None):
        x = x[rows, s:e] if dtype is None else x[rows, s:e].astype(dtype)
        pad = chunk_len - (e - s)
        if pad:
            x = np.concatenate([x, np.full((V, pad) + x.shape[2:], fill, x.dtype)], axis=1)
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    state = pipeline.init_state(V)
    prev = torch.from_numpy(np.ascontiguousarray(frames[rows, 0])).to(dev)
    for s in range(1, T, chunk_len):
        e = min(s + chunk_len, T)
        extra = () if flow_img is None else (chunk(flow_img, s, e, fill=FLOW_PAD),)
        state, prev, sums = chunk_fn(
            state, prev, chunk(frames, s, e), chunk(fixsac, s, e, dtype=np.float32),
            chunk(gaze, s, e, dtype=np.float32), chunk(valid, s, e, dtype=np.float32), *extra)
        totals += sums.cpu().numpy()[:, :V_real]   # the chunk's one device-to-host copy
    return totals[0], totals[1], totals[2]


def _decode_group_chunk(
    group: Sequence[str], recs: Dict[str, List[FrameRecord]], s: int, chunk_len: int, V: int,
    nh: int, nw: int, th: int, tw: int, use_precomputed_flow: bool, pin: bool = False,
    allow_empty: bool = False, flow_shape: Optional[Tuple[int, ...]] = None,
) -> Tuple[torch.Tensor, ...]:
    """Decode one lockstep chunk, frames ``[s, s + chunk_len)``, for a
    whole group of videos.

    All frame paths of the group go into one batched decode call (the
    threaded libjpeg decoder parallelizes inside a batch), and likewise
    one flow-image decode. Returns host tensors (pinned when ``pin``):
    frames (V, chunk_len, nh, nw, 3) uint8, fixsac, gaze (model-grid
    pixels: native gaze times ``tw / nw``, ``th / nh``), valid, and the
    flow images (V, chunk_len, h, w, 2) uint8 or None. Slots past a
    video's end hold zeros (flow images 128) and valid 0. A chunk past
    every video's end is an error, unless ``allow_empty``: then it is all
    padding, its flow images of ``flow_shape`` (a rank of a mesh whose
    videos ended while another's run on).
    """
    frames_c = torch.zeros((V, chunk_len, nh, nw, 3), dtype=torch.uint8, pin_memory=pin)
    fix_c, valid_c = (torch.zeros((V, chunk_len), pin_memory=pin) for _ in range(2))
    gaze_c = torch.zeros((V, chunk_len, 2), pin_memory=pin)
    frames_np, fix_np, gaze_np, valid_np = (x.numpy() for x in (frames_c, fix_c, gaze_c, valid_c))
    slots: List[Tuple[int, int]] = []
    flat_recs = []
    for vi, v in enumerate(group):
        rs = recs[v][s:s + chunk_len]
        if not rs:
            continue
        fix_np[vi, :len(rs)] = [r.fixation for r in rs]
        gaze_np[vi, :len(rs)] = [(r.gaze[0] * tw / nw, r.gaze[1] * th / nh) for r in rs]
        valid_np[vi, :len(rs)] = [float(r.gaze_valid) for r in rs]
        slots.extend((vi, t) for t in range(len(rs)))
        flat_recs.extend(rs)
    if not flat_recs:
        if not allow_empty:
            raise ValueError(f"empty chunk at frame {s}: past every video's end")
    else:
        for (vi, t), img in zip(slots, _decode_images([r.image_path for r in flat_recs])):
            frames_np[vi, t] = img
    flow_c = None
    if use_precomputed_flow:
        fl = _decode_flow_images(flat_recs) if flat_recs else np.zeros((0,) + flow_shape)
        flow_c = torch.full((V, chunk_len) + fl.shape[1:], FLOW_PAD, dtype=torch.uint8,
                            pin_memory=pin)
        flow_np = flow_c.numpy()
        for (vi, t), f in zip(slots, fl):
            flow_np[vi, t] = f
    return frames_c, fix_c, gaze_c, valid_c, flow_c


def rollout_eval_videos(
    pipeline: GazePipeline,
    videos: Dict[str, Sequence[FrameRecord]],
    chunk_len: int = 32,
    group_size: int = 8,
    use_precomputed_flow: Optional[bool] = None,
    mesh: Optional[Mesh] = None,
    score_key: str = "heatmap",
) -> Dict[str, Tuple[float, float, int]]:
    """Rollout-evaluate GTEA videos from their FrameRecord lists with the
    pipeline's weights, on its device.

    Videos advance in lockstep groups of ``group_size`` (short groups
    padded with inactive slots, so every chunk has one shape), and are
    decoded chunk by chunk on the host, so a whole video never needs to
    fit in memory. One worker thread decodes chunk k+1 (one batched
    decode across the group) while the card runs chunk k; on the card
    the chunk is copied from pinned host memory on a side CUDA stream,
    and the compute stream waits on that copy's event before the chunk
    runs. Frames are decoded at their native size and resized on the
    card (antialiased when shrinking); gaze is scaled by the decoded
    size.

    ``use_precomputed_flow``: None uses the flow images when every
    record has one; True uses them; False solves TV-L1 on the card.
    The span ``rollout.decode_wait`` (``utils/profiling.py``) covers, per
    chunk, this thread's wait for the chunk's decode and copy to be issued.

    With a ``mesh``, ``group_size`` is rounded up to a multiple of its
    size, each rank decodes and rolls out only its block of each group's
    slots (every rank runs the group's chunks, its videos ended or not),
    and every rank returns every video's result.

    Returns {video: (mean AAE in degrees, mean AUC, frames scored)}. A
    video of one frame scores nothing: (nan, nan, 0). Raises ValueError
    on an empty record list.
    """
    if checked(mesh) is not None and group_size % mesh.size:
        group_size += mesh.size - group_size % mesh.size
    rows = slice(0, group_size) if mesh is None else local_batch_slice(group_size, mesh)
    cfg = pipeline.config
    th, tw = cfg.image.height, cfg.image.width
    names = sorted(videos.keys())
    recs = {v: sorted(videos[v], key=lambda r: r.index) for v in names}
    empty = [v for v in names if not recs[v]]
    if empty:
        raise ValueError(
            f"rollout_eval_videos: empty record lists for {empty[:5]}: a truncated or "
            "abandoned manifest entry; drop them before evaluating")

    def rec_has_flow(r: FrameRecord) -> bool:
        return r.flow_path is not None or r.flow_xy_paths is not None

    if use_precomputed_flow is None:
        use_precomputed_flow = bool(names) and all(
            rec_has_flow(r) for v in names for r in recs[v])
    chunk_fn = make_rollout_chunk_fn(pipeline, with_flow=use_precomputed_flow, mesh=mesh,
                                     score_key=score_key)
    dev = pipeline.device
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    results: Dict[str, Tuple[float, float, int]] = {}

    def stage(group, s, V, nh, nw, flow_shape):
        """Decode a chunk; on the card, start its copy on the side stream."""
        host = [x for x in _decode_group_chunk(group, recs, s, chunk_len, V, nh, nw, th, tw,
                                               use_precomputed_flow, pin=side is not None,
                                               allow_empty=mesh is not None,
                                               flow_shape=flow_shape)
                if x is not None]
        if side is None:
            return host, None
        with torch.cuda.stream(side):
            staged = [x.to(dev, non_blocking=True) for x in host]
            done = torch.cuda.Event()
            done.record(side)
        return staged, done

    def consume(fut):
        with span("rollout.decode_wait"):
            staged, done = fut.result()
        if done is not None:
            compute = torch.cuda.current_stream(dev)
            compute.wait_event(done)
            for x in staged:   # allocated on the side stream, used on this one
                x.record_stream(compute)
        return staged

    with ThreadPoolExecutor(max_workers=1) as pool:
        for g in range(0, len(names), group_size):
            group = names[g:g + group_size]
            T_max = max(len(recs[v]) for v in group)   # the whole group's, on every rank
            if T_max < 2:
                # no frame pair: nothing to score, as rollout_eval_arrays
                results.update((v, (float("nan"), float("nan"), 0)) for v in group)
                continue
            mine = group[rows]   # this rank's videos (all of them without a mesh)
            V = rows.stop - rows.start
            state = pipeline.init_state(V)
            # seed prev with each video's frame 0 (scoring starts at 1); a
            # rank of a mesh without videos here decodes one for the size
            decoded0 = _decode_images([recs[v][0].image_path for v in mine or group[:1]])
            nh, nw = decoded0.shape[1:3]
            prev_np = np.zeros((V, nh, nw, 3), np.uint8)
            prev_np[:len(mine)] = decoded0[:len(mine)]
            prev = torch.from_numpy(prev_np).to(dev)
            flow_shape = None
            if mesh is not None and use_precomputed_flow:   # for an all-padding chunk
                flow_shape = _decode_flow_images([next(
                    r for v in group for r in recs[v] if rec_has_flow(r))]).shape[1:]
            totals = np.zeros((3, group_size), np.float64)
            starts = list(range(1, T_max, chunk_len))
            fut = pool.submit(stage, mine, starts[0], V, nh, nw, flow_shape)
            chunk = consume(fut)
            for si in range(len(starts)):
                if si + 1 < len(starts):   # decode the next chunk while this one runs
                    fut = pool.submit(stage, mine, starts[si + 1], V, nh, nw, flow_shape)
                state, prev, sums = chunk_fn(state, prev, *chunk)
                if si + 1 < len(starts):
                    chunk = consume(fut)
                totals += sums.cpu().numpy()   # the chunk's one device-to-host copy
            for vi, v in enumerate(group):
                n = max(totals[2, vi], 1e-9)
                results[v] = (float(totals[0, vi] / n), float(totals[1, vi] / n),
                              int(totals[2, vi]))
    return results
