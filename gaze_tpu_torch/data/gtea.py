"""GTEA Gaze+ / GTEA Gaze dataset manifest and host-side loading.

The port's own copy of ``gaze_tpu/data/gtea.py`` (numpy and the standard
library; JPEG decode through ``data/native_io.py``). The on-disk layout:

    <root>/images/<video>/<frame>.jpg      RGB frames (ffmpeg-extracted)
    <root>/flows/<video>/<frame>.jpg       optional precomputed flow images
    <root>/gaze/<video>.txt                per-frame gaze "x y" (pixels,
                                           native resolution)
    <root>/fixsac/<video>.txt              per-frame 0/1 fixation labels

- JPEG decode happens on the host; resize, normalization and the
  heatmap targets run on the card (``gaze_tpu_torch.ops``).
- Flow images are optional: by default the pipeline solves TV-L1 on the
  card from consecutive frames. When ``flows/`` is present,
  ``pair_batches`` decodes the 8-bit flow images and the pipeline feeds
  them to the temporal stream instead. Two layouts are recognized:
    flows/<video>/<frame>.jpg                    packed (ch0=x, ch1=y)
    flows/<video>/flow_x_<frame>.jpg + flow_y_…  separate grayscale
  (a ``.png`` twin of either name too, the lossless option of
  ``data/flow_extract.py``). The pair (t-1, t) uses frame t's flow image.
- The train/test split is leave-one-subject-out, keyed on the leading
  subject token of the video name (e.g. "Ahmad_American").
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from gaze_tpu_torch.data.fixation import detect_fixations_idt
from gaze_tpu_torch.data.native_io import decode_batch


@dataclasses.dataclass(frozen=True)
class FrameRecord:
    video: str
    index: int            # frame index within the video (0-based)
    image_path: str
    flow_path: Optional[str]
    gaze: Tuple[float, float]   # native-resolution pixels
    fixation: float             # 1.0 fixation / 0.0 saccade
    gaze_valid: bool = True     # False on untracked frames (NaN / zero /
                                # out-of-frame rows the tracker lost) —
                                # excluded from losses and AAE/AUC, like
                                # the reference's loader filtering
    # Separate-grayscale dense_flow layout (flow_x_*.jpg / flow_y_*.jpg);
    # flow_path holds the packed single-file layout.
    flow_xy_paths: Optional[Tuple[str, str]] = None


@dataclasses.dataclass
class GTEAManifest:
    root: str
    videos: List[str]
    frames: Dict[str, List[FrameRecord]]
    native_hw: Tuple[int, int]

    def subjects(self) -> List[str]:
        return sorted({v.split("_")[0] for v in self.videos})

    def split_leave_one_out(self, test_subject: str) -> Tuple[List[FrameRecord], List[FrameRecord]]:
        """Leave-one-subject-out split (reference convention)."""
        train, test = [], []
        for v in self.videos:
            bucket = test if v.split("_")[0] == test_subject else train
            bucket.extend(self.frames[v])
        return train, test


def _read_gaze_txt(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a per-frame gaze txt of "x y" rows.

    Returns (gaze (T, 2) float32, valid (T,) bool). Every non-blank line
    occupies a frame slot — unparsable or non-finite rows stay in place
    with valid=False, so frame indices never desync from the images (the
    reference's loader drops/ignores untracked rows; here they are
    masked downstream instead). A (0, 0) row is the tracker's untracked
    sentinel and is also invalid.
    """
    rows, valid = [], []
    if not os.path.exists(path):
        # No annotations for this video: build_manifest degrades to
        # all-invalid records (frames stay usable for inference-style
        # consumers) instead of aborting the whole manifest.
        return np.zeros((0, 2), np.float32), np.zeros((0,), bool)
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            parts = line.split()
            try:
                x, y = float(parts[0]), float(parts[1])
            except (IndexError, ValueError):
                x, y = 0.0, 0.0
            ok = np.isfinite(x) and np.isfinite(y) and not (x == 0.0 and y == 0.0)
            rows.append((x if ok else 0.0, y if ok else 0.0))
            valid.append(ok)
    return np.asarray(rows, np.float32), np.asarray(valid, bool)


def _read_fixsac_txt(path: str) -> np.ndarray:
    with open(path) as f:
        return np.asarray([float(l.strip() or 0) for l in f if l.strip() != ""],
                          dtype=np.float32)


def _dir_names(path: str) -> frozenset:
    """Filenames under ``path`` as a set (empty when absent) — one
    ``os.listdir`` per directory instead of per-frame ``os.path.exists``
    probes, keeping manifest builds O(videos) syscalls at GTEA Gaze+
    scale (hundreds of thousands of frames on possibly-cold NFS)."""
    try:
        return frozenset(os.listdir(path))
    except OSError:
        return frozenset()


def build_manifest(root: str, native_hw: Tuple[int, int] = (720, 960)) -> GTEAManifest:
    """Scan the dataset root into a manifest. Raises FileNotFoundError if
    the layout is absent (callers gate on this — no dataset ships here)."""
    images_dir = os.path.join(root, "images")
    if not os.path.isdir(images_dir):
        raise FileNotFoundError(f"no GTEA layout under {root!r} (missing images/)")
    flows_root = os.path.join(root, "flows")
    videos = sorted(
        d for d in os.listdir(images_dir) if os.path.isdir(os.path.join(images_dir, d))
    )
    frames: Dict[str, List[FrameRecord]] = {}
    nh, nw = native_hw
    for v in videos:
        vdir = os.path.join(images_dir, v)
        names = sorted(os.listdir(vdir))
        gaze, valid = _read_gaze_txt(os.path.join(root, "gaze", v + ".txt"))
        annotated = bool(len(gaze))
        if annotated:
            # Out-of-frame points (tracker glitches) are also invalid.
            valid &= (
                (gaze[:, 0] >= 0) & (gaze[:, 0] < nw)
                & (gaze[:, 1] >= 0) & (gaze[:, 1] < nh)
            )
        if not annotated:
            # Keep the video in the manifest with every row masked
            # invalid — this used to be dead code behind a gaze-file
            # crash (training consumers drop the rows via gaze_valid;
            # inference-style consumers keep the frames).
            gaze = np.zeros((len(names), 2), np.float32)
            valid = np.zeros((len(names),), bool)
        fixsac_path = os.path.join(root, "fixsac", v + ".txt")
        if os.path.exists(fixsac_path):
            fixsac = _read_fixsac_txt(fixsac_path)
        elif annotated:
            # No eye-tracker segmentation shipped: derive labels from
            # the raw gaze with I-DT dispersion (data/fixation.py);
            # untracked frames can neither seed nor extend a fixation.
            fixsac = detect_fixations_idt(gaze, valid=valid)
        else:
            fixsac = np.ones((len(names),), np.float32)
        recs = []
        n = min(len(names), len(gaze), len(fixsac))
        fdir = os.path.join(flows_root, v)
        flow_names = _dir_names(fdir)

        def flow_file(*candidates: str) -> Optional[str]:
            for c in candidates:
                if c in flow_names:
                    return os.path.join(fdir, c)
            return None

        for i in range(n):
            # Flow images match the frame name; a .png twin of a .jpg
            # frame name is also accepted (the lossless option of this
            # repo's own --extract_flow producer, data/flow_extract.py).
            stem = os.path.splitext(names[i])[0]
            fp = flow_file(names[i], stem + ".png")
            fxp = flow_file("flow_x_" + names[i], "flow_x_" + stem + ".png")
            fyp = flow_file("flow_y_" + names[i], "flow_y_" + stem + ".png")
            recs.append(
                FrameRecord(
                    video=v,
                    index=i,
                    image_path=os.path.join(vdir, names[i]),
                    flow_path=fp,
                    gaze=(float(gaze[i, 0]), float(gaze[i, 1])),
                    fixation=float(fixsac[i]),
                    gaze_valid=bool(valid[i]),
                    flow_xy_paths=(fxp, fyp) if fxp and fyp else None,
                )
            )
        frames[v] = recs
    return GTEAManifest(root=root, videos=videos, frames=frames, native_hw=native_hw)


def _decode_images(paths: List[str]) -> np.ndarray:
    """Batch-decode JPEGs: the native threaded decoder when it builds
    (``data/native_io.py``), PIL otherwise."""
    return decode_batch(paths)


def clip_batches(
    records: Sequence[FrameRecord],
    batch_size: int,
    clip_len: int,
    target_hw: Tuple[int, int],
    shuffle: bool = True,
    seed: int = 0,
) -> Iterator[dict]:
    """Yield contiguous-clip batches for rollout-mode LF training.

    Each element is ``clip_len + 1`` consecutive frames of one video
    (index 0 only seeds the flow pair); labels align with frames[0:].
    Only fully-contiguous windows are sampled — no padding, so the
    rollout inside the LF train step never sees synthetic joins.
    """
    by_video: Dict[str, List[FrameRecord]] = {}
    for r in records:
        by_video.setdefault(r.video, []).append(r)
    windows: List[List[FrameRecord]] = []
    for recs in by_video.values():
        recs = sorted(recs, key=lambda r: r.index)
        for s in range(0, len(recs) - clip_len):
            w = recs[s : s + clip_len + 1]
            if w[-1].index - w[0].index == clip_len:
                windows.append(w)
    order = np.arange(len(windows))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    th, tw = target_hw
    for s in range(0, len(order) - batch_size + 1, batch_size):
        chunk = [windows[i] for i in order[s : s + batch_size]]
        flat = [r for w in chunk for r in w]
        imgs = _decode_images([r.image_path for r in flat])
        nh, nw = imgs.shape[1:3]
        frames = imgs.reshape(batch_size, clip_len + 1, nh, nw, 3)
        yield {
            "frames": frames,
            "gaze": np.asarray(
                [[(r.gaze[0] * tw / nw, r.gaze[1] * th / nh) for r in w]
                 for w in chunk], np.float32,
            ),
            "fixsac": np.asarray(
                [[r.fixation for r in w] for w in chunk], np.float32
            ),
            "valid": np.asarray(
                [[float(r.gaze_valid) for r in w] for w in chunk], np.float32
            ),
        }


def _decode_flow_images(recs: List[FrameRecord]) -> np.ndarray:
    """Decode precomputed dense_flow JPEGs -> (N, h, w, 2) uint8 (x, y).

    The values are dense_flow's 8-bit quantization of the flow (zero
    motion = 128); dequantization semantics live in
    ``ops.tvl1.dequantize_flow`` / ``ops.preprocess.normalize_flow_image``.
    """
    idx_xy = [i for i, r in enumerate(recs) if r.flow_xy_paths is not None]
    idx_pk = [i for i, r in enumerate(recs) if r.flow_xy_paths is None]
    missing = [i for i in idx_pk if recs[i].flow_path is None]
    if missing:
        raise FileNotFoundError(
            f"records without any flow image in a precomputed-flow batch: "
            f"{[recs[i].image_path for i in missing[:3]]}..."
        )
    if not idx_pk:
        xs = _decode_images([recs[i].flow_xy_paths[0] for i in idx_xy])[..., 0]
        ys = _decode_images([recs[i].flow_xy_paths[1] for i in idx_xy])[..., 0]
        return np.stack([xs, ys], axis=-1)
    if not idx_xy:
        return _decode_images([recs[i].flow_path for i in idx_pk])[..., :2]
    # Mixed layouts in one (shuffled, cross-video) batch: decode each
    # group separately — the native decoder sizes a batch off its first
    # file — and merge back in record order at a common resolution.
    pk = _decode_images([recs[i].flow_path for i in idx_pk])[..., :2]
    h, w = pk.shape[1:3]
    xs = decode_batch([recs[i].flow_xy_paths[0] for i in idx_xy],
                      target_hw=(h, w))[..., 0]
    ys = decode_batch([recs[i].flow_xy_paths[1] for i in idx_xy],
                      target_hw=(h, w))[..., 0]
    out = np.empty((len(recs), h, w, 2), np.uint8)
    out[idx_pk] = pk
    out[idx_xy] = np.stack([xs, ys], axis=-1)
    return out


def pair_batches(
    records: Sequence[FrameRecord],
    batch_size: int,
    target_hw: Tuple[int, int],
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = True,
    use_precomputed_flow: Optional[bool] = None,
) -> Iterator[dict]:
    """Yield SP batches of consecutive-frame pairs with gaze labels.

    Gaze coordinates are rescaled from native resolution to ``target_hw``
    pixels so labels match the on-device processing grid. Decode is on the
    host; ``data/prefetch.py`` stages the batches on the card.

    use_precomputed_flow: None (default) auto-detects — batches carry a
      ``flow_img`` key when every record has a flow image on disk (the
      reference's data path, ref:data/STdatas.py flow loading);
      True requires them (raises if missing); False ignores ``flows/``
      and lets the pipeline solve TV-L1 on the card.
    """
    by_video: Dict[str, List[FrameRecord]] = {}
    for r in records:
        by_video.setdefault(r.video, []).append(r)
    pairs: List[Tuple[FrameRecord, FrameRecord]] = []
    for recs in by_video.values():
        recs = sorted(recs, key=lambda r: r.index)
        for a, b in zip(recs[:-1], recs[1:]):
            if b.index == a.index + 1:
                pairs.append((a, b))
    order = np.arange(len(pairs))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)

    def has_flow(r: FrameRecord) -> bool:
        return r.flow_path is not None or r.flow_xy_paths is not None

    if use_precomputed_flow is None:
        use_precomputed_flow = bool(pairs) and all(has_flow(b) for _, b in pairs)
    elif use_precomputed_flow and any(not has_flow(b) for _, b in pairs):
        missing = next(b for _, b in pairs if not has_flow(b))
        raise FileNotFoundError(
            f"use_precomputed_flow=True but no flow image for "
            f"{missing.video}/{missing.index} under flows/"
        )

    th, tw = target_hw
    for s in range(0, len(order) - (batch_size - 1 if drop_remainder else 0), batch_size):
        chunk = [pairs[i] for i in order[s : s + batch_size]]
        if not chunk:
            return
        both = _decode_images(
            [a.image_path for a, _ in chunk] + [b.image_path for _, b in chunk]
        )
        prev, cur = both[: len(chunk)], both[len(chunk) :]
        nh, nw = prev.shape[1], prev.shape[2]
        gaze = np.asarray(
            [[b.gaze[0] * tw / nw, b.gaze[1] * th / nh] for _, b in chunk],
            dtype=np.float32,
        )
        fixsac = np.asarray([b.fixation for _, b in chunk], dtype=np.float32)
        valid = np.asarray([b.gaze_valid for _, b in chunk], dtype=np.float32)
        batch = {"prev": prev, "cur": cur, "gaze": gaze, "fixsac": fixsac,
                 "valid": valid,
                 # host-side metadata (not used by the steps)
                 "index": np.asarray([b.index for _, b in chunk], np.int64)}
        if use_precomputed_flow:
            batch["flow_img"] = _decode_flow_images([b for _, b in chunk])
        yield batch
