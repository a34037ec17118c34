"""A small GTEA-layout tree written from numpy seeds, shared by the port's
data-layer tests (not collected: no ``test_`` prefix).

``write_tree`` lays out ``images/<video>/%06d.jpg`` frames (a smooth
texture drifting by about a pixel a frame, plus noise), per-video gaze
txt files whose gaze dwells for a few frames and then jumps (so I-DT
finds fixations), with untracked rows ("nan nan", "0 0" and an
out-of-frame point), ``fixsac`` files for some videos, a video without
any gaze txt, and optional flow images in the packed or the x/y layout.
"""

import os

import numpy as np
from PIL import Image


def texture_frames(rng, n: int, hw, drift: float = 1.0) -> np.ndarray:
    """(n, H, W, 3) uint8: a sum of plane waves shifted by ``drift``
    pixels a frame in x and half that in y, plus noise of +-4 levels."""
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    waves = [(rng.uniform(0, np.pi), rng.uniform(6, 16), rng.uniform(0, 2 * np.pi))
             for _ in range(4)]
    out = np.empty((n, h, w, 3), np.uint8)
    for t in range(n):
        dx, dy = drift * t, 0.5 * drift * t
        img = np.zeros((h, w))
        for ang, lam, ph in waves:
            k = 2 * np.pi / lam
            img += np.sin(k * np.cos(ang) * (xx - dx) + k * np.sin(ang) * (yy - dy) + ph)
        base = 128 + 25 * img
        for c in range(3):
            out[t, ..., c] = np.clip(base + 20 * (c - 1) + rng.uniform(-4, 4, (h, w)), 0, 255)
    return out


def gaze_rows(rng, n: int, hw, untracked=()):
    """``n`` "x y" lines: dwell 3-5 frames, then jump. Rows in
    ``untracked`` become "nan nan", "0 0" or a point past the frame, in
    turn."""
    h, w = hw
    rows, t = [], 0
    while len(rows) < n:
        x, y = rng.uniform(2, w - 3), rng.uniform(2, h - 3)
        for _ in range(int(rng.integers(3, 6))):
            rows.append(f"{x + rng.uniform(-0.5, 0.5):.3f} {y + rng.uniform(-0.5, 0.5):.3f}")
    rows = rows[:n]
    bad = ("nan nan", "0 0", f"{w + 5} {h / 2}")
    for k, i in enumerate(untracked):
        rows[i] = bad[k % len(bad)]
    return rows


def write_tree(root, videos, hw=(24, 32), seed=0, fixsac=(), no_gaze=(), untracked=None,
               flows=None):
    """Write a GTEA tree under ``root`` and return its path as a string.

    videos: {name: number of frames}; fixsac: names that get a fixsac
    txt (the others get I-DT labels from the manifest); no_gaze: names
    without a gaze txt; untracked: {name: frame indices}; flows: {name:
    (layout, fmt)} with layout "packed" or "xy" and fmt "jpg" or "png",
    flow images for frames 1.. (frame t's image encodes the pair t-1, t).
    """
    root = str(root)
    rng = np.random.default_rng(seed)
    untracked = untracked or {}
    flows = flows or {}
    for d in ("images", "gaze", "fixsac"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for name, n in videos.items():
        vdir = os.path.join(root, "images", name)
        os.makedirs(vdir)
        for t, img in enumerate(texture_frames(rng, n, hw)):
            Image.fromarray(img).save(os.path.join(vdir, f"{t:06d}.jpg"), quality=95)
        if name not in no_gaze:
            with open(os.path.join(root, "gaze", name + ".txt"), "w") as f:
                f.write("\n".join(gaze_rows(rng, n, hw, untracked.get(name, ()))) + "\n")
        if name in fixsac:
            bits = (rng.uniform(size=n) < 0.6).astype(int)
            with open(os.path.join(root, "fixsac", name + ".txt"), "w") as f:
                f.write("".join(f"{b}\n" for b in bits))
        if name in flows:
            layout, fmt = flows[name]
            fdir = os.path.join(root, "flows", name)
            os.makedirs(fdir)
            for t in range(1, n):
                q = rng.integers(96, 160, hw + (2,), dtype=np.uint8)
                stem = f"{t:06d}.{fmt}"
                kw = {"quality": 95} if fmt == "jpg" else {}
                if layout == "packed":
                    img = np.concatenate([q, np.full(hw + (1,), 128, np.uint8)], -1)
                    Image.fromarray(img).save(os.path.join(fdir, stem), **kw)
                else:
                    for axis, tag in enumerate(("x", "y")):
                        Image.fromarray(q[..., axis], "L").save(
                            os.path.join(fdir, f"flow_{tag}_{stem}"), **kw)
    return root
