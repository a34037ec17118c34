"""Operations and bytes of the model and of the port's kernels, from the
configuration's shapes alone (nothing here reads the program).

- ``model_macs``: multiply-adds per frame of each op family (both VGG16
  streams, the fuse, the decoder, AT, LF), whatever implements them;
- ``step_least_s``: the least time of one step's model arithmetic on the
  chip, each family at the peak of the precision its configuration file
  states (the ``mfu`` metrics divide it by the measured time per step);
- ``k1_step``, ``k2_step``, ``k3_step``: per step (one frame pair of a
  batch), each launch's shape and its least time by the larger of its
  operations over the peak and its bytes over HBM's rate, counting each
  input read once and each output written once.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())

# Operations per pixel of one primal-dual iteration of K2, counted from
# the algorithm's arithmetic and rounded down: the data-term threshold
# (about 13), the primal update (about 10), the forward differences, the
# dual norms and the reprojection (about 24).
K2_OPS_PER_ITER = 40
# A 3x3 median by the 19-comparator network: 38 min/max per field.
K2_OPS_PER_MEDIAN = 38


def peak(precision: str) -> float:
    """Operations per second of one H100 SXM at ``precision``."""
    return PEAKS["ops_per_s"][precision]


def pyramid(cfg: dict) -> List[Tuple[int, int]]:
    """The TV-L1 pyramid's (h, w), finest first, at the flow grid."""
    im, tv = cfg["image"], cfg["tvl1"]
    h, w = im["height"], im["width"]
    s = tv["flow_scale"]
    if s != 1.0:
        h, w = int(round(h * s)), int(round(w * s))
    shapes = [(h, w)]
    for _ in range(1, tv["pyramid_levels"]):
        nh, nw = (int(round(v * tv["pyramid_factor"])) for v in shapes[-1])
        if nh < 16 or nw < 16:
            break
        shapes.append((nh, nw))
    return shapes


def vgg_shapes(cfg: dict, cin: int) -> List[Tuple[str, int, int, int, int, bool]]:
    """(layer, h, w, ci, co, pooled after) of one VGG16 stream."""
    h, w = cfg["image"]["height"], cfg["image"]["width"]
    stages = cfg["sp"]["stages"]
    out, c = [], cin
    for s, stage in enumerate(stages):
        for i, co in enumerate(stage):
            pool = i == len(stage) - 1 and s < len(stages) - 1
            out.append((f"conv{s + 1}_{i + 1}", h, w, c, co, pool))
            c = co
        if s < len(stages) - 1:
            h, w = h // 2, w // 2
    return out


def model_macs(cfg: dict) -> Dict[str, float]:
    """Multiply-adds per frame by op family."""
    sp, at, lf = cfg["sp"], cfg["at"], cfg["lf"]
    H, W = cfg["image"]["height"], cfg["image"]["width"]
    fam = {"vgg_stem": 0.0, "vgg": 0.0, "fuse": 0.0, "decoder": 0.0, "lstm": 0.0, "lf": 0.0}
    for cin in (3, sp["flow_channels"]):
        for name, h, w, ci, co, _ in vgg_shapes(cfg, cin):
            fam["vgg_stem" if name == "conv1_1" else "vgg"] += h * w * ci * co * 9
    h5, w5 = H // 16, W // 16
    c5 = sp["stages"][-1][-1]
    fam["fuse"] = h5 * w5 * 2 * c5 * sp["fused_channels"]
    c, h, w = sp["fused_channels"], h5, w5
    for co in sp["decoder_channels"]:
        h, w = 2 * h, 2 * w
        fam["decoder"] += h * w * c * co * 4     # 4 of the 16 taps reach each output pixel
        c = co
    fam["decoder"] += h * w * c                   # the 1x1 conv to one channel
    hs, fd = at["hidden_size"], at["feature_dim"]
    fam["lstm"] = 4 * hs * (fd + hs) + fd * hs + h5 * w5 * fd
    c = 2
    for co in list(lf["channels"]) + [1]:
        fam["lf"] += H * W * c * co * 9
        c = co
    return fam


def step_least_s(cfg: dict, batch: int, train: bool = False) -> float:
    """Least seconds of one step's model arithmetic over ``batch`` frames:
    2 operations a multiply-add over the peak of each family's stated
    precision. A train step (the SP: VGG streams, fuse, decoder) counts
    the forward, the weight gradients and the input gradients of every
    layer but each stream's first."""
    prec = cfg["precision"]
    macs = model_macs(cfg)
    fams = ("vgg_stem", "vgg", "fuse", "decoder") if train else tuple(macs)
    total = 0.0
    for f in fams:
        m = macs[f] * (2 if f == "vgg_stem" else 3) if train else macs[f]
        total += 2.0 * m / peak(prec[f])
    return total * batch


def k1_step(cfg: dict, batch: int) -> List[Tuple[Tuple[int, int], float]]:
    """(level shape, least seconds) of each K1 launch of one step: 4
    fields read (I0, I1, u1, u2) and 4 written, float32."""
    out = []
    for h, w in pyramid(cfg):
        b = 8 * 4 * batch * h * w
        out += [((h, w), b / PEAKS["hbm_bytes_per_s"])] * cfg["tvl1"]["warps"]
    return out


def k2_step(cfg: dict, batch: int) -> List[Tuple[Tuple[int, int], float]]:
    """(level shape, least seconds) of each K2 launch of one step (one
    call: ``iters`` iterations and the median): 10 fields read (the flow,
    4 duals, 4 warp fields), 6 written, float32; its operations at the
    float32 peak."""
    tv = cfg["tvl1"]
    passes = 2 if tv["median_kernel"] >= 5 else 1
    out = []
    for h, w in pyramid(cfg):
        px = batch * h * w
        ops = px * (tv["iters"] * K2_OPS_PER_ITER + passes * 2 * K2_OPS_PER_MEDIAN)
        t = max(16 * 4 * px / PEAKS["hbm_bytes_per_s"], ops / peak("float32"))
        out += [((h, w), t)] * tv["warps"]
    return out


def k3_step(cfg: dict, batch: int) -> List[Tuple[str, float]]:
    """(layer, least seconds) of each K3 launch of one step: every int8
    layer of both streams (all but a bf16 stem), at the int8 peak or by
    its bytes (int8 codes in and out, int8 weights)."""
    if cfg["precision"]["vgg"] != "int8":
        return []
    out = []
    for cin in (3, cfg["sp"]["flow_channels"]):
        for name, h, w, ci, co, pool in vgg_shapes(cfg, cin):
            if name == "conv1_1" and cfg["precision"]["vgg_stem"] != "int8":
                continue
            ops = 2.0 * batch * h * w * ci * co * 9
            out_px = h * w // 4 if pool else h * w
            byts = batch * h * w * ci + 9 * ci * co + batch * out_px * co * (
                4 if name == "conv5_3" else 1)
            out.append((name, max(ops / peak("int8"), byts / PEAKS["hbm_bytes_per_s"])))
    return out
