"""Plain reference of the per-frame gaze step and the SP train step.

Written from the configuration file's sizes and the model's equations,
with plain ``torch`` operations in NCHW, no kernel, no cache and no
batching trick:

- preprocessing: uint8 frames to [0, 1], bilinear resize with
  ``jax.image.resize`` semantics (half-pixel centres, antialiased when an
  axis shrinks), ImageNet normalization, BT.601 gray;
- TV-L1 (Zach, Pock, Bischof 2007; the schedule of Sanchez et al., IPOL
  2013): a Gaussian-presmoothed pyramid, coarse to fine; per warp the
  border-clamped bilinear warp of I1 and of its central-difference
  gradients, ``iters`` primal-dual iterations, a 3x3 median of the flow;
  solved at ``flow_scale`` of the grid, upsampled and rescaled, clipped
  to the 8-bit flow image's range;
- SP: two VGG16 streams (float, or int8 as the configuration states
  it: per-output-channel symmetric weights, activations on the [0, 255]
  grid of a scale calibrated at a percentile of |x|, a bf16 stem),
  the 1x1 fuse, ConvTranspose(4, s2) + BatchNorm + ReLU blocks, a 1x1
  conv and a sigmoid;
- AT: the conv5 features pooled in a 3x3 ROI at the saliency argmax,
  the LSTM step kept only at a fixation onset, the attention map;
- LF: 3x3 convs on (saliency, attention), a sigmoid, the argmax gaze;
- training: train-mode BatchNorm, the focal loss against Gaussian
  targets, autograd, optax's AdamW.

Every inference function computes in float32 (TF32 off), or, given
``dt``, in the activation type the configuration states (bf16): each
operation's operands and result rounded to it, products summed in
float32, a convolution's bias added to its rounded sum and rounded again,
BatchNorm, logits and sigmoids in float32, as the model's own precision
rules state them. The TV-L1 solve runs in float32 as stated, or in
float64 (``flow_dtype``) for the exact answer. The check holds the
program's distance from the exact answer (float64 flow, float32 model)
to the distance of the computation at the stated precisions (float32
flow, bf16 model) from it: the stated precisions' own rounding noise,
both worked out here.

``lowp="fp8"`` rounds every convolution's operands of the train step
through float8 e4m3 with a per-tensor scale: its control.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]
LUMA = (0.299, 0.587, 0.114)
EPS_GRAD = 1e-9
BN_EPS = 1e-5
FP8_MAX = 448.0


def act_dtype(cfg: dict) -> Optional[torch.dtype]:
    """The activation type the configuration states, None for float32."""
    a = cfg["precision"]["activations"]
    return None if a == "float32" else getattr(torch, a)


def rnd(x: torch.Tensor, dt: Optional[torch.dtype]) -> torch.Tensor:
    """``x`` rounded to the activation type ``dt`` and held in float32."""
    return x if dt is None else x.to(dt).float()


def full_precision() -> None:
    """float32 matmuls and convolutions without TF32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


# ------------------------------------------------------------ images ----
def resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize of NCHW ``x``, half-pixel centres, antialiased
    where an axis shrinks."""
    if tuple(x.shape[-2:]) == (h, w):
        return x
    shrink = h < x.shape[-2] or w < x.shape[-1]
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False, antialias=shrink)


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable normalized Gaussian of radius ceil(2.5 sigma) over
    (B, H, W), edges replicated."""
    r = max(1, int(math.ceil(2.5 * sigma)))
    x = torch.arange(-r, r + 1, dtype=img.dtype, device=img.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()
    y = F.pad(img[:, None], (r, r, 0, 0), mode="replicate")
    y = F.conv2d(y, k.view(1, 1, 1, -1))
    y = F.pad(y, (0, 0, r, r), mode="replicate")
    return F.conv2d(y, k.view(1, 1, -1, 1))[:, 0]


def pyramid_shapes(h: int, w: int, levels: int, factor: float) -> List[Tuple[int, int]]:
    shapes = [(h, w)]
    for _ in range(1, levels):
        nh, nw = int(round(shapes[-1][0] * factor)), int(round(shapes[-1][1] * factor))
        if nh < 16 or nw < 16:
            break
        shapes.append((nh, nw))
    return shapes


def central_gradient(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central differences of (B, H, W), one-sided at the borders."""
    gx = torch.empty_like(img)
    gx[:, :, 1:-1] = 0.5 * (img[:, :, 2:] - img[:, :, :-2])
    gx[:, :, 0] = img[:, :, 1] - img[:, :, 0]
    gx[:, :, -1] = img[:, :, -1] - img[:, :, -2]
    gy = torch.empty_like(img)
    gy[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    gy[:, 0] = img[:, 1] - img[:, 0]
    gy[:, -1] = img[:, -1] - img[:, -2]
    return gx, gy


def forward_gradient(u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward differences, zero in the last column and row."""
    gx = torch.zeros_like(u)
    gy = torch.zeros_like(u)
    gx[:, :, :-1] = u[:, :, 1:] - u[:, :, :-1]
    gy[:, :-1] = u[:, 1:] - u[:, :-1]
    return gx, gy


def divergence(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Backward-difference divergence, the negative adjoint of
    :func:`forward_gradient`."""
    d1 = torch.empty_like(p1)
    d1[:, :, 0] = p1[:, :, 0]
    d1[:, :, 1:-1] = p1[:, :, 1:-1] - p1[:, :, :-2]
    d1[:, :, -1] = -p1[:, :, -2]
    d2 = torch.empty_like(p2)
    d2[:, 0] = p2[:, 0]
    d2[:, 1:-1] = p2[:, 1:-1] - p2[:, :-2]
    d2[:, -1] = -p2[:, -2]
    return d1 + d2


def median3x3(img: torch.Tensor) -> torch.Tensor:
    """3x3 median of (B, H, W), edges replicated."""
    B, H, W = img.shape
    p = F.pad(img[:, None], (1, 1, 1, 1), mode="replicate")
    return F.unfold(p, 3).view(B, 9, H, W).median(dim=1).values


def warp(imgs: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """(K, B, H, W) images sampled bilinearly at (x + u1, y + u2), the
    coordinates clamped to the frame."""
    K, B, H, W = imgs.shape
    xs = torch.arange(W, dtype=u1.dtype, device=u1.device).view(1, 1, W)
    ys = torch.arange(H, dtype=u1.dtype, device=u1.device).view(1, H, 1)
    x = torch.clamp(xs + u1, 0.0, W - 1.0)
    y = torch.clamp(ys + u2, 0.0, H - 1.0)
    x0 = torch.clamp(torch.floor(x), 0, W - 2)
    y0 = torch.clamp(torch.floor(y), 0, H - 2)
    fx, fy = x - x0, y - y0
    base = (y0 * W + x0).long().view(1, B, H * W).expand(K, B, H * W)
    flat = imgs.reshape(K, B, H * W)

    def tap(off):
        return torch.gather(flat, 2, base + off).view(K, B, H, W)

    return (tap(0) * ((1 - fx) * (1 - fy)) + tap(1) * (fx * (1 - fy))
            + tap(W) * ((1 - fx) * fy) + tap(W + 1) * (fx * fy))


def tvl1(i0: torch.Tensor, i1: torch.Tensor, tv: dict) -> torch.Tensor:
    """(B, H, W) gray frames in [0, 1] -> (B, H, W, 2) flow in pixels, in
    the frames' type."""
    i0, i1 = i0 * 255.0, i1 * 255.0
    B, H, W = i0.shape
    shapes = pyramid_shapes(H, W, tv["pyramid_levels"], tv["pyramid_factor"])
    pyr0, pyr1 = [i0], [i1]
    for s in shapes[1:]:
        pyr0.append(resize(gaussian_blur(pyr0[-1], tv["presmooth_sigma"])[:, None], *s)[:, 0])
        pyr1.append(resize(gaussian_blur(pyr1[-1], tv["presmooth_sigma"])[:, None], *s)[:, 0])
    u1 = torch.zeros((B, *shapes[-1]), dtype=i0.dtype, device=i0.device)
    u2 = torch.zeros_like(u1)
    passes = 2 if tv["median_kernel"] >= 5 else 1
    lt = tv["lambda_"] * tv["theta"]
    theta, taut = tv["theta"], tv["tau"] / tv["theta"]
    for lvl in range(len(shapes) - 1, -1, -1):
        a0, a1 = pyr0[lvl], pyr1[lvl]
        gx, gy = central_gradient(a1)
        stack = torch.stack([a1, gx, gy])
        p11, p12, p21, p22 = (torch.zeros_like(u1) for _ in range(4))
        for _ in range(tv["warps"]):
            i1w, wx, wy = warp(stack, u1, u2)
            grad = wx * wx + wy * wy
            rho_c = i1w - wx * u1 - wy * u2 - a0
            for _ in range(tv["iters"]):
                rho = rho_c + wx * u1 + wy * u2
                neg, pos = rho < -lt * grad, rho > lt * grad
                scale = torch.where(neg, lt, torch.where(pos, -lt, -rho / (grad + EPS_GRAD)))
                v1 = u1 + scale * wx
                v2 = u2 + scale * wy
                u1 = v1 + theta * divergence(p11, p12)
                u2 = v2 + theta * divergence(p21, p22)
                g1x, g1y = forward_gradient(u1)
                g2x, g2y = forward_gradient(u2)
                n1 = 1.0 + taut * torch.sqrt(g1x * g1x + g1y * g1y)
                n2 = 1.0 + taut * torch.sqrt(g2x * g2x + g2y * g2y)
                p11, p12 = (p11 + taut * g1x) / n1, (p12 + taut * g1y) / n1
                p21, p22 = (p21 + taut * g2x) / n2, (p22 + taut * g2y) / n2
            for _ in range(passes):
                u1, u2 = median3x3(u1), median3x3(u2)
        if lvl > 0:
            (nh, nw), (h, w) = shapes[lvl - 1], shapes[lvl]
            u1 = resize(u1[:, None], nh, nw)[:, 0] * (nw / w)
            u2 = resize(u2[:, None], nh, nw)[:, 0] * (nh / h)
    return torch.stack([u1, u2], dim=-1)


def preprocess(prev_u8: torch.Tensor, cur_u8: torch.Tensor, cfg: dict,
               flow_dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, 3) uint8 frame pair -> NCHW (normalized rgb, temporal
    input), float32 at the model grid; the TV-L1 solve in ``flow_dtype``
    (the configuration states float32; float64 for the exact answer)."""
    im, tv = cfg["image"], cfg["tvl1"]
    H, W = im["height"], im["width"]

    def frames(u8):
        return resize(u8.permute(0, 3, 1, 2).float() / 255.0, H, W)

    prev, cur = frames(prev_u8), frames(cur_u8)
    luma = torch.tensor(LUMA, device=cur.device).view(1, 3, 1, 1)
    g0, g1 = (prev * luma).sum(1), (cur * luma).sum(1)
    s = tv["flow_scale"]
    if s != 1.0:
        fh, fw = int(round(H * s)), int(round(W * s))
        low = tvl1(resize(g0[:, None], fh, fw)[:, 0].to(flow_dtype),
                   resize(g1[:, None], fh, fw)[:, 0].to(flow_dtype), tv)
        flow = resize(low.permute(0, 3, 1, 2), H, W) * (1.0 / s)
    else:
        flow = tvl1(g0.to(flow_dtype), g1.to(flow_dtype), tv).permute(0, 3, 1, 2)
    flow = flow.float()
    b = tv["quant_bound"]
    flow_in = (torch.clamp(flow, -b, b) * (0.5 / b) + 0.5 - 0.5) / 0.226
    mean = torch.tensor(im["mean"], device=cur.device).view(1, 3, 1, 1)
    std = torch.tensor(im["std"], device=cur.device).view(1, 3, 1, 1)
    return (cur - mean) / std, flow_in


# ---------------------------------------------------------------- SP ----
def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 with a per-tensor scale, the gradient
    passed straight through."""
    s = torch.clamp_min(x.detach().abs().amax() / FP8_MAX, 1e-30)
    q = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
    return x + (q - x).detach()


def _in_act(op, x, w, b, dt, **kw):
    """``op`` in the activation type ``dt``: operands rounded to it, the
    products summed in float32, the sum rounded to it; the bias added to
    that and the result rounded again (a bias add of its own)."""
    if dt is None:
        return op(x, w, b, **kw)
    y = rnd(op(rnd(x, dt), rnd(w, dt), None, **kw), dt)
    return rnd(y + rnd(b, dt).view(1, -1, 1, 1), dt)


def conv(x, w, b, lowp: Optional[str] = None, dt: Optional[torch.dtype] = None, **kw):
    if lowp == "fp8":
        x, w = fp8_round(x), fp8_round(w)
    return _in_act(F.conv2d, x, w, b, dt, **kw)


def conv_t(x, w, b, lowp: Optional[str] = None, dt: Optional[torch.dtype] = None):
    if lowp == "fp8":
        x, w = fp8_round(x), fp8_round(w)
    return _in_act(F.conv_transpose2d, x, w, b, dt, stride=2, padding=1)


def vgg_layers(cfg: dict) -> List[Tuple[str, bool]]:
    """(layer name, a 2x2 max-pool follows) in order."""
    stages = cfg["sp"]["stages"]
    out = []
    for s, stage in enumerate(stages):
        for i in range(len(stage)):
            out.append((f"conv{s + 1}_{i + 1}", i == len(stage) - 1 and s < len(stages) - 1))
    return out


def vgg(w: Weights, stream: str, x: torch.Tensor, cfg: dict, lowp=None,
        dt: Optional[torch.dtype] = None) -> torch.Tensor:
    """Float VGG16 features through conv5_3 + ReLU (NCHW)."""
    for name, pool in vgg_layers(cfg):
        x = F.relu(conv(x, w[f"{stream}.{name}.weight"], w[f"{stream}.{name}.bias"], lowp, dt,
                        padding=1))
        if pool:
            x = F.max_pool2d(x, 2, 2)
    return x


def percentile(x: torch.Tensor, q: float) -> float:
    """The ``q``-th percentile of all of ``x`` by linear interpolation,
    the position ``q / 100 * (n - 1)`` taken in float32 as
    ``jnp.percentile`` takes it in the JAX package that defines the
    calibration."""
    a = torch.sort(x.reshape(-1)).values
    pos = np.float32(np.float32(q) / np.float32(100.0)) * np.float32(a.numel() - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    w_hi = float(np.float32(pos - np.float32(lo)))
    return float(a[lo].double() * (1.0 - w_hi) + a[hi].double() * w_hi)


@torch.no_grad()
def calibrate(w: Weights, stream: str, batches: List[torch.Tensor], cfg: dict,
              q: float) -> Dict[str, float]:
    """Each layer's input bound: the ``q``-th percentile of |input| of
    the float forward, the largest over the batches."""
    bounds: Dict[str, float] = {}
    for x in batches:
        for name, pool in vgg_layers(cfg):
            bounds[name] = max(bounds.get(name, 0.0), percentile(x.abs(), q))
            x = F.relu(F.conv2d(x, w[f"{stream}.{name}.weight"], w[f"{stream}.{name}.bias"],
                                padding=1))
            if pool:
                x = F.max_pool2d(x, 2, 2)
    return bounds


def int8_weight(wt: torch.Tensor) -> torch.Tensor:
    """Per-output-channel symmetric int8 weights, dequantized."""
    s = torch.clamp_min(wt.abs().amax(dim=(1, 2, 3), keepdim=True) / 127.0, 1e-12)
    return torch.clamp(torch.round(wt / s), -127, 127) * s


def vgg_int8(w: Weights, stream: str, x: torch.Tensor, cfg: dict,
             bounds: Dict[str, float]) -> torch.Tensor:
    """The int8 stream as the configuration states it: conv1_1 in bf16
    (operands rounded to bf16, a float32 sum); then each layer's input as
    codes 0..255 on the grid of scale bound / 255, its weights as
    per-output-channel symmetric codes -127..127, the products summed as
    whole numbers (a float32 sum of whole numbers, exact below 2^24) and
    scaled in float64 into the next layer's codes; conv5_3's output in
    float. A max-pool of codes is the max-pool of their values."""
    top, wtop = 255.0, 127.0
    layers = vgg_layers(cfg)
    sx = None
    for li, (name, pool) in enumerate(layers):
        wt, b = w[f"{stream}.{name}.weight"], w[f"{stream}.{name}.bias"]
        if li == 0:
            y = F.conv2d(x.to(torch.bfloat16).float(), wt.to(torch.bfloat16).float(),
                         padding=1).double() + b.double().view(1, -1, 1, 1)
        else:
            sw = torch.clamp_min(wt.abs().amax(dim=(1, 2, 3)) / wtop, 1e-12)
            wq = torch.clamp(torch.round(wt / sw.view(-1, 1, 1, 1)), -wtop, wtop)
            acc = F.conv2d(x, wq, padding=1).double()
            y = acc * (sx * sw.double()).view(1, -1, 1, 1) + b.double().view(1, -1, 1, 1)
        if li == len(layers) - 1:
            return F.relu(y).float()
        sx = max(bounds[layers[li + 1][0]], 1e-12) / top
        x = torch.clamp(torch.round(y / sx), 0.0, top).float()
        if pool:
            x = F.max_pool2d(x, 2, 2)
    return x


def fuse_decode(w: Weights, f_s: torch.Tensor, f_t: torch.Tensor, cfg: dict,
                train: bool = False, lowp=None, dt: Optional[torch.dtype] = None):
    """conv5 features -> (saliency (B, H, W), new BatchNorm running
    statistics when ``train``)."""
    x = F.relu(conv(torch.cat([f_s, f_t], 1), w["fuse_conv.weight"], w["fuse_conv.bias"], lowp,
                    dt))
    stats = {}
    for i in range(len(cfg["sp"]["decoder_channels"])):
        d, bn = f"decoder.deconv{i + 1}", f"decoder.bn{i + 1}"
        x = conv_t(x, w[f"{d}.weight"], w[f"{d}.bias"], lowp, dt)
        if train:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
            stats[f"{bn}.running_mean"] = 0.99 * w[f"{bn}.running_mean"] + 0.01 * mean.detach()
            stats[f"{bn}.running_var"] = 0.99 * w[f"{bn}.running_var"] + 0.01 * var.detach()
        else:
            mean, var = w[f"{bn}.running_mean"], w[f"{bn}.running_var"]
        x = (x - mean.view(1, -1, 1, 1)) * torch.rsqrt(var + BN_EPS).view(1, -1, 1, 1)
        x = F.relu(rnd(x * w[f"{bn}.weight"].view(1, -1, 1, 1) + w[f"{bn}.bias"].view(1, -1, 1, 1),
                       dt))
    logits = conv(x, w["decoder.out_conv.weight"], w["decoder.out_conv.bias"], lowp, dt)
    return torch.sigmoid(logits)[:, 0], stats


# ------------------------------------------------------------ AT + LF ----
def argmax_xy(hm: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> (B, 2) float (x, y) of the first maximum, row-major."""
    B, H, W = hm.shape
    idx = torch.argmax(hm.reshape(B, -1), dim=1)
    return torch.stack([(idx % W).float(), (idx // W).float()], dim=1)


def roi_pool(feat: torch.Tensor, pts: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Mean of the r x r conv5 cells around each point (cell index by
    round half to even, window kept inside the grid): (B, C)."""
    B, C, h, w = feat.shape
    r = min(cfg["at"]["roi_size"], h, w)
    stride = cfg["at"]["feature_stride"]
    fx = torch.clamp(torch.round(pts[:, 0] / stride).long() - r // 2, 0, w - r)
    fy = torch.clamp(torch.round(pts[:, 1] / stride).long() - r // 2, 0, h - r)
    out = []
    for b in range(B):
        fyb, fxb = int(fy[b]), int(fx[b])
        out.append(feat[b, :, fyb:fyb + r, fxb:fxb + r].mean(dim=(1, 2)))
    return torch.stack(out)


def init_state(batch: int, cfg: dict, device) -> dict:
    hs, fd = cfg["at"]["hidden_size"], cfg["at"]["feature_dim"]
    z = torch.zeros((batch, hs), device=device)
    return {"c": [z] * cfg["at"]["num_layers"], "h": [z] * cfg["at"]["num_layers"],
            "w_hat": torch.ones((batch, fd), device=device),
            "prev_fix": torch.zeros((batch,), device=device)}


def lstm_step(w: Weights, c: List[torch.Tensor], h: List[torch.Tensor], x: torch.Tensor,
              dt: Optional[torch.dtype] = None):
    """One step of the stacked LSTM (gate rows i, f, g, o) and the ReLU
    head: (new c, new h, prediction). In the activation type ``dt`` every
    operation's result is rounded to it: each product of matrices, each
    sum, each gate and the carry."""
    def r(v):
        return rnd(v, dt)

    def lin(v, k):
        return r(r(v) @ r(w[k]).T)

    nc, nh = [], []
    for k in range(len(c)):
        gates = r(r(lin(h[k], f"weight_hh_l{k}") + r(w[f"bias_hh_l{k}"]))
                  + r(lin(x, f"weight_ih_l{k}") + r(w[f"bias_ih_l{k}"])))
        gi, gf, gg, go = gates.chunk(4, dim=1)
        ck = r(r(r(torch.sigmoid(gf)) * c[k]) + r(r(torch.sigmoid(gi)) * r(torch.tanh(gg))))
        hk = r(r(torch.sigmoid(go)) * r(torch.tanh(ck)))
        nc.append(ck)
        nh.append(hk)
        x = hk
    head = r(r(x) @ r(w["head.weight"]).T + r(w["head.bias"]))     # the bias in the product's sum
    return nc, nh, F.relu(head)


def attend(weights: Dict[str, Weights], state: dict, sal: torch.Tensor, feat: torch.Tensor,
           fix: torch.Tensor, cfg: dict, dt: Optional[torch.dtype] = None
           ) -> Tuple[dict, torch.Tensor, torch.Tensor]:
    """AT and LF from SP's outputs: (new state, heatmap (B, H, W), gaze);
    the LSTM and LF in the activation type ``dt`` where it is given."""
    at, lf = weights["at"], weights["lf"]
    H, W = sal.shape[1:]
    pooled = roi_pool(feat, argmax_xy(sal), cfg)
    nc, nh, pred = lstm_step(at, state["c"], state["h"], pooled, dt)
    onset = (fix * (1.0 - state["prev_fix"]) != 0).view(-1, 1)
    c = [torch.where(onset, n, o) for n, o in zip(nc, state["c"])]
    h = [torch.where(onset, n, o) for n, o in zip(nh, state["h"])]
    w_hat = torch.where(onset, pred, state["w_hat"])
    amap = torch.einsum("bchw,bc->bhw", feat, w_hat)
    mn = amap.amin(dim=(1, 2), keepdim=True)
    mx = amap.amax(dim=(1, 2), keepdim=True)
    amap = resize(((amap - mn) / (mx - mn + 1e-8))[:, None], H, W)[:, 0]
    x = torch.stack([sal, amap], dim=1)
    for i in range(len(cfg["lf"]["channels"])):
        x = F.relu(conv(x, lf[f"conv{i + 1}.weight"], lf[f"conv{i + 1}.bias"], dt=dt, padding=1))
    hm = torch.sigmoid(conv(x, lf["out_conv.weight"], lf["out_conv.bias"], dt=dt, padding=1))[:, 0]
    return {"c": c, "h": h, "w_hat": w_hat, "prev_fix": fix}, hm, argmax_xy(hm)


def sp_forward(weights: Dict[str, Weights], rgb, flow, cfg: dict,
               bounds: Optional[dict] = None, dt: Optional[torch.dtype] = None):
    """(saliency, spatial conv5) of the inference-mode SP; with ``bounds``
    (per stream) the VGG streams run int8; float layers in the activation
    type ``dt`` where it is given."""
    sp = weights["sp"]
    if bounds is None:
        f_s, f_t = vgg(sp, "spatial", rgb, cfg, dt=dt), vgg(sp, "temporal", flow, cfg, dt=dt)
    else:
        f_s = vgg_int8(sp, "spatial", rgb, cfg, bounds["spatial"])
        f_t = vgg_int8(sp, "temporal", flow, cfg, bounds["temporal"])
    sal, _ = fuse_decode(sp, f_s, f_t, cfg, dt=dt)
    return sal, f_s


@torch.no_grad()
def run_clip(weights: Dict[str, Weights], frames: torch.Tensor, fix: torch.Tensor, cfg: dict,
             bounds: Optional[dict] = None, dt: Optional[torch.dtype] = None,
             flow_dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T+1, H, W, 3) uint8 frames, (B, T+1) fixation bits ->
    (heatmaps (B, T, H, W), gaze (B, T, 2)); step t takes frames t and
    t + 1 and the fixation bit of frame t + 1."""
    state = init_state(frames.shape[0], cfg, frames.device)
    hms, gz = [], []
    for t in range(frames.shape[1] - 1):
        rgb, flow = preprocess(frames[:, t], frames[:, t + 1], cfg, flow_dtype)
        sal, feat = sp_forward(weights, rgb, flow, cfg, bounds, dt)
        state, hm, g = attend(weights, state, sal, feat, fix[:, t + 1].float(), cfg, dt)
        hms.append(hm)
        gz.append(g)
    return torch.stack(hms, 1), torch.stack(gz, 1)


@torch.no_grad()
def calibrate_streams(weights: Dict[str, Weights], pairs, cfg: dict,
                      flow_dtype: torch.dtype = torch.float32) -> dict:
    """Per stream and layer, the input bound of the int8 grids from the
    calibration frame pairs ((B, H, W, 3) uint8 prev, cur) through this
    file's preprocessing (the TV-L1 solve in ``flow_dtype``) and float
    VGG. The grids are as sensitive as the codes: a flow a rounding away
    moves a bound by a millionth and turns codes through the layers."""
    q = cfg["quant"]["percentile"]
    dt = act_dtype(cfg)     # the model's inputs are in the activation type
    ins = [tuple(rnd(x, dt) for x in preprocess(p, c, cfg, flow_dtype)) for p, c in pairs]
    return {"spatial": calibrate(weights["sp"], "spatial", [r for r, _ in ins], cfg, q),
            "temporal": calibrate(weights["sp"], "temporal", [f for _, f in ins], cfg, q)}


# ----------------------------------------------------------- training ----
def gaussians(pts: torch.Tensor, H: int, W: int, sigma: float) -> torch.Tensor:
    ys = torch.arange(H, dtype=torch.float32, device=pts.device).view(1, H, 1)
    xs = torch.arange(W, dtype=torch.float32, device=pts.device).view(1, 1, W)
    d2 = (xs - pts[:, 0].view(-1, 1, 1)) ** 2 + (ys - pts[:, 1].view(-1, 1, 1)) ** 2
    return torch.exp(-d2 / (2.0 * sigma * sigma))


def focal_loss(p: torch.Tensor, t: torch.Tensor, gamma: float, eps: float) -> torch.Tensor:
    p = torch.minimum(torch.maximum(p, torch.tensor(eps, device=p.device)),
                      torch.tensor(1.0 - eps, device=p.device))
    per = -t * (1.0 - p) ** gamma * torch.log(p) - (1.0 - t) * p ** gamma * torch.log(1.0 - p)
    return per.mean()


def trainable(name: str) -> bool:
    """The SP's trained leaves: every conv, deconv and BatchNorm scale and
    bias (not the running statistics)."""
    return not name.endswith(("running_mean", "running_var"))


class TrainRef:
    """The SP train step at float32: (prev, cur, gaze) -> train-mode
    forward, focal loss, gradients, optax AdamW (b1 0.9, b2 0.999, eps
    1e-8, decoupled weight decay on every leaf)."""

    def __init__(self, sp: Weights, cfg: dict, lowp=None):
        self.cfg, self.lowp = cfg, lowp
        self.w = {k: v.detach().clone() for k, v in sp.items()}
        self.names = [k for k in self.w if trainable(k)]
        self.mu = {k: torch.zeros_like(self.w[k]) for k in self.names}
        self.nu = {k: torch.zeros_like(self.w[k]) for k in self.names}
        self.count = 0

    def grads(self, batch: Dict[str, torch.Tensor]):
        """(loss, {leaf: gradient}, new running statistics) at the current
        weights."""
        cfg = self.cfg
        with torch.no_grad():
            rgb, flow = preprocess(batch["prev"], batch["cur"], cfg)
        params = {k: self.w[k].clone().requires_grad_(True) for k in self.names}
        w = dict(self.w, **params)
        f_s = vgg(w, "spatial", rgb, cfg, self.lowp)
        f_t = vgg(w, "temporal", flow, cfg, self.lowp)
        sal, stats = fuse_decode(w, f_s, f_t, cfg, train=True, lowp=self.lowp)
        im, ls = cfg["image"], cfg["loss"]
        target = gaussians(batch["gaze"].float(), im["height"], im["width"], im["heatmap_sigma"])
        loss = focal_loss(sal, target, ls["gamma"], ls["eps"])
        g = torch.autograd.grad(loss, [params[k] for k in self.names])
        return float(loss.detach()), dict(zip(self.names, g)), stats

    def step(self, batch: Dict[str, torch.Tensor]):
        """One step; returns (loss, the gradients it applied)."""
        loss, g, stats = self.grads(batch)
        self.apply(g, stats)
        return loss, g

    @torch.no_grad()
    def apply(self, g: Weights, stats: Weights) -> None:
        tr = self.cfg["train"]
        lr, wd = tr["learning_rate"], tr["weight_decay"]
        self.count += 1
        bc1, bc2 = 1 - 0.9 ** self.count, 1 - 0.999 ** self.count
        for k in self.names:
            self.mu[k] = 0.9 * self.mu[k] + 0.1 * g[k]
            self.nu[k] = 0.999 * self.nu[k] + 0.001 * g[k] * g[k]
            upd = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + 1e-8) + wd * self.w[k]
            self.w[k] = self.w[k] - lr * upd
        self.w.update(stats)
