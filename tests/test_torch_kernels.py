"""The arithmetic of the redesigned kernels K2 and K3, in plain form on
the CPU, against the JAX package.

K2 (``csrc/tvl1_pd.cu``) runs a (level, warp) step's iterations and the
between-warp median in one launch; its wrapper's plain composition is
``pd_iterations_plain`` followed by ``median3x3``. K3 (``csrc/conv_int8.cu``)
loads the frame's border as 0 through TMA and adds the pad code back in
its epilogue; ``pad_correction`` is that step in plain form. K3 also
fuses the 2x2 max-pool that ends a VGG stage; its plain composition is
``conv3x3_int8_plain`` followed by ``maxpool2x2_int8``. The CUDA
kernels themselves are held against the same plain versions on the card
by chip_smoke.py.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from flax.linen import max_pool

from gaze_tpu.core.config import TVL1Config as JTVL1Config
from gaze_tpu.ops import image as jimage
from gaze_tpu_torch.core.config import TVL1Config
from gaze_tpu_torch.ops import tvl1
from gaze_tpu_torch.ops.conv_int8 import (
    ConvTap,
    border_table,
    conv3x3_int8_plain,
    epilogue,
    int8_conv_acc,
    maxpool2x2_int8,
    pad_correction,
)
from gaze_tpu_torch.ops.cuda.conv_int8 import conv3x3_int8
from gaze_tpu_torch.ops.cuda.tvl1_pd import pd_iterations, pd_iterations_plain
from gaze_tpu_torch.ops.image import median3x3
from tests.test_pallas_pd import scan_reference  # the scan body of ops/tvl1.py:131-159
from tests.test_torch_ops import pd_inputs, t
from tests.torch_threads import cap_torch_threads  # noqa: F401  (autouse)


@pytest.mark.parametrize("passes", [0, 1, 2])
def test_pd_with_median_matches_jax(passes):
    """The wrapper's CPU path (iterations, then ``passes`` medians of the
    flow, duals untouched) against JAX's scan body and ``median3x3`` at a
    ragged shape. 1e-5 (measured 4.8e-7): XLA contracts the scan body's
    multiply-adds into FMAs, the port rounds each operation
    (tests/test_torch_ops.py), over 4 iterations; the median only
    selects values."""
    args = pd_inputs(2, 13, 21, seed=21, warm_duals=True)
    cfg = JTVL1Config(iters=4)
    kw = dict(iters=4, tau=cfg.tau, lambda_=cfg.lambda_, theta=cfg.theta)
    got = pd_iterations(*(t(a) for a in args), median_passes=passes, **kw)
    want = list(scan_reference(*(jnp.asarray(a) for a in args), cfg))
    for _ in range(passes):
        want[0], want[1] = jimage.median3x3(want[0]), jimage.median3x3(want[1])
    plain = pd_iterations_plain(*(t(a) for a in args), **kw)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
        if i >= 2:   # the duals take no median
            assert torch.equal(g, plain[i])
    if passes:
        assert not torch.equal(got[0], plain[0])


def old_solve_level(i0, i1, u1, u2, cfg):
    """``_solve_level`` as it was before K2 took the median: the
    iterations, then 1 or 2 separate median passes per warp."""
    i1x, i1y = tvl1.central_gradient(i1)
    p = [torch.zeros_like(u1) for _ in range(4)]
    for _ in range(cfg.warps):
        fields = tvl1.warp3_plain(i1, i1x, i1y, u1, u2, i0)
        u1, u2, *p = pd_iterations_plain(u1, u2, *p, *fields, iters=cfg.iters, tau=cfg.tau,
                                         lambda_=cfg.lambda_, theta=cfg.theta)
        if cfg.median_filter:
            for _ in range(2 if cfg.median_kernel >= 5 else 1):
                u1, u2 = median3x3(u1), median3x3(u2)
    return u1, u2


@pytest.mark.parametrize("median", [dict(median_kernel=3), dict(median_kernel=5),
                                    dict(median_filter=False)])
def test_solve_level_keeps_its_output(median):
    """The kernel path's median argument changes no bit of the level
    solve on the CPU, nor does the plain path's median."""
    rng = np.random.default_rng(22)
    i0, i1, u1, u2 = (torch.from_numpy(rng.uniform(0, 255 if k < 2 else 1, (1, 12, 18))
                                       .astype(np.float32)) for k in range(4))
    cfg = TVL1Config(warps=2, iters=3, **median)
    want = old_solve_level(i0, i1, u1, u2, cfg)
    for pd in (True, False):
        got = tvl1._solve_level(i0, i1, u1, u2, dataclasses.replace(cfg, use_pallas_pd=pd))
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("hw", [(3, 4), (1, 5)])
@pytest.mark.parametrize("pad_code", [-128, 0])
@pytest.mark.parametrize("ci", [32, 64])
def test_zero_fill_plus_pad_correction_is_the_pad_code_conv(hw, pad_code, ci):
    """K3's border arithmetic: the zero-padded accumulator plus the border
    table's entry for each pixel (``pad_code`` times the colsums of the
    taps outside the frame) equals the pad-code conv, bit for bit, through
    both epilogues. A 3x4 frame: every pixel is on an edge, the corners
    leave five taps out; a 1x5 frame: every pixel is on the top and the
    bottom edge at once."""
    H, W = hw
    rng = np.random.default_rng(23)
    x = torch.from_numpy(rng.integers(-128, 128, (2, H, W, ci), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (16, 3, 3, ci), dtype=np.int8))
    a = torch.from_numpy(rng.uniform(1e-4, 1e-3, 16).astype(np.float32))
    c = torch.from_numpy(rng.normal(0, 10, 16).astype(np.float32))
    border = border_table(w, pad_code)
    assert border.dtype == torch.int32 and border.shape == (16, 16)
    assert not border[0].any()
    acc = int8_conv_acc(x, w, 0) + pad_correction(border, H, W)
    assert acc.dtype == torch.int32
    assert torch.equal(acc, int8_conv_acc(x, w, pad_code))
    # the same conv in JAX: nine shifted int32 matmuls of the pad-code canvas
    xp = jnp.pad(jnp.asarray(x.numpy(), jnp.int32), ((0, 0), (1, 1), (1, 1), (0, 0)),
                 constant_values=pad_code)
    k = jnp.asarray(w.permute(1, 2, 3, 0).numpy(), jnp.int32)
    jacc = sum(xp[:, dy:dy + H, dx:dx + W] @ k[dy, dx] for dy in range(3) for dx in range(3))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    for bias in (None, torch.from_numpy(rng.normal(0, 1, 16).astype(np.float32))):
        tap = ConvTap(w, a, c, bias, pad_code, border)
        assert torch.equal(epilogue(acc, tap), conv3x3_int8_plain(x, tap))


@pytest.mark.parametrize("hw", [(6, 8), (7, 9)])
def test_pooled_conv_matches_jax(hw):
    """The K3 wrapper's pooled layer on the CPU: the requantized codes of
    the pad-code conv, then the 2x2 VALID max-pool, which drops an odd
    last row and column as flax's ``max_pool`` does."""
    H, W = hw
    rng = np.random.default_rng(24)
    x = torch.from_numpy(rng.integers(-128, 128, (2, H, W, 32), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (16, 3, 3, 32), dtype=np.int8))
    a = torch.from_numpy(rng.uniform(1e-4, 1e-3, 16).astype(np.float32))
    c = torch.from_numpy(rng.normal(0, 10, 16).astype(np.float32))
    tap = ConvTap(w, a, c, None, -128)
    got = conv3x3_int8(x, tap, pool=True)
    codes = conv3x3_int8_plain(x, tap)
    assert got.shape == (2, H // 2, W // 2, 16) and got.dtype == torch.int8
    assert torch.equal(got, maxpool2x2_int8(codes))
    # the int8 pool of gaze_tpu/models/quant.py:quant_vgg_forward
    want = max_pool(jnp.asarray(codes.numpy()), window_shape=(2, 2), strides=(2, 2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
