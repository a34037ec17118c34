"""The port's tensor ops (gaze_tpu_torch.ops) against their JAX
counterparts on the CPU.

Inputs come from a numpy seed and go through both functions. Each
tolerance is stated beside its test; most agree to float32 rounding
(1 ulp of 255 is 1.5e-5). Kernels K1 and K2 are checked here through
their plain PyTorch versions, against the JAX gather warp / scan body and
against the Pallas kernels in interpret mode; the CUDA kernels themselves
are held against the same plain versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from gaze_tpu.core.config import ImageConfig as JImageConfig
from gaze_tpu.core.config import TVL1Config as JTVL1Config
from gaze_tpu.ops import heatmap as jheat
from gaze_tpu.ops import image as jimage
from gaze_tpu.ops import preprocess as jpre
from gaze_tpu.ops import tvl1 as jtvl1
from gaze_tpu.ops import warp as jwarp
from gaze_tpu.ops.pallas.tvl1_pd import pd_iterations as pallas_pd
from gaze_tpu.ops.pallas.warp import MAX_DISP, warp_fields
from gaze_tpu_torch.core.config import ImageConfig, TVL1Config
from gaze_tpu_torch.ops import heatmap, image, preprocess, tvl1, warp
from gaze_tpu_torch.ops.cuda.tvl1_pd import pd_iterations_plain
from tests.test_pallas_pd import scan_reference  # the scan body of ops/tvl1.py:131-159
from tests.torch_threads import cap_torch_threads  # noqa: F401  (autouse)


def t(x):
    return torch.from_numpy(np.array(x))  # a writable copy of a numpy or JAX array


def close(actual, expected, atol, rtol=0.0):
    np.testing.assert_allclose(
        np.asarray(actual), np.asarray(expected), atol=atol, rtol=rtol
    )


def smooth_flow(B, H, W, scale, seed, noise=1.0):
    """Smooth displacement fields of amplitude ``scale`` px plus uniform
    noise of amplitude ``noise``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    u1 = scale * np.sin(xx / 17.0 + rng.uniform(0, 3)) + noise * rng.uniform(-1, 1, (B, H, W))
    u2 = scale * np.cos(yy / 11.0 + rng.uniform(0, 3)) + noise * rng.uniform(-1, 1, (B, H, W))
    return u1.astype(np.float32), u2.astype(np.float32)


# ------------------------------------------------------------ preprocess
class TestPreprocess:
    def test_to_float_gray_normalize(self):
        rng = np.random.default_rng(0)
        u8 = rng.integers(0, 256, (2, 20, 24, 3), np.uint8)
        f = jpre.to_float(jnp.asarray(u8))
        close(preprocess.to_float(t(u8)), f, atol=0)
        # tensordot sums the three products in another order: 1 ulp.
        close(preprocess.rgb_to_gray(t(f)), jpre.rgb_to_gray(f), atol=1e-7)
        close(preprocess.normalize_rgb(t(f), ImageConfig()),
              jpre.normalize_rgb(f, JImageConfig()), atol=1e-6)
        close(preprocess.normalize_flow_image(t(f)), jpre.normalize_flow_image(f), atol=1e-6)

    def test_prepare_temporal_input_clips(self):
        flow = np.random.default_rng(1).uniform(-30, 30, (2, 8, 8, 2)).astype(np.float32)
        close(preprocess.prepare_temporal_input(t(flow), 15.0),
              jpre.prepare_temporal_input(jnp.asarray(flow), 15.0), atol=1e-6)

    @pytest.mark.parametrize("src,dst", [
        ((224, 224), (112, 112)),   # antialiased shrink, pyramid level 1
        ((56, 56), (28, 28)),       # antialiased shrink, pyramid level 3
        ((37, 50), (19, 25)),       # ragged ratio
        ((48, 40), (96, 80)),       # growing
        ((40, 40), (40, 40)),       # no-op
    ])
    def test_resize_frames(self, src, dst):
        # jax.image.resize antialiases a shrink; without antialias=True
        # F.interpolate misses by ~60 on this 0-255 data. The filter
        # weights round differently: tolerance 1e-6 relative (~10 ulp).
        x = np.random.default_rng(2).uniform(0, 255, (2,) + src + (3,)).astype(np.float32)
        close(preprocess.resize_frames(t(x), *dst),
              jpre.resize_frames(jnp.asarray(x), *dst), atol=1e-5, rtol=1e-6)


# --------------------------------------------------------------- heatmap
class TestHeatmap:
    def test_argmax_first_max_wins(self):
        hm = np.random.default_rng(3).uniform(0, 1, (3, 9, 11)).astype(np.float32)
        hm[1, 2, 7] = hm[1, 5, 1] = hm[1, 8, 10] = 2.0   # ties: first in row-major order
        hm[2] = 0.5                                     # all equal -> (0, 0)
        close(heatmap.heatmap_argmax(t(hm)), jheat.heatmap_argmax(jnp.asarray(hm)), atol=0)

    def test_normalize_map(self):
        hm = np.random.default_rng(4).normal(size=(2, 7, 5)).astype(np.float32)
        close(heatmap.normalize_map(t(hm)), jheat.normalize_map(jnp.asarray(hm)), atol=1e-6)


# ----------------------------------------------------------------- image
class TestImage:
    @pytest.mark.parametrize("sigma", [0.8, 1.6])
    def test_gaussian(self, sigma):
        close(image.gaussian_kernel1d(sigma), jimage.gaussian_kernel1d(sigma), atol=1e-7)
        x = np.random.default_rng(5).uniform(0, 255, (2, 30, 41)).astype(np.float32)
        # conv sums the taps in another order: a few ulp of 255.
        close(image.gaussian_blur(t(x), sigma), jimage.gaussian_blur(jnp.asarray(x), sigma),
              atol=1e-4)

    @pytest.mark.parametrize("src,dst", [
        ((224, 224), (112, 112)), ((56, 56), (28, 28)), ((37, 50), (19, 25)),
        ((28, 28), (56, 56)), ((14, 14), (224, 224)),
    ])
    def test_resize_and_pyramid(self, src, dst):
        x = np.random.default_rng(6).uniform(0, 255, (2,) + src).astype(np.float32)
        close(image.resize_bilinear(t(x), dst),
              jimage.resize_bilinear(jnp.asarray(x), dst), atol=1e-5, rtol=1e-6)
        if dst[0] < src[0]:
            close(image.pyramid_downscale(t(x), dst),
                  jimage.pyramid_downscale(jnp.asarray(x), dst), atol=1e-4)

    def test_gradients_divergence_median(self):
        rng = np.random.default_rng(7)
        x = rng.uniform(-3, 3, (2, 13, 17)).astype(np.float32)
        y = rng.uniform(-3, 3, (2, 13, 17)).astype(np.float32)
        for a, b in zip(image.central_gradient(t(x)), jimage.central_gradient(jnp.asarray(x))):
            close(a, b, atol=0)
        for a, b in zip(image.forward_gradient(t(x)), jimage.forward_gradient(jnp.asarray(x))):
            close(a, b, atol=0)
        close(image.divergence(t(x), t(y)), jimage.divergence(jnp.asarray(x), jnp.asarray(y)),
              atol=0)
        # min/max network: exact.
        close(image.median3x3(t(x)), jimage.median3x3(jnp.asarray(x)), atol=0)


# ------------------------------------------------------------------ warp
class TestWarp:
    @pytest.mark.parametrize("shape", [(2, 32, 64), (1, 14, 14), (2, 48, 224)])
    def test_warp_backward_matches_jax(self, shape):
        """The exact gather, displacements to +-40 px (past the TPU
        kernel's +-16 clamp). Same operations, same order: 1e-6."""
        B, H, W = shape
        img = np.random.default_rng(8).uniform(0, 1, shape).astype(np.float32)
        u1, u2 = smooth_flow(B, H, W, 39.0, seed=9)
        close(warp.warp_backward(t(img), t(u1), t(u2)),
              jwarp.warp_backward(jnp.asarray(img), jnp.asarray(u1), jnp.asarray(u2)),
              atol=1e-6)

    def test_bilinear_sample_clamps_at_the_border(self):
        rng = np.random.default_rng(10)
        img = rng.uniform(0, 1, (2, 6, 9)).astype(np.float32)
        x = rng.uniform(-4, 13, (2, 6, 9)).astype(np.float32)
        y = rng.uniform(-4, 10, (2, 6, 9)).astype(np.float32)
        x[0, 0, :3] = (0.0, 8.0, 7.5)  # exactly on the border / last cell
        close(warp.bilinear_sample(t(img), t(x), t(y)),
              jwarp.bilinear_sample(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y)),
              atol=1e-6)

    @pytest.mark.parametrize("shape", [(2, 32, 64), (1, 14, 14), (2, 48, 224)])
    def test_warp3_matches_pallas_kernel(self, shape):
        """warp3_plain (K1's plain version, which forms I1's gradients
        itself) against JAX's central_gradient and the Pallas warp in
        interpret mode, on the fields and flow of tests/test_pallas_warp.py
        (0-1 images, flow smooth enough for the kernel's per-tile residual
        bound), plus the fused epilogue of ops/tvl1.py:111-113. The Pallas
        kernel holds itself to 1e-5 against the gather warp; rho_c
        multiplies the warped gradients by displacements of up to 4 px:
        atol 1e-4."""
        B, H, W = shape
        rng = np.random.default_rng(11)
        i1 = rng.uniform(0, 1, shape).astype(np.float32)
        i0 = rng.uniform(0, 1, shape).astype(np.float32)
        i1x, i1y = jimage.central_gradient(jnp.asarray(i1))
        u1, u2 = smooth_flow(B, H, W, 4.0, seed=12, noise=0.0)
        assert np.abs(u1).max() < MAX_DISP and np.abs(u2).max() < MAX_DISP
        ju1, ju2 = jnp.asarray(u1), jnp.asarray(u2)
        jw, jx, jy = warp_fields((jnp.asarray(i1), i1x, i1y), ju1, ju2, interpret=True)
        expect = (jx, jy, jx * jx + jy * jy, jw - jx * ju1 - jy * ju2 - jnp.asarray(i0))
        got = warp.warp3_plain(t(i1), t(u1), t(u2), t(i0))
        for g, e in zip(got, expect):
            close(g, e, atol=1e-4)

    @pytest.mark.parametrize("shape", [(2, 9, 13), (1, 2, 11), (2, 3, 7), (1, 8, 2),
                                       (2, 5, 3), (1, 2, 2), (1, 3, 3)])
    def test_warp3_plain_is_the_gradients_then_the_gather(self, shape):
        """K1's plain version equals central_gradient followed by the
        gather bit for bit, and so does the kernel's own scheme, emulated
        here in float32 numpy: each tap's gradient formed from the 12
        loads of the 4x4 neighbourhood without its corners, one-sided on
        the border. Displacements of +-40 px push taps onto every border;
        H or W of 2 and 3 make the one-sided differences meet."""
        B, H, W = shape
        rng = np.random.default_rng(13)
        i1 = rng.uniform(0, 255, shape).astype(np.float32)
        i0 = rng.uniform(0, 255, shape).astype(np.float32)
        u1, u2 = smooth_flow(B, H, W, 39.0, seed=14)
        got = warp.warp3_plain(t(i1), t(u1), t(u2), t(i0))
        gx, gy = image.central_gradient(t(i1))
        want = warp.warp3_gather(t(i1), gx, gy, t(u1), t(u2), t(i0))
        taps = kernel_taps(i1, u1, u2, i0)
        for g, w, k in zip(got, want, taps):
            assert torch.equal(g, w)
            assert torch.equal(g, torch.from_numpy(k))


def kernel_taps(i1, u1, u2, i0):
    """csrc/warp.cu's arithmetic in float32 numpy, operation by operation:
    the corner and weights of each pixel, the 12 loads around the corner
    and each tap's central (or one-sided) difference, the shared-weight
    sums and the epilogue."""
    f32 = np.float32
    B, H, W = i1.shape
    yy, xx = np.mgrid[0:H, 0:W]
    xs = np.minimum(np.maximum(xx.astype(f32) + u1, f32(0)), f32(W - 1))
    ys = np.minimum(np.maximum(yy.astype(f32) + u2, f32(0)), f32(H - 1))
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, W - 2)
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, H - 2)
    fx, fy = xs - x0.astype(f32), ys - y0.astype(f32)
    w = ((f32(1) - fx) * (f32(1) - fy), fx * (f32(1) - fy), (f32(1) - fx) * fy, fx * fy)
    b = np.arange(B)[:, None, None]

    def at(r, c):
        return i1[b, r, c]

    def central(vr, vl, edge):
        d = vr - vl
        return np.where(edge, d, f32(0.5) * d)

    xe0, xe1, ye0, ye1 = x0 == 0, x0 + 1 == W - 1, y0 == 0, y0 + 1 == H - 1
    xl, xr = np.where(xe0, x0, x0 - 1), np.where(xe1, x0 + 1, x0 + 2)
    yu, yd = np.where(ye0, y0, y0 - 1), np.where(ye1, y0 + 1, y0 + 2)
    a = (at(y0, x0), at(y0, x0 + 1), at(y0 + 1, x0), at(y0 + 1, x0 + 1))
    gx = (central(a[1], at(y0, xl), xe0), central(at(y0, xr), a[0], xe1),
          central(a[3], at(y0 + 1, xl), xe0), central(at(y0 + 1, xr), a[2], xe1))
    gy = (central(a[2], at(yu, x0), ye0), central(a[3], at(yu, x0 + 1), ye0),
          central(at(yd, x0), a[0], ye1), central(at(yd, x0 + 1), a[1], ye1))

    def wsum(v):
        return v[0] * w[0] + v[1] * w[1] + v[2] * w[2] + v[3] * w[3]

    i1w, wx, wy = wsum(a), wsum(gx), wsum(gy)
    return wx, wy, wx * wx + wy * wy, i1w - wx * u1 - wy * u2 - i0


# --------------------------------------------------------- primal-dual
def pd_inputs(B, H, W, seed, warm_duals):
    rng = np.random.default_rng(seed)
    i1 = rng.uniform(0, 255, (B, H, W)).astype(np.float32)
    i0 = rng.uniform(0, 255, (B, H, W)).astype(np.float32)
    i1x, i1y = (np.asarray(g) for g in jimage.central_gradient(jnp.asarray(i1)))
    grad = i1x**2 + i1y**2
    rho_c = i1 - i0
    u1 = rng.uniform(-1, 1, (B, H, W)).astype(np.float32)
    u2 = rng.uniform(-1, 1, (B, H, W)).astype(np.float32)
    ps = []
    for k in range(4):
        p = (rng.uniform(-0.5, 0.5, (B, H, W)) if warm_duals else np.zeros((B, H, W)))
        p = p.astype(np.float32)
        # The solver invariant: x-duals zero in the last column, y-duals
        # zero in the last row.
        if k % 2 == 0:
            p[:, :, -1] = 0
        else:
            p[:, -1, :] = 0
        ps.append(p)
    return [u1, u2, *ps, i1x, i1y, grad, rho_c]


class TestPrimalDual:
    @pytest.mark.parametrize("shape,iters,warm", [
        ((2, 24, 40), 7, False),    # ragged vs the TPU's (8, 128) canvas
        ((1, 16, 128), 3, True),    # warm duals carried across warps
    ])
    def test_plain_matches_scan_and_pallas(self, shape, iters, warm):
        """K2's plain version against the Pallas kernel (interpret mode)
        and the JAX scan body. XLA contracts the scan body's
        multiply-adds into FMAs, the port rounds each operation: 1e-4,
        the tolerance tests/test_pallas_pd.py holds the kernel to."""
        args = pd_inputs(*shape, seed=13, warm_duals=warm)
        cfg = JTVL1Config(iters=iters)
        kw = dict(iters=iters, tau=cfg.tau, lambda_=cfg.lambda_, theta=cfg.theta)
        got = pd_iterations_plain(*(t(a) for a in args), **kw)
        jargs = [jnp.asarray(a) for a in args]
        pallas = pallas_pd(*jargs, interpret=True, **kw)
        scan = scan_reference(*jargs, cfg)
        for g, p, r in zip(got, pallas, scan):
            close(g, p, atol=1e-4)
            close(g, r, atol=1e-4)


# ----------------------------------------------------------------- tvl1
class TestTVL1:
    @pytest.mark.parametrize("hw,levels", [((224, 224), 5), ((32, 48), 2), ((30, 40), 5)])
    def test_pyramid_shapes(self, hw, levels):
        assert tvl1._pyramid_shapes(*hw, levels, 0.5) == jtvl1._pyramid_shapes(*hw, levels, 0.5)

    @pytest.mark.parametrize("median_kernel", [3, 5])
    def test_flow_matches_jax(self, median_kernel):
        """A small pyramid (2 levels, 2 warps, 5 iterations, 32x48).
        Tolerance 1e-3 px: the scan's FMAs against separate roundings,
        carried through 20 iterations and the medians."""
        rng = np.random.default_rng(14)
        yy, xx = np.mgrid[0:32, 0:48]
        base = 0.5 + 0.2 * np.sin(xx / 3.0) * np.cos(yy / 4.0)
        i0 = (base + 0.05 * rng.uniform(-1, 1, (2, 32, 48))).astype(np.float32)
        i1 = np.roll(i0, (1, 2), axis=(1, 2))
        kw = dict(pyramid_levels=2, warps=2, iters=5, median_kernel=median_kernel)
        expect = jtvl1.tvl1_flow(jnp.asarray(i0), jnp.asarray(i1), JTVL1Config(**kw))
        got = tvl1.tvl1_flow(t(i0), t(i1), TVL1Config(**kw), device="cpu")
        close(got, expect, atol=1e-3)

    def test_plain_flags_take_the_same_path_on_cpu(self):
        rng = np.random.default_rng(15)
        i0 = rng.uniform(0, 1, (1, 20, 24)).astype(np.float32)
        i1 = rng.uniform(0, 1, (1, 20, 24)).astype(np.float32)
        a = tvl1.tvl1_flow(t(i0), t(i1), TVL1Config(pyramid_levels=1, warps=2, iters=3),
                           device="cpu")
        b = tvl1.tvl1_flow(t(i0), t(i1), TVL1Config(pyramid_levels=1, warps=2, iters=3,
                                                    use_pallas_warp=False,
                                                    use_pallas_pd=False), device="cpu")
        assert torch.equal(a, b)

