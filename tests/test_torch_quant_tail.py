"""The port's int8 fuse/decoder tail (``gaze_tpu_torch/models/quant_tail.py``
and ``ops/int8_gemm.py``) against ``gaze_tpu/models/quant_tail.py`` on the
CPU: the BatchNorm fold and the float32 polyphase probe, the built codes
and calibrated scales, the int8 forward layer by layer, its GEMM route,
the pipeline's step with a tail, ``calibrate_pipeline_sp(quant_tail=True)``
and the ``.npz`` bundle with ``tail.*`` keys.

Tolerances, with their reasons:

- fold and probe: 1e-5 relative (the float32 convolutions sum in another
  order than XLA's; the fold's ``rsqrt`` may differ by an ulp).
- calibrated scales: the probe's bounds on the same features, 1e-5
  relative (``SCALE_RTOL``).
- built codes: the port's own build equals JAX's or lies one code away
  where ``k * g / s`` sits within an ulp of a .5 boundary, at most
  ``CODE_FLIP_SHARE`` of the codes (measured: none of 17416 at these
  seeds; the scales 9.7e-8 relative apart).
- a tail carried across from JAX: every layer's codes within 1 LSB of
  JAX's, at most ``CODE_FLIP_SHARE`` of them flipped (measured: none:
  the s32 accumulators are exact and each epilogue operation rounds once
  on both sides); the saliency within ``SAL_ATOL`` (the sigmoid's own
  ulps).
- the GEMM route: bit for bit against a float64 ``F.conv2d``.
- through ``calibrate_pipeline_sp``: the streams' scales move with the
  TV-L1 band (``tests/test_torch_quant.py``), which moves the features
  the tail calibrates on; its scales are held to ``FLOW_SCALE_RTOL``
  (measured 2.0e-4), its codes as above (measured: none flipped).
- the pipeline step with JAX's calibration carried across: saliency and
  heatmaps within ``STEP_ATOL`` (the TV-L1 band carried through int8
  codes that may flip; measured 4.3e-4 and 1.5e-5), gaze equal or a
  near tie.
"""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from gaze_tpu.data.synthetic import SyntheticSpec, generate_sequence
from gaze_tpu.models import quant as jquant
from gaze_tpu.models import quant_io as jquant_io
from gaze_tpu.models import quant_tail as jtail
from gaze_tpu.models.decode_fast import _depth_to_space_offset as jd2s
from gaze_tpu.models.pipeline import GazePipeline as JGazePipeline
from gaze_tpu_torch.models import quant, quant_io
from gaze_tpu_torch.models import quant_tail as tail
from gaze_tpu_torch.models.decode_fast import depth_to_space_offset_nhwc
from gaze_tpu_torch.models.pipeline import GazePipeline
from gaze_tpu_torch.models.weights import torch_state_from_jax
from gaze_tpu_torch.ops import int8_gemm
from tests.test_torch_pipeline import port_config
from tests.test_torch_quant import narrow_config, np_tree
from tests.torch_threads import cap_torch_threads  # noqa: F401  (autouse)
from tests.torch_train_cases import randomize

FOLD_RTOL = 1e-5
SCALE_RTOL = 1e-5
FLOW_SCALE_RTOL = 5e-4
CODE_FLIP_SHARE = 1e-3
SAL_ATOL = 1e-6
STEP_ATOL = 2e-3
NEAR_TIE = 1e-5


@pytest.fixture(scope="module")
def case():
    """The narrow 32² pipeline on both sides with the same weights, the
    decoder's biases, BatchNorm scales and statistics randomized (so the
    fold is not the identity), and post-ReLU conv5 features of both
    streams on a 4x4 grid (the tail's input; its output is 64²)."""
    cfg = narrow_config()
    jp = JGazePipeline(cfg)
    v = np_tree(jax.jit(jp.init_variables)(jax.random.key(0)))
    v["sp"] = {"params": randomize(v["sp"]["params"], 3),
               "batch_stats": randomize(v["sp"]["batch_stats"], 4)}
    pipe = GazePipeline(port_config(cfg), device="cpu")
    pipe.load_state_dicts(torch_state_from_jax(v))
    rng = np.random.default_rng(5)
    c5 = cfg.sp.stages[-1][-1]
    fs, ft = (np.maximum(rng.normal(0, 1, (2, 4, 4, c5)), 0).astype(np.float32)
              for _ in range(2))
    x = np.concatenate([fs, ft], axis=-1)
    return dict(cfg=cfg, jp=jp, v=v, pipe=pipe, fs=fs, ft=ft, x=x)


def rel_close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, err


# ------------------------------------------------------------ fold, probe
@pytest.mark.parametrize("percentile", [None, 99.9])
def test_fold_and_probe_match_jax(case, percentile):
    want_fold = jtail.fold_tail_params(case["v"]["sp"], case["cfg"].sp)
    got_fold = tail.fold_tail_params(case["pipe"].sp)
    assert list(got_fold) == list(want_fold) == list(tail.tail_layer_names(case["cfg"].sp))
    for name, (k, b) in want_fold.items():
        assert got_fold[name][0].shape == k.shape, name
        rel_close(got_fold[name][0].numpy(), k, FOLD_RTOL)
        rel_close(got_fold[name][1].numpy(), b, FOLD_RTOL)
    sal, bounds = jtail.tail_forward_with_bounds(want_fold, case["cfg"].sp,
                                                 jnp.asarray(case["x"]), percentile)
    got_sal, got_bounds = tail.tail_forward_with_bounds(got_fold, case["cfg"].sp,
                                                        torch.from_numpy(case["x"]), percentile)
    assert got_sal.shape == sal.shape == (2, 64, 64)
    np.testing.assert_allclose(got_sal.numpy(), np.asarray(sal), rtol=FOLD_RTOL, atol=1e-6)
    assert set(got_bounds) == set(bounds)
    for k in bounds:
        rel_close(float(got_bounds[k]), float(bounds[k]), FOLD_RTOL)
    # the probe is the canonical float decoder, up to the fold's float order
    ref = case["pipe"].sp.fuse_decode(torch.from_numpy(case["fs"]), torch.from_numpy(case["ft"]))
    np.testing.assert_allclose(got_sal.numpy(), ref.detach().numpy(), atol=1e-5)


# -------------------------------------------------------- codes and scales
@pytest.fixture(scope="module", params=[None, 99.9], ids=["max", "percentile"])
def calibrated(request, case):
    """(JAX's calibrated tail, the port's own, JAX's carried across)."""
    jt = jtail.calibrate_tail(case["v"]["sp"], case["cfg"].sp, [case["x"]],
                              percentile=request.param)
    tt = tail.calibrate_tail(case["pipe"].sp, [torch.from_numpy(case["x"])],
                             percentile=request.param)
    return jt, tt, quant_io.quant_tail_from_numpy(np_tree(jt))


def test_built_codes_and_scales_match_jax(calibrated):
    jt, tt, _ = calibrated
    assert tt.num_blocks == jt.num_blocks == 4
    flipped = total = 0
    for name in tail.tail_layer_names(narrow_config().sp):
        rel_close(float(tt.act_scales[name]), float(jt.act_scales[name]), SCALE_RTOL)
        rel_close(tt.w_scales[name].numpy(), np.asarray(jt.w_scales[name]), FOLD_RTOL)
        rel_close(tt.biases[name].numpy(), np.asarray(jt.biases[name]), FOLD_RTOL)
        got, want = tt.kernels[name].numpy(), np.asarray(jt.kernels[name])
        assert got.dtype == want.dtype == np.int8 and got.shape == want.shape, name
        d = np.abs(got.astype(np.int16) - want)
        assert d.max() <= 1, name
        flipped += int((d != 0).sum())
        total += d.size
        np.testing.assert_array_equal(tt.col_sums[name].numpy(),
                                      got.astype(np.float32).sum(axis=(0, 1, 2)))
    assert flipped <= CODE_FLIP_SHARE * total, (flipped, total)


def jax_layer_codes(qt, fs, ft):
    """Each layer's output of ``gaze_tpu/models/quant_tail.py:
    quant_tail_forward`` op by op (eager), the up blocks after their
    depth-to-space; the out layer's saliency."""
    x = jnp.concatenate([jnp.asarray(fs), jnp.asarray(ft)], axis=-1).astype(jnp.float32)
    names = ["fuse"] + [f"up{i + 1}" for i in range(qt.num_blocks)] + ["out"]
    xq = (jnp.clip(jnp.round(x / qt.act_scales["fuse"]), 0, 255) - 128).astype(jnp.int8)
    codes = {}
    for li, name in enumerate(names):
        k, col = qt.kernels[name], qt.col_sums[name]
        pad = ((0, 0), (0, 0), (0, 0), (0, 0)) if k.shape[0] == 1 else \
            ((0, 0), (1, 1), (1, 1), (0, 0))
        acc = jax.lax.conv_general_dilated(
            jnp.pad(xq, pad, constant_values=np.int8(-128)), k, (1, 1), "VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
        sw = qt.act_scales[name] * qt.w_scales[name]
        if name == "out":
            xf = (acc.astype(jnp.float32) + 128 * col) * sw + qt.biases[name]
            codes[name] = np.asarray(jax.nn.sigmoid(xf)[..., 0])
            return codes
        sn = qt.act_scales[names[li + 1]]
        a = sw / sn
        c = (qt.biases[name] / sn - 128) + (128 * col) * a
        xq = jnp.clip(jnp.round(acc.astype(jnp.float32) * a + c), -128, 127).astype(jnp.int8)
        if name.startswith("up"):
            xq = jd2s(xq, xq.shape[-1] // 4)
        codes[name] = np.asarray(xq)


def port_layer_codes(qt, fs, ft, taps=None, d2s=depth_to_space_offset_nhwc, pad_code=-128):
    """The same of the port's tail, from its parts (``tail_layer`` with the
    2x2 convs' pad code as given)."""
    taps = tail.tail_taps(qt) if taps is None else taps
    xq = tail.quantize_tail_input(qt, torch.from_numpy(fs), torch.from_numpy(ft))
    codes = {}
    for name in qt.names():
        tap = taps[name]
        xin = F.pad(xq, (0, 0, 1, 1, 1, 1), value=pad_code) if tap.k == 2 else xq
        out = tail.tail_epilogue(tap, int8_gemm.conv_valid_int8(xin.contiguous(), tap.w, tap.k))
        if pad_code == -128:
            assert torch.equal(out, tail.tail_layer(tap, xq)), name
        if name.startswith("up"):
            out = d2s(out, out.shape[-1] // 4)
        codes[name] = out.numpy()
        xq = out
    return codes


def test_forward_of_a_carried_tail_matches_jax(case, calibrated):
    jt, _, qt = calibrated
    for name in qt.names():   # the bridge moves the codes as they are
        np.testing.assert_array_equal(qt.kernels[name].numpy(), np.asarray(jt.kernels[name]))
    want = jax_layer_codes(jt, case["fs"], case["ft"])
    # the mirror above is the JAX package's forward, bit for bit
    np.testing.assert_array_equal(
        want["out"], np.asarray(jtail.quant_tail_forward(jt, case["fs"], case["ft"])))
    got = port_layer_codes(qt, case["fs"], case["ft"])
    assert list(got) == list(want)
    flipped = total = 0
    for name in qt.names()[:-1]:
        assert got[name].shape == want[name].shape and got[name].dtype == np.int8, name
        d = np.abs(got[name].astype(np.int16) - want[name])
        assert d.max() <= 1, name
        flipped += int((d != 0).sum())
        total += d.size
        assert len(np.unique(want[name])) > 8, name   # non-vacuous: codes spread
    assert flipped <= CODE_FLIP_SHARE * total, (flipped, total)
    sal = tail.quant_tail_forward(qt, torch.from_numpy(case["fs"]), torch.from_numpy(case["ft"]))
    np.testing.assert_array_equal(sal.numpy(), got["out"])
    assert sal.dtype == torch.float32 and sal.shape == (2, 64, 64)
    np.testing.assert_allclose(got["out"], want["out"], rtol=0, atol=SAL_ATOL)
    # and the int8 tail tracks the float one
    ref = case["pipe"].sp.fuse_decode(torch.from_numpy(case["fs"]), torch.from_numpy(case["ft"]))
    assert np.abs(sal.numpy() - ref.detach().numpy()).max() < 0.05


def test_forward_has_teeth(case, calibrated):
    """Padding with code 0 (not the real zero -128), dropping the
    zero-point term (128 * col_sum) or a depth-to-space without the
    phase offset each break the agreement by many LSB."""
    jt, _, qt = calibrated
    want = jax_layer_codes(jt, case["fs"], case["ft"])
    taps = tail.tail_taps(qt)

    def plain_d2s(y, c):   # a pixel shuffle of the first N x M positions
        b, h, w, _ = y.shape
        y = y[:, :-1, :-1].reshape(b, h - 1, w - 1, 2, 2, c)
        return y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * (h - 1), 2 * (w - 1), c)

    no_zp = {}
    for li, name in enumerate(qt.names()):
        t = taps[name]
        if name == "out":
            no_zp[name] = t._replace(c=torch.zeros_like(t.c))
        else:
            sn = qt.act_scales[qt.names()[li + 1]]
            no_zp[name] = t._replace(c=qt.biases[name] / sn - 128)
    for bad in ("pad0", "no_zp", "plain_d2s"):
        if bad == "pad0":
            got = port_layer_codes(qt, case["fs"], case["ft"], taps, pad_code=0)
        elif bad == "no_zp":
            got = port_layer_codes(qt, case["fs"], case["ft"], no_zp)
        else:
            got = port_layer_codes(qt, case["fs"], case["ft"], taps, d2s=plain_d2s)
        d = np.abs(got["up2"].astype(np.int16) - want["up2"])
        assert d.max() > 10, (bad, int(d.max()))


# -------------------------------------------------------------- GEMM route
@pytest.mark.parametrize("k,b,h,w,ci,co", [
    (1, 2, 4, 4, 64, 32),      # fuse
    (2, 2, 6, 6, 32, 64),      # a polyphase conv over a padded grid
    (2, 1, 5, 7, 12, 20),      # ragged depth and width
    (1, 2, 8, 8, 8, 1),        # out: one channel
    (1, 1, 3, 3, 16, 8),       # 9 rows
])
def test_gemm_route_is_exact(k, b, h, w, ci, co, monkeypatch):
    """The plain version (the CPU's) and the card's route, ``_int_mm``
    behind the zero padding to its CUDA shape rules (run here on the CPU's
    ``_int_mm``, with the rules asserted), both against a float64
    ``F.conv2d``, bit for bit, at the extreme codes too."""
    rng = np.random.default_rng(k * 100 + co)
    x = torch.from_numpy(rng.integers(-128, 128, (b, h, w, ci), dtype=np.int8))
    x[0, 0, 0] = -128
    wk = torch.from_numpy(rng.integers(-127, 128, (k, k, ci, co), dtype=np.int8))
    wk[..., 0] = -127
    want = F.conv2d(x.double().permute(0, 3, 1, 2), wk.double().permute(3, 2, 0, 1))
    want = want.permute(0, 2, 3, 1).to(torch.int32)
    w_gemm = wk.reshape(-1, co).t().contiguous()
    got = int8_gemm.conv_valid_int8(x, w_gemm, k)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    real = torch._int_mm
    shapes = []

    def checked(a, bm):
        assert a.shape[0] > 16 and a.shape[1] % 8 == 0 and bm.shape[1] % 8 == 0
        assert a.is_contiguous() and bm.t().is_contiguous()
        shapes.append((tuple(a.shape), tuple(bm.shape)))
        return real(a, bm)

    monkeypatch.setattr(torch, "_int_mm", checked)
    acc = int8_gemm.int_mm_padded(int8_gemm.im2col_valid(x, k), w_gemm)
    assert torch.equal(acc.reshape(want.shape), want) and len(shapes) == 1


def test_gemm_wrapper_refuses_bad_inputs():
    x = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    w = torch.zeros((8, 32), dtype=torch.int8)
    int8_gemm.conv_valid_int8(x, w, 2)
    with pytest.raises(TypeError):
        int8_gemm.conv_valid_int8(x.float(), w, 2)
    with pytest.raises(ValueError):
        int8_gemm.conv_valid_int8(x, w, 1)


# ---------------------------------------------------- the pipeline, bundles
@pytest.fixture(scope="module")
def pipeline_tail(case):
    """Four seed-11 frame pairs; JAX's ``calibrate_pipeline_sp`` with the
    tail at the 99.9th percentile with the bf16 stem, and the port's."""
    frames, _, _ = generate_sequence(SyntheticSpec(num_frames=7, height=32, width=32,
                                                   seed=11))
    pairs = [(frames[t : t + 2], frames[t + 1 : t + 3]) for t in (0, 2, 4)]
    jq = jquant.calibrate_pipeline_sp(case["jp"], case["v"], pairs, percentile=99.9,
                                      quant_tail=True, bf16_stem=True)
    tq = quant.calibrate_pipeline_sp(case["pipe"], pairs, percentile=99.9, quant_tail=True,
                                     bf16_stem=True)
    return jq, tq, frames


def test_calibrate_pipeline_sp_with_tail_matches_jax(pipeline_tail):
    """Replaces the test that pinned ``quant_tail=True`` raising."""
    jq, tq, _ = pipeline_tail
    assert tq.tail is not None and tq.tail.num_blocks == 4
    for name in tail.tail_layer_names(narrow_config().sp):
        rel_close(float(tq.tail.act_scales[name]), float(jq.tail.act_scales[name]),
                  FLOW_SCALE_RTOL)
        d = np.abs(tq.tail.kernels[name].numpy().astype(np.int16)
                   - np.asarray(jq.tail.kernels[name]))
        assert d.max() <= 1 and (d != 0).mean() <= CODE_FLIP_SHARE, name


def test_pipeline_step_with_a_tail_matches_jax(case, pipeline_tail):
    jq, _, frames = pipeline_tail
    qsp = quant_io.quant_sp_from_numpy(np_tree(jq))
    jpipe = dataclasses.replace(case["jp"], quant_sp=jq)
    pipe = GazePipeline(port_config(case["cfg"]), device="cpu", quant_sp=qsp,
                        decoder_impl="halfres")   # the tail replaces any decoder
    pipe.load_state_dicts(torch_state_from_jax(case["v"]))
    prev, cur = frames[3:5], frames[4:6]
    fix = np.ones((2,), np.float32)
    _, want = jax.jit(jpipe.step)(case["v"], jpipe.init_state(2), jnp.asarray(prev),
                                  jnp.asarray(cur), jnp.asarray(fix))
    _, got = pipe.step(pipe.init_state(2), torch.from_numpy(prev), torch.from_numpy(cur),
                       torch.from_numpy(fix))
    for k in ("saliency", "heatmap"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=STEP_ATOL,
                                   err_msg=k)
    # the saliency is the int8 tail's, not the float decoder's
    with torch.inference_mode():
        rgb_in, flow_in = pipe.preprocess_pair(torch.from_numpy(prev), torch.from_numpy(cur))
        sal, feat = pipe.sp_forward(rgb_in, flow_in)
        f_t = quant.quant_vgg_forward(pipe.quant_sp.temporal, flow_in)
        np.testing.assert_array_equal(
            sal.numpy(), tail.quant_tail_forward(pipe.quant_sp.tail, feat, f_t).numpy())
    hm, ghm = got["heatmap"].numpy(), np.asarray(want["heatmap"])
    tie = max(NEAR_TIE, 2 * float(np.abs(hm - ghm).max()))
    for b, (gx, gy) in enumerate(got["gaze"].numpy().astype(int)):
        assert float(ghm[b].max() - ghm[b, gy, gx]) <= tie, b


def test_bundle_with_a_tail_both_ways(pipeline_tail, tmp_path):
    """A bundle with a tail written by JAX's ``save_quant_sp`` loads in the
    port array for array; the port writes it back key for key, and JAX
    reads the port's file as its own (its own bundle and the port's own
    calibration alike)."""
    jq, tq, _ = pipeline_tail
    jpath = str(tmp_path / "jax.npz")
    jquant_io.save_quant_sp(jpath, jq)
    back = quant_io.load_quant_sp(jpath)
    assert back.tail.num_blocks == jq.tail.num_blocks
    for field in ("kernels", "w_scales", "biases", "act_scales", "col_sums"):
        a, b = getattr(jq.tail, field), getattr(back.tail, field)
        assert list(a) == list(b)
        for k in a:
            assert b[k].numpy().dtype == np.asarray(a[k]).dtype
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]))
    tpath = str(tmp_path / "port.npz")
    quant_io.save_quant_sp(tpath, back)
    with np.load(jpath) as fa, np.load(tpath) as fb:
        assert list(fa.files) == list(fb.files)
        for k in fa.files:
            assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    own = str(tmp_path / "own.npz")
    quant_io.save_quant_sp(own, tq)
    jback = jquant_io.load_quant_sp(own)
    assert jback.tail.num_blocks == 4
    np.testing.assert_array_equal(np.asarray(jback.tail.kernels["up3"]),
                                  tq.tail.kernels["up3"].numpy())
    moved = back.to("cpu")
    assert moved.tail is not None and torch.equal(moved.tail.col_sums["out"],
                                                  back.tail.col_sums["out"])
    assert os.path.getsize(tpath) > 0
