"""The port's int8 SP streams against the JAX package on the CPU:
calibration (percentile and activation scales), the plain int8 conv
chain, the quantized VGG forward layer by layer, the committed quant
goldens, and the ``.npz`` bundle format.

Tolerances, with their reasons:

- percentile: equal to ``jnp.percentile`` jitted with a constant ``q``,
  as the JAX package's calibration runs it; ``percentile_linear``
  repeats the float32 arithmetic XLA compiles that into.
- activation scales: 1e-6 relative where both sides see the same inputs
  (the float32 convolutions sum in another order than XLA's: measured
  up to 6.3e-7 over three weight seeds). Through
  ``calibrate_pipeline_sp`` the temporal stream's inputs carry the TV-L1
  flow band of ``tests/test_torch_pipeline.py`` (XLA contracts the
  solver's multiply-adds into FMAs; the port rounds each), which moves
  its scales by up to 1.1e-4 relative: held to 5e-4 there.
- the plain int8 chain: bit for bit against ``_xla_reference`` of
  ``tests/test_pallas_conv_int8.py`` run op by op, as the JAX package
  computes its goldens.
- the forward: every layer's codes within 1 LSB of the JAX package's,
  with the share of flipped codes bounded. The int8 stem is exact; the
  bf16 stem's float32 accumulator sums in another order than XLA's, which
  can flip a code at a rounding boundary.
- goldens: their own 5e-3 (``tests/test_goldens.py``). With the JAX
  package's calibration carried across, the forward tests below find no
  flipped code. With the port's own calibration, whose scales
  differ from JAX's by up to 1e-6 relative (3e-4 in the temporal
  stream), codes flip at rounding boundaries: every key
  stays within 5e-3 but ``at_attention``, whose min-max normalization
  over the conv5 grid divides by the map's range (measured 1.3e-2 at 32²,
  9.4e-3 at 224²; held to 3e-2), and ``gaze_xy`` is equal or a near tie
  on the golden heatmap (measured: 12 px apart at 224², 2.2e-4 below
  the golden maximum, with heatmaps 1.2e-3 apart).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gaze_tpu.core.config import (
    ATConfig,
    ImageConfig,
    PipelineConfig,
    SPConfig,
    TVL1Config,
)
from gaze_tpu.data.synthetic import SyntheticSpec, generate_sequence
from gaze_tpu.evaluation.goldens import _golden_setup, load_goldens
from gaze_tpu.models import quant as jquant
from gaze_tpu.models import quant_io as jquant_io
from gaze_tpu.models.pipeline import GazePipeline as JGazePipeline
from gaze_tpu_torch.models import quant, quant_io
from gaze_tpu_torch.models.at import fixation_pool
from gaze_tpu_torch.models.pipeline import GazePipeline
from gaze_tpu_torch.models.quant_tail import QuantTail
from gaze_tpu_torch.models.weights import torch_state_from_jax
from gaze_tpu_torch.ops.conv_int8 import ConvTap, conv3x3_int8_plain, maxpool2x2_int8
from gaze_tpu_torch.ops.cuda.conv_int8 import conv3x3_int8
from gaze_tpu_torch.ops.heatmap import heatmap_argmax
from tests.test_pallas_conv_int8 import _make_layers, _xla_reference
from tests.test_torch_pipeline import port_config
from tests.torch_threads import cap_torch_threads  # noqa: F401  (autouse)

GOLDEN_TOL = 5e-3
SCALE_RTOL = 1e-6
FLOW_SCALE_RTOL = 5e-4
ATTENTION_BAND = 3e-2
NEAR_TIE = 1e-5
NARROW = ((8, 8), (8, 8), (16, 16, 16), (16, 16, 16), (32, 32, 32))


def narrow_config():
    return PipelineConfig(
        image=ImageConfig(height=32, width=32, heatmap_sigma=4.0),
        tvl1=TVL1Config(pyramid_levels=2, warps=2, iters=3),
        sp=SPConfig(stages=NARROW, fused_channels=32, decoder_channels=(16, 16, 8, 8)),
        at=ATConfig(feature_dim=32, hidden_size=32, feature_stride=16, roi_size=1),
    )


def np_tree(x):
    return jax.tree.map(np.asarray, x)


# ------------------------------------------------------------- percentile
@pytest.mark.parametrize("n", [1, 2, 3, 999, 12345, 200001])
def test_percentile_equals_jnp_percentile(n):
    x = np.abs(np.random.default_rng(n).normal(size=n)).astype(np.float32)
    for q in (99.9, 99.0, 50.0):
        want = np.asarray(jax.jit(lambda a: jnp.percentile(a.ravel(), q))(jnp.asarray(x)))
        got = quant.percentile_linear(torch.from_numpy(x), q).numpy()
        assert got == want, (n, q, got, want)


def test_percentile_above_2_pow_24():
    """Where ``torch.quantile`` refuses and float32 no longer holds n - 1
    exactly: held to a numpy replay of the same float32 arithmetic (one
    ``jnp.percentile`` of this size sorts for 10 s on a CPU; the formula
    is held to it at the sizes above)."""
    n = 2**24 + 77
    x = np.abs(np.random.default_rng(n).normal(size=n)).astype(np.float32)
    s = np.sort(x)
    f32 = np.float32
    pos = (f32(99.9) / f32(100)) * (f32(n) - f32(1))
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    w_hi = pos - np.floor(pos)
    want = f32(np.float64(s[lo]) * np.float64(f32(1) - w_hi) + np.float64(s[hi] * w_hi))
    assert float(pos) != 0.999 * (n - 1)  # the float32 position is not the exact one
    assert quant.percentile_linear(torch.from_numpy(x), 99.9).numpy() == want


@pytest.fixture(scope="module")
def narrow_calibration():
    """A narrow 32² pipeline on both sides with the same weights, and the
    JAX package's calibration on four seed-11 frame pairs."""
    cfg = narrow_config()
    jp = JGazePipeline(cfg)
    v = jax.jit(jp.init_variables)(jax.random.key(0))
    pipe = GazePipeline(port_config(cfg), device="cpu")
    pipe.load_state_dicts(torch_state_from_jax(np_tree(v)))
    frames, _, _ = generate_sequence(SyntheticSpec(num_frames=6, height=32, width=32, seed=11))
    pairs = [(frames[t : t + 2], frames[t + 1 : t + 3]) for t in (0, 2)]
    return jp, v, pipe, pairs, frames


def assert_scales_close(got, want, rtol):
    assert set(got) == set(want) == set(quant.LAYERS)
    for k in want:
        g, w = float(got[k]), float(np.asarray(want[k]))
        assert abs(g - w) <= rtol * w, (k, g, w)


def test_calibrate_sp_scales_match_jax(narrow_calibration):
    """The same preprocessed inputs (the JAX package's) on both sides."""
    jp, v, pipe, pairs, _ = narrow_calibration
    pre = jax.jit(jp.preprocess_pair)
    rgb, flow = zip(*(pre(jnp.asarray(a), jnp.asarray(b)) for a, b in pairs))
    want = jquant.calibrate_sp(v["sp"]["params"], [np.asarray(r) for r in rgb],
                               [np.asarray(f) for f in flow], percentile=99.9)
    got = quant.calibrate_sp(pipe.sp, [torch.from_numpy(np.array(r)) for r in rgb],
                             [torch.from_numpy(np.array(f)) for f in flow], percentile=99.9)
    assert_scales_close(got.spatial.act_scales, want.spatial.act_scales, SCALE_RTOL)
    assert_scales_close(got.temporal.act_scales, want.temporal.act_scales, SCALE_RTOL)


def test_calibrate_pipeline_sp_scales_match_jax(narrow_calibration):
    jp, v, pipe, pairs, _ = narrow_calibration
    want = jquant.calibrate_pipeline_sp(jp, v, pairs, percentile=99.9, bf16_stem=True)
    got = quant.calibrate_pipeline_sp(pipe, pairs, percentile=99.9, bf16_stem=True)
    assert_scales_close(got.spatial.act_scales, want.spatial.act_scales, SCALE_RTOL)
    assert_scales_close(got.temporal.act_scales, want.temporal.act_scales, FLOW_SCALE_RTOL)
    # the quantized weights are the JAX package's, bit for bit
    for name in quant.LAYERS:
        np.testing.assert_array_equal(got.spatial.kernels[name].numpy(),
                                      np.asarray(want.spatial.kernels[name]))
        np.testing.assert_array_equal(got.spatial.w_scales[name].numpy(),
                                      np.asarray(want.spatial.w_scales[name]))
        np.testing.assert_array_equal(got.temporal.col_sums[name].numpy(),
                                      np.asarray(want.temporal.col_sums[name]))
    np.testing.assert_array_equal(got.spatial.stem_kernel.float().numpy(),
                                  np.asarray(want.spatial.stem_kernel, np.float32))


# ------------------------------------------------------------ plain chain
def port_tap(t, pad_code=-128) -> ConvTap:
    """A JAX ``ConvTap`` (k9 (9, Ci, Co), a and c (1, Co)) as the port's."""
    k9 = np.asarray(t.k9)
    ci, co = k9.shape[1:]
    w = np.ascontiguousarray(k9.reshape(3, 3, ci, co).transpose(3, 0, 1, 2))
    return ConvTap(torch.from_numpy(w), torch.from_numpy(np.asarray(t.a)[0].copy()),
                   torch.from_numpy(np.asarray(t.c)[0].copy()), None, pad_code)


def plain_chain(x, layers, pad_code=-128):
    out = torch.from_numpy(x)
    for t in layers:
        out = conv3x3_int8_plain(out, port_tap(t, pad_code))
    return out.numpy()


@pytest.mark.parametrize("B,H,chans", [
    (2, 14, (128, 128)),           # the four cases of tests/test_pallas_conv_int8.py
    (2, 14, (128, 256, 128)),
    (4, 28, (128, 128)),
    (2, 13, (128, 128)),
    (2, 14, (64, 64)),             # Ci = 64: conv1_2, conv2_1
    (3, 9, (64, 96, 64)),          # ragged channels and grid
])
def test_plain_chain_matches_xla_reference_bitwise(B, H, chans):
    rng = np.random.default_rng(0)
    x = rng.integers(-128, 128, (B, H, H, chans[0]), dtype=np.int8)
    layers = _make_layers(rng, chans)
    want = np.asarray(_xla_reference(jnp.asarray(x), layers))
    np.testing.assert_array_equal(plain_chain(x, layers), want)
    # teeth: padding with code 0 (not real zero on the zp-128 grid) breaks it
    assert (plain_chain(x, layers, pad_code=0) != want).mean() > 0.01


def jax_dequant(x, k, zp_bias, sw, bias):
    """gaze_tpu/models/quant.py:309-312, the conv5_3 epilogue, op by op."""
    xp = jnp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)), constant_values=np.int8(-128))
    acc = jax.lax.conv_general_dilated(xp, k, (1, 1), "VALID",
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                       preferred_element_type=jnp.int32)
    xf = (acc.astype(jnp.float32) + zp_bias) * sw
    return jax.nn.relu(xf + bias)


@pytest.mark.parametrize("ci,co", [(64, 64), (128, 96)])
def test_plain_dequant_epilogue_matches_jax_bitwise(ci, co):
    rng = np.random.default_rng(1)
    x = rng.integers(-128, 128, (2, 14, 14, ci), dtype=np.int8)
    k = rng.integers(-127, 128, (3, 3, ci, co), dtype=np.int8)
    col = k.astype(np.float32).sum(axis=(0, 1, 2))
    zp_bias = np.float32(128) * col
    sw = (rng.uniform(1e-5, 1e-4, co)).astype(np.float32)
    bias = rng.normal(0, 1.0, co).astype(np.float32)
    want = np.asarray(jax_dequant(jnp.asarray(x), jnp.asarray(k), zp_bias, sw, bias))
    w = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 0, 1, 2)))
    tap = ConvTap(w, torch.from_numpy(sw), torch.from_numpy(zp_bias), torch.from_numpy(bias))
    got = conv3x3_int8(torch.from_numpy(x), tap)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).mean() > 0.2  # non-vacuous: the ReLU passes a share
    # teeth: dropping the zero-point bias breaks it
    no_zp = ConvTap(w, tap.a, torch.zeros_like(tap.c), tap.bias)
    assert np.abs(conv3x3_int8(torch.from_numpy(x), no_zp).numpy() - want).max() > 1.0


def test_int8_maxpool_is_exact():
    x = np.random.default_rng(2).integers(-128, 128, (2, 7, 9, 5), dtype=np.int8)
    from flax.linen import max_pool

    want = np.asarray(max_pool(jnp.asarray(x), (2, 2), strides=(2, 2)))
    np.testing.assert_array_equal(maxpool2x2_int8(torch.from_numpy(x)).numpy(), want)


# ---------------------------------------------------------------- forward
def jax_layer_codes(q, x):
    """Each layer's output of ``gaze_tpu/models/quant.py:quant_vgg_forward``
    (its XLA body, eager), before the pools; conv5_3 as float32."""
    from flax.linen import max_pool

    x = jnp.asarray(x, jnp.float32)
    codes = {}
    zp = 0
    if q.stem_kernel is None:
        xq = jnp.clip(jnp.round(x / q.act_scales["conv1_1"]), -127, 127).astype(jnp.int8)
    li = 0
    for s, stage in enumerate(jquant.VGG16_STAGES):
        for _ in stage:
            name = jquant._LAYERS[li]
            li += 1
            if li == 1 and q.stem_kernel is not None:
                acc = jax.lax.conv_general_dilated(
                    x.astype(jnp.bfloat16), q.stem_kernel, (1, 1), "SAME",
                    dimension_numbers=("NHWC", "HWIO", "NHWC"),
                    preferred_element_type=jnp.float32)
                sn = q.act_scales["conv1_2"]
                xq = jnp.clip(jnp.round(acc / sn + (q.stem_bias / sn - 128)), -128, 127
                              ).astype(jnp.int8)
                zp = 128
                codes[name] = xq
                continue
            xp = jnp.pad(xq, ((0, 0), (1, 1), (1, 1), (0, 0)), constant_values=np.int8(-zp))
            acc = jax.lax.conv_general_dilated(
                xp, q.kernels[name], (1, 1), "VALID",
                dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
            zp_bias = (zp * q.col_sums[name]) if zp else 0.0
            if li < len(jquant._LAYERS):
                sn = q.act_scales[jquant._LAYERS[li]]
                a = (q.act_scales[name] * q.w_scales[name]) / sn
                c = (q.biases[name] / sn - 128) + zp_bias * a
                xq = jnp.clip(jnp.round(acc.astype(jnp.float32) * a + c), -128, 127
                              ).astype(jnp.int8)
                zp = 128
                codes[name] = xq
            else:
                xf = (acc.astype(jnp.float32) + zp_bias) * (q.act_scales[name] * q.w_scales[name])
                codes[name] = jax.nn.relu(xf + q.biases[name])
        if s < len(jquant.VGG16_STAGES) - 1:
            xq = max_pool(xq, window_shape=(2, 2), strides=(2, 2))
    return {k: np.asarray(v) for k, v in codes.items()}


def port_layer_codes(q, x, taps):
    """The same of the port's ``quant_vgg_forward``, from its parts."""
    xt = torch.from_numpy(np.array(x, np.float32))
    codes = {}
    if q.stem_kernel is None:
        xq = torch.clamp(torch.round(xt / q.act_scales["conv1_1"]), -127, 127).to(torch.int8)
    else:
        xb = xt.to(torch.bfloat16).float().permute(0, 3, 1, 2)
        acc = torch.nn.functional.conv2d(xb, q.stem_kernel.float().permute(3, 2, 0, 1),
                                         padding=1).permute(0, 2, 3, 1)
        sn = q.act_scales["conv1_2"]
        xq = torch.clamp(torch.round(acc / sn + (q.stem_bias / sn - 128)), -128, 127
                         ).to(torch.int8)
        codes["conv1_1"] = xq.numpy()
    li = 0
    for s, stage in enumerate(quant.VGG16_STAGES):
        for _ in stage:
            name = quant.LAYERS[li]
            li += 1
            if name in taps:
                xq = conv3x3_int8(xq.contiguous(), taps[name])
                codes[name] = xq.numpy()
        if s < len(quant.VGG16_STAGES) - 1:
            xq = maxpool2x2_int8(xq)
    return codes


@pytest.fixture(scope="module", params=[False, True], ids=["int8_stem", "bf16_stem"])
def forward_setup(request, narrow_calibration):
    jp, v, _, pairs, frames = narrow_calibration
    jq = jquant.calibrate_pipeline_sp(jp, v, pairs, percentile=99.9, bf16_stem=request.param)
    rgb, flow = jax.jit(jp.preprocess_pair)(jnp.asarray(frames[3:5]), jnp.asarray(frames[4:6]))
    return jq, quant_io.quant_sp_from_numpy(np_tree(jq)), np.array(rgb), np.array(flow)


@pytest.mark.parametrize("stream", ["spatial", "temporal"])
def test_forward_codes_within_one_lsb_of_jax(forward_setup, stream):
    jq, tq, rgb, flow = forward_setup
    jv, tv = getattr(jq, stream), getattr(tq, stream)
    x = rgb if stream == "spatial" else flow
    want = jax_layer_codes(jv, x)
    # the mirror above is the JAX package's forward, bit for bit
    np.testing.assert_array_equal(want["conv5_3"], np.asarray(jquant.quant_vgg_forward(jv, x)))
    taps = quant.quant_taps(tv)
    got = port_layer_codes(tv, x, taps)
    assert set(got) == set(want)
    flipped = total = 0
    for name in quant.LAYERS[:-1]:
        d = np.abs(got[name].astype(np.int16) - want[name].astype(np.int16))
        assert d.max() <= 1, (name, int(d.max()))
        flipped += int((d != 0).sum())
        total += d.size
    # measured: 0 flipped codes for both stems and both streams at 32²
    assert flipped <= 1e-3 * total, (flipped, total)
    out = quant.quant_vgg_forward(tv, torch.from_numpy(x), taps=taps).numpy()
    np.testing.assert_array_equal(out, got["conv5_3"])
    lsb = float(np.max(np.asarray(jv.act_scales["conv5_3"]) * np.asarray(jv.w_scales["conv5_3"])))
    assert np.abs(out - want["conv5_3"]).max() <= 1.5 * lsb
    assert want["conv5_3"].std() > 0


def test_forward_has_teeth(forward_setup):
    """Dropping the zero-point bias or padding with code 0 must break
    the agreement by many LSB."""
    jq, tq, rgb, _ = forward_setup
    want = np.asarray(jquant.quant_vgg_forward(jq.spatial, rgb))
    lsb = float(np.max(np.asarray(jq.spatial.act_scales["conv5_3"])
                       * np.asarray(jq.spatial.w_scales["conv5_3"])))
    taps = quant.quant_taps(tq.spatial)
    x = torch.from_numpy(rgb)
    wrong_pad = {k: ConvTap(t.w, t.a, t.c, t.bias, 0) for k, t in taps.items()}
    no_zp = {}
    for k, t in taps.items():
        li = quant.LAYERS.index(k)
        if t.bias is not None:
            no_zp[k] = ConvTap(t.w, t.a, torch.zeros_like(t.c), t.bias, t.pad_code)
        elif li == 0:
            no_zp[k] = t
        else:
            sn = tq.spatial.act_scales[quant.LAYERS[li + 1]]
            no_zp[k] = ConvTap(t.w, t.a, tq.spatial.biases[k] / sn - 128, None, t.pad_code)
    for bad in (wrong_pad, no_zp):
        got = quant.quant_vgg_forward(tq.spatial, x, taps=bad).numpy()
        assert np.abs(got - want).max() > 10 * lsb


def test_forward_options():
    with pytest.raises(ValueError, match="conv_impl"):
        quant.quant_vgg_forward(None, torch.zeros(1, 4, 4, 3), conv_impl="cudnn")
    # a tail is carried, to the device too (the int8 tail is held against
    # JAX in test_torch_quant_tail.py)
    t = QuantTail({}, {}, {}, {}, {"out": torch.zeros(1)}, num_blocks=0)
    assert quant.QuantSP(None, None, tail=t).tail is t
    assert torch.equal(t.to("cpu").col_sums["out"], t.col_sums["out"])


# ---------------------------------------------------------------- goldens
@pytest.fixture(scope="module")
def golden_weights():
    """``GazePipeline(cfg).init_variables(jax.random.key(0))``, the
    goldens' parameters (they do not depend on the image size), as JAX
    variables and as the port's state dicts."""
    cfg, _ = _golden_setup("tiny")
    v = jax.jit(JGazePipeline(cfg).init_variables)(jax.random.key(0))
    return v, torch_state_from_jax(np_tree(v))


def quant_golden_step(size, sd, qsp=None):
    """``gaze_tpu/evaluation/goldens.py:quant_golden_bundle`` on the port:
    the parity config and weights, the int8 streams calibrated on the
    seed-11 pairs at the 99.9th percentile with the bf16 stem (by the
    port unless ``qsp`` is given), the float32 tail, one step on the
    seed-7 frames. Returns (the port's bundle, the committed one)."""
    cfg, batch = _golden_setup(size)
    pcfg = port_config(cfg)
    if qsp is None:
        f32 = GazePipeline(pcfg, device="cpu")
        f32.load_state_dicts(sd)
        qsp = quant.calibrate_pipeline_sp(f32, golden_calibration_pairs(size),
                                          percentile=99.9, bf16_stem=True)
    pipe = GazePipeline(pcfg, device="cpu", quant_sp=qsp)
    pipe.load_state_dicts(sd)
    frames, _, _ = generate_sequence(SyntheticSpec(
        num_frames=batch + 1, height=cfg.image.height, width=cfg.image.width, seed=7))
    prev = torch.from_numpy(frames[:batch])
    cur = torch.from_numpy(frames[1 : batch + 1])
    with torch.inference_mode():
        rgb_in, flow_in = pipe.preprocess_pair(prev, cur)
        sal, feat = pipe.sp_forward(rgb_in, flow_in)
        w = fixation_pool(feat, heatmap_argmax(sal), pcfg.at)
        _, out = pipe.step(pipe.init_state(batch), prev, cur, torch.ones(batch))
    got = {
        "rgb_in": rgb_in, "flow_in": flow_in, "sp_saliency": out["saliency"],
        "sp_conv5": feat, "at_weights": w, "at_attention": out["attention"],
        "lf_heatmap": out["heatmap"], "gaze_xy": out["gaze"],
    }
    golden = load_goldens(os.path.join(os.path.dirname(__file__), "goldens",
                                       f"quant_{size}.npz"))
    assert set(got) == set(golden)
    got = {k: v.float().numpy() for k, v in got.items()}
    for k, g in golden.items():
        assert got[k].shape == g.shape, k
    return got, golden


def golden_calibration_pairs(size):
    cfg, batch = _golden_setup(size)
    calib, _, _ = generate_sequence(SyntheticSpec(
        num_frames=2 * batch + 1, height=cfg.image.height, width=cfg.image.width, seed=11))
    return [(calib[i : i + batch], calib[i + 1 : i + 1 + batch]) for i in (0, batch)]


@pytest.mark.parametrize("size", ["tiny", "full"])
def test_step_reproduces_quant_goldens(size, golden_weights):
    """The port's own calibration; bands in the module docstring."""
    got, golden = quant_golden_step(size, golden_weights[1])
    for k, g in golden.items():
        if k == "gaze_xy":
            continue
        tol = ATTENTION_BAND if k == "at_attention" else GOLDEN_TOL
        np.testing.assert_allclose(got[k], g, atol=tol, rtol=tol, err_msg=k)
    hm, ghm = got["lf_heatmap"], golden["lf_heatmap"]
    tie = max(NEAR_TIE, 2 * float(np.abs(hm - ghm).max()))
    for b, (gx, gy) in enumerate(got["gaze_xy"].astype(int)):
        gap = float(ghm[b].max() - ghm[b, gy, gx])
        assert gap <= tie, (b, got["gaze_xy"][b], golden["gaze_xy"][b], gap, tie)


# -------------------------------------------------------------- bundle io
def test_jax_bundle_round_trip(forward_setup, tmp_path):
    jq = forward_setup[0]
    stem = jq.spatial.stem_kernel is not None
    jpath = str(tmp_path / "jax.npz")
    jquant_io.save_quant_sp(jpath, jq)
    tq = quant_io.load_quant_sp(jpath)
    for stream in ("spatial", "temporal"):
        a, b = getattr(jq, stream), getattr(tq, stream)
        for field in ("kernels", "w_scales", "biases", "act_scales", "col_sums"):
            fa, fb = getattr(a, field), getattr(b, field)
            assert set(fa) == set(fb)
            for k in fa:
                assert fb[k].numpy().dtype == np.asarray(fa[k]).dtype
                np.testing.assert_array_equal(fb[k].numpy(), np.asarray(fa[k]))
        if stem:
            assert b.stem_kernel.dtype == torch.bfloat16
            np.testing.assert_array_equal(b.stem_kernel.float().numpy(),
                                          np.asarray(a.stem_kernel, np.float32))
            np.testing.assert_array_equal(b.stem_bias.numpy(), np.asarray(a.stem_bias))
        else:
            assert b.stem_kernel is None and b.stem_bias is None
    # saved back by the port: the same file content, key by key
    tpath = str(tmp_path / "port.npz")
    quant_io.save_quant_sp(tpath, tq)
    with np.load(jpath) as fa, np.load(tpath) as fb:
        assert sorted(fa.files) == sorted(fb.files)
        for k in fa.files:
            assert fa[k].dtype == fb[k].dtype, k
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    # and the JAX package reads the port's file as its own
    back = jquant_io.load_quant_sp(tpath)
    np.testing.assert_array_equal(np.asarray(back.temporal.kernels["conv3_2"]),
                                  np.asarray(jq.temporal.kernels["conv3_2"]))


def test_bundle_suffix_and_tail(narrow_calibration, tmp_path):
    """A bare path saves to ``<path>.npz`` and loads from it (the JAX
    package's load reads the bare path and fails: not copied); a bundle
    with an int8 tail loads with it (both ways against the JAX package in
    test_torch_quant_tail.py)."""
    _, _, pipe, pairs, _ = narrow_calibration
    tq = quant.calibrate_pipeline_sp(pipe, pairs[:1], quant_tail=True)
    bare = str(tmp_path / "bundle")
    quant_io.save_quant_sp(bare, tq)
    assert os.path.exists(bare + ".npz") and not os.path.exists(bare)
    back = quant_io.load_quant_sp(bare)
    assert torch.equal(back.spatial.kernels["conv2_1"], tq.spatial.kernels["conv2_1"])
    with pytest.raises(FileNotFoundError):
        jquant_io.load_quant_sp(bare)
    assert back.tail.num_blocks == tq.tail.num_blocks == 4
    for field in ("kernels", "w_scales", "biases", "act_scales", "col_sums"):
        for k, v in getattr(tq.tail, field).items():
            assert torch.equal(getattr(back.tail, field)[k], v), (field, k)
