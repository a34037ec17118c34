"""The port's SP / AT / LF modules against the JAX modules on the CPU,
through the weight bridge (gaze_tpu_torch.models.weights).

The model is narrow (VGG stages of 8-32 channels in the 2,2,3,3,3
layout, conv5 width = ATConfig.feature_dim) so the JAX side compiles
quickly; every layer and convention of the full-width model is still
crossed. Biases and BatchNorm statistics are randomized (flax initialises
them to 0 and 1, which would hide a wrong mapping). Tolerances: float32
convolutions summed in another order, 1e-5 relative.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from gaze_tpu.core import config as jconfig
from gaze_tpu.models import at as jat
from gaze_tpu.models.lf import LateFusion as JLateFusion
from gaze_tpu.models.pipeline import GazePipeline as JGazePipeline
from gaze_tpu.models.sp import SPNet as JSPNet
from gaze_tpu.models.weights_export import export_pipeline_to_torch
from gaze_tpu_torch.core import config as tconfig
from gaze_tpu_torch.models import at as tat
from gaze_tpu_torch.models import vgg as tvgg
from gaze_tpu_torch.models.lf import LateFusion
from gaze_tpu_torch.models.pipeline import GazePipeline
from gaze_tpu_torch.models.sp import SPNet
from gaze_tpu_torch.models.vgg import VGG16Features
from gaze_tpu_torch.models.weights import (
    at_to_torch_state,
    lf_to_torch_state,
    load_state,
    sp_to_torch_state,
    torch_state_from_jax,
)
from gaze_tpu_torch.utils import profiling
from tests.torch_threads import cap_torch_threads  # noqa: F401  (autouse)

NARROW = dict(
    image=dict(height=64, width=64, heatmap_sigma=8.0),
    tvl1=dict(pyramid_levels=2, warps=2, iters=5),
    sp=dict(
        stages=((8, 8), (16, 16), (16, 16, 16), (32, 32, 32), (32, 32, 32)),
        fused_channels=32,
        decoder_channels=(32, 16, 8, 8),
    ),
    at=dict(feature_dim=32, hidden_size=24),
    lf=dict(channels=(8, 8, 4)),
)


def make_configs(**over):
    """The same narrow config built from both packages' dataclasses."""
    kw = {k: dict(v, **over.get(k, {})) for k, v in NARROW.items()}

    def build(mod):
        return mod.PipelineConfig(
            image=mod.ImageConfig(**kw["image"]),
            tvl1=mod.TVL1Config(**kw["tvl1"]),
            sp=mod.SPConfig(**kw["sp"]),
            at=mod.ATConfig(**kw["at"]),
            lf=mod.LFConfig(**kw["lf"]),
        )

    return build(jconfig), build(tconfig)


def randomize(tree, seed):
    """Random biases / BN scales and statistics; kernels kept."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("bias", "mean"):
                out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
            elif k in ("scale", "var"):
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                out[k] = np.array(v)
        return out

    return walk(tree)


def jax_variables(jcfg, seed=0):
    """JAX pipeline variables (jit-compiled init) as numpy, randomized."""
    v = jax.jit(JGazePipeline(jcfg).init_variables)(jax.random.key(0))
    return randomize(jax.tree.map(np.asarray, v), seed)


def t(x):
    return torch.from_numpy(np.array(x))


def close(actual, expected, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(
        np.asarray(actual.detach() if torch.is_tensor(actual) else actual),
        np.asarray(expected), atol=atol, rtol=rtol,
    )


@pytest.fixture(scope="module")
def narrow():
    jcfg, tcfg = make_configs()
    return jcfg, tcfg, jax_variables(jcfg)


def sp_inputs(cfg, B=2, seed=0):
    rng = np.random.default_rng(seed)
    h, w = cfg.image.height, cfg.image.width
    rgb = rng.normal(0, 1, (B, h, w, 3)).astype(np.float32)
    flow = rng.normal(0, 1, (B, h, w, cfg.sp.flow_channels)).astype(np.float32)
    return rgb, flow


class TestSP:
    def test_vgg_stream(self, narrow):
        jcfg, tcfg, v = narrow
        rgb, _ = sp_inputs(tcfg)
        vgg = VGG16Features(3, tcfg.sp.stages)
        load_state(vgg, {k[len("spatial."):]: t(a) for k, a in
                         sp_to_torch_state(v["sp"]).items() if k.startswith("spatial.")})
        expect, _ = JSPNet(jcfg.sp).apply(
            v["sp"], jnp.asarray(rgb), jnp.zeros(rgb.shape[:3] + (2,)), method=JSPNet.encode)
        with torch.no_grad():
            close(vgg(t(rgb)), expect)

    def test_spnet_forward_encode_fuse_decode(self, narrow):
        jcfg, tcfg, v = narrow
        rgb, flow = sp_inputs(tcfg)
        sp = SPNet(tcfg.sp).eval()
        load_state(sp, {k: t(a) for k, a in sp_to_torch_state(v["sp"]).items()})
        j_sal, j_feat = JSPNet(jcfg.sp).apply(v["sp"], jnp.asarray(rgb), jnp.asarray(flow))
        with torch.no_grad():
            sal, feat = sp(t(rgb), t(flow))
            fs, ft = sp.encode(t(rgb), t(flow))
            sal2 = sp.fuse_decode(fs, ft)
        assert sal.shape == (2, 64, 64) and feat.shape == (2, 4, 4, 32)
        close(sal, j_sal)
        close(feat, j_feat)
        close(sal2, sal, atol=0, rtol=0)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
    def test_vgg_nhwc_route(self, narrow, dtype, monkeypatch):
        """The streams' channels_last route, taken on the card in bf16 and
        fp16 alone, forced on the CPU through the module's route test,
        each layer one ``_ConvBiasReLU`` there with the plain ops standing
        in for cuDNN's fused convolution: against the NCHW route, the same
        features (float32 within 1e-6 of the largest, bf16 within one ulp
        of the larger of each pair) as contiguous NHWC tensors, the same
        weight gradients within 1e-5, and ``sp.nhwc_streams`` counted once
        a stream."""
        _, tcfg, v = narrow
        cuda, cpu = torch.device("cuda"), torch.device("cpu")
        assert tvgg._nhwc_route(cuda, dtype) == (dtype == torch.bfloat16)
        assert tvgg._nhwc_route(cuda, torch.float16)
        assert not tvgg._nhwc_route(cpu, dtype) and not tvgg._nhwc_route(cpu, torch.float16)
        sp = SPNet(tcfg.sp, dtype)
        load_state(sp, {k: t(a) for k, a in sp_to_torch_state(v["sp"]).items()})
        rgb, flow = (t(a) for a in sp_inputs(tcfg))
        params = list(sp.spatial.parameters()) + list(sp.temporal.parameters())

        def run():
            with profiling.recording() as rec:
                feats = sp.encode(rgb, flow)
            loss = sum(f.float().square().sum() for f in feats)
            return feats, torch.autograd.grad(loss, params), rec.counters

        want, want_grads, counters = run()
        assert counters == {}
        monkeypatch.setattr(tvgg, "_nhwc_route", lambda device, dtype: True)
        monkeypatch.setattr(tvgg, "_fused_conv_relu", plain_conv_relu)
        got, grads, counters = run()
        assert counters == {"sp.nhwc_streams": 2}
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == dtype and g.shape == w.shape and g.is_contiguous()
            big = torch.maximum(g.float().abs(), w.float().abs())
            if dtype == torch.float32:
                tol = 1e-6 * big.max()
            else:   # bf16 keeps 8 significant bits: an ulp is 2^(e - 8) on [2^(e-1), 2^e)
                tol = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
            assert bool(((g.float() - w.float()).abs() <= tol).all())
        for g, w in zip(grads, want_grads):
            assert float((g - w).norm()) <= 1e-5 * float(w.norm())

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
    @pytest.mark.parametrize("case", ["conv1_1", "conv1_2", "checkpoint"])
    def test_conv_bias_relu(self, dtype, case, monkeypatch):
        """``conv_bias_relu`` off the NHWC route is the plain ops; on it
        (forced on the CPU, the plain ops standing in for cuDNN's fused
        convolution, which ``chip_smoke.py``'s vgg_fused_b128 holds to
        them on the card) one ``_ConvBiasReLU``, whose backward is under
        test: on a channels_last input as the route gives it, the input,
        weight and bias gradients within 1e-5 of the norm of autograd's
        through the plain ops; at conv1_1's width (3 input channels), at
        conv1_2's, and under ``checkpoint(use_reentrant=False)``
        (``remat="encoders"``)."""
        ci, co = (3, 8) if case == "conv1_1" else (8, 8)
        torch.manual_seed(0)
        m = nn.Conv2d(ci, co, 3, padding=1)
        x = torch.randn(2, ci, 12, 12).to(dtype).contiguous(memory_format=torch.channels_last)
        x.requires_grad_()
        gy = torch.randn(2, co, 12, 12).to(dtype)
        leaves = (x, m.weight, m.bias)
        assert type(tvgg.conv_bias_relu(m, x).grad_fn).__name__ == "ReluBackward0"
        monkeypatch.setattr(tvgg, "_nhwc_route", lambda device, dtype: True)
        monkeypatch.setattr(tvgg, "_fused_conv_relu", plain_conv_relu)

        def fused(x):
            if case == "checkpoint":
                return checkpoint(tvgg.conv_bias_relu, m, x, use_reentrant=False)
            return tvgg.conv_bias_relu(m, x)

        want = F.relu(F.conv2d(x, m.weight.to(dtype), m.bias.to(dtype), 1, 1))
        want_grads = torch.autograd.grad(want, leaves, gy)
        got = fused(x)
        assert "ConvBiasReLU" in type(got.grad_fn).__name__
        grads = torch.autograd.grad(got, leaves, gy)
        assert got.dtype == dtype and torch.equal(got, want)
        for g, w in zip(grads, want_grads):
            assert g.dtype == w.dtype
            assert float((g - w).float().norm()) <= 1e-5 * float(w.float().norm())


def plain_conv_relu(x, w, b, stride, padding, dilation, groups):
    """The plain ops in the place of ``aten.cudnn_convolution_relu``, which
    only the card has."""
    return F.relu(F.conv2d(x, w, b, stride, padding, dilation, groups))


class TestAT:
    @pytest.mark.parametrize("roi", [1, 3, 5])
    def test_fixation_pool(self, roi):
        """Cell index by round-half-even (8/16 -> 0, 24/16 -> 2,
        40/16 -> 2), the window clamped inside the grid, the ROI clamped
        to the grid (5 > 4)."""
        rng = np.random.default_rng(1)
        feat = rng.normal(size=(6, 4, 4, 7)).astype(np.float32)
        pts = np.array([[8, 24], [24, 40], [40, 8], [0, 63], [63, 0], [31.9, 16.1]],
                       np.float32)
        jc = jconfig.ATConfig(roi_size=roi, feature_stride=16)
        tc = tconfig.ATConfig(roi_size=roi, feature_stride=16)
        close(tat.fixation_pool(t(feat), t(pts), tc),
              jat.fixation_pool(jnp.asarray(feat), jnp.asarray(pts), jc), atol=1e-6)

    def test_lstm_steps(self, narrow):
        """Three steps from zero carries: (c, h) carry order, i,f,g,o
        gate packing, zero bias_ih with the flax biases in bias_hh."""
        jcfg, tcfg, v = narrow
        lstm = tat.LSTMNet(tcfg.at)
        load_state(lstm, {k: t(a) for k, a in at_to_torch_state(v["at"]).items()})
        jl = jat.LSTMNet(jcfg.at)
        rng = np.random.default_rng(2)
        jc, tc = jl.init_carry(3), lstm.init_carry(3)
        for _ in range(3):
            w = rng.uniform(0, 1, (3, tcfg.at.feature_dim)).astype(np.float32)
            jc, jp = jl.apply(v["at"], jc, jnp.asarray(w), method=jat.LSTMNet.step)
            with torch.no_grad():
                tc, tp = lstm.step(tc, t(w))
            close(tp, jp)
            for (c, h), (c2, h2) in zip(tc, jc):
                close(c, c2)
                close(h, h2)

    def test_attention_map(self):
        rng = np.random.default_rng(3)
        feat = np.maximum(rng.normal(size=(2, 4, 4, 9)), 0).astype(np.float32)
        w = rng.uniform(0, 1, (2, 9)).astype(np.float32)
        close(tat.attention_map(t(feat), t(w), (64, 64)),
              jat.attention_map(jnp.asarray(feat), jnp.asarray(w), (64, 64)), atol=1e-6)


class TestLF:
    @pytest.mark.parametrize("padding,residual", [
        ("zero", False), ("edge", False), ("zero", True), ("edge", True)])
    def test_late_fusion(self, padding, residual):
        jc = jconfig.LFConfig(channels=(8, 4), padding=padding, residual=residual)
        tc = tconfig.LFConfig(channels=(8, 4), padding=padding, residual=residual)
        rng = np.random.default_rng(4)
        maps = rng.uniform(0, 1, (2, 16, 20, 2)).astype(np.float32)
        jv = jax.jit(JLateFusion(jc).init)(jax.random.key(1), jnp.asarray(maps))
        jv = jax.tree.map(np.asarray, jv)
        # random kernels too: the residual head's out_conv starts at zero
        jv = jax.tree.map(lambda a: rng.normal(0, 0.3, a.shape).astype(np.float32), jv)
        lf = LateFusion(tc)
        load_state(lf, {k: t(a) for k, a in lf_to_torch_state(jv).items()})
        with torch.no_grad():
            close(lf(t(maps)), JLateFusion(jc).apply(jv, jnp.asarray(maps)))

    def test_unknown_padding(self):
        with pytest.raises(ValueError):
            LateFusion(tconfig.LFConfig(padding="reflect"))


class TestWeights:
    def test_export_file_loads_as_is(self, narrow, tmp_path):
        """A file written by gaze_tpu's export_pipeline_to_torch loads
        into the port with the same result as the in-memory bridge."""
        jcfg, tcfg, v = narrow
        path = str(tmp_path / "bundle.pt")
        export_pipeline_to_torch(v, path)
        a = GazePipeline(tcfg, device="cpu")
        a.load_state_dicts(torch.load(path))
        b = GazePipeline(tcfg, device="cpu", seed=1)
        b.load_state_dicts(torch_state_from_jax(v))
        for name, m in a.modules().items():
            sb = b.modules()[name].state_dict()
            for k, x in m.state_dict().items():
                assert torch.equal(x, sb[k]), (name, k)

    def test_missing_or_extra_keys_raise(self, narrow):
        _, tcfg, v = narrow
        state = {k: t(a) for k, a in lf_to_torch_state(v["lf"]).items()}
        lf = LateFusion(tcfg.lf)
        with pytest.raises(KeyError):
            load_state(lf, {k: x for k, x in state.items() if k != "conv1.bias"})
        with pytest.raises(KeyError):
            load_state(lf, dict(state, extra=torch.zeros(1)))

    def test_seeded_init_is_reproducible(self):
        _, tcfg = make_configs()
        a, b = GazePipeline(tcfg, device="cpu", seed=3), GazePipeline(tcfg, device="cpu", seed=3)
        c = GazePipeline(tcfg, device="cpu", seed=4)
        sa, sb, sc = a.state_dicts()["sp"], b.state_dicts()["sp"], c.state_dicts()["sp"]
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
        assert not torch.equal(sa["spatial.conv1_1.weight"], sc["spatial.conv1_1.weight"])

