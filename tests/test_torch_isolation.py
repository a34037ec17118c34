"""The port stands alone and never hides the device or its kernels.

- No module of gaze_tpu_torch, and not chip_smoke.py, imports jax, flax,
  optax, orbax or gaze_tpu, or loads anything from ``native/`` (the JPEG
  decoder is built from the port's own ``csrc/gaze_io.cpp``); a fresh
  interpreter that runs a CPU step, the serving surface, the three
  training stages and the GTEA data layer has none of them loaded.
- Entry points (the command line's ``main`` among them) default to CUDA
  and raise without it.
- On CPU tensors the kernel wrappers take their plain versions and the
  launch counters stay at 0; bad inputs are refused.
- The port's config copy (training's included) has the JAX
  dataclasses' defaults, field by field, and its presets are the JAX
  package's (``production_config``,
  ``production_fast_config``, ``bench.PRESETS``).
"""

import ast
import dataclasses
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from gaze_tpu.core import config as jconfig
from gaze_tpu_torch.core import config as tconfig
from gaze_tpu_torch import cli
from gaze_tpu_torch.data import native_io
from gaze_tpu_torch.data.flow_extract import FlowExtractSpec, extract_flow_images
from gaze_tpu_torch.data.prefetch import device_prefetch
from gaze_tpu_torch.evaluation.rollout import make_rollout_chunk_fn
from gaze_tpu_torch.models.pipeline import GazePipeline, run_clip
from gaze_tpu_torch.ops import cuda
from gaze_tpu_torch.ops.conv_int8 import ConvTap, conv3x3_int8_plain
from gaze_tpu_torch.ops.cuda.conv_int8 import conv3x3_int8
from gaze_tpu_torch.ops.cuda.tvl1_pd import pd_iterations, pd_iterations_plain
from gaze_tpu_torch.ops.cuda.warp import warp3
from gaze_tpu_torch.ops.tvl1 import tvl1_flow
from gaze_tpu_torch.ops.warp import warp3_plain
from gaze_tpu_torch.serve import StreamServer
from gaze_tpu_torch.utils.profiling import device_time
from tests.torch_threads import cap_torch_threads  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "gaze_tpu")


def port_sources():
    return sorted((ROOT / "gaze_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_module_imports_jax_or_the_jax_package():
    sources = port_sources()
    assert len(sources) > 10 and all(p.exists() for p in sources)
    names = {str(p.relative_to(ROOT / "gaze_tpu_torch")) for p in sources[:-1]}
    assert {"train/common.py", "train/sp.py", "train/at.py", "train/lf.py", "train/stages.py",
            "core/checkpoint.py", "data/augment.py", "data/prefetch.py",
            "utils/logging.py", "data/video.py", "data/native_io.py", "data/gtea.py",
            "data/flow_extract.py", "models/quant_tail.py", "models/qat.py", "train/qat.py",
            "ops/int8_gemm.py", "parallel/mesh.py", "parallel/__init__.py",
            "core/distributed.py", "cli/__init__.py", "cli/__main__.py", "cli/args.py",
            "cli/quant.py", "cli/evaluate.py", "cli/extract.py", "cli/infer.py",
            "utils/tboard.py", "utils/viz.py", "utils/profiling.py", "models/weights_io.py",
            "models/weights_export.py", "evaluation/goldens.py"} <= names
    bad = {str(p.relative_to(ROOT)): sorted(imported_roots(p) & set(FORBIDDEN))
           for p in sources}
    assert not {k: v for k, v in bad.items() if v}
    # nothing is read from, or built into, the JAX package's native/
    assert not [str(p) for p in sources
                if "libgaze_io" in p.read_text() or "native/" in p.read_text()]
    assert native_io.SOURCE == ROOT / "gaze_tpu_torch" / "csrc" / "gaze_io.cpp"
    assert native_io.BUILD_DIR == ROOT / "gaze_tpu_torch" / "_build"


def test_fresh_interpreter_runs_a_cpu_step_without_jax():
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        torch.set_num_threads(2)   # as tests/torch_threads.py caps the test workers
        import gaze_tpu_torch
        import gaze_tpu_torch.cli   # the command line and every module it drives
        from gaze_tpu_torch.core.config import (
            ATConfig, ImageConfig, LFConfig, PipelineConfig, SPConfig, TVL1Config)
        cfg = PipelineConfig(
            image=ImageConfig(height=32, width=32),
            tvl1=TVL1Config(pyramid_levels=2, warps=1, iters=2),
            sp=SPConfig(stages=((4, 4), (4, 4), (4, 4, 4), (8, 8, 8), (8, 8, 8)),
                        fused_channels=8, decoder_channels=(8, 4, 4, 4)),
            at=ATConfig(feature_dim=8, hidden_size=8, roi_size=1),
            lf=LFConfig(channels=(4,)),
        )
        pipe = gaze_tpu_torch.GazePipeline(cfg, device="cpu")
        frames = np.random.default_rng(0).integers(0, 256, (1, 3, 32, 32, 3), np.uint8)
        hm, gaze = gaze_tpu_torch.run_clip(pipe, frames, np.ones((1, 3), np.float32))
        assert hm.shape == (1, 2, 32, 32) and gaze.shape == (1, 2, 2)
        # the turbo path: bf16, half-grid flow, int8 streams
        import torch
        from gaze_tpu_torch.core.config import preset_config
        from gaze_tpu_torch.models.quant import calibrate_pipeline_sp
        cfg = preset_config("turbo", cfg)
        pipe = gaze_tpu_torch.GazePipeline(cfg, dtype=torch.bfloat16, device="cpu")
        qsp = calibrate_pipeline_sp(pipe, [(frames[:, 0], frames[:, 1])], percentile=99.9,
                                    bf16_stem=True)
        pipe = gaze_tpu_torch.GazePipeline(cfg, dtype=torch.bfloat16, device="cpu", quant_sp=qsp)
        hm, gaze = gaze_tpu_torch.run_clip(pipe, frames, np.ones((1, 3), np.float32))
        assert hm.shape == (1, 2, 32, 32) and bool(torch.isfinite(hm).all())
        # the int8 fuse/decoder tail on top of the int8 streams
        qtail = gaze_tpu_torch.calibrate_pipeline_sp(pipe, [(frames[:, 0], frames[:, 1])],
                                                     quant_tail=True)
        tailed = gaze_tpu_torch.GazePipeline(cfg, dtype=torch.bfloat16, device="cpu",
                                             quant_sp=qtail)
        hm, _ = gaze_tpu_torch.run_clip(tailed, frames, np.ones((1, 3), np.float32))
        assert isinstance(qtail.tail, gaze_tpu_torch.QuantTail)
        assert bool(torch.isfinite(hm).all())
        # the serving and evaluation surface: two server ticks, a rollout
        srv = gaze_tpu_torch.StreamServer(cfg, pipe.state_dicts(), 2, dtype=torch.bfloat16,
                                          quant_sp=qsp, device="cpu")
        srv.attach(0)
        srv.tick(frames[0, :2])
        out = srv.tick(frames[0, 1:3])
        assert (out["gaze"][0] >= 0).all() and (out["gaze"][1] == -1).all()
        s = gaze_tpu_torch.rollout_eval_arrays(pipe, frames, np.zeros((1, 3, 2), np.float32),
                                               np.ones((1, 3), np.float32), chunk_len=2)
        assert s[2].tolist() == [2.0] and np.isfinite(s[0]).all()
        # the trainer: SP -> QAT -> AT -> LF, one step each, checkpoints and all
        import os
        import tempfile
        from gaze_tpu_torch.train import stages
        cfg = PipelineConfig(
            image=ImageConfig(height=32, width=32),
            tvl1=TVL1Config(pyramid_levels=2, warps=1, iters=2),
            sp=SPConfig(stages=((4, 4), (4, 4), (4, 4, 4), (8, 8, 8), (8, 8, 8)),
                        fused_channels=8, decoder_channels=(8, 4, 4, 4)),
            at=ATConfig(feature_dim=8, hidden_size=8, roi_size=1),
            lf=LFConfig(channels=(4,)),
        )
        pipe = gaze_tpu_torch.GazePipeline(cfg, device="cpu")
        with tempfile.TemporaryDirectory() as d:
            opts = stages.StageOptions(batch_size=2, steps_per_epoch=1, save_dir=d)
            sp = stages.run_train_qat(opts, pipe, stages.run_train_sp(opts, pipe))
            assert os.path.exists(os.path.join(d, "sp_qat", "qat_act_scales.npz"))
            lf = stages.run_train_late(opts, pipe, sp, stages.run_train_lstm(opts, pipe, sp))
        assert lf.step == 1
        # the GTEA data layer: frames written with PIL, the manifest, flow
        # images on the CPU, a rollout over the tree
        from PIL import Image
        from gaze_tpu_torch.data.flow_extract import FlowExtractSpec
        with tempfile.TemporaryDirectory() as d:
            os.makedirs(os.path.join(d, "images", "Ann_Tea"))
            for i in range(3):
                Image.fromarray(frames[0, i]).save(os.path.join(d, "images", "Ann_Tea",
                                                                f"{i:06d}.jpg"))
            spec = FlowExtractSpec(tvl1=cfg.tvl1, bound=15.0, batch_size=2)
            assert gaze_tpu_torch.extract_flow_images(d, spec, verbose=False, device="cpu") == 2
            m = gaze_tpu_torch.build_manifest(d)
            r = gaze_tpu_torch.rollout_eval_videos(pipe, m.frames, chunk_len=2,
                                                   use_precomputed_flow=True)
            assert r["Ann_Tea"][2] == 0   # no gaze txt: every frame untracked
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                               "gaze_tpu"))
        print("LOADED", loaded)
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "LOADED []" in r.stdout, r.stdout


def tiny_config():
    return tconfig.PipelineConfig(
        image=tconfig.ImageConfig(height=32, width=32),
        sp=tconfig.SPConfig(stages=((4, 4), (4, 4), (4, 4, 4), (8, 8, 8), (8, 8, 8)),
                            fused_channels=8, decoder_channels=(8, 4, 4, 4)),
        at=tconfig.ATConfig(feature_dim=8, hidden_size=8, roi_size=1),
    )


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GazePipeline(tiny_config())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GazePipeline(tiny_config(), device="cuda")
    z = torch.zeros(1, 20, 20)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tvl1_flow(z, z)
    pipe = GazePipeline(tiny_config(), device="cpu")
    assert pipe.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamServer(tiny_config(), pipe.state_dicts(), 2)
    frames = np.zeros((1, 2, 32, 32, 3), np.uint8)
    hm, _ = run_clip(pipe, frames, np.ones((1, 2), np.float32))
    assert hm.device.type == "cpu"
    # the trainer: its prefetcher defaults to the card too; its stages run
    # where their pipeline runs
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(device_prefetch(iter([{"x": np.zeros(1)}])))
    # the data layer: flow extraction runs on the card unless asked not to
    spec = FlowExtractSpec(tvl1=tconfig.TVL1Config(), bound=15.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        extract_flow_images("/nonexistent", spec)
    assert next(device_prefetch(iter([{"x": np.zeros(1)}]), "cpu"))["x"].device.type == "cpu"
    # the command line: its stages run on the card unless main is asked not to
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--export_torch", "/nonexistent/b.pt", "--save_dir", "/nonexistent"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_time(lambda: None)


def test_unknown_options_and_flow_img_raise():
    with pytest.raises(ValueError):
        GazePipeline(tiny_config(), device="cpu", at_pool="nearest")
    with pytest.raises(ValueError):
        GazePipeline(tiny_config(), device="cpu", decoder_impl="bilinear")
    with pytest.raises(ValueError):
        GazePipeline(tiny_config(), device="cpu", quant_conv="cudnn")
    with pytest.raises(ValueError):
        GazePipeline(tiny_config(), device="cpu", dtype=torch.float16)
    with pytest.raises(TypeError):
        GazePipeline(tiny_config(), device="cpu", quant_sp=object())
    # a rollout chunk function takes flow images only if it was made for them
    pipe = GazePipeline(tiny_config(), device="cpu")
    f = torch.zeros((1, 1, 32, 32, 3), dtype=torch.uint8)
    z = torch.zeros((1, 1))
    chunk = make_rollout_chunk_fn(pipe, with_flow=False)
    with pytest.raises(ValueError):
        chunk(pipe.init_state(1), f[:, 0], f, z, torch.zeros((1, 1, 2)), z,
              flow_img=torch.zeros((1, 1, 32, 32, 2), dtype=torch.uint8))
    with pytest.raises(ValueError):
        make_rollout_chunk_fn(pipe, with_flow=True)(pipe.init_state(1), f[:, 0], f, z,
                                                    torch.zeros((1, 1, 2)), z)


def fields(n, shape=(2, 18, 22), seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.uniform(-2, 2, shape).astype(np.float32)) for _ in range(n)]


def test_wrappers_take_the_plain_version_on_cpu_and_count_nothing():
    cuda.reset_launch_counts()
    f = fields(6)
    for a, b in zip(warp3(*f), warp3_plain(*f)):
        assert torch.equal(a, b)
    g = fields(10, seed=1)
    kw = dict(iters=3, tau=0.25, lambda_=0.15, theta=0.3)
    for a, b in zip(pd_iterations(*g, **kw), pd_iterations_plain(*g, **kw)):
        assert torch.equal(a, b)
    x, tap = int8_layer()
    assert torch.equal(conv3x3_int8(x, tap), conv3x3_int8_plain(x, tap))
    assert {k: v.launches for k, v in cuda.kernels().items()} == {
        "warp3": 0, "tvl1_pd": 0, "conv3x3_int8": 0}


def int8_layer(ci=32, co=16, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-128, 128, (2, 6, 7, ci), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (co, 3, 3, ci), dtype=np.int8))
    a = torch.from_numpy(rng.uniform(1e-4, 1e-3, co).astype(np.float32))
    c = torch.from_numpy(rng.normal(0, 10, co).astype(np.float32))
    return x, ConvTap(w, a, c)


def test_int8_wrapper_pads_a_small_stem_ci():
    """An int8 stem's Ci = 3 is padded to 32 with zero weights: the same
    codes as the plain version of the unpadded layer (pad code 0)."""
    x, tap = int8_layer(ci=3)
    tap = ConvTap(tap.w, tap.a, tap.c, None, 0)
    assert torch.equal(conv3x3_int8(x, tap), conv3x3_int8_plain(x, tap))


@pytest.mark.parametrize("bad", ["float_codes", "noncontiguous", "epilogue", "pad_code",
                                 "channels"])
def test_int8_wrapper_refuses_bad_inputs(bad):
    x, tap = int8_layer()
    if bad == "channels":
        x = x[..., :-1].contiguous()
    elif bad == "float_codes":
        x = x.float()
    elif bad == "noncontiguous":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "epilogue":
        tap = ConvTap(tap.w, tap.a[:-1], tap.c)
    else:
        tap = ConvTap(tap.w, tap.a, tap.c, None, 200)
    with pytest.raises((TypeError, ValueError)):
        conv3x3_int8(x, tap)


@pytest.mark.parametrize("bad", ["median_passes", "negative_median", "negative_iters",
                                 "border_dtype", "border_shape", "pool_dequant"])
def test_redesigned_wrappers_refuse_what_their_kernels_do_not_take(bad):
    """K2 takes 0, 1 or 2 median passes and iters >= 0; K3's border table
    is (16, Co) int32, and it pools only after a requantizing layer."""
    g = fields(10, seed=1)
    kw = dict(iters=3, tau=0.25, lambda_=0.15, theta=0.3)
    x, tap = int8_layer()
    with pytest.raises((TypeError, ValueError)):
        if bad == "median_passes":
            pd_iterations(*g, median_passes=3, **kw)
        elif bad == "negative_median":
            pd_iterations(*g, median_passes=-1, **kw)
        elif bad == "negative_iters":
            pd_iterations(*g, **{**kw, "iters": -1})
        elif bad == "pool_dequant":
            conv3x3_int8(x, ConvTap(tap.w, tap.a, tap.c, tap.c, -128), pool=True)
        elif bad == "border_dtype":
            conv3x3_int8(x, ConvTap(tap.w, tap.a, tap.c, None, -128,
                                    torch.zeros((16, 16), dtype=torch.int64)))
        else:
            conv3x3_int8(x, ConvTap(tap.w, tap.a, tap.c, None, -128,
                                    torch.zeros((9, 16), dtype=torch.int32)))


@pytest.mark.parametrize("bad", ["float64", "noncontiguous", "shape", "narrow"])
def test_wrappers_refuse_bad_inputs(bad):
    f = fields(6)
    if bad == "float64":
        f[2] = f[2].double()
    elif bad == "noncontiguous":
        f[1] = torch.zeros(2, 22, 18).transpose(1, 2)  # (2, 18, 22), strided
    elif bad == "shape":
        f[4] = f[4][:, :-1]
    else:
        f = fields(6, shape=(2, 1, 22))
    with pytest.raises((TypeError, ValueError)):
        warp3(*f)


@pytest.mark.parametrize("name", ["ImageConfig", "TVL1Config", "SPConfig", "ATConfig",
                                  "LFConfig", "LossConfig", "CameraConfig", "PipelineConfig",
                                  "TrainConfig"])
def test_config_copy_matches_the_jax_defaults(name):
    ours, theirs = getattr(tconfig, name)(), getattr(jconfig, name)()
    ours_fields = {f.name for f in dataclasses.fields(ours)}
    theirs_fields = {f.name for f in dataclasses.fields(theirs)}
    if name == "PipelineConfig":
        # the port's tree holds the inference, evaluation and training
        # sections; its mesh is a runtime object (``make_mesh``), not config
        assert ours_fields == {"image", "tvl1", "sp", "at", "lf", "loss", "camera", "train"}
        assert theirs_fields - ours_fields == {"mesh"}
    elif name == "CameraConfig":
        for geometry in ("gtea_gaze_plus", "gtea_gaze"):
            assert (dataclasses.asdict(getattr(tconfig.CameraConfig, geometry)())
                    == dataclasses.asdict(getattr(jconfig.CameraConfig, geometry)()))
    if name != "PipelineConfig":
        assert ours_fields == theirs_fields
    for k in ours_fields:
        a, b = getattr(ours, k), getattr(theirs, k)
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), k
        else:
            assert a == b, k
    if name == "PipelineConfig":
        for fn in ("parity_config", "production_config", "production_fast_config"):
            p, q = getattr(tconfig, fn)(), getattr(jconfig, fn)()
            assert p.tvl1 == tconfig.TVL1Config(**dataclasses.asdict(q.tvl1)), fn
            assert dataclasses.asdict(p.sp) == dataclasses.asdict(q.sp), fn


def test_presets_match_the_jax_benchmark():
    import bench

    assert tconfig.PRESETS == bench.PRESETS
    turbo = tconfig.preset_config("turbo")
    assert turbo == tconfig.production_fast_config()
    assert tconfig.preset_config("production") == tconfig.production_config()
    assert tconfig.preset_config("parity") == tconfig.parity_config()
