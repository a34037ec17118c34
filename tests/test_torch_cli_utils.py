"""The command line's host logic and the utilities it drives, against the
JAX package on the CPU: the flags, the config, the trainer's options,
the track format, the TensorBoard writer, the overlays, the heatmap
PNGs, the pretrained-VGG import, the torch export, the goldens and the
profiling helpers. Cheap: no JAX CLI run.

Tolerances: none where both sides compute the same bytes (parser,
config, tracks, event files, overlays, PNGs, the VGG import, the golden
report). ``pipeline_module_outputs`` is held as
``tests/test_torch_pipeline.py`` holds the step: 1e-5 (atol and rtol)
on every key but ``flow_in`` (2e-4, the TV-L1 band stated there), gaze
equal. The eval and extraction stages: each test states its band.
"""

import argparse
import ast
import collections
import dataclasses
import io
import json
import os
import re
import socket
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from gaze_tpu import cli as jcli
from gaze_tpu.evaluation import goldens as jgoldens
from gaze_tpu.models import weights_io as jweights_io
from gaze_tpu.models.pipeline import GazePipeline as JGazePipeline
from gaze_tpu.utils import logging as jlogging
from gaze_tpu.utils import tboard as jtboard
from gaze_tpu.utils import viz as jviz
from gaze_tpu_torch.cli import args as cli_args
from gaze_tpu_torch.cli import evaluate as cli_eval
from gaze_tpu_torch.cli import extract as cli_extract
from gaze_tpu_torch.cli import infer as cli_infer
from gaze_tpu_torch.evaluation import goldens
from gaze_tpu_torch.models import weights_export, weights_io
from gaze_tpu_torch.models.pipeline import GazePipeline
from gaze_tpu_torch.models.sp import SPNet
from gaze_tpu_torch.models.weights import _conv, torch_state_from_jax
from gaze_tpu_torch.core.config import SPConfig
from gaze_tpu_torch.train import stages
from gaze_tpu_torch.utils import logging as tlogging
from gaze_tpu_torch.utils import profiling, tboard, viz
from tests.test_torch_models import jax_variables
from tests.torch_gtea_tree import texture_frames, write_tree
from tests.torch_threads import cap_torch_threads  # noqa: F401  (autouse)
from tests.torch_train_cases import make_configs as train_configs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_TOL = 1e-5
AAE_BAND = 1e-4                  # degrees per scored frame
AUC_BAND = 1.0 / (32 * 32)       # per scored frame
FLOW_IN_BAND = 2e-4

# ------------------------------------------------------------------ flags


def actions(parser):
    return {a.dest: a for a in parser._actions if not isinstance(a, argparse._HelpAction)}


def test_parser_matches_jax():
    ours, theirs = actions(cli_args.build_argparser()), actions(jcli.build_argparser())
    assert ours.keys() == theirs.keys() and len(ours) == 71
    for dest, w in theirs.items():
        g = ours[dest]
        assert (g.option_strings, type(g), g.default, g.choices, g.type, g.nargs, g.const) == (
            w.option_strings, type(w), w.default, w.choices, w.type, w.nargs, w.const), dest


def test_help_of_the_module_lists_every_flag():
    """``python -m gaze_tpu_torch.cli --help``, run as a user runs it,
    against the JAX parser's help: the same flags, and every choice list
    of the JAX help in ours."""
    r = subprocess.run([sys.executable, "-m", "gaze_tpu_torch.cli", "--help"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    want = jcli.build_argparser().format_help()
    flags = re.compile(r"--[a-z_0-9]+")
    assert set(flags.findall(r.stdout)) == set(flags.findall(want))
    choices = re.compile(r"\{[a-z_0-9,]+\}")
    assert set(choices.findall(r.stdout)) == set(choices.findall(want))
    assert r.stdout.startswith("usage: gaze_tpu_torch ")


ARGVS = [
    [],
    ["--image_size", "288x384", "--camera", "gtea"],
    ["--image_size", "64", "--tvl1_preset", "dense_flow", "--flow_scale", "0.5"],
    ["--tvl1_warps", "3", "--tvl1_iters", "5", "--flow_scale", "0.5"],   # the turbo preset's
    ["--flow_scale", "0.5"],                                             # production's
    ["--lr_schedule", "cosine", "--epochs", "3", "--steps_per_epoch", "7"],
    ["--lr_schedule", "cosine", "--lr_decay_steps", "11", "--warmup_steps", "2"],
    ["--lr_schedule", "step", "--lr_decay_steps", "5", "--lr_decay_rate", "0.5"],
    ["--remat", "encoders", "--grad_accum", "2", "--batch_size", "8", "--augment_flip"],
    ["--lf_padding", "edge", "--lf_residual", "--grad_clip", "1.0", "--lr", "3e-4"],
    ["--tvl1_preset", "dense_flow", "--tvl1_iters", "7", "--camera", "gtea"],
    ["--remat", "full", "--image_size", "48x64", "--epochs", "2"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a) or "defaults" for a in ARGVS])
def test_make_config_matches_jax(argv):
    want = dataclasses.asdict(jcli.make_config(jcli.build_argparser().parse_args(argv)))
    got = dataclasses.asdict(cli_args.make_config(cli_args.build_argparser().parse_args(argv)))
    assert want.pop("mesh") and got == want


def test_stage_options_take_the_flags():
    args = cli_args.build_argparser().parse_args(
        ["--batch_size", "6", "--tboard", "tb", "--pretrained_vgg", "v.pth", "--at_stateless",
         "--precomputed_flow", "off", "--sp_ckpt", "x", "--quant_percentile", "99.9"])
    opts = cli_args.stage_options(args)
    assert (opts.batch_size, opts.tboard, opts.pretrained_vgg, opts.at_stateless,
            opts.precomputed_flow, opts.sp_ckpt, opts.quant_percentile) == (
        6, "tb", "v.pth", True, "off", "x", 99.9)
    assert cli_args.stage_options(cli_args.build_argparser().parse_args([])) == \
        stages.StageOptions(save_dir="save")


def test_write_track_is_the_jax_format(tmp_path):
    gazes = [(-1.0, -1.0), (3.25, 7.5), (0.0, 31.0), (12.125, 0.5)]
    for mod, name in ((jcli, "j.txt"), (cli_infer, "t.txt")):
        mod._write_track(str(tmp_path / name), gazes, (960, 720), (32, 24))
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    assert (tmp_path / "t.txt").read_text().splitlines()[:2] == ["-1 -1", "97.50 225.00"]

# ------------------------------------------------------------ tensorboard


@pytest.fixture()
def fixed_clock(monkeypatch):
    """Wall time, host name and pid fixed, so two writers make the same
    file names and bytes (and the loggers' steps/s 0)."""
    monkeypatch.setattr(time, "time", lambda: 1.7e9 + 0.25)
    monkeypatch.setattr(time, "perf_counter", lambda: 5.0)
    monkeypatch.setattr(socket, "gethostname", lambda: "host")
    monkeypatch.setattr(os, "getpid", lambda: 42)


def write_events(mod, logdir):
    w = mod.SummaryWriter(str(logdir))
    w.add_scalar("loss", 0.125, step=1)
    w.add_scalars({"val_aae": 3.5, "val_auc": 0.75, "big": 1e30}, step=2 ** 40)
    w.close()
    return w.path


def test_event_files_are_the_jax_bytes(tmp_path, fixed_clock):
    want = write_events(jtboard, tmp_path / "j")
    got = write_events(tboard, tmp_path / "t")
    assert os.path.basename(got) == os.path.basename(want) == \
        "events.out.tfevents.1700000000.host.42"
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()
    assert list(tboard.read_scalars(got)) == [
        (1, "loss", 0.125), (2 ** 40, "val_aae", 3.5), (2 ** 40, "val_auc", 0.75),
        (2 ** 40, "big", float(np.float32(1e30)))]
    assert tboard._crc32c(b"123456789") == 0xE3069283   # the CRC-32C check value


def test_step_logger_mirrors_scalars_as_jax(tmp_path, fixed_clock):
    lines = {}
    for mod, name in ((jlogging, "j"), (tlogging, "t")):
        stream = io.StringIO()
        log = mod.StepLogger("sp", every=2, stream=stream, tboard_dir=str(tmp_path / name))
        log.log(1, {"loss": 0.5})          # not a logged step
        log.log(2, {"loss": torch.tensor(0.25) if name == "t" else 0.25})
        log.log(3, {"val_aae": 2.0}, force=True)
        lines[name] = stream.getvalue()
    assert lines["t"] == lines["j"]
    assert [json.loads(x)["step"] for x in lines["t"].splitlines()] == [2, 3]
    (ev,) = os.listdir(tmp_path / "t" / "sp")
    with open(tmp_path / "t" / "sp" / ev, "rb") as f, \
            open(tmp_path / "j" / "sp" / ev, "rb") as g:
        assert f.read() == g.read()

# ---------------------------------------------- eval and extract paths


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    """Both packages' narrow 32² pipelines with the same weights, and a
    GTEA tree of three subjects ("Cal" held out) with an untracked frame
    and a fixsac file."""
    jcfg, tcfg = train_configs()
    v = jax_variables(jcfg)
    pipe = GazePipeline(tcfg, device="cpu")
    pipe.load_state_dicts(torch_state_from_jax(v))
    root = write_tree(tmp_path_factory.mktemp("gtea"), GTEA, (24, 32), seed=4,
                      fixsac=("Ben_Tea",), untracked={"Cal_Pie": (2,)})
    return dict(jcfg=jcfg, tcfg=tcfg, jpipe=JGazePipeline(jcfg), v=v, pipe=pipe, root=root)


GTEA = {"Ann_Soup": 5, "Ben_Tea": 5, "Cal_Pie": 5, "Cal_Jam": 5}   # 4 pairs each
EVAL_ARGV = ["--eval", "--synthetic", "--batch_size", "2", "--steps_per_epoch", "2"]
LFState = collections.namedtuple("LFState", "params")


def with_save_dir(args, save_dir):
    args.save_dir = save_dir
    return args


def printed_dicts(text):
    return [ast.literal_eval(x) for x in text.splitlines() if x.startswith("{'")]


def both(narrow, capsys, run_port, run_jax, argv):
    """The JAX CLI's stage function and the port's on the same flags:
    their printed dicts, JAX's first."""
    out = []
    for fn, mod in ((run_jax, jcli), (run_port, cli_args)):
        fn(mod.build_argparser().parse_args(argv))
        out.append(printed_dicts(capsys.readouterr().out))
    return out


@pytest.mark.parametrize("flags", [["--eval_teacher_forced"],
                                   ["--eval_teacher_forced", "--eval_map", "attention"],
                                   ["--data_root"]],
                         ids=["teacher_forced", "teacher_forced_attention", "gtea_rollout"])
def test_eval_matches_jax(flags, narrow, capsys):
    """``run_eval`` of both packages on the same weights: the synthetic
    corpus's teacher-forced diagnostic, and the rollout over a GTEA
    tree's held-out videos, per video and averaged, within
    ``tests/test_torch_rollout.py``'s bands (AAE 1e-4 degrees, AUC
    1/(H·W) per scored frame); the per-video lines are printed rounded to
    3 decimals of a degree, so their AAE is held to 1e-3."""
    n = narrow
    if "--data_root" in flags:
        flags = [f if f != "--data_root" else f"--data_root={n['root']}" for f in flags]
        flags += ["--test_subject", "Cal"]
    want, got = both(
        n, capsys,
        lambda a: cli_eval.run_eval(a, n["tcfg"], n["pipe"], SimpleNamespace(module=n["pipe"].lf)),
        lambda a: jcli.run_eval(a, n["jcfg"], n["jpipe"], n["v"]["sp"], n["v"]["at"],
                                LFState(n["v"]["lf"]["params"])),
        EVAL_ARGV + flags)
    assert len(got) == len(want) == (3 if "--test_subject" in flags else 1)
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g.get("video") == w.get("video")
        assert g.get("frames") == w.get("frames")
        for k, band in (("AAE_deg", 1e-3 if "video" in g else AAE_BAND), ("AUC", AUC_BAND)):
            assert abs(g[k] - w[k]) <= band and np.isfinite(g[k]), (k, g, w)


def test_extract_late_on_a_gtea_tree_matches_jax(narrow, tmp_path, capsys):
    """Every subject's videos, per video ``.npz``: float16 maps within 2e-3
    (four float16 steps at 1.0), indices equal."""
    n = narrow
    argv = ["--extract_late", "--batch_size", "4", f"--data_root={n['root']}",
            "--test_subject", "Cal"]
    want, got = both(
        n, capsys,
        lambda a: cli_extract.run_extract_late(
            with_save_dir(a, str(tmp_path / "t")), n["tcfg"], n["pipe"]),
        lambda a: jcli.run_extract_late(with_save_dir(a, str(tmp_path / "j")),
                                        n["jcfg"], n["jpipe"], n["v"]["sp"], n["v"]["at"]),
        argv)
    assert [x["extracted"] for x in got] == [x["extracted"] for x in want] == sorted(GTEA)
    for video in GTEA:
        with np.load(tmp_path / "t" / "maps" / f"{video}.npz") as z, \
                np.load(tmp_path / "j" / "maps" / f"{video}.npz") as y:
            np.testing.assert_array_equal(z["index"], y["index"])
            for k in ("saliency", "attention"):
                np.testing.assert_allclose(z[k].astype(np.float32), y[k].astype(np.float32),
                                           atol=2e-3, rtol=0, err_msg=(video, k))

# ------------------------------------------------------- overlays, PNGs


@pytest.fixture(scope="module")
def frames():
    return texture_frames(np.random.default_rng(3), 3, (24, 40))


def test_overlay_frame_matches_jax(frames):
    hm = np.random.default_rng(4).uniform(0, 1, (12, 20)).astype(np.float32)
    for kw in (dict(gaze_xy=(17.3, 9.8), heatmap=hm), dict(gaze_xy=(-1, -1)),
               dict(heatmap=frames[1, ..., 0].astype(np.float32), alpha=0.7),
               dict(gaze_xy=(39.0, 0.0), radius=6.0)):
        got = viz.overlay_gaze_frame(frames[0], **kw)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, jviz.overlay_gaze_frame(frames[0], **kw))
    with pytest.raises(ValueError):
        viz.overlay_gaze_frame(frames[0, ..., 0])


def test_overlay_video_and_heatmap_pngs_are_the_jax_bytes(frames, tmp_path):
    paths = []
    for i, f in enumerate(frames):
        paths.append(str(tmp_path / f"{i:06d}.png"))
        Image.fromarray(f).save(paths[-1])
    gazes = [(-1.0, -1.0), (5.0, 6.0), (30.5, 20.25)]
    hms = [None] + [np.random.default_rng(i).uniform(0, 1, (8, 8)).astype(np.float32)
                    for i in range(2)]
    n = viz.write_overlay_video(str(tmp_path / "t.avi"),
                                viz.render_gaze_track(paths, gazes, hms), fps=12)
    jviz.write_overlay_video(str(tmp_path / "j.avi"),
                             jviz.render_gaze_track(paths, gazes, hms), fps=12)
    assert n == 3
    assert (tmp_path / "t.avi").read_bytes() == (tmp_path / "j.avi").read_bytes()
    hm = hms[1]
    for frame in (None, frames[0][:8, :8]):
        tlogging.dump_heatmap_png(str(tmp_path / "t" / "h.png"), hm, frame)
        jlogging.dump_heatmap_png(str(tmp_path / "j" / "h.png"), hm, frame)
        assert (tmp_path / "t" / "h.png").read_bytes() == (tmp_path / "j" / "h.png").read_bytes()

# ------------------------------------------------ pretrained VGG, export


def torchvision_vgg16(path, stages_, seed=0):
    """A torchvision-layout ``features.N`` state dict with the convs of
    ``stages_`` (VGG16's 2,2,3,3,3 layout), drawn from a seed, saved as
    torchvision saves it."""
    g = torch.Generator().manual_seed(seed)
    state, idx, cin = {}, 0, 3
    for stage in stages_:
        for cout in stage:
            state[f"features.{idx}.weight"] = torch.randn(cout, cin, 3, 3, generator=g) * 0.1
            state[f"features.{idx}.bias"] = torch.randn(cout, generator=g) * 0.1
            idx, cin = idx + 2, cout
        idx += 1   # the pool
    torch.save(state, path)
    return state


def test_init_sp_from_torch_vgg16_matches_jax(tmp_path):
    """Full VGG16 widths, two flow channels (the TSN-style conv1_1),
    bit-equal to the JAX function's kernels through the bridge."""
    path = str(tmp_path / "vgg16.pth")
    torchvision_vgg16(path, SPConfig().stages)
    sp = weights_io.init_sp_from_torch_vgg16(SPNet(SPConfig()), path, 2)
    want = jweights_io.init_sp_from_torch_vgg16({"params": {}}, path, 2)["params"]
    for stream in ("spatial", "temporal"):
        got = getattr(sp, stream).state_dict()
        assert len(got) == len(want[stream]) * 2 == 26
        for name, p in want[stream].items():
            bridged = {}
            _conv(bridged, name, p)
            for k, v in bridged.items():
                assert torch.equal(got[k], torch.from_numpy(v)), (stream, k)
    assert sp.temporal.conv1_1.weight.shape[1] == 2


def test_run_train_sp_starts_from_pretrained_vgg_before_a_resume(tmp_path):
    """lr 0: the stage keeps what it started from, the file's encoders on
    a fresh start and the checkpoint's on a resume."""
    _, tcfg = train_configs(train=dict(learning_rate=0.0, weight_decay=0.0))
    pipe = GazePipeline(tcfg, device="cpu")
    first = torchvision_vgg16(str(tmp_path / "a.pth"), tcfg.sp.stages, seed=1)
    torchvision_vgg16(str(tmp_path / "b.pth"), tcfg.sp.stages, seed=2)
    opts = stages.StageOptions(batch_size=2, steps_per_epoch=1, save_dir=str(tmp_path / "s"),
                               pretrained_vgg=str(tmp_path / "a.pth"), log_every=100)
    stages.run_train_sp(opts, pipe)
    assert torch.equal(pipe.sp.spatial.conv2_1.weight, first["features.5.weight"])
    assert torch.allclose(pipe.sp.temporal.conv1_1.weight,
                          first["features.0.weight"].mean(1, keepdim=True).expand(-1, 2, -1, -1)
                          * 1.5)
    stages.run_train_sp(dataclasses.replace(opts, pretrained_vgg=str(tmp_path / "b.pth")), pipe)
    assert torch.equal(pipe.sp.spatial.conv2_1.weight, first["features.5.weight"])


def test_export_round_trips_into_fresh_modules(tmp_path):
    """The bundle (``tests/test_torch_cli.py`` holds it to the JAX CLI's
    key for key): CPU float32 tensors without ``num_batches_tracked``,
    loading into a pipeline of other weights bit-equal."""
    _, tcfg = train_configs()
    pipe = GazePipeline(tcfg, device="cpu", seed=3)
    with torch.no_grad():
        pipe.sp.decoder.bn1.running_mean.uniform_(-1, 1)
    weights_export.export_pipeline_to_torch(pipe, str(tmp_path / "t.pt"))
    got = torch.load(str(tmp_path / "t.pt"), weights_only=True)
    assert got.keys() == {"sp", "at", "lf"}
    assert not [k for sd in got.values() for k in sd if k.endswith("num_batches_tracked")]
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for sd in got.values() for t in sd.values())
    fresh = GazePipeline(tcfg, device="cpu", seed=5)
    fresh.load_state_dicts(got)
    for name, module in fresh.modules().items():
        for k, t in module.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(t, pipe.modules()[name].state_dict()[k]), (name, k)

# ---------------------------------------------------------------- goldens


def test_compare_goldens_gives_the_jax_report(tmp_path):
    rng = np.random.default_rng(0)
    a = {"x": rng.normal(size=(3, 4)).astype(np.float32), "y": np.zeros(2), "only_a": np.ones(1),
         "shape": np.zeros((2, 2)), "empty": np.zeros((0,))}
    b = {"x": a["x"] + 2e-6, "y": np.array([0.0, 1e-3]), "only_b": np.ones(1),
         "shape": np.zeros((4,)), "empty": np.zeros((0,))}
    for kw in ({}, dict(atol=1e-2, rtol=0.0)):
        assert goldens.compare_goldens(a, b, **kw) == jgoldens.compare_goldens(a, b, **kw)
    ok, report = goldens.compare_goldens({"x": torch.from_numpy(a["x"])}, {"x": a["x"]})
    assert ok and report == {"x": 0.0}
    goldens.save_goldens(str(tmp_path / "g" / "b.npz"), {"x": torch.ones(2), "y": a["y"]})
    got = goldens.load_goldens(str(tmp_path / "g" / "b.npz"))
    assert got.keys() == {"x", "y"} and got["x"].tolist() == [1.0, 1.0]
    assert dataclasses.asdict(goldens.golden_tiny_parity_config()) == {
        k: v for k, v in dataclasses.asdict(jgoldens.golden_tiny_parity_config()).items()
        if k != "mesh"}


def test_pipeline_module_outputs_match_jax(narrow):
    """Every module-boundary tensor of one step, both packages on the same
    weights and frames (the JAX step compiled), within
    ``tests/test_torch_pipeline.py``'s goldens tolerance (1e-5) but
    ``flow_in`` (its TV-L1 band, 2e-4); the gaze equal."""
    n = narrow
    frames = texture_frames(np.random.default_rng(8), 3, (32, 32))
    prev, cur, fix = frames[:2], frames[1:], np.ones(2, np.float32)
    jstep = jax.jit(lambda v, st, p, c, f: jgoldens.pipeline_module_outputs(n["jpipe"], v, st,
                                                                             p, c, f))
    want = {k: np.asarray(v) for k, v in jstep(n["v"], n["jpipe"].init_state(2), prev, cur,
                                               fix).items()}
    got = goldens.pipeline_module_outputs(n["pipe"], None, n["pipe"].init_state(2), prev, cur,
                                          torch.from_numpy(fix))
    flow = {"flow_in": got.pop("flow_in")}
    ok, report = goldens.compare_goldens(got, {k: v for k, v in want.items() if k != "flow_in"},
                                         atol=GOLDEN_TOL, rtol=GOLDEN_TOL)
    assert ok and report.keys() == {"rgb_in", "sp_saliency", "sp_conv5", "at_weights",
                                    "at_attention", "lf_heatmap", "gaze_xy"}, report
    assert goldens.compare_goldens(flow, {"flow_in": want["flow_in"]}, atol=FLOW_IN_BAND,
                                   rtol=0)[0]
    assert report["gaze_xy"] == 0.0

# -------------------------------------------------------------- profiling


def test_trace_writes_a_chrome_trace_and_device_time_times_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        (x @ x).sum()
    with open(tmp_path / "tr" / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    calls = []
    s = profiling.device_time(lambda a: calls.append(a) or (a @ a), iters=4, repeats=2,
                              args=(x,), device="cpu")
    assert 0 < s < 1 and len(calls) == 1 + 4 * 2
