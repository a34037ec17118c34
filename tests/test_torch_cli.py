"""The port's command line (``gaze_tpu_torch.cli``) against the JAX CLI on
the CPU, the slice as a whole.

One module fixture writes SP, AT and LF checkpoints in both packages'
formats from the same seeded variables (JAX states with randomized biases
and BatchNorm statistics, carried into the port's states through the
bridge), runs the JAX CLI once, ``python -m gaze_tpu.cli --eval
--extract_late --infer --infer_batch --export_torch`` at ``--image_size
32 --batch_size 2`` (full VGG16 widths, the CLI's config; TV-L1 cut to 1
warp x 2 iterations), in a subprocess held to two cores (so XLA's
threads leave the other test workers their share), and runs the port's
``main(..., device="cpu")`` on the same flags. No training stage runs.

Tolerances:

- ``--eval``: the sequential rollout's AAE and AUC, means over the
  scored frames, within ``tests/test_torch_rollout.py``'s bands per
  scored frame: AAE 1e-4 degrees, AUC 1/(H·W);
- ``--extract_late``: the float16 maps within 2e-3 (four float16 steps
  at 1.0), the frame indices equal;
- ``--infer``, ``--infer_batch``: every track row within 1e-3 px (the
  tracks are written to 0.01 px, so the rows are equal);
- ``--export_torch``: the bundles key for key, bit for bit.

The ``--quant_sp`` route: the port runs ``--quant_sp --quant_calib_batches
1 --quant_save --eval`` (PTQ calibration on the first training batch, the
rollout through its int8 streams on K3's plain version) and ``--eval
--quant_load`` of that bundle:

- the bundle against the JAX package's calibration of the same pairs and
  weights: the int8 kernels, their scales, biases and column sums equal;
  the activation scales within ``tests/test_torch_quant.py``'s bands,
  1e-6 relative in the spatial stream, 5e-4 in the temporal one (its
  inputs carry the TV-L1 flow band);
- each quantized ``--eval`` prints exactly what its pieces give: the
  calibration and the rollout (``rollout_eval_arrays``) of the int8
  pipeline, the same numbers from the loaded bundle;
- the int8 pipeline of that bundle against the JAX package's over the
  first 5 frames of the CLI's four videos (heatmaps within 5e-3, the
  int8 goldens' tolerance, since a code at a rounding boundary can flip
  between the packages; gaze equal or a near tie): the JAX CLI's own
  int8 rollout of all 4 x 32 frames takes 100 s on this CPU (XLA's int8
  convolutions).

Where the port departs from the JAX CLI on purpose, a test pins it: the
temporary frame directory of ``--infer`` is removed (the JAX CLI leaves
it), ``--infer_batch`` removes its directories when it fails midway, and
both servers get ``--quant_conv``.
"""

import ast
import contextlib
import io
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from gaze_tpu import cli as jcli
from gaze_tpu.core import checkpoint as jckpt
from gaze_tpu.models.pipeline import GazePipeline as JGazePipeline
from gaze_tpu.models.pipeline import make_clip_fn
from gaze_tpu.models import quant as jquant
from gaze_tpu.models.quant_io import load_quant_sp as jax_load_quant_sp
from gaze_tpu.train.common import make_optimizer, make_state
from gaze_tpu_torch import cli
from gaze_tpu_torch.cli import args as cli_args
from gaze_tpu_torch.cli import infer as cli_infer
from gaze_tpu_torch.cli.evaluate import synthetic_eval_corpus
from gaze_tpu_torch.core import checkpoint as tckpt
from gaze_tpu_torch.core.checkpoint import latest_step
from gaze_tpu_torch.data.video import write_mjpeg_avi
from gaze_tpu_torch.evaluation.rollout import rollout_eval_arrays
from gaze_tpu_torch.models.pipeline import GazePipeline, run_clip
from gaze_tpu_torch.models.quant import calibrate_pipeline_sp
from gaze_tpu_torch.models.quant_io import load_quant_sp
from gaze_tpu_torch.train import at as tat
from gaze_tpu_torch.train import lf as tlf
from gaze_tpu_torch.train import sp as tsp
from gaze_tpu_torch.train.stages import _calibration_pairs
from tests.torch_gtea_tree import texture_frames
from tests.torch_threads import cap_torch_threads  # noqa: F401  (autouse)
from tests.torch_train_cases import port_state, randomize, to_numpy

SIZE = 32
AAE_BAND = 1e-4                 # degrees per scored frame
AUC_BAND = 1.0 / (SIZE * SIZE)  # per scored frame
MAP_TOL = 2e-3                  # float16 maps of --extract_late
TRACK_TOL = 1e-3                # px, tracks of --infer and --infer_batch
COMMON = ["--synthetic", "--image_size", str(SIZE), "--batch_size", "2",
          "--steps_per_epoch", "2", "--tvl1_warps", "1", "--tvl1_iters", "2"]
STEP = 3   # the checkpoints' step
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CLI_CORES = 2
CALIB = ["--quant_sp", "--quant_calib_batches", "1"]
SCALE_RTOL = 1e-6         # spatial activation scales, relative
FLOW_SCALE_RTOL = 5e-4    # temporal activation scales, relative
PREFIX = 5                # frames per video of the int8 clip held to JAX's
QUANT_HEATMAP_TOL = 5e-3  # int8 heatmaps against JAX's (the int8 goldens' tolerance)


def jpeg(frame):
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=95)
    return buf.getvalue()


def write_inputs(root):
    """A 7-frame MJPEG AVI at 48x64 for --infer; for --infer_batch a
    5-frame AVI and a 4-frame PNG frame directory."""
    rng = np.random.default_rng(5)
    frames = texture_frames(rng, 7, (48, 64))
    avi = os.path.join(root, "clip.avi")
    write_mjpeg_avi(avi, [jpeg(f) for f in frames], 64, 48, fps=10)
    batch = os.path.join(root, "batch")
    os.makedirs(os.path.join(batch, "dirv"))
    write_mjpeg_avi(os.path.join(batch, "a.avi"), [jpeg(f) for f in frames[2:]], 64, 48, fps=10)
    for i, f in enumerate(texture_frames(rng, 4, (48, 64))):
        Image.fromarray(f).save(os.path.join(batch, "dirv", f"{i:06d}.png"))
    return avi, batch


def write_checkpoints(jdir, tdir):
    """SP, AT and LF states from seeded JAX variables (one compiled
    initialization of the pipeline; biases and BatchNorm statistics
    randomized, fresh Adam moments, step 3), as orbax checkpoints under
    ``jdir`` and the port's under ``tdir``. Returns the JAX pipeline
    variables (numpy leaves)."""
    jcfg = jcli.make_config(jcli.build_argparser().parse_args(COMMON))
    tcfg = cli_args.make_config(cli_args.build_argparser().parse_args(COMMON))
    jpipe = JGazePipeline(jcfg)
    tpipe = GazePipeline(tcfg, device="cpu")
    init = jax.tree.map(np.asarray, jax.jit(jpipe.init_variables)(jax.random.key(0)))
    tx = make_optimizer(jcfg.train)
    variables = {}
    for stage, tcreate, seed in (("sp", tsp.create_sp_state, 10), ("at", tat.create_at_state, 20),
                                 ("lf", tlf.create_lf_state, 30)):
        v = {"params": randomize(init[stage]["params"], seed)}
        if "batch_stats" in init[stage]:
            v["batch_stats"] = randomize(init[stage]["batch_stats"], seed + 1)
        js = to_numpy(make_state(v, tx)).replace(step=STEP)
        jckpt.save_checkpoint(os.path.join(jdir, stage), STEP, js)
        tckpt.save_checkpoint(os.path.join(tdir, stage), STEP, port_state(tcreate, tpipe, js))
        variables[stage] = v
    return variables


def checkpoints(save):
    """The flags that read the stages' checkpoints from ``save``."""
    return [x for stage in ("sp", "at", "lf")
            for x in (f"--{stage}_ckpt", os.path.join(save, stage))]


def printed(out):
    return [ast.literal_eval(x) for x in out.splitlines() if x.startswith("{'")]


def run_cli(main, argv, tmpdir, **kw):
    """``main(argv)`` with its stdout and stderr captured and the
    temporary directories made under ``tmpdir``."""
    os.makedirs(tmpdir)
    out, err = io.StringIO(), io.StringIO()
    before = tempfile.tempdir
    tempfile.tempdir = tmpdir
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            main(argv, **kw)
    finally:
        tempfile.tempdir = before
    return out.getvalue(), err.getvalue()


def run_jax_cli(argv, tmpdir):
    """``python -m gaze_tpu.cli`` in a subprocess on JAX_CLI_CORES cores,
    its temporary directories under ``tmpdir``, the tests' JAX settings
    (CPU devices, float32 matmuls, the compile cache) in its
    environment: (stdout, stderr)."""
    os.makedirs(tmpdir)
    cores = ",".join(map(str, sorted(os.sched_getaffinity(0))[:JAX_CLI_CORES]))
    env = dict(os.environ, TMPDIR=tmpdir, JAX_DEFAULT_MATMUL_PRECISION="float32",
               JAX_COMPILATION_CACHE_DIR=jax.config.jax_compilation_cache_dir or "",
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="-1")
    r = subprocess.run(["taskset", "-c", cores, sys.executable, "-m", "gaze_tpu.cli"] + argv,
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout, r.stderr


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs' runs; their files (about 1.5 GB of checkpoints, bundles
    and maps) are removed when the module ends."""
    root = str(tmp_path_factory.mktemp("cli"))
    try:
        yield _runs(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _runs(root):
    avi, batch = write_inputs(root)
    save = {"jax": os.path.join(root, "save_jax"), "port": os.path.join(root, "save_port")}
    result = {"avi": avi, "batch": batch, "root": root,
              "variables": write_checkpoints(save["jax"], save["port"])}
    for name in ("jax", "port"):
        d = os.path.join(root, name)
        argv = COMMON + ["--save_dir", save[name], "--eval", "--extract_late",
                         "--infer", avi, "--infer_out", os.path.join(d, "track.txt"),
                         "--infer_heatmaps", os.path.join(d, "hm"), "--infer_heatmap_every", "3",
                         "--infer_batch", batch, "--export_torch", os.path.join(d, "bundle.pt")]
        tmp = os.path.join(root, name + "_tmp")
        if name == "jax":
            out, err = run_jax_cli(argv, tmp)
        else:
            out, err = run_cli(cli.main, argv, tmp, device="cpu")
        result[name] = dict(dir=d, save=save[name], out=printed(out), err=err,
                            tmp=sorted(os.listdir(tmp)))
    bundle = os.path.join(root, "int8.npz")
    result["quant"] = {"bundle": bundle}
    for name, flags in (("calibrated", CALIB + ["--quant_save", bundle]),
                        ("loaded", ["--quant_load", bundle])):
        out, err = run_cli(cli.main, COMMON + flags + ["--eval", "--save_dir", save["port"]],
                           os.path.join(root, name + "_tmp"), device="cpu")
        assert "random init" not in err
        result["quant"][name] = printed(out)
    return result


def test_consumers_restore_the_checkpoints(runs):
    for name in ("jax", "port"):
        assert "random init" not in runs[name]["err"], (name, runs[name]["err"])


def test_eval_matches_jax(runs):
    want, got = (next(x for x in runs[k]["out"] if "AAE_deg" in x) for k in ("jax", "port"))
    assert abs(got["AAE_deg"] - want["AAE_deg"]) <= AAE_BAND, (got, want)
    assert abs(got["AUC"] - want["AUC"]) <= AUC_BAND, (got, want)
    assert np.isfinite(got["AAE_deg"]) and 0 < got["AUC"] <= 1


def test_extract_late_matches_jax(runs):
    with np.load(os.path.join(runs["jax"]["save"], "maps", "synthetic.npz")) as z:
        want = {k: z[k] for k in z.files}
    with np.load(os.path.join(runs["port"]["save"], "maps", "synthetic.npz")) as z:
        got = {k: z[k] for k in z.files}
    assert got.keys() == want.keys() == {"saliency", "attention", "index"}
    np.testing.assert_array_equal(got["index"], want["index"])
    for k in ("saliency", "attention"):
        assert got[k].dtype == np.float16 and got[k].shape == want[k].shape == (4, SIZE, SIZE)
        np.testing.assert_allclose(got[k].astype(np.float32), want[k].astype(np.float32),
                                   atol=MAP_TOL, rtol=0, err_msg=k)


def read_track(path):
    return np.loadtxt(path, ndmin=2)


def test_infer_matches_jax(runs):
    got = read_track(os.path.join(runs["port"]["dir"], "track.txt"))
    want = read_track(os.path.join(runs["jax"]["dir"], "track.txt"))
    assert got.shape == want.shape == (7, 2)
    np.testing.assert_array_equal(got[0], [-1, -1])
    np.testing.assert_allclose(got, want, atol=TRACK_TOL, rtol=0)
    assert (sorted(os.listdir(os.path.join(runs["port"]["dir"], "hm")))
            == sorted(os.listdir(os.path.join(runs["jax"]["dir"], "hm")))
            == ["000000.png", "000003.png", "000006.png"])


def test_infer_batch_matches_jax(runs):
    for stem, n in (("a", 5), ("dirv", 4)):
        got = read_track(os.path.join(runs["port"]["save"], "infer_batch", f"{stem}.txt"))
        want = read_track(os.path.join(runs["jax"]["save"], "infer_batch", f"{stem}.txt"))
        assert got.shape == want.shape == (n, 2)
        np.testing.assert_allclose(got, want, atol=TRACK_TOL, rtol=0, err_msg=stem)


def test_export_torch_matches_jax(runs):
    got = torch.load(os.path.join(runs["port"]["dir"], "bundle.pt"), weights_only=True)
    want = torch.load(os.path.join(runs["jax"]["dir"], "bundle.pt"), weights_only=False)
    assert got.keys() == want.keys() == {"sp", "at", "lf"}
    for m in want:
        assert got[m].keys() == want[m].keys(), m
        for k, w in want[m].items():
            g = got[m][k]
            assert g.device.type == "cpu" and g.dtype == w.dtype == torch.float32, k
            assert torch.equal(g, w), (m, k)


@pytest.fixture(scope="module")
def restored(runs):
    """The quantized runs' flags, config and float pipeline, the port's
    checkpoints loaded."""
    save = runs["port"]["save"]
    args = cli_args.build_argparser().parse_args(COMMON + CALIB + checkpoints(save))
    cfg = cli_args.make_config(args)
    pipe = GazePipeline(cfg, device="cpu")
    for stage, module in (("sp", pipe.sp), ("at", pipe.lstm), ("lf", pipe.lf)):
        d = os.path.join(save, stage)
        module.load_state_dict(torch.load(os.path.join(d, f"{latest_step(d)}.pt"),
                                          weights_only=True)["module"])
    return args, cfg, pipe


def printed_eval(lines):
    return next(x for x in lines if "AAE_deg" in x)


def test_calibrated_bundle_matches_jax(runs, restored):
    """The JAX package's calibration of the same first training batch
    with the same weights."""
    args, cfg, pipe = restored
    assert {"quant_sp": "int8", "calibration_batches": 1, "percentile": None,
            "stem": "int8"} in runs["quant"]["calibrated"]
    jargs = jcli.build_argparser().parse_args(COMMON + CALIB)
    jpipe = JGazePipeline(jcli.make_config(jargs))
    want = jquant.calibrate_pipeline_sp(jpipe, {"sp": runs["variables"]["sp"]},
                                        jcli._calibration_pairs(jargs, jpipe.config))
    got = load_quant_sp(runs["quant"]["bundle"])
    assert got.tail is None and want.tail is None
    for stream, rtol in (("spatial", SCALE_RTOL), ("temporal", FLOW_SCALE_RTOL)):
        g, w = getattr(got, stream), getattr(want, stream)
        for field in ("kernels", "w_scales", "biases", "col_sums"):
            for k, v in getattr(w, field).items():
                np.testing.assert_array_equal(getattr(g, field)[k].numpy(), np.asarray(v),
                                              err_msg=f"{stream} {field} {k}")
        for k, v in w.act_scales.items():
            assert abs(float(g.act_scales[k]) - float(v)) <= rtol * float(v), (stream, k)


def test_quant_eval_is_its_pieces(runs, restored):
    args, cfg, pipe = restored
    qsp = calibrate_pipeline_sp(pipe, _calibration_pairs(cli_args.stage_options(args), cfg))
    frames, gaze, fixsac = synthetic_eval_corpus(args, cfg)
    aae, auc, cnt = rollout_eval_arrays(pipe.with_quant(qsp), frames, gaze, fixsac)
    assert cnt.sum() == 4 * 31
    want = {"AAE_deg": float(aae.sum() / cnt.sum()), "AUC": float(auc.sum() / cnt.sum())}
    for route in ("calibrated", "loaded"):
        assert printed_eval(runs["quant"][route]) == want, route


def test_quant_clip_matches_jax(runs, restored):
    """The int8 pipeline of the CLI's bundle against the JAX package's on
    the same bundle: ``run_clip`` against ``make_clip_fn`` over the first
    5 frames of the CLI's four videos. Heatmaps within 5e-3 (the int8
    goldens' tolerance, ``tests/test_goldens.py``): a code at a rounding
    boundary can flip between the packages (measured 1.1e-3 here); each
    gaze equal, or a near tie on JAX's heatmap (its value at the port's
    gaze within twice the largest heatmap difference of the maximum)."""
    args, cfg, pipe = restored
    frames, _, fixsac = (x[:, :PREFIX] for x in synthetic_eval_corpus(args, cfg))
    hm, gz = (x.numpy() for x in run_clip(
        pipe.with_quant(load_quant_sp(runs["quant"]["bundle"])), frames, fixsac))
    jcfg = jcli.make_config(jcli.build_argparser().parse_args(COMMON + CALIB))
    jpipe = JGazePipeline(jcfg, quant_sp=jax_load_quant_sp(runs["quant"]["bundle"]))
    jhm, jgz = (np.asarray(x) for x in make_clip_fn(jpipe)(runs["variables"], frames, fixsac))
    delta = float(np.abs(hm - jhm).max())
    assert hm.shape == jhm.shape == (4, PREFIX - 1, SIZE, SIZE) and delta <= QUANT_HEATMAP_TOL
    for v, t in zip(*np.nonzero((gz != jgz).any(-1))):
        x, y = gz[v, t].astype(int)
        assert jhm[v, t].max() - jhm[v, t, y, x] <= 2 * delta, (v, t, gz[v, t], jgz[v, t])


def test_infer_removes_its_frame_directory(runs):
    """Diverged from the JAX CLI, which leaves the frames of --infer's
    video in a temporary directory (``gaze_tpu/cli.py:1043``)."""
    assert runs["port"]["tmp"] == []
    assert [d for d in runs["jax"]["tmp"] if d.startswith(cli_infer.FRAMES_PREFIX)]


def test_infer_batch_failing_midway_removes_its_frame_directories(runs, tmp_path, monkeypatch):
    """Diverged from the JAX CLI, which leaks them on an exception
    (``gaze_tpu/cli.py:1249``): the decode of the third tick fails."""
    real, calls = cli_infer.decode_batch, []

    def failing(paths, **kw):
        calls.append(paths)
        if len(calls) > 2:
            raise OSError("disk gone")
        return real(paths, **kw)

    monkeypatch.setattr(cli_infer, "decode_batch", failing)
    tmp = str(tmp_path / "tmp")
    with pytest.raises(OSError, match="disk gone"):
        run_cli(cli.main, COMMON + checkpoints(runs["port"]["save"])
                + ["--save_dir", str(tmp_path), "--infer_batch", runs["batch"]], tmp, device="cpu")
    assert len(calls) == 3 and os.listdir(tmp) == []


def test_quant_conv_reaches_both_servers(runs, tmp_path, monkeypatch):
    """Diverged from the JAX CLI, which builds both servers without
    ``quant_conv`` (``gaze_tpu/cli.py:1054``, ``:1194``); the servers
    run from the int8 bundle the same invocation calibrated."""
    made = []
    real = cli_infer.StreamServer

    def spy(*a, **kw):
        made.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(cli_infer, "StreamServer", spy)
    d = str(tmp_path)
    run_cli(cli.main, COMMON + checkpoints(runs["port"]["save"])
            + ["--save_dir", d, "--quant_sp", "--quant_calib_batches", "1",
               "--quant_conv", "pallas", "--infer", runs["avi"], "--infer_out", d + "/t.txt",
               "--infer_batch", runs["batch"]], d + "/tmp", device="cpu")
    assert [(kw["max_streams"], kw["quant_conv"]) for kw in made] == [(1, "pallas"), (2, "pallas")]
    assert all(kw["quant_sp"] is not None for kw in made)
    assert read_track(d + "/t.txt").shape == (7, 2)
    assert sorted(os.listdir(d + "/infer_batch")) == ["a.txt", "dirv.txt"]


def test_missing_checkpoints_warn(tmp_path, capsys):
    """As the JAX CLI: a consumer stage with no checkpoint runs from the
    seeded initialization and says so for each module."""
    cli.main(COMMON + ["--save_dir", str(tmp_path), "--export_torch", str(tmp_path / "b.pt")],
             device="cpu")
    err = capsys.readouterr().err
    for module in ("sp", "at", "lf"):
        assert f"no {module} checkpoint" in err, err
    assert jax.devices()[0].platform == "cpu"
