"""The benchmark's files: every cell, mix, metric and configuration that
``BENCHMARK.json`` names exists and loads; the counts match hand counts;
the command line refuses to run without a card or without the program;
nothing the benchmark runs loads JAX or the JAX package."""

import importlib
import json
import math
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.roofline import counts
from benchmark.tests.conftest import ROOT, load, tiny_config

SPEC = load(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = ROOT / "benchmark"


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    cells = len(SPEC["workloads"])
    # a full check: 2 + 14 runs a cell, each run_seconds + 60 s, 180 s a cell to compile,
    # 1200 s spare, within 43200 s with 24 cells
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_keys():
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]] + [
        m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    for n in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(n), n
    assert len(set(m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"])) == len(
        SPEC["end_to_end"]) + len(SPEC["per_layer"])
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
        assert load(ROOT / c["file"])["name"] == c["name"]
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_resolves_and_reports_enough():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for w in SPEC["workloads"]:
        spec = harness.cell_spec(w["name"])
        names = [m["name"] for m in spec["end_to_end"]]
        assert "setup_s" in names and len(names) >= 2
        assert spec["per_layer"]
        assert (BENCH / "kinds" / f"{spec['traffic']['kind']}.py").exists()
        for m in spec["per_layer"]:
            assert m["moves"] in names, (w["name"], m["name"])
            assert m["moves"] in e2e
        assert set(spec["limits"])
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", [])) <= cells


def test_every_file_is_named_by_the_spec():
    """A per-layer metric is a reader of its own, a mix and a cell are data
    files: none is left over and none is missing."""
    readers = {p.name[:-3] for p in (BENCH / "metrics").glob("*.py")}
    assert readers == {m["name"] for m in SPEC["per_layer"]}
    for name in readers:
        assert callable(harness.metric_reader(name))
    mixes = {p.stem for p in (BENCH / "traffic").glob("*.json")}
    assert mixes == {w["traffic"] for w in SPEC["workloads"]}
    cells = {p.name[:-5] for p in (BENCH / "workloads").glob("*.json")}
    assert cells == {w["name"] for w in SPEC["workloads"]}
    configs = {p.stem for p in (BENCH / "configs").glob("*.json")}
    assert configs == {c["name"] for c in SPEC["configs"]}
    for p in (BENCH / "traffic").glob("*.json"):
        importlib.import_module(f"benchmark.kinds.{load(p)['kind']}")


def test_configs_state_published_widths_and_precisions():
    for c in SPEC["configs"]:
        cfg = load(ROOT / c["file"])
        assert cfg["image"]["height"] == cfg["image"]["width"] == 224
        assert cfg["sp"]["stages"] == [[64, 64], [128, 128], [256, 256, 256], [512, 512, 512],
                                       [512, 512, 512]]
        assert cfg["sp"]["decoder_channels"] == [512, 256, 128, 64]
        assert cfg["sp"]["fused_channels"] == 512 and cfg["at"]["hidden_size"] == 512
        assert cfg["lf"]["channels"] == [32, 32, 8] and cfg["tvl1"]["pyramid_levels"] == 5
        assert set(cfg["precision"]) == {"activations", "tvl1", "vgg_stem", "vgg", "fuse",
                                         "decoder", "lstm", "lf"}
        assert cfg["reduced"] == c["reduced"] == []


def test_counts_match_hand_counts_at_a_tiny_shape():
    cfg = tiny_config(load(BENCH / "configs" / "turbo.json"))
    macs = counts.model_macs(cfg)
    # conv1_1 of both streams at 48 x 48: (3 + 2) inputs x 4 outputs x 9 taps
    assert macs["vgg_stem"] == 48 * 48 * (3 + 2) * 4 * 9
    vgg = 0
    for cin in (3, 2):
        hand = [(48, 48, cin, 4), (48, 48, 4, 4), (24, 24, 4, 8), (24, 24, 8, 8), (12, 12, 8, 8),
                (12, 12, 8, 8), (12, 12, 8, 8), (6, 6, 8, 16), (6, 6, 16, 16), (6, 6, 16, 16),
                (3, 3, 16, 16), (3, 3, 16, 16), (3, 3, 16, 16)]
        vgg += sum(h * w * ci * co * 9 for h, w, ci, co in hand[1:])
    assert macs["vgg"] == vgg
    assert macs["fuse"] == 3 * 3 * 32 * 16
    assert macs["decoder"] == (6 * 6 * 16 * 16 + 12 * 12 * 16 * 8 + 24 * 24 * 8 * 8
                               + 48 * 48 * 8 * 4) * 4 + 48 * 48 * 4
    assert macs["lf"] == 48 * 48 * 9 * (2 * 4 + 4 * 4 + 4 * 2 + 2 * 1)
    assert macs["lstm"] == 4 * 16 * 32 + 16 * 16 + 3 * 3 * 16
    # the turbo step at B=2: int8 VGG at 1979e12, the rest at bf16's 989e12
    bf16 = macs["vgg_stem"] + macs["fuse"] + macs["decoder"] + macs["lstm"] + macs["lf"]
    want = 2 * 2 * (macs["vgg"] / 1979e12 + bf16 / 989e12)
    assert math.isclose(counts.step_least_s(cfg, 2), want, rel_tol=1e-12)
    # K1 at 24 x 24 and its pyramid (24 only: 12 < 16): 8 float32 fields, 3 warps
    assert counts.pyramid(cfg) == [(24, 24)]
    assert counts.k1_step(cfg, 2) == [((24, 24), 8 * 4 * 2 * 24 * 24 / 3.35e12)] * 3
    (shape, t), = set(counts.k2_step(cfg, 2))
    assert t == max(16 * 4 * 2 * 576 / 3.35e12, 2 * 576 * (5 * 40 + 2 * 38) / 67e12)
    k3 = dict(counts.k3_step(cfg, 2))
    assert len(counts.k3_step(cfg, 2)) == 24
    assert k3["conv1_2"] == max(2.0 * 2 * 48 * 48 * 4 * 4 * 9 / 1979e12,
                                (2 * 48 * 48 * 4 + 9 * 16 + 2 * 24 * 24 * 4) / 3.35e12)
    assert counts.k3_step(tiny_config(load(BENCH / "configs" / "production.json")), 2) == []


def _env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return env


def test_command_line_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the command line would run the cell")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "clip.turbo.b128",
                        "--seed", str(2 ** 40 + 3), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "cuda" in p.stderr.lower()


def test_command_line_fails_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "clip.turbo.b128",
                        "--seed", "5", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_nothing_run_loads_jax():
    """A whole tiny run of every kind on the CPU, in a fresh process,
    leaves no module whose top-level name is jax, jaxlib, flax or
    gaze_tpu (gaze_tpu_torch is the program)."""
    code = (
        "import sys, torch; torch.set_num_threads(2)\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmark import harness\n"
        "from benchmark.tests.conftest import tiny_spec\n"
        "for cell in ('clip.turbo.b128', 'serve.turbo.s128', 'train.production.b128'):\n"
        "    harness.run_cell(cell, 11, 0.2, spec=tiny_spec(cell), device='cpu')\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    top = set(json.loads(p.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert "gaze_tpu_torch" in top
    assert not top & set(harness.FORBIDDEN)
