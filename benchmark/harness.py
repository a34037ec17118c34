"""Runs one cell once: set-up, the timed window, the traced span, the
correctness check, and the result line.

Everything cell-specific is found by name (``benchmark/__init__.py``):
the cell's configuration, its traffic mix and the kind that drives it,
its limits, and a reader per per-layer metric. A kind module
(``kinds/<kind>.py``) has four functions:

- ``setup(run) -> state``: builds the program and the cell's inputs from
  the seed and warms up every shape the window uses;
- ``window(run, state) -> (end-to-end values, attempted, failed)``: the
  timed window, at least ``run.seconds`` long;
- ``traced(run, state) -> info``: calls ``run.trace_span(fn)`` on a span
  of whole units of the cell's work, and returns what the readers need
  besides the trace (``steps``: model steps in the span; host samples);
- ``release(run, state)``: frees the program's state, keeping its outputs;
- ``check(run, state) -> [(name, value, limit)]``: the comparison with
  the plain reference, after the program is freed.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gaze_tpu")
CACHE = ROOT / ".bench_cache"


class RunError(RuntimeError):
    """A run that cannot give a result."""


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def cell_spec(name: str) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic, limits and the metrics it reports."""
    spec = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise RunError(f"no cell {name!r} in BENCHMARK.json (cells: {sorted(cells)})")
    w = cells[name]
    own = load_json(HERE / "workloads" / f"{name}.json")

    def reports(m):
        return name in m.get("workloads", [name])

    return {"workload": w,
            "config": load_json(HERE / "configs" / f"{w['config']}.json"),
            "traffic": load_json(HERE / "traffic" / f"{w['traffic']}.json"),
            "limits": own["limits"], "control": own.get("control", {}),
            "end_to_end": [m for m in spec["end_to_end"] if reports(m)],
            "per_layer": [m for m in spec["per_layer"] if reports(m)]}


def kind_module(kind: str):
    return importlib.import_module(f"benchmark.kinds.{kind}")


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its kernels into ``gaze_tpu_torch/_build/``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("CUDA_MODULE_LOADING", "LAZY")


def process_start() -> float:
    """``time.perf_counter()`` at the start of this process."""
    now = time.perf_counter()
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return now - max(0.0, up - start)
    except (OSError, ValueError, IndexError):
        return now


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Run:
    """One run of one cell: its inputs, where it runs, and its spans."""

    def __init__(self, name: str, seed: int, seconds: float, trace: bool, spec: dict,
                 device: str = "cuda", variant: str = "program"):
        from benchmark.tracing import Spans

        self.name, self.seed, self.seconds, self.trace = name, int(seed), float(seconds), trace
        self.spec = spec
        self.config, self.traffic, self.limits = spec["config"], spec["traffic"], spec["limits"]
        self.device = device
        self.variant = variant
        self.spans = Spans()
        self.device_trace = None
        # numbers the check read besides those it compares, for the record
        self.readings: Dict[str, float] = {}

    @property
    def on_card(self) -> bool:
        return self.device != "cpu"

    def sync(self) -> None:
        if self.on_card:
            import torch

            torch.cuda.synchronize()

    def trace_span(self, fn) -> None:
        """Trace ``fn`` (a span of whole units) on the device."""
        from benchmark.tracing import device_trace

        self.device_trace = device_trace(fn, self.spans)


def run_cell(name: str, seed: int, seconds: float, trace: bool = False, *,
             spec: Optional[dict] = None, device: str = "cuda", variant: str = "program",
             t_start: Optional[float] = None, log=sys.stderr) -> dict:
    """One run of cell ``name``; returns the result object. ``spec``
    replaces the cell's files (the tests shrink it); ``device="cpu"`` and
    ``variant`` (a control or a planted fault) serve the tests and
    ``benchmark/control.py``: the command line runs the program on the
    card."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = spec or cell_spec(name)
    chips = spec["workload"]["chips"]
    import torch

    if device != "cpu":
        if not torch.cuda.is_available():
            raise RunError("torch.cuda.is_available() is false: this benchmark measures the "
                           "card and has no CPU fallback")
        if torch.cuda.device_count() < chips:
            raise RunError(f"the cell needs {chips} cards, {torch.cuda.device_count()} visible")
    run = Run(name, seed, seconds, trace, spec, device, variant)
    kind = kind_module(run.traffic["kind"])
    state = kind.setup(run)
    run.sync()
    t_window = time.perf_counter()
    e2e, attempted, failed = kind.window(run, state)
    e2e["setup_s"] = t_window - t_start
    info = kind.traced(run, state) if trace else None
    peak = torch.cuda.max_memory_allocated() if run.on_card else 0
    kind.release(run, state)
    if run.on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = kind.check(run, state)
    run.sync()
    parts = {k: round(sum(e - s for s, e in v), 3) for k, v in run.spans.by_name.items()
             if k.startswith("setup.")}
    print(f"benchmark: setup {e2e['setup_s']:.3f} s {parts}, window and trace "
          f"{t_check - t_window:.3f} s, check {time.perf_counter() - t_check:.3f} s",
          file=log, flush=True)
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    device_info = {"platform": "gpu" if run.on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if run.on_card else "cpu",
                   "count": chips, "memory_peak_bytes": int(peak)}
    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    if trace:
        dt = run.device_trace
        device_info["busy_s"] = dt.busy_s()
        device_info["window_s"] = dt.wall_s
        metrics = {}
        for m in spec["per_layer"]:
            v = metric_reader(m["name"])(run, info)
            if v is not None:
                if not math.isfinite(v):
                    raise RunError(f"per-layer metric {m['name']} read {v}")
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    for k, v in metrics.items():
        if v["unit"] != units[k]:
            raise RunError(f"metric {k}: unit {v['unit']} against {units[k]}")
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace:
        result["breakdown"] = {"device_ops": run.device_trace.top_ops(10),
                               "idle_gaps": run.device_trace.idle_gaps(10)}
    if run.readings:
        result["readings"] = run.readings
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a non-negative whole number")
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                          t_start=t_start)
    except RunError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 1
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process holds {found} after the window: the port must not "
              f"load JAX or the JAX package", file=sys.stderr)
        return 1
    for n, c in result["checks"].items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
