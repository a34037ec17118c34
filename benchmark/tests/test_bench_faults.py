"""A whole run of each kind on the CPU with the timed path broken
underneath (``faults.py``), past the harness's look for a card: the
check comes out false. The limits are set at this size the way the
cells' limits are set at theirs: over the sound program's own reading
on the same seed (three times it, and a floor), so what a fault moves
is held against what rounding moves here."""

import copy

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import tiny_spec

SEED = 2 ** 35 + 9
FAULTS = {
    "clip.turbo.b128": ("state_unchanged", "answer_altered"),
    "clip.production.b128": ("state_unchanged", "answer_altered"),
    "serve.turbo.s128": ("state_unchanged", "answer_altered"),
    "train.production.b128": ("state_unchanged", "half_batch"),
}
# the serve cell at a size where a frozen state moves the served gaze
SERVE = {"sequence_frames": 8, "rate_hz": 12.0}


def spec_of(cell: str) -> dict:
    spec = tiny_spec(cell)
    if cell.startswith("serve"):
        spec["traffic"].update(SERVE)
    return spec


def run(cell: str, variant: str, spec: dict) -> dict:
    torch.set_num_threads(2)
    return harness.run_cell(cell, SEED, 0.7, spec=spec, device="cpu", variant=variant)


@pytest.fixture(scope="module")
def limits():
    """Per cell, limits three times the sound program's readings."""
    out = {}
    for cell in FAULTS:
        r = run(cell, "program", spec_of(cell))
        assert list(r)[-1] == "checks"
        out[cell] = {k: 3 * c["value"] + (0.0 if k == "sentinel_misses" else 1e-3)
                     for k, c in r["checks"].items()}
    return out


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items() for f in fs])
def test_a_fault_fails_the_check(limits, cell, fault):
    spec = copy.deepcopy(spec_of(cell))
    spec["limits"] = limits[cell]
    assert run(cell, "program", spec)["correct"]
    r = run(cell, fault, spec)
    assert not r["correct"], r["checks"]
