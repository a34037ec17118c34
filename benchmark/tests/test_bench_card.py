"""On the card, at each cell's own size: the program comes out correct and
its control (the lower precision the cell's ``workloads/<cell>.json``
names) does not, on three seeds. Readings that set the limits are taken
with ``benchmark/control.py``; these tests hold the limits to them."""

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT, load

CELLS = [w["name"] for w in load(ROOT / "BENCHMARK.json")["workloads"]]
SEEDS = (2 ** 33 + 101, 2 ** 33 + 202, 2 ** 33 + 303)
SECONDS = 5.0


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(card, cell):
    r = harness.run_cell(cell, SEEDS[0], SECONDS)
    assert r["correct"], r["checks"]


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell, seed):
    r = harness.run_cell(cell, seed, SECONDS, variant="control")
    assert not r["correct"], r["checks"]
