"""The benchmark's own tests. The CPU ones run anywhere:

    python -m pytest benchmark/tests -q

Those marked ``card`` need an H100 and skip elsewhere; on the card run
them without the repository's JAX test plugin:

    python -m pytest -o addopts="" -p no:cacheprovider benchmark/tests -q -m card
"""

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA H100; skipped without one")


@pytest.fixture
def card():
    """Skips the test where no card is visible (decided here, at run time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark's measurements run only there")
    return torch.device("cuda")


def tiny_config(cfg: dict) -> dict:
    """The configuration at 48 x 48 with narrow widths: the CPU tests' size."""
    cfg = copy.deepcopy(cfg)
    cfg["image"].update(height=48, width=48)
    cfg["sp"].update(stages=[[4, 4], [8, 8], [8, 8, 8], [16, 16, 16], [16, 16, 16]],
                     fused_channels=16, decoder_channels=[16, 8, 8, 4])
    cfg["at"].update(feature_dim=16, hidden_size=16)
    cfg["lf"].update(channels=[4, 4, 2])
    return cfg


TINY_TRAFFIC = {
    "clip": {"batch": 8, "steps": 3, "distinct_streams": 4, "pool": 2, "calibration_pairs": 2},
    "serve": {"slots": 8, "distinct_streams": 4, "sequence_frames": 6, "rate_hz": 8.0,
              "calibration_pairs": 2, "warmup_ticks": 2},
    "train": {"batch": 8, "sequences": 4},
}


def tiny_spec(name: str) -> dict:
    """Cell ``name`` at the CPU tests' size."""
    from benchmark import harness

    spec = copy.deepcopy(harness.cell_spec(name))
    spec["config"] = tiny_config(spec["config"])
    spec["traffic"].update(TINY_TRAFFIC[spec["traffic"]["kind"]])
    return spec


def load(path) -> dict:
    return json.loads(Path(path).read_text())
