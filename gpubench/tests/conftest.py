"""The benchmark's CPU tests: the repository's root on the import path, and
the ``cuda`` marker's fixture (a test that needs the card skips without
one, decided when it runs)."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: TF32 exists only on the card")
    return torch.device("cuda")


# each cell at a size a CPU test run holds: fewer clients (the AirComp gm
# keeps its 50, below which its noisy receiver diverges, with fewer steps),
# a smaller data set, and the CNN at one iteration a round (over ten, the
# median of five clients turns rounding into gaps of a few percent)
TINY = {
    "mlp.gm2.k1000.r2": ({}, dict(honest_size=8, byz_size=2)),
    "cnn.median-var.k50.r1": ({"display_interval": 1}, dict(honest_size=4, byz_size=1)),
    "mlp.gm-var.k50.r2": ({"agg_maxiter": 30}, {}),
    "mlp.trimmed_mean-var.k1000.r10": ({}, dict(honest_size=18, byz_size=2,
                                             rounds_per_dispatch=2)),
}


def tiny_cell(name):
    """``(workload, configuration, traffic)`` of a cell at the CPU size."""
    from gpubench import cells

    work, config, cell = cells.cell(name)
    config_over, cell_over = TINY[name]
    config = dict(config, train_size=3000, val_size=500, **config_over)
    cell = dict(cell, check_dispatches=2, **cell_over)
    return work, config, cell


@pytest.fixture
def tiny():
    return tiny_cell
