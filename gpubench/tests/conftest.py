"""The benchmark's CPU tests: the repository's root on the import path, and
the ``cuda`` marker's fixture (a test that needs the card skips without
one, decided when it runs)."""

import json
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


#: what every cell's CPU test cuts: a smaller data set and two checked
#: dispatches; each cell cuts more in ``gpubench/tiny/<cell>.json``
TINY_CONFIG = {"train_size": 3000, "val_size": 500}
TINY_TRAFFIC = {"check_dispatches": 2}


def tiny_cell(name):
    """``(workload, configuration, traffic)`` of a cell at the CPU size: the
    cell's own files with :data:`TINY_CONFIG`, :data:`TINY_TRAFFIC` and its
    ``gpubench/tiny/<cell>.json`` (``config``, ``traffic``) over them."""
    from gpubench import cells

    work, config, cell = cells.cell(name)
    tiny = json.loads((cells.HERE / "tiny" / f"{name}.json").read_text())
    config = {**config, **TINY_CONFIG, **tiny.get("config", {})}
    cell = {**cell, **TINY_TRAFFIC, **tiny.get("traffic", {})}
    return work, config, cell


@pytest.fixture
def tiny():
    return tiny_cell
