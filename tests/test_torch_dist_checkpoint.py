"""Structured params checkpoints on ``torch.distributed.checkpoint``
(``utils/checkpoint.py``): the four cases of the JAX package's
``tests/test_orbax_checkpoint.py`` on the port, bitwise, with JAX's
``round_{:06d}`` layout; a save cut before its ``.metadata`` never loads.
The two-rank save and load runs in ``tests/test_torch_parallel.py``."""

import os

import pytest
import torch

from byzantine_aircomp_tpu.utils import checkpoint as jckpt
from byzantine_aircomp_tpu_torch.utils import checkpoint as tckpt


@pytest.fixture
def params():
    return {"dense": {"kernel": torch.arange(12.0).reshape(3, 4),
                      "bias": torch.ones(4, dtype=torch.float32)}}


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and torch.equal(a, b)


def _bumped(params):
    return {"dense": {k: v + 1.0 for k, v in params["dense"].items()}}


def test_save_load_roundtrip(tmp_path, params):
    path = tckpt.save(str(tmp_path), "run_a", 7, params)
    assert "round_000007" in path
    assert path == jckpt.step_dir(str(tmp_path), "run_a", 7)
    out = tckpt.load(str(tmp_path), "run_a", params)
    assert out is not None
    round_idx, restored = out
    assert round_idx == 7 and _equal(restored, params)


def test_latest_round_selection(tmp_path, params):
    tckpt.save(str(tmp_path), "run_b", 1, params)
    tckpt.save(str(tmp_path), "run_b", 3, _bumped(params))
    assert tckpt.latest_round(str(tmp_path), "run_b") == 3
    round_idx, restored = tckpt.load(str(tmp_path), "run_b", params)
    assert round_idx == 3 and _equal(restored, _bumped(params))
    # the example tree is a template, never written into
    assert _equal(params, {"dense": {"kernel": torch.arange(12.0).reshape(3, 4),
                                     "bias": torch.ones(4)}})


def test_load_missing_returns_none(tmp_path, params):
    assert tckpt.load(str(tmp_path), "nope", params) is None
    assert tckpt.latest_round(str(tmp_path), "nope") is None


def test_explicit_round(tmp_path, params):
    tckpt.save(str(tmp_path), "run_c", 2, params)
    tckpt.save(str(tmp_path), "run_c", 5, _bumped(params))
    out = tckpt.load(str(tmp_path), "run_c", params, round_idx=2)
    assert out is not None and out[0] == 2 and _equal(out[1], params)
    assert tckpt.load(str(tmp_path), "run_c", params, round_idx=9) is None


def test_an_unfinished_save_is_skipped_and_a_save_overwrites(tmp_path, params):
    tckpt.save(str(tmp_path), "run_d", 1, params)
    tckpt.save(str(tmp_path), "run_d", 2, params)
    os.remove(os.path.join(tckpt.step_dir(str(tmp_path), "run_d", 2), ".metadata"))
    assert tckpt.latest_round(str(tmp_path), "run_d") == 1
    assert tckpt.load(str(tmp_path), "run_d", params, round_idx=2) is None
    tckpt.save(str(tmp_path), "run_d", 1, _bumped(params))
    assert _equal(tckpt.load(str(tmp_path), "run_d", params)[1], _bumped(params))
