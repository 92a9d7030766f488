"""Structured params checkpoints on ``torch.distributed.checkpoint`` (JAX
``utils/checkpoint.py``, which uses orbax).

Complements the flat ``.npz`` path of ``fed.checkpoint`` (the [d] vector
and the round): this writes a params tree (a dict of tensors, nested or
not) under ``{ckpt_dir}/{title}/round_{round:06d}``, JAX's layout.  In a
process group every rank takes part in the save and writes its own shard
file (``__{rank}_0.distcp``), and rank 0 writes the ``.metadata`` last;
a step directory without it is an unfinished save and is never loaded.
With no process group one process writes and reads alone.
"""

from __future__ import annotations

import os
import shutil
import warnings
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

#: the file whose presence marks a finished save
_METADATA = ".metadata"


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def _quiet(fn, *a, **kw):
    """``fn`` with DCP's one-process notice silenced: with no process group
    a single process writing or reading alone is what is asked for."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        return fn(*a, **kw)


def step_dir(ckpt_dir: str, title: str, round_idx: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), title, f"round_{round_idx:06d}")


def _clone(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    raise TypeError(f"a params tree holds dicts and tensors, got {type(tree).__name__}")


def save(ckpt_dir: str, title: str, round_idx: int, params: Any) -> str:
    """Write the params tree (a dict of tensors) for ``round_idx``, over a
    save of the same round; returns the step dir.  Every rank of a process
    group calls it."""
    path = step_dir(ckpt_dir, title, round_idx)
    if not _distributed() or dist.get_rank() == 0:
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.makedirs(path)
    if _distributed():
        dist.barrier()
    _quiet(dcp.save, params, checkpoint_id=path)
    return path


def latest_round(ckpt_dir: str, title: str) -> Optional[int]:
    """The last round with a finished save, or None."""
    root = os.path.join(os.path.abspath(ckpt_dir), title)
    if not os.path.isdir(root):
        return None
    rounds = [
        int(name.split("_")[1])
        for name in os.listdir(root)
        if name.startswith("round_") and name.split("_")[1].isdigit()
        and os.path.isfile(os.path.join(root, name, _METADATA))
    ]
    return max(rounds) if rounds else None


def load(ckpt_dir: str, title: str, example_params: Any,
         round_idx: Optional[int] = None) -> Optional[Tuple[int, Any]]:
    """Restore ``(round_idx, params)``: the latest finished round unless
    ``round_idx`` is given, None when there is none.  ``example_params``
    gives the tree's structure, shapes, dtypes and devices (the freshly
    initialized tree); it is not modified."""
    if round_idx is None:
        round_idx = latest_round(ckpt_dir, title)
        if round_idx is None:
            return None
    path = step_dir(ckpt_dir, title, round_idx)
    if not os.path.isfile(os.path.join(path, _METADATA)):
        return None
    params = _clone(example_params)
    _quiet(dcp.load, params, checkpoint_id=path)
    return round_idx, params
