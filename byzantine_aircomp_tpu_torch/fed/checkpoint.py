"""Checkpoint / resume.

Port of ``byzantine_aircomp_tpu/fed/checkpoint.py``.  The reference's
``--inherit`` flag is dead (parsed at ``MNIST_Air_weight.py:22``, read at
``:500``, never used) and only end-of-run metrics are pickled.  Here, as in
the JAX package, the flat parameter vector and the round index are written
after every round, and ``--inherit`` restores them.

Format: one ``.npz`` per run (atomic-rename write) with the JAX package's
keys: ``round_idx``, ``flat_params`` (the JAX flat layout, :mod:`..ops.flatten`),
``opt_{i}`` for the extra state leaves in order (``harness.extra_state``)
and ``meta_json`` for an opaque string.  Either package reads the other's
files.  Every array is written as numpy on the host.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import io as io_lib


def checkpoint_file(ckpt_dir: str, title: str) -> str:
    return os.path.join(ckpt_dir, title + ".ckpt.npz")


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save(
    ckpt_dir: str,
    title: str,
    round_idx: int,
    flat_params,
    opt_leaves=(),
    meta: Optional[str] = None,
) -> str:
    """Write params (+ extra state leaves, in ``harness.extra_state`` order)
    atomically.  ``meta`` is an opaque string (the harness stores the
    run's metric paths as JSON) that rides the same atomic write, so a
    crash can never leave params and paths at different rounds."""
    path = checkpoint_file(ckpt_dir, title)
    # host copies BEFORE the temp file exists: a device error here must not
    # leave one behind
    flat_host = _host(flat_params)
    extras = {f"opt_{i}": _host(leaf) for i, leaf in enumerate(opt_leaves)}
    if meta is not None:
        extras["meta_json"] = np.asarray(meta)
    return io_lib.atomic_write(
        path,
        lambda f: np.savez(f, round_idx=round_idx, flat_params=flat_host, **extras),
    )


def load(ckpt_dir: str, title: str) -> Optional[Tuple[int, np.ndarray, list]]:
    """Returns (round_idx, flat_params, opt_leaves) as numpy, or None."""
    path = checkpoint_file(ckpt_dir, title)
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        n_opt = sum(1 for k in z.files if k.startswith("opt_"))
        opt_leaves = [z[f"opt_{i}"] for i in range(n_opt)]
        return int(z["round_idx"]), z["flat_params"], opt_leaves


def load_meta(ckpt_dir: str, title: str) -> Optional[str]:
    """The opaque ``meta`` string saved with the checkpoint, or None when
    the file (or the key) is absent."""
    path = checkpoint_file(ckpt_dir, title)
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if "meta_json" not in z.files:
            return None
        return str(z["meta_json"])
