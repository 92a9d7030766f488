"""The models' per-client gradients, in plain float32 PyTorch.

The flat weight vector is laid out as the configuration's ``layout`` says:
the leaves in order, each a row-major array (a dense kernel as [in, out], a
conv kernel as [kh, kw, in, out], the first dense layer's input in
height-width-channel order).  Each model's gradients are in
``models/<model>.py`` (:mod:`.models`), found by the configuration's
``model``.
"""

from __future__ import annotations

import importlib
import math
from typing import Dict, List, Tuple

import torch


def leaves(layout) -> List[Tuple[str, Tuple[int, ...], int, int]]:
    """``(name, shape, offset, size)`` of each leaf of the flat vector."""
    out, off = [], 0
    for name, shape in layout:
        size = math.prod(shape)
        out.append((name, tuple(shape), off, size))
        off += size
    return out


def unflatten(flat: torch.Tensor, layout) -> Dict[str, torch.Tensor]:
    return {name: flat[off:off + size].reshape(shape)
            for name, shape, off, size in leaves(layout)}


def client_grads(config, flat, x, y):
    """[K, d] per-client gradients of the configuration's model."""
    name = f"{__package__}.models.{config['model']}"
    try:
        mod = importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"no reference for the model {config['model']!r}: no file "
                         f"gpubench/reference/models/{config['model']}.py") from None
    return mod.client_grads(config, flat, x, y)
