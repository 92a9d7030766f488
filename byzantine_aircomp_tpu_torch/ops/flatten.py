"""Parameters <-> flat vector, in the JAX package's layout.

The flat vector is the federated state: client weights are stacked as
[K, d] rows of it.  Its layout must be the JAX package's coordinate for
coordinate, or no stack comparison between the two means anything.

flax names a layer by its class and its count among its siblings of that
class (``Dense_0``, ``Conv_1``, ``GroupNorm_2``), nests the names of
submodules (``BasicBlock_3/Conv_0/kernel``), and ``jax.tree.flatten``
orders the leaves by their dict keys, sorted as strings at every level.
The port's models build from ``nn.Linear``, ``nn.Conv2d`` and
``nn.GroupNorm`` layers, named after flax where a model gives its layers
names (``self.Conv_0``) and numbered in registration order per parent and
class where it does not (the MLP's ``fc`` is ``Dense_0``).  Each torch
tensor maps onto its flax leaf by a permutation of its axes:

* ``Linear.weight`` [out, in] is ``Dense.kernel`` [in, out] transposed;
* ``Conv2d.weight`` OIHW is ``Conv.kernel`` HWIO permuted;
* ``GroupNorm.weight`` is ``scale``; every ``bias`` is ``bias``.

This module owns that mapping (the interop module reuses it).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

# leaf layer class -> (flax class name, {torch tensor: (flax leaf, torch -> flax axes)})
_LAYERS = (
    (nn.Linear, "Dense", {"weight": ("kernel", (1, 0)), "bias": ("bias", None)}),
    (nn.Conv2d, "Conv", {"weight": ("kernel", (2, 3, 1, 0)), "bias": ("bias", None)}),
    (nn.GroupNorm, "GroupNorm", {"weight": ("scale", None), "bias": ("bias", None)}),
)
_FLAX_NAME = re.compile(r"^[A-Za-z]\w*_\d+$")


@dataclass(frozen=True)
class FlatLeaf:
    """One parameter: its torch name, its flax path and JAX shape, its
    slice of the flat vector, and ``perm``, the axes that take the torch
    tensor to the flax leaf (None where the two layouts agree)."""

    torch_name: str
    jax_path: Tuple[str, ...]
    jax_shape: Tuple[int, ...]
    offset: int
    size: int
    perm: Optional[Tuple[int, ...]]

    @property
    def inverse_perm(self) -> Optional[Tuple[int, ...]]:
        if self.perm is None:
            return None
        return tuple(sorted(range(len(self.perm)), key=self.perm.__getitem__))


@dataclass(frozen=True)
class FlatSpec:
    leaves: Tuple[FlatLeaf, ...]
    total: int


def _layer_kind(module: nn.Module):
    for cls, kind, tensors in _LAYERS:
        if type(module) is cls:
            return kind, tensors
    return None


def _collect(module: nn.Module, torch_prefix: str, jax_prefix: Tuple[str, ...], out: list):
    counts: Dict[str, int] = {}
    for name, child in module.named_children():
        layer = _layer_kind(child)
        if layer is None:
            if any(True for _ in child.parameters()):
                _collect(child, f"{torch_prefix}{name}.", jax_prefix + (name,), out)
            continue
        kind, tensors = layer
        flax_name = f"{kind}_{counts.get(kind, 0)}"
        counts[kind] = counts.get(kind, 0) + 1
        if _FLAX_NAME.match(name) and name != flax_name:
            raise ValueError(
                f"layer {torch_prefix}{name} is flax's {flax_name}: name it so, "
                "or register the layers of its class in flax's order"
            )
        for tname, p in child.named_parameters(recurse=False):
            leaf, perm = tensors[tname]
            shape = tuple(p.shape) if perm is None else tuple(p.shape[a] for a in perm)
            out.append((jax_prefix + (flax_name, leaf), f"{torch_prefix}{name}.{tname}",
                        shape, perm))
    own = [n for n, _ in module.named_parameters(recurse=False)]
    if own:
        raise ValueError(f"parameters outside Linear/Conv2d/GroupNorm layers: {own}")


def make_flat_spec(module: nn.Module) -> FlatSpec:
    """Layout of a model built from ``nn.Linear``, ``nn.Conv2d`` and
    ``nn.GroupNorm`` layers, in ``jax.tree.flatten``'s leaf order."""
    found: list = []
    _collect(module, "", (), found)
    leaves, offset = [], 0
    for path, torch_name, shape, perm in sorted(found, key=lambda f: f[0]):
        size = 1
        for n in shape:
            size *= n
        leaves.append(FlatLeaf(torch_name, path, shape, offset, size, perm))
        offset += size
    if offset != sum(p.numel() for p in module.parameters()):
        raise ValueError(
            "make_flat_spec supports models built from nn.Linear, nn.Conv2d and "
            "nn.GroupNorm layers only"
        )
    return FlatSpec(tuple(leaves), offset)


def flatten(params: Dict[str, torch.Tensor], spec: FlatSpec) -> torch.Tensor:
    """torch parameters (name -> tensor) -> [d] float32 vector."""
    parts = []
    for leaf in spec.leaves:
        p = params[leaf.torch_name]
        if leaf.perm is not None:
            p = p.permute(leaf.perm)
        parts.append(p.reshape(-1).to(torch.float32))
    return torch.cat(parts)


def unflatten(vector: torch.Tensor, spec: FlatSpec) -> Dict[str, torch.Tensor]:
    """[d] vector -> torch parameters (name -> tensor, views of ``vector``),
    ready for ``torch.func.functional_call``."""
    out = {}
    for leaf in spec.leaves:
        v = vector[leaf.offset : leaf.offset + leaf.size].reshape(leaf.jax_shape)
        out[leaf.torch_name] = v if leaf.perm is None else v.permute(leaf.inverse_perm)
    return out
