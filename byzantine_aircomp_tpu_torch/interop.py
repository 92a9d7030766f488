"""Carry weights between the JAX package and the port.

The JAX package's parameters arrive as numpy: either the flax tree
(``{'params': {'Dense_0': {'bias': [out], 'kernel': [in, out]}}}``, nested
as deep as the model: ``{'BasicBlock_0': {'Conv_0': {'kernel': ...}}}``)
or its flat [d] vector.  :func:`from_jax` returns the port's module state dict and
flat vector; :func:`to_jax` is its inverse (the tests use it to round-trip).
The layout mapping itself lives in :mod:`.ops.flatten`.

The JAX package's packed sign words are ``uint32``; the port carries them as
``int32`` with the same bits (:func:`sign_words_from_jax`,
:func:`sign_words_to_jax`).
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch

from .ops import flatten as flatten_lib


def from_jax(
    params: Union[dict, np.ndarray], spec: flatten_lib.FlatSpec
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """JAX parameters (flax tree or flat [d], as numpy) ->
    ``(state_dict, flat [d] float32)`` on the CPU."""
    if isinstance(params, dict):
        tree = params.get("params", params)
        parts = []
        for leaf in spec.leaves:
            node = tree
            for key in leaf.jax_path:
                node = node[key]
            parts.append(np.asarray(node, np.float32).reshape(-1))
        flat = np.concatenate(parts)
    else:
        flat = np.asarray(params, np.float32).reshape(-1)
    if flat.size != spec.total:
        raise ValueError(
            f"JAX parameters hold {flat.size} values, the port's model {spec.total}"
        )
    flat_t = torch.from_numpy(flat.copy())
    state = {k: v.clone() for k, v in flatten_lib.unflatten(flat_t, spec).items()}
    return state, flat_t


def to_jax(
    params: Union[Dict[str, torch.Tensor], torch.Tensor],
    spec: flatten_lib.FlatSpec,
) -> Tuple[dict, np.ndarray]:
    """Port parameters (state dict or flat [d]) -> ``(flax tree, flat [d])``
    as numpy float32."""
    if isinstance(params, dict):
        flat_t = flatten_lib.flatten(params, spec)
    else:
        flat_t = params
    flat = flat_t.detach().cpu().to(torch.float32).numpy().copy()
    tree: dict = {}
    for leaf in spec.leaves:
        node = tree
        for key in leaf.jax_path[:-1]:
            node = node.setdefault(key, {})
        node[leaf.jax_path[-1]] = (
            flat[leaf.offset : leaf.offset + leaf.size].reshape(leaf.jax_shape)
        )
    return {"params": tree}, flat


def sign_words_from_jax(words: np.ndarray) -> torch.Tensor:
    """JAX packed sign words (``uint32`` [K, W]) -> the port's ``int32``
    [K, W] with the same bits."""
    w = np.ascontiguousarray(words)
    if w.dtype != np.uint32:
        raise TypeError(f"sign words must be uint32, got {w.dtype}")
    return torch.from_numpy(w.view(np.int32).copy())


def sign_words_to_jax(words: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`sign_words_from_jax`: ``int32`` -> ``uint32``."""
    if words.dtype != torch.int32:
        raise TypeError(f"sign words must be int32, got {words.dtype}")
    return words.detach().cpu().contiguous().numpy().view(np.uint32).copy()
