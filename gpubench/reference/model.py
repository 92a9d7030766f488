"""The models' per-client gradients, in plain float32 PyTorch.

The flat weight vector is laid out as the configuration's ``layout`` says:
the leaves in order, each a row-major array (a dense kernel as [in, out], a
conv kernel as [kh, kw, in, out], the first dense layer's input in
height-width-channel order).  ``grads(x, y)`` gives the [K, d] gradients of
each client's mean cross entropy over its own batch ``x`` [K, B, features].
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F


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


def mlp_grads(flat, layout, x, y, num_classes):
    """Softmax regression: the gradients in closed form, for all clients at
    once (two batched products)."""
    p = unflatten(flat, layout)
    w, b = p["Dense_0/kernel"], p["Dense_0/bias"]
    x = x.reshape(x.shape[0], x.shape[1], -1)
    logits = torch.einsum("kbi,io->kbo", x, w) + b
    err = (torch.softmax(logits, dim=-1) - F.one_hot(y, num_classes).to(x.dtype)) / x.shape[1]
    grads = {"Dense_0/kernel": torch.einsum("kbi,kbo->kio", x, err), "Dense_0/bias": err.sum(1)}
    k = x.shape[0]
    return torch.cat([grads[name].reshape(k, -1) for name, _ in layout], dim=1)


def cnn_forward(p, x, hw):
    h, w = hw
    x = x.reshape(x.shape[0], 1, h, w)
    x = F.max_pool2d(F.relu(F.conv2d(x, p["Conv_0/kernel"].permute(3, 2, 0, 1),
                                     p["Conv_0/bias"], padding=2)), 2)
    x = F.max_pool2d(F.relu(F.conv2d(x, p["Conv_1/kernel"].permute(3, 2, 0, 1),
                                     p["Conv_1/bias"], padding=2)), 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.relu(x @ p["Dense_0/kernel"] + p["Dense_0/bias"])
    return x @ p["Dense_1/kernel"] + p["Dense_1/bias"]


def cnn_grads(flat, layout, x, y, hw):
    """The reference CNN: one autograd pass per client."""
    out = torch.empty((x.shape[0], flat.numel()), dtype=flat.dtype, device=flat.device)
    with torch.enable_grad():
        leaf = flat.detach().clone().requires_grad_(True)
        p = unflatten(leaf, layout)
        for k in range(x.shape[0]):
            loss = F.cross_entropy(cnn_forward(p, x[k], hw), y[k])
            out[k] = torch.autograd.grad(loss, leaf)[0]
    return out


def client_grads(config, flat, x, y):
    """[K, d] per-client gradients of the configuration's model."""
    if config["model"] == "MLP":
        return mlp_grads(flat, config["layout"], x, y, config["num_classes"])
    if config["model"] == "CNN":
        return cnn_grads(flat, config["layout"], x, y, tuple(config["input_shape"]))
    raise ValueError(f"no reference for the model {config['model']!r}")
