"""The MNIST MLP (softmax regression, ``Dense_0`` only)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gpubench.reference.model import unflatten


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


def client_grads(config, flat, x, y):
    return mlp_grads(flat, config["layout"], x, y, config["num_classes"])
