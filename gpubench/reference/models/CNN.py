"""The reference CNN (``MNIST_Air_weight.py:63-90``): two 5x5 'same' convs,
each with relu and a 2x2 max-pool, then two dense layers."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gpubench.reference.model import unflatten


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
    return cnn_grads(flat, config["layout"], x, y, tuple(config["input_shape"]))
