"""ResNet-18 (He et al., arXiv:1512.03385, the CIFAR stem) with GroupNorm
(Wu and He, arXiv:1803.08494) in place of BatchNorm: a 3x3 stem conv, four
stages of two basic blocks at ``width * 2**i`` channels, the first block of
stages 1-3 at stride 2 with a 1x1 projection on its shortcut, a global mean
and ``Dense_0``.  Every norm is GroupNorm over 8 groups with epsilon 1e-6,
and every conv pads as flax's ``SAME``: ``max((ceil(H/s) - 1) s + k - H, 0)``
in all, the smaller half before.  The convs have no bias.  Per-client
gradients by one autograd pass a client."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gpubench.reference.model import unflatten

GROUPS = 8
EPS = 1e-6
#: basic blocks per stage
STAGES = (2, 2, 2, 2)


def conv(x, kernel, stride=1):
    """``x`` NCHW by an HWIO kernel, with SAME padding."""
    k, pads = kernel.shape[0], []
    for size in (x.shape[3], x.shape[2]):
        total = max((math.ceil(size / stride) - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), kernel.permute(3, 2, 0, 1), stride=stride)


def norm(x, p, name):
    return F.group_norm(x, GROUPS, p[f"{name}/scale"], p[f"{name}/bias"], EPS)


def forward(p, x, hwc):
    x = x.reshape((x.shape[0],) + hwc).permute(0, 3, 1, 2)
    x = F.relu(norm(conv(x, p["Conv_0/kernel"]), p, "GroupNorm_0"))
    block = 0
    for stage, count in enumerate(STAGES):
        for j in range(count):
            b = f"BasicBlock_{block}"
            stride = 2 if stage > 0 and j == 0 else 1
            y = F.relu(norm(conv(x, p[f"{b}/Conv_0/kernel"], stride), p, f"{b}/GroupNorm_0"))
            y = norm(conv(y, p[f"{b}/Conv_1/kernel"]), p, f"{b}/GroupNorm_1")
            if f"{b}/Conv_2/kernel" in p:
                x = norm(conv(x, p[f"{b}/Conv_2/kernel"], stride), p, f"{b}/GroupNorm_2")
            x = F.relu(y + x)
            block += 1
    return x.mean(dim=(2, 3)) @ p["Dense_0/kernel"] + p["Dense_0/bias"]


def client_grads(config, flat, x, y):
    hwc = tuple(config["input_shape"])
    out = torch.empty((x.shape[0], flat.numel()), dtype=flat.dtype, device=flat.device)
    with torch.enable_grad():
        leaf = flat.detach().clone().requires_grad_(True)
        p = unflatten(leaf, config["layout"])
        for k in range(x.shape[0]):
            loss = F.cross_entropy(forward(p, x[k], hwc), y[k])
            out[k] = torch.autograd.grad(loss, leaf)[0]
    return out
