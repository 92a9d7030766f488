"""Weight initialization matching the reference.

The reference initializes every Conv and Linear with xavier-normal scaled by the
relu gain (sqrt(2)) and constant bias 0.01 (``MNIST_Air_weight.py:92-95``);
port of ``byzantine_aircomp_tpu/models/initializers.py``.  Draws come from
an explicit ``torch.Generator``, so they never match JAX's threefry draws:
the interop module carries JAX weights across where two runs must agree.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

RELU_GAIN = math.sqrt(2.0)


@torch.no_grad()
def xavier_normal_relu_(
    weight: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    gain: float = RELU_GAIN,
) -> torch.Tensor:
    """In place: N(0, std^2) with std = gain * sqrt(2 / (fan_in + fan_out)),
    i.e. ``nn.init.xavier_normal_(w, gain=calculate_gain('relu'))`` and
    JAX's ``variance_scaling(gain^2, "fan_avg", "normal")``: for a Linear
    [out, in] fan_in = in, fan_out = out; for a Conv2d [out, in, kh, kw]
    fan_in = in*kh*kw, fan_out = out*kh*kw."""
    receptive = weight[0][0].numel() if weight.dim() > 2 else 1
    fan_out, fan_in = weight.shape[0] * receptive, weight[0].numel()
    std = gain * math.sqrt(2.0 / (fan_in + fan_out))
    draw = torch.randn(weight.shape, generator=generator, dtype=weight.dtype)
    return weight.copy_(std * draw)


@torch.no_grad()
def bias_001_(bias: torch.Tensor) -> torch.Tensor:
    """Constant 0.01 bias (reference ``nn.init.constant_(m.bias, 0.01)``)."""
    return bias.fill_(0.01)
