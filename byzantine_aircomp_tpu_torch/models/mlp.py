"""MLP: despite the name, a single linear softmax-regression layer.

Mirrors the reference ``MLP`` (``MNIST_Air_weight.py:53-61``) and
``byzantine_aircomp_tpu/models/mlp.py``: input flattened to
[batch, H*W*C], one ``Linear(input_size, num_classes)``; 7,850 params for
MNIST (784 -> 10).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..registry import MODELS
from .initializers import bias_001_, xavier_normal_relu_


class MLP(nn.Module):
    SPATIAL_INPUT = False  # takes the trainer's flat rows

    def __init__(
        self,
        input_shape: Tuple[int, ...] = (28, 28),
        num_classes: int = 10,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.fc = nn.Linear(math.prod(input_shape), num_classes)
        xavier_normal_relu_(self.fc.weight, generator)
        bias_001_(self.fc.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x.reshape(x.shape[0], -1))


@MODELS.register("MLP", aliases=("mlp",), graphable=True)
def make_mlp(input_shape=(28, 28), num_classes: int = 10, generator=None, **_):
    return MLP(input_shape, num_classes, generator)
