"""CNN matching the reference architecture.

Reference ``CNN`` (``MNIST_Air_weight.py:63-90``), port of
``byzantine_aircomp_tpu/models/cnn.py``: conv(C->32, 5x5, pad 2) + ReLU +
maxpool2 -> conv(32->64, 5x5, pad 2) + ReLU + maxpool2 -> fc(64*H/4*W/4 ->
fc_width) + ReLU -> fc(fc_width -> classes).  MNIST: fc_width 1024, 10
classes, 3,274,634 params; CIFAR-10 (32x32x3): 4,259,274; EMNIST byclass
(fc_width 2048, 62 classes): 6,603,710.

The JAX model is NHWC.  This one takes rows in that layout (flat [B,
H*W*C] as the trainer gathers them, or [B, H, W(, C)]), runs the convs in
torch's NCHW, and flattens the last feature map back in NHWC order, so
that ``Dense_0``'s input coordinates are flax's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..registry import MODELS
from .initializers import bias_001_, xavier_normal_relu_


def nhwc_shape(input_shape: Tuple[int, ...]) -> Tuple[int, int, int]:
    """(H, W, C) of an image shape, C = 1 for a [H, W] image."""
    h, w = input_shape[:2]
    return h, w, input_shape[2] if len(input_shape) == 3 else 1


def to_nchw(x: torch.Tensor, hwc: Tuple[int, int, int]) -> torch.Tensor:
    """NHWC rows (flat or not) -> an NCHW batch."""
    return x.reshape((x.shape[0],) + hwc).permute(0, 3, 1, 2)


class CNN(nn.Module):
    def __init__(
        self,
        input_shape: Tuple[int, ...] = (28, 28),
        num_classes: int = 10,
        fc_width: int = 1024,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.hwc = nhwc_shape(input_shape)
        h, w, c = self.hwc
        self.Conv_0 = nn.Conv2d(c, 32, 5, padding=2)
        self.Conv_1 = nn.Conv2d(32, 64, 5, padding=2)
        self.Dense_0 = nn.Linear(64 * (h // 4) * (w // 4), fc_width)
        self.Dense_1 = nn.Linear(fc_width, num_classes)
        for layer in (self.Conv_0, self.Conv_1, self.Dense_0, self.Dense_1):
            xavier_normal_relu_(layer.weight, generator)
            bias_001_(layer.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = to_nchw(x, self.hwc)
        x = F.max_pool2d(F.relu(self.Conv_0(x)), 2)
        x = F.max_pool2d(F.relu(self.Conv_1(x)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC, flax's order
        return self.Dense_1(F.relu(self.Dense_0(x)))


@MODELS.register("CNN", aliases=("cnn",), graphable=True)
def make_cnn(input_shape=(28, 28), num_classes: int = 10, fc_width: int = 1024,
             generator=None, **_):
    # the EMNIST variant widens fc1 to 2048 (EMNIST_Air_weight.py:80-82)
    return CNN(input_shape, num_classes, fc_width, generator)
