"""ResNet-18 (CIFAR-10 variant), port of
``byzantine_aircomp_tpu/models/resnet.py``.

* GroupNorm (8 groups, flax's epsilon 1e-6) instead of BatchNorm: its
  statistics are per sample, so they commute with weight-space
  aggregation across clients.
* CIFAR stem: a 3x3 conv, no max-pool; then four stages of two basic
  blocks at ``width * 2**i`` channels, the first block of stages 1-3 at
  stride 2 with a 1x1 projection conv and GroupNorm on the shortcut; a
  global mean and ``Dense_0``.  11,173,962 params at width 64 on CIFAR-10.
* Every conv pads as flax's ``SAME`` does: ``max((ceil(H/s) - 1) s + k - H,
  0)`` in all, the smaller half before.  A 3x3 stride-2 conv on an even
  input pads (0, 1), not torch's symmetric (1, 1), so its windows start
  on even rows and columns.
* Layers are named as flax names them (``BasicBlock_i.Conv_j``,
  ``GroupNorm_j``; ``Conv_2`` and ``GroupNorm_2`` are the projection), so
  the flat vector is the JAX package's.

``remat=True`` recomputes each block's activations in the backward pass,
as the JAX model's ``nn.remat`` does: the trainer takes per-client
gradients under ``vmap(grad)``, where ``torch.utils.checkpoint`` does not
run (saved-tensor hooks and the reentrant mode are both refused there), so
each block is a ``torch.autograd.Function`` that keeps only its input and
parameters and, in its backward, runs the block again under
``torch.func.vjp``.  The gradients are those of ``remat=False``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call, vjp

from ..registry import MODELS
from .cnn import nhwc_shape, to_nchw
from .initializers import bias_001_, xavier_normal_relu_

GROUPS = 8
GN_EPS = 1e-6  # flax GroupNorm's default (torch's is 1e-5)
STAGE_SIZES = (2, 2, 2, 2)  # basic blocks per stage: ResNet-18


def same_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (built with padding 0) on ``x`` with flax's SAME padding."""
    pads = []
    for size, k, s in zip(reversed(x.shape[2:]), reversed(conv.kernel_size),
                          reversed(conv.stride)):
        total = max((math.ceil(size / s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    if any(pads):
        x = F.pad(x, pads)
    return conv(x)


def _conv(cin: int, cout: int, k: int, stride: int, generator) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, k, stride=stride, bias=False)
    xavier_normal_relu_(conv.weight, generator)
    return conv


def _norm(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(GROUPS, c, eps=GN_EPS)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, strides: int, generator=None):
        super().__init__()
        self.Conv_0 = _conv(cin, features, 3, strides, generator)
        self.GroupNorm_0 = _norm(features)
        self.Conv_1 = _conv(features, features, 3, 1, generator)
        self.GroupNorm_1 = _norm(features)
        self.project = cin != features or strides != 1
        if self.project:
            self.Conv_2 = _conv(cin, features, 1, strides, generator)
            self.GroupNorm_2 = _norm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.GroupNorm_0(same_conv(self.Conv_0, x)))
        y = self.GroupNorm_1(same_conv(self.Conv_1, y))
        if self.project:
            x = self.GroupNorm_2(same_conv(self.Conv_2, x))
        return F.relu(y + x)


class _Remat(torch.autograd.Function):
    """One block whose backward recomputes its forward (``nn.remat``)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(block, names, x, *params):
        return functional_call(block, dict(zip(names, params)), (x,))

    @staticmethod
    def setup_context(ctx, inputs, output):
        block, names, x, *params = inputs
        ctx.block, ctx.names = block, names
        ctx.save_for_backward(x, *params)

    @staticmethod
    def backward(ctx, grad_out):
        x, *params = ctx.saved_tensors

        def run(x, *params):
            return functional_call(ctx.block, dict(zip(ctx.names, params)), (x,))

        with torch.enable_grad():
            _, pullback = vjp(run, x, *params)
            # the trainer's torch.func.grad runs its backward with
            # create_graph=True; the graph of the recompute would keep every
            # recomputed activation alive to its end, so it is cut here
            grads = [g.detach() for g in pullback(grad_out)]
        return (None, None, *grads)


class ResNet18(nn.Module):
    def __init__(
        self,
        input_shape: Tuple[int, ...] = (32, 32, 3),
        num_classes: int = 10,
        width: int = 64,
        remat: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if width % GROUPS:
            raise ValueError(
                f"ResNet18 width must be a multiple of 8 (GroupNorm groups), got {width}"
            )
        self.hwc = nhwc_shape(input_shape)
        self.remat = remat
        self.Conv_0 = _conv(self.hwc[2], width, 3, 1, generator)
        self.GroupNorm_0 = _norm(width)
        cin, n_block = width, 0
        for i, count in enumerate(STAGE_SIZES):
            features = width * 2**i
            for j in range(count):
                strides = 2 if i > 0 and j == 0 else 1
                self.add_module(f"BasicBlock_{n_block}",
                                BasicBlock(cin, features, strides, generator))
                cin = features
                n_block += 1
        self.n_blocks = n_block
        self.Dense_0 = nn.Linear(cin, num_classes)
        xavier_normal_relu_(self.Dense_0.weight, generator)
        bias_001_(self.Dense_0.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = to_nchw(x, self.hwc)
        x = F.relu(self.GroupNorm_0(same_conv(self.Conv_0, x)))
        for i in range(self.n_blocks):
            block = getattr(self, f"BasicBlock_{i}")
            if self.remat:
                names, params = zip(*block.named_parameters())
                x = _Remat.apply(block, names, x, *params)
            else:
                x = block(x)
        return self.Dense_0(torch.mean(x, dim=(2, 3)))


@MODELS.register("ResNet18", aliases=("resnet18",), graphable=True)
def make_resnet18(input_shape=(32, 32, 3), num_classes: int = 10, width: int = 64,
                  remat: bool = False, generator=None, **_):
    return ResNet18(input_shape, num_classes, width, remat, generator)
