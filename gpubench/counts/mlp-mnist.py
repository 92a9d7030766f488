"""Training FLOPs of the MNIST MLP (softmax regression, 784 -> 10): the
forward product and the weight gradient, 2 x 784 x 10 multiply-adds a
sample, 31,360 FLOPs; no input gradient (the first layer's)."""

from gpubench.counts import dense_conv_flops


def train_flops_per_sample(config) -> int:
    return dense_conv_flops(config)
