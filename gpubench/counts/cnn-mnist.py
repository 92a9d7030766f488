"""Training FLOPs of the reference CNN: conv 1->32 5x5 at 28x28 (627,200
multiply-adds), conv 32->64 5x5 at 14x14 (10,035,200), dense 3136->1024
(3,211,264), dense 1024->10 (10,240); forward and weight gradient each
13,883,904 multiply-adds, the input gradients of all but the first layer
13,256,704: 82,049,024 FLOPs a sample."""

from gpubench.counts import dense_conv_flops


def train_flops_per_sample(config) -> int:
    return dense_conv_flops(config)
