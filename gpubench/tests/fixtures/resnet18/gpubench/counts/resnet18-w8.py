"""Training FLOPs of ResNet-18 at the configuration's width and input: each
conv's multiply-adds at its output's size (a stage halves it), the
projections and ``Dense_0``; forward, the weight gradient and every input
gradient but the stem's, at 2 FLOPs per multiply-add.  GroupNorm, relu and
the mean are left out."""

import math


def train_flops_per_sample(config) -> int:
    p = dict((name, shape) for name, shape in config["layout"])
    h, w, _ = config["input_shape"]
    macs = [h * w * math.prod(p["Conv_0/kernel"])]
    block = 0
    for stage in range(4):
        for j in range(2):
            b = f"BasicBlock_{block}"
            if stage > 0 and j == 0:
                h, w = math.ceil(h / 2), math.ceil(w / 2)
            for c in ("Conv_0", "Conv_1", "Conv_2"):
                if f"{b}/{c}/kernel" in p:
                    macs.append(h * w * math.prod(p[f"{b}/{c}/kernel"]))
            block += 1
    macs.append(math.prod(p["Dense_0/kernel"]))
    return 2 * (2 * sum(macs) + sum(macs[1:]))
