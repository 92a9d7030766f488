"""The whole round's share of the device's f32 peak: the training FLOPs the
model needs (``counts/<config>.py``) times batch x K x the iterations the
untraced window completed, over its seconds and the published peak."""

from gpubench import cells
from gpubench.counts import peak


def read(r):
    top = peak(r.device_kind, "f32_flops_per_s")
    if top is None or r.window_s <= 0:
        return None
    per_sample = cells.module("counts", r.config["name"]).train_flops_per_sample(r.config)
    flops = per_sample * r.config["batch_size"] * r.clients * r.iterations(r.rounds)
    return 100.0 * flops / r.window_s / top
