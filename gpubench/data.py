"""The benchmark's inputs, made on the device from ``--seed``: an
MNIST-shaped data set and the model's initial weights.  Both sides get
the same: the program its data set and weights, the reference its own copy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# rows made per call, so that the device holds little while it makes them
CHUNK = 10_000
# the std of the pixel noise around each class's prototype
PIXEL_NOISE = 0.35


def sub_seed(seed: int, key: int) -> int:
    """A 63-bit seed of ``(seed, key)``; the run's seed may be any integer."""
    hi, lo = np.random.SeedSequence([seed % 2**64, key]).generate_state(2)
    return ((int(hi) << 32) | int(lo)) & (2**63 - 1)


def make_data(config, seed: int, device, train_size=None, val_size=None):
    """Class prototypes uniform in [0.1, 0.9], each row its class's
    prototype plus Gaussian pixel noise, clipped and quantized to u8.
    Returns host arrays: ``x_train`` u8 [N, features], ``y_train`` int64
    [N], the normalized f32 ``x_train_f32``, ``x_val`` and ``y_val``."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 0))
    c, f = config["num_classes"], math.prod(config["input_shape"])
    mean, std = config["norm_stats"]
    protos = 0.1 + 0.8 * torch.rand((c, f), generator=g, device=device)

    def rows(n):
        xs, xf, ys = [], [], []
        for start in range(0, n, CHUNK):
            m = min(CHUNK, n - start)
            y = torch.randint(0, c, (m,), generator=g, device=device)
            x = protos[y] + PIXEL_NOISE * torch.randn((m, f), generator=g, device=device)
            u8 = torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)
            xs.append(u8.cpu())
            xf.append(((u8.to(torch.float32) / 255.0 - mean) / std).cpu())
            ys.append(y.cpu())
        return torch.cat(xs).numpy(), torch.cat(xf).numpy(), torch.cat(ys).numpy()

    x_tr, x_tr_f32, y_tr = rows(train_size or config["train_size"])
    _, x_va, y_va = rows(val_size or config["val_size"])
    return {"x_train": x_tr, "x_train_f32": x_tr_f32, "y_train": y_tr,
            "x_val": x_va, "y_val": y_va}


def on_device(data, device):
    """The train rows and labels as the reference reads them."""
    return {"x_train": torch.from_numpy(data["x_train"]).to(device),
            "y_train": torch.from_numpy(data["y_train"]).to(device)}


def init_std(shape) -> float:
    """Xavier normal with the relu gain: ``sqrt(2) * sqrt(2 / (fan_in +
    fan_out))``, for a dense kernel [in, out] or a conv kernel [kh, kw,
    in, out]."""
    receptive = math.prod(shape[:-2])
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    return math.sqrt(2.0) * math.sqrt(2.0 / (fan_in + fan_out))


def make_params(config, seed: int, device) -> torch.Tensor:
    """The flat initial weights [d] f32, in one draw on the device: every
    kernel's slice scaled to its init std, every bias 0.01."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    p = torch.randn(config["params"], generator=g, device=device)
    off = 0
    for name, shape in config["layout"]:
        size = math.prod(shape)
        if name.endswith("/bias"):
            p[off:off + size] = 0.01
        else:
            p[off:off + size] *= init_std(shape)
        off += size
    if off != p.numel():
        raise ValueError(f"the layout holds {off} weights, the configuration {p.numel()}")
    return p
