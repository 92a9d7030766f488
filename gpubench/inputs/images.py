"""Images: an MNIST-shaped data set of u8 rows made on the device from
``--seed``, normalized by the configuration's ``norm_stats``.  Both sides
get the same rows: the program as its data set, the reference its own copy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpubench.data import sub_seed

# rows made per call, so that the device holds little while it makes them
CHUNK = 10_000
# the std of the pixel noise around each class's prototype
PIXEL_NOISE = 0.35


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


def batch(config, data, idx):
    """The rows ``idx`` [K, B], normalized to f32 [K, B, features], and their
    labels [K, B]."""
    mean, std = config["norm_stats"]
    x = (data["x_train"][idx].to(torch.float32) / 255.0 - mean) / std
    return x, data["y_train"][idx]


def flip(config, y):
    """Classflip: label ``c`` becomes ``num_classes - 1 - c``."""
    return config["num_classes"] - 1 - y


def port_dataset(config, data):
    """The port's ``Dataset`` over the rows, in the configuration's input
    shape, with the u8 rows and their normalization for its on-device
    gather."""
    from byzantine_aircomp_tpu_torch.data.datasets import Dataset

    shape = tuple(config["input_shape"])
    n_val = len(data["y_val"])
    return Dataset(
        "mnist", data["x_train_f32"].reshape((-1,) + shape), data["y_train"].astype(np.int32),
        data["x_val"].reshape((n_val,) + shape), data["y_val"].astype(np.int32),
        config["num_classes"], "synthetic", x_train_raw=data["x_train"].reshape((-1,) + shape),
        stats=tuple(config["norm_stats"]))
