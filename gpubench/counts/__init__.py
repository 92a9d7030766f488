"""The yardstick: the peaks of each device (``peaks.json``), the training
FLOPs of each model (``<config>.py``) and the bytes each kernel needs
(``<kernel>.py``).  Counted from shapes, never read from the program."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent


def peak(kind: str, what: str) -> Optional[float]:
    """The published peak ``what`` of the device named ``kind``, or None
    for a device the table does not hold."""
    table = json.loads((HERE / "peaks.json").read_text())["devices"]
    for key, peaks in table.items():
        if key in kind:
            return peaks[what]
    return None


def dense_conv_flops(config) -> int:
    """Training FLOPs per sample of a stack of 'same'-padded convolutions,
    each followed by a 2x2 pool, then dense layers, from the layout's
    kernels: forward, the weight gradient and every input gradient but the
    first layer's, at 2 FLOPs per multiply-add."""
    h, w = config["input_shape"][:2]
    macs = []
    for name, shape in config["layout"]:
        if not name.endswith("/kernel"):
            continue
        if len(shape) == 4:
            kh, kw, cin, cout = shape
            macs.append(h * w * cout * kh * kw * cin)
            h, w = h // 2, w // 2
        else:
            macs.append(shape[0] * shape[1])
    return 2 * (2 * sum(macs) + sum(macs[1:]))
