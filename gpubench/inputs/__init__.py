"""The benchmark's input kinds: ``inputs/<kind>.py`` makes a configuration's
data set from ``--seed`` and hands it to both sides.  A configuration names
its kind under ``inputs`` (default ``images``).  Each kind gives:

* ``make_data(config, seed, device, train_size=None, val_size=None)``: the
  data set, as host arrays;
* ``on_device(data, device)``: what the reference reads of it;
* ``batch(config, data, idx)``: the reference's ``(x, y)`` of the train rows
  ``idx`` [K, B];
* ``flip(config, y)``: classflip's targets for the labels ``y``;
* ``port_dataset(config, data)``: the port's ``Dataset`` over the same rows.
"""

from __future__ import annotations

import importlib
from types import ModuleType

DEFAULT = "images"


def of(config) -> ModuleType:
    """The input kind that the configuration names."""
    kind = config.get("inputs", DEFAULT)
    try:
        return importlib.import_module(f"{__name__}.{kind}")
    except ModuleNotFoundError as e:
        if e.name != f"{__name__}.{kind}":
            raise
        raise ValueError(f"no input kind {kind!r}: no file gpubench/inputs/{kind}.py") from None
