"""The model's initial weights, made on the device from ``--seed``, and the
sub-seeds the benchmark draws its inputs with.  Both sides get the same: the
program its weights, the reference its own copy.  The data set is the
configuration's input kind's (``gpubench/inputs/``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: the rules of a leaf that no rule of the configuration's ``init_rules``
#: covers: every bias 0.01, every other leaf (a dense or conv kernel)
#: xavier normal with the relu gain
DEFAULT_RULES = (("/bias", 0.01), ("", "xavier_relu"))


def sub_seed(seed: int, key: int) -> int:
    """A 63-bit seed of ``(seed, key)``; the run's seed may be any integer."""
    hi, lo = np.random.SeedSequence([seed % 2**64, key]).generate_state(2)
    return ((int(hi) << 32) | int(lo)) & (2**63 - 1)


def init_std(shape) -> float:
    """Xavier normal with the relu gain: ``sqrt(2) * sqrt(2 / (fan_in +
    fan_out))``, for a dense kernel [in, out] or a conv kernel [kh, kw,
    in, out]."""
    receptive = math.prod(shape[:-2])
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    return math.sqrt(2.0) * math.sqrt(2.0 / (fan_in + fan_out))


def leaf_rule(config, name: str):
    """The rule of the leaf ``name``: the first of the configuration's
    ``init_rules`` (``[leaf-name suffix, rule]``) whose suffix ends the
    name, else of :data:`DEFAULT_RULES`.  A rule is ``"xavier_relu"`` or a
    constant."""
    rules = [*config.get("init_rules", []), *DEFAULT_RULES]
    return next(rule for suffix, rule in rules if name.endswith(suffix))


def make_params(config, seed: int, device) -> torch.Tensor:
    """The flat initial weights [d] f32, in one draw on the device: each
    leaf's slice scaled to its init std (``xavier_relu``) or set to its
    constant, by :func:`leaf_rule`."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    p = torch.randn(config["params"], generator=g, device=device)
    off = 0
    for name, shape in config["layout"]:
        size = math.prod(shape)
        rule = leaf_rule(config, name)
        if rule == "xavier_relu":
            if len(shape) < 2:
                raise ValueError(f"the leaf {name} {list(shape)} has no fan in and out for "
                                 "xavier_relu: give it a rule under the configuration's "
                                 "init_rules")
            p[off:off + size] *= init_std(shape)
        elif isinstance(rule, (int, float)):
            p[off:off + size] = rule
        else:
            raise ValueError(f"the leaf {name}: no init rule {rule!r} (xavier_relu or a number)")
        off += size
    if off != p.numel():
        raise ValueError(f"the layout holds {off} weights, the configuration {p.numel()}")
    return p
