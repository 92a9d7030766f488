"""The reference follows the program's first dispatches from the same start.

:func:`follow` runs ``dispatches`` x ``rounds_per_dispatch`` rounds of
``display_interval`` iterations each from the initial weights ``p0``, on the
data the benchmark made, with the draws of :mod:`.draws`, and returns the
weights after each dispatch, each round's honest variance (of its last
iteration's stack, as the program reports it) and the Weiszfeld steps of
each solve.

``tf32`` computes the client step's products in TF32, the control that has
to come out not correct.  ``half_batch`` gives each client only the first
half of its batch, one of the faults that has to come out not correct.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

from .. import inputs
from . import aggregate, draws, model


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 products (TF32 off), or TF32 for the control."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def shards(n: int, k: int, device):
    """Client i owns train rows [offset_i, offset_i + size_i): K contiguous
    slices of near-equal size."""
    cuts = torch.tensor([(i * n) // k for i in range(k + 1)], dtype=torch.int64, device=device)
    return cuts[:-1], cuts[1:] - cuts[:-1]


def iteration(config, cell, data, p, seed, round_idx, it, offsets, sizes, half_batch=False):
    """One global iteration from the weights ``p``: ``(new weights, the
    received stack, Weiszfeld steps or None)``."""
    dev = p.device
    k = cell["honest_size"] + cell["byz_size"]
    b, d = config["batch_size"], p.numel()
    u = draws.batch_uniforms(draws.generator(seed, round_idx, it, draws.BATCH, dev), k, b, dev)
    local = torch.minimum(torch.floor(u * sizes[:, None].to(torch.float32)).to(torch.int64),
                          sizes[:, None] - 1)
    idx = offsets[:, None] + local
    if half_batch:
        idx = idx[:, : b // 2]
    kind = inputs.of(config)
    x, y = kind.batch(config, data, idx)
    if cell["attack"] == "classflip" and cell["byz_size"]:
        # the Byzantine clients (the last rows) train on flipped labels
        y = torch.cat([y[: cell["honest_size"]], kind.flip(config, y[cell["honest_size"]:])])
    elif cell["attack"] is not None:
        raise ValueError(f"no reference for the attack {cell['attack']!r}")
    w = p - config["gamma"] * (model.client_grads(config, p, x, y)
                               + config["weight_decay"] * p)
    agg, noise_var, steps = cell["agg"], cell["noise_var"], None
    if noise_var is not None and agg != "gm":
        gen = draws.generator(seed, round_idx, it, draws.CHANNEL, dev)
        w = aggregate.received(w, draws.oma_terms(gen, k, d, noise_var, dev))
    if agg == "gm2":
        new, steps = aggregate.gm2(w, p, config["agg_maxiter"], config["agg_tol"])
    elif agg == "gm":
        gen = draws.generator(seed, round_idx, it, draws.AGGREGATION, dev)
        new, steps = aggregate.gm(
            w, p, config["agg_maxiter"], config["agg_tol"], config["gm_p_max"], noise_var,
            lambda _i: draws.gm_step_draws(gen, k, d, noise_var is not None, dev))
    elif agg == "median":
        new = aggregate.median(w)
    elif agg == "trimmed_mean":
        new = aggregate.trimmed_mean(w, config["trim_ratio"])
    else:
        raise ValueError(f"no reference for the rule {agg!r}")
    return new, w, steps


def follow(config, cell, data, p0, seed, dispatches, tf32=False, half_batch=False) -> Dict:
    """The reference's first ``dispatches`` dispatches from ``p0``."""
    dev = p0.device
    k = cell["honest_size"] + cell["byz_size"]
    offsets, sizes = shards(data["x_train"].shape[0], k, dev)
    rounds = cell["rounds_per_dispatch"]
    interval = config["display_interval"]
    p = p0.clone()
    params: List[torch.Tensor] = []
    variances: List[float] = []
    solve_steps: List[int] = []
    with precision(tf32), torch.no_grad():
        for disp in range(dispatches):
            for r in range(disp * rounds, (disp + 1) * rounds):
                for it in range(interval):
                    p, w, steps = iteration(config, cell, data, p, seed, r, it, offsets, sizes,
                                            half_batch)
                    if steps is not None:
                        solve_steps.append(steps)
                    if it == interval - 1:
                        variances.append(float(aggregate.honest_variance(w, cell["honest_size"])))
                    del w
            params.append(p.clone())
    return {"params": params, "variances": variances, "solve_steps": solve_steps}
