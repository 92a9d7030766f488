"""How ``correct`` is decided: the program's first dispatches against the
reference's, from the same weights, data and draws.

The numbers (each a share, 0 where the two sides agree):

* ``var_gap`` - each round's honest variance (the loss-like reading the
  program reports every round), the largest relative gap;
* ``step1_gap`` - the change of the weights over the first dispatch,
  leaf by leaf: the gap between the program's and the reference's norm of a
  leaf's change, over the larger of the reference's norm of that leaf and
  of the median leaf; the worst leaf;
* ``step_gap`` - the same for the change over all the checked dispatches,
  leaving out the leaves whose reference change over the first dispatch is
  under a thousandth of the median leaf's (moved by rounding alone);
* ``step1_q99`` - the 99th percentile, over all coordinates, of the gap
  between the program's and the reference's change over the first
  dispatch, each over its leaf's RMS reference change.  Where a
  coordinatewise median of noisy rows picks the weights, a rounding
  difference moves a few coordinates to the neighbouring order statistic,
  and those jumps fill the norms above; a lower precision moves the bulk
  of the coordinates, which the percentile reads past the jumps.

A cell's traffic file names the numbers it compares under ``limits``.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch

from .reference.model import leaves

# a leaf moved by rounding alone moves under this share of the median leaf
ROUNDING_SHARE = 1e-3
# the share of coordinates under the percentile of ``step1_q99``
QUANTILE = 0.99


def _leaf_norms(v: torch.Tensor, layout) -> List[float]:
    return [float(torch.linalg.vector_norm(v[off:off + size].double()))
            for _, _, off, size in leaves(layout)]


def _worst(prog: torch.Tensor, ref: torch.Tensor, layout, keep=None) -> float:
    """The gap of norms of the worst leaf, over the larger of the leaf's
    reference norm and the median leaf's."""
    rn = _leaf_norms(ref, layout)
    pn = _leaf_norms(prog, layout)
    med = statistics.median(rn)
    gap = 0.0
    for i, r in enumerate(rn):
        if keep is None or keep[i]:
            gap = max(gap, _share(abs(pn[i] - r), max(r, med)))
    return gap


def _share(x: float, base: float) -> float:
    if not math.isfinite(x):
        return math.inf
    return x / base if base > 0 else (0.0 if x == 0 else math.inf)


def _quantile_gap(prog: torch.Tensor, ref: torch.Tensor, layout) -> float:
    """The ``QUANTILE`` percentile, over all coordinates, of the gap between
    the two changes, each over its leaf's RMS reference change."""
    gaps = []
    for _, _, off, size in leaves(layout):
        r = ref[off:off + size].double()
        rms = float(torch.sqrt(torch.mean(r ** 2)))
        g = (prog[off:off + size].double() - r).abs()
        g = g / rms if rms > 0 else torch.where(g == 0, 0.0, math.inf)
        # a non-finite coordinate is the largest gap
        gaps.append(torch.where(torch.isnan(g), math.inf, g))
    g = torch.cat(gaps)
    return float(torch.kthvalue(g, min(g.numel(), int(QUANTILE * g.numel()) + 1)).values)


def numbers(layout, p0, prog_params, prog_vars, ref_params, ref_vars) -> Dict[str, float]:
    """The comparison's numbers from the weights after each checked
    dispatch and the variances of each checked round."""
    if len(prog_vars) != len(ref_vars) or len(prog_params) != len(ref_params):
        raise ValueError("the program and the reference checked different dispatches")
    var_gap = max(_share(abs(p - r), abs(r)) if math.isfinite(p) else math.inf
                  for p, r in zip(prog_vars, ref_vars))
    d1p, d1r = prog_params[0] - p0, ref_params[0] - p0
    dnp, dnr = prog_params[-1] - p0, ref_params[-1] - p0
    r1 = _leaf_norms(d1r, layout)
    med = statistics.median(r1)
    keep = [n >= ROUNDING_SHARE * med for n in r1]
    return {"var_gap": var_gap, "step1_gap": _worst(d1p, d1r, layout),
            "step_gap": _worst(dnp, dnr, layout, keep),
            "step1_q99": _quantile_gap(d1p, d1r, layout)}


def judge(nums: Dict[str, float], limits: Dict[str, float]):
    """``(correct, checks)``: every number the cell compares under its
    limit; ``checks`` maps each to its value and limit."""
    checks = {name: {"value": nums[name], "limit": limit} for name, limit in limits.items()}
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
    return correct, checks
