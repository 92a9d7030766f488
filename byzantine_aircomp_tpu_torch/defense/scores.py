"""Per-client anomaly scores and the robust change-point detector.

Port of ``byzantine_aircomp_tpu/defense/scores.py``.  Everything runs on the
received [K, d] stack, on its device, with no host read and no random draw,
so the iteration's streams are the same whatever the defense mode.

Three statistics per client (:func:`client_score_components`): the update
norm ``||w_i - g||`` relative to the finite-median norm, the cosine to the
finite centroid of the updates, and the mean squared distance to the other
finite rows relative to its finite median.  Each is a relative excess over
the honest median, so one threshold works across models and step sizes.

Per-client baselines (:func:`detector_update`) are EMAs with a huberized
innovation, plus a one-sided CUSUM that saturates at twice its threshold.
Non-finite rows (erasures, NaN corruption) are left out of every median and
their detector state is frozen, so a fault burst neither flags nor poisons
the baselines.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..ops import aggregators as agg_lib

#: detector state: (step i32 scalar, ema [K] f32, dev [K] f32, cusum [K] f32)
DetectorState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@dataclass(frozen=True)
class DetectorParams:
    """Detector knobs (the ``defense_*`` fields of FedConfig)."""

    alpha: float = 0.1         # EMA rate of the baseline mean and deviation
    drift: float = 0.5         # CUSUM allowance (robust sigmas)
    z_thresh: float = 4.0      # instantaneous flag above this z
    cusum_thresh: float = 8.0  # change-point flag above this CUSUM
    warmup: int = 5            # iterations before flags and CUSUM arm
    clip: float = 3.0          # huber clip of the baseline innovation (sigmas)
    eps: float = 1e-6          # deviation floor


def init_detector(k: int, device) -> DetectorState:
    zeros = lambda: torch.zeros(k, dtype=torch.float32, device=device)  # noqa: E731
    return (torch.zeros((), dtype=torch.int32, device=device), zeros(), zeros(), zeros())


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of ``x[mask]`` at a static shape: the masked-out entries sort to
    +inf and the order statistic is ``(n-1)//2`` at a device index (+inf when
    n = 0).  Ties give the same value in any order."""
    n = torch.sum(mask)
    srt = torch.sort(torch.where(mask, x, torch.inf)).values
    idx = torch.clamp(n - 1, min=0) // 2
    return torch.index_select(srt, 0, idx.reshape(1))[0]


def client_score_components(w_stack: torch.Tensor, guess: torch.Tensor):
    """``(score [K], finite [K], components [K, 3])``: the composite score
    and its (norm, cosine, distance) terms, each a nonnegative relative
    excess (honest rows score ~0)::

        relu(norm_i / med(norm) - 1) + relu(1 - cos(delta_i, centroid))
          + relu(dist_i / med(dist) - 1)

    Medians and the centroid run over the finite rows; a non-finite row
    scores exactly 0."""
    finite = agg_lib._finite_rows(w_stack)
    delta = (w_stack - guess[None, :]).to(torch.float32)
    safe_delta = torch.where(finite[:, None], delta, 0.0)

    norms = torch.sqrt(torch.sum(safe_delta * safe_delta, dim=1))
    med_norm = masked_median(norms, finite)
    norm_term = torch.clamp(norms / torch.clamp(med_norm, min=1e-12) - 1.0, min=0.0)

    cent = agg_lib._finite_centroid(delta, finite)
    cent_norm = torch.sqrt(torch.sum(cent * cent))
    cos = torch.sum(safe_delta * cent[None, :], dim=1) / (
        torch.clamp(norms, min=1e-12) * torch.clamp(cent_norm, min=1e-12)
    )
    cos_term = torch.clamp(1.0 - cos, min=0.0)

    # mean squared distance to the other finite rows
    dists = agg_lib.pairwise_sq_dists(w_stack)
    k = w_stack.shape[0]
    eye = torch.eye(k, dtype=torch.bool, device=w_stack.device)
    pair_mask = finite[None, :] & ~eye
    n_others = torch.clamp(torch.sum(pair_mask, dim=1), min=1)
    dist_mean = torch.sum(torch.where(pair_mask, dists, 0.0), dim=1) / n_others
    med_dist = masked_median(dist_mean, finite)
    dist_term = torch.clamp(dist_mean / torch.clamp(med_dist, min=1e-12) - 1.0, min=0.0)

    score = torch.where(finite, norm_term + cos_term + dist_term, 0.0)
    components = torch.where(
        finite[:, None], torch.stack([norm_term, cos_term, dist_term], dim=1), 0.0
    )
    return score, finite, components


def client_scores(w_stack: torch.Tensor, guess: torch.Tensor):
    """The composite score [K] and the finite-row mask [K]."""
    score, finite, _ = client_score_components(w_stack, guess)
    return score, finite


def detector_update(det: DetectorState, score: torch.Tensor, finite: torch.Tensor,
                    p: DetectorParams, first: Optional[torch.Tensor] = None):
    """One detector step; returns ``(new state, flags [K] bool)``.

    Step 0 seeds the EMA and the deviation from the first score; after that
    the innovation is clipped at ``p.clip`` robust sigmas.  The CUSUM runs
    from the end of the warm-up on the clipped z and saturates at twice its
    threshold, so that it decays in bounded time once an attacker goes
    quiet.  Non-finite rows keep their state and never flag.

    ``first`` ([rows] bool) replaces the seeding condition ``step == 0``:
    under service rounds the rows are those of the drawn population ids,
    whose first observation can come at any step, and the trainer passes
    their never-updated marker ``dev == 0``."""
    step, ema, dev, cusum = det
    warm = step >= p.warmup
    if first is None:
        first = step == 0

    sigma = dev + p.eps
    resid = score - ema
    z = resid / sigma
    clipped = torch.clamp(resid, -p.clip * sigma, p.clip * sigma)
    ema_new = torch.where(first, score, ema + p.alpha * clipped)
    dev_new = torch.where(
        first, torch.abs(score) + p.eps, (1.0 - p.alpha) * dev + p.alpha * torch.abs(clipped)
    )
    z_c = torch.clamp(z, -p.clip, p.clip)
    cusum_new = torch.where(
        warm,
        torch.clamp(torch.clamp(cusum + z_c - p.drift, min=0.0), max=2.0 * p.cusum_thresh),
        torch.zeros_like(cusum),
    )
    flags = warm & ((z > p.z_thresh) | (cusum_new > p.cusum_thresh)) & finite

    ema = torch.where(finite, ema_new, ema)
    dev = torch.where(finite, dev_new, dev)
    cusum = torch.where(finite, cusum_new, cusum)
    return (step + 1, ema, dev, cusum), flags
