"""Online defense: per-client anomaly scores and an adaptive escalation of
the aggregator.

Port of ``byzantine_aircomp_tpu/defense/``: :mod:`.scores` (scores on the
received [K, d] stack, robust EMA/CUSUM detector), :mod:`.policy` (the
escalation ladder, ``mean -> trimmed_mean -> multi_krum`` by default, with
hysteresis) and :mod:`.events` (the per-round metrics and record keys).

Modes (``--defense``): ``off`` runs no defense code and keeps the
iteration's draws, record and config hash as they were; ``monitor`` scores
and tracks the rung that would run, the aggregation untouched (the
trajectory is bitwise that of ``off``); ``adaptive`` lets the rung pick the
aggregator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from . import events  # noqa: F401
from .policy import (  # noqa: F401
    PolicyParams,
    aggregate_rung,
    init_policy,
    policy_update,
    stream_aggregate_rung,
    validate_ladder,
)
from .scores import (  # noqa: F401
    DetectorParams,
    client_score_components,
    client_scores,
    detector_update,
    init_detector,
)

#: the defense state: (detector state, policy state), None when off
DefenseState = tuple


@dataclass(frozen=True)
class DefenseSpec:
    """The resolved defense configuration of a run."""

    mode: str                      # "monitor" | "adaptive"
    ladder: Tuple[str, ...]
    detector: DetectorParams
    policy: PolicyParams


def from_config(cfg) -> Optional[DefenseSpec]:
    """The spec of ``cfg`` (None when ``defense == "off"``); the ladder was
    checked by ``cfg.validate()``."""
    if cfg.defense == "off":
        return None
    ladder = cfg.defense_ladder_names()
    return DefenseSpec(
        mode=cfg.defense,
        ladder=ladder,
        detector=DetectorParams(
            alpha=cfg.defense_alpha,
            drift=cfg.defense_drift,
            z_thresh=cfg.defense_z,
            cusum_thresh=cfg.defense_cusum,
            warmup=cfg.defense_warmup,
        ),
        policy=PolicyParams(
            up_n=cfg.defense_up,
            down_m=cfg.defense_down,
            min_flagged=cfg.defense_min_flagged,
            n_rungs=len(ladder),
            budget_leak=cfg.defense_leak,
            floor_thresh=cfg.defense_floor,
        ),
    )


def init_state(spec: Optional[DefenseSpec], k: int, device) -> Optional[DefenseState]:
    """The initial defense state for K clients on ``device`` (None when off)."""
    if spec is None:
        return None
    return (init_detector(k, device), init_policy(device))
