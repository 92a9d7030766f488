"""The defense's per-round metrics: their packing, the record keys and
the ``defense`` event.

Port of ``byzantine_aircomp_tpu/defense/events.py``.  Each iteration
observes a [5] vector (rung, flagged clients, suspicious, max score, max
CUSUM); :func:`reduce_round` folds a round of them into the [6] round
vector of :data:`METRIC_KEYS`, as the JAX package's round does
(``fed/train.py:1770-1784``); :func:`emit_round` writes it as one
``defense`` event through the run's obs sinks, with the transition from
the previous round's rung.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

# order of the [6] per-round defense vector
METRIC_KEYS = (
    "rung", "flagged", "suspicious_iters", "score_max", "cusum_max",
    "transitions",
)

# round-vector entry -> record path key
PATH_KEYS = {
    "rung": "defenseRungPath",
    "flagged": "defenseFlaggedPath",
    "suspicious_iters": "defenseSuspiciousPath",
    "score_max": "defenseScorePath",
    "cusum_max": "defenseCusumPath",
    "transitions": "defenseTransitionsPath",
}


def reduce_round(rung_in: torch.Tensor, per_iteration: Sequence[torch.Tensor]) -> torch.Tensor:
    """[6] round vector from the round's [5] iteration vectors: the rung at
    the round's end, the most flagged clients, the suspicious iterations,
    the largest score and CUSUM, and the rung moves, counted from the rung
    the round started at (``rung_in``), so a round that opens with an
    escalation reports it."""
    obs = torch.stack(list(per_iteration))
    rung_path = torch.cat([rung_in.to(torch.float32).reshape(1), obs[:, 0]])
    return torch.stack([
        obs[-1, 0],
        torch.max(obs[:, 1]),
        torch.sum(obs[:, 2]),
        torch.max(obs[:, 3]),
        torch.max(obs[:, 4]),
        torch.sum(torch.abs(torch.diff(rung_path))),
    ])


def round_metrics(round_vec) -> Dict[str, float]:
    """The round's [6] vector as named floats (counts are exact floats)."""
    vals = [float(v) for v in torch.as_tensor(round_vec).tolist()]
    return dict(zip(METRIC_KEYS, vals))


def active_agg(mode: str, ladder, rung: int, base_agg: str) -> str:
    """The aggregator applied: the rung's ladder entry under ``adaptive``,
    always the configured one under ``monitor``."""
    return ladder[rung] if mode == "adaptive" else base_agg


def emit_round(
    obs,
    round_idx: int,
    *,
    mode: str,
    agg: str,
    metrics: Dict[str, float],
    prev_rung: Optional[int] = None,
) -> None:
    """One ``defense`` event per round on the run's sinks.  ``prev_rung``
    (the previous round's end rung, kept on the host) makes the carried
    rung an explicit transition: "escalate" / "deescalate" / None."""
    rung = int(metrics["rung"])
    transition = None
    if prev_rung is not None and rung != prev_rung:
        transition = "escalate" if rung > prev_rung else "deescalate"
    obs.emit(
        "defense",
        round=round_idx,
        mode=mode,
        rung=rung,
        agg=agg,
        prev_rung=prev_rung,
        transition=transition,
        flagged=metrics["flagged"],
        suspicious_iters=metrics["suspicious_iters"],
        score_max=metrics["score_max"],
        cusum_max=metrics["cusum_max"],
        transitions=metrics["transitions"],
    )
