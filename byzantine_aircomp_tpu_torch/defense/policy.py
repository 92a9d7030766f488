"""Escalation-ladder policy: the hysteresis state machine and the rung
dispatch.

Port of ``byzantine_aircomp_tpu/defense/policy.py``.  An iteration is
*suspicious* when at least ``min_flagged`` clients flag; ``up_n``
suspicious iterations in a row escalate one rung, ``down_m`` clean ones
de-escalate one rung, and either streak resets on the opposite
observation.  A leaky escalation budget (+1 per escalation, decaying by
``budget_leak`` per iteration) pins the floor at rung 1 while it is at or
above ``floor_thresh``, so an attacker that bursts, sleeps through the
de-escalation window and bursts again finds the ladder still raised.
``floor_thresh <= 0`` disables the floor.

The state stays on the device.  The JAX package picks the rung's
aggregator inside its compiled program with ``lax.switch``, which runs one
branch; running every rung and selecting would, for example, run a
1000-step gm2 solve that is never used.  So :func:`aggregate_rung` reads the
rung on the host, one ``int()`` per iteration, and calls that rung's
aggregator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from ..obs.span import span
from ..registry import AGGREGATORS

#: policy state: (rung i32, up_streak i32, down_streak i32, budget f32)
PolicyState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@dataclass(frozen=True)
class PolicyParams:
    """Hysteresis knobs (the ``defense_*`` fields of FedConfig)."""

    up_n: int = 3          # suspicious iterations in a row per escalation
    down_m: int = 20       # clean iterations in a row per de-escalation
    min_flagged: int = 1   # flagged clients that make an iteration suspicious
    n_rungs: int = 3       # ladder length (clamps the rung)
    budget_leak: float = 0.005
    floor_thresh: float = 1.5


def init_policy(device) -> PolicyState:
    zero = lambda dtype: torch.zeros((), dtype=dtype, device=device)  # noqa: E731
    return (zero(torch.int32), zero(torch.int32), zero(torch.int32), zero(torch.float32))


def policy_update(pol: PolicyState, n_flagged: torch.Tensor, p: PolicyParams):
    """One hysteresis step; returns ``(new state, suspicious bool)``."""
    rung, up, down, budget = pol
    suspicious = n_flagged >= p.min_flagged
    up = torch.where(suspicious, up + 1, 0).to(torch.int32)
    down = torch.where(suspicious, 0, down + 1).to(torch.int32)
    escalate = up >= p.up_n
    deescalate = (down >= p.down_m) & (rung > 0)
    budget = budget * (1.0 - p.budget_leak) + escalate.to(torch.float32)
    if p.floor_thresh > 0:
        floor = torch.clamp((budget >= p.floor_thresh).to(torch.int32), max=p.n_rungs - 1)
    else:
        floor = torch.zeros((), dtype=torch.int32, device=rung.device)
    moved = rung + escalate.to(torch.int32) - deescalate.to(torch.int32)
    rung = torch.clamp(torch.maximum(moved, floor), max=p.n_rungs - 1).to(torch.int32)
    # a consumed streak restarts: each further rung needs fresh evidence
    up = torch.where(escalate, 0, up).to(torch.int32)
    down = torch.where(deescalate, 0, down).to(torch.int32)
    return (rung, up, down, budget), suspicious


def validate_ladder(names: Sequence[str], base_agg: "str | None") -> None:
    """Refuse a ladder the dispatch cannot run: fewer than 2 rungs, an
    unknown name, a rung that owns its channel (gm and signmv transmit
    inside aggregation, so there is no received stack for the rungs to
    share), or, in adaptive mode (``base_agg`` given), a rung 0 other than
    ``--agg``.  Monitor mode passes ``base_agg=None``: its rung is only
    reported."""
    if len(names) < 2:
        raise ValueError(f"defense ladder needs >= 2 rungs to escalate, got {list(names)}")
    for n in names:
        if AGGREGATORS.meta(n).get("owns_channel", False):  # raises on unknown names
            raise ValueError(
                f"defense ladder rung {n!r} owns its channel (the AirComp "
                "transmission happens inside aggregation); all rungs must "
                "aggregate the same received stack; use gm2 instead of gm"
            )
    if base_agg is not None and names[0] != base_agg:
        raise ValueError(
            f"defense ladder base rung {names[0]!r} must equal --agg {base_agg!r}: "
            f"rung 0 IS the configured aggregator (set --agg {names[0]} or "
            "reorder --defense-ladder)"
        )


#: the span around the host read of the rung
RUNG_READ_RANGE = "defense_rung_read"


def _rung_name(rung: torch.Tensor, ladder: Sequence[str]) -> str:
    with span(RUNG_READ_RANGE):
        return ladder[int(rung)]


def aggregate_rung(rung: torch.Tensor, ladder: Sequence[str], w_agg: torch.Tensor, **kw):
    """The rung's aggregator on ``w_agg`` with the trainer's keyword surface
    (every aggregator takes ``**_``).  The rung is read on the host here
    (inside the profiler range ``RUNG_READ_RANGE``), the one host sync the
    adaptive defense adds to an iteration.  Under service rounds ``kw``
    carries the rollback-widened ``trim_ratio`` as a device f32 scalar,
    which only the degraded trimmed_mean reads (JAX
    ``_defense_branches(agg_honest, trim_ratio)``)."""
    return AGGREGATORS.get(_rung_name(rung, ladder))(w_agg, **kw).to(torch.float32)


def stream_aggregate_rung(rung: torch.Tensor, ladder: Sequence[str], rebuild, **kw):
    """:func:`aggregate_rung` for a cohort-streamed round: the rung's
    streamed rule (``ops.aggregators.stream_aggregate``) over the chunks
    that ``rebuild`` remakes."""
    from ..ops import aggregators as agg_lib

    return agg_lib.stream_aggregate(_rung_name(rung, ladder), rebuild, **kw).to(torch.float32)
