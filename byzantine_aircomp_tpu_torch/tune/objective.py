"""The tuner's scalar objective: one paired-lane event fold.

The port's copy of ``byzantine_aircomp_tpu/tune/objective.py``.

Each candidate runs as TWO lanes of the same group under the same seed: an *attacked* lane (the configured attack active from its
onset round) and a *benign* lane (the attack-onset iteration counter
pinned so the attack never activates — every Byzantine row stays
bit-identical to an honest one, see ``ops/attacks.AttackSpec.onset_round``
and the tuner's onset pinning).  The pairing is the variance control:
both lanes share the data layout, the channel draws, and the detector
constants, so any flag the benign lane raises is attributable to the
constants — not to a different data order.

The attacked lane's ``client_flag`` stream goes through the SAME
``analysis/audit.py`` precision/recall/time-to-detect machinery every
offline forensic report uses (one fold implementation, no drift); the
benign lane's stream reduces to a false-flag rate.  The scalar is

    objective = precision + recall
                - ff_penalty * benign_flag_rate
                - ttd_weight * normalized_time_to_detect

with the benign-false-flag penalty explicit and dominant by default: a
detector that pages on honest non-IID clients is worse than a slightly
slower one, which is exactly the trade the IID-tuned defaults get wrong
at low Dirichlet alpha.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..analysis import audit as audit_lib

#: default penalty per unit of benign false-flag rate — sized so a
#: detector flagging one honest client per round (rate 1/K with K=16,
#: ~0.0625) loses ~0.6, i.e. more than the whole recall term can buy back
DEFAULT_FF_PENALTY = 10.0
#: weight of the normalized time-to-detect term (1.0 = never detected)
DEFAULT_TTD_WEIGHT = 0.25


def benign_flag_rate(events: List[dict], k: int, rounds: int) -> float:
    """Flagged ``client_flag`` events per client-round on a lane where no
    attack ever activated — every one is a false positive."""
    if k <= 0 or rounds <= 0:
        return 0.0
    flags = sum(
        1 for e in events
        if e.get("kind") == "client_flag" and e.get("flagged")
    )
    return flags / float(k * rounds)


def objective_score(
    precision: Optional[float],
    recall: Optional[float],
    time_to_detect: Optional[int],
    ff_rate: float,
    rounds: int,
    *,
    ff_penalty: float = DEFAULT_FF_PENALTY,
    ttd_weight: float = DEFAULT_TTD_WEIGHT,
) -> float:
    """The scalar the halving schedule ranks on (higher is better).

    ``precision=None`` (no flag ever raised) scores as 1.0 — an attacked
    lane that flags nothing pays through recall=0 and the full ttd term,
    not through a phantom precision penalty; ``recall=None`` (no ground
    truth) scores 0."""
    p = 1.0 if precision is None else float(precision)
    rec = 0.0 if recall is None else float(recall)
    if time_to_detect is None:
        ttd_norm = 1.0  # never detected: the worst the term can charge
    else:
        ttd_norm = min(1.0, max(0.0, float(time_to_detect) / max(1, rounds)))
    return p + rec - ff_penalty * ff_rate - ttd_weight * ttd_norm


def fold_pair(
    attacked_events: List[dict],
    benign_events: List[dict],
    *,
    k: int,
    rounds: int,
    ff_penalty: float = DEFAULT_FF_PENALTY,
    ttd_weight: float = DEFAULT_TTD_WEIGHT,
) -> Dict[str, object]:
    """One candidate's score from its two lanes' event streams.

    ``attacked_events`` must contain the lane's ``run_start`` header (the
    tuner emits it with the explicit ``byz_ids`` the audit pins on) and
    its ``client_flag`` stream; ``benign_events`` only needs the flag
    stream.  Returns the audit summary fields plus ``benign_flag_rate``
    and the scalar ``objective``."""
    summary = audit_lib.audit(attacked_events)["summary"]
    ff_rate = benign_flag_rate(benign_events, k, rounds)
    score = objective_score(
        summary["precision"], summary["recall"], summary["time_to_detect"],
        ff_rate, rounds, ff_penalty=ff_penalty, ttd_weight=ttd_weight,
    )
    return {
        "precision": summary["precision"],
        "recall": summary["recall"],
        "time_to_detect": summary["time_to_detect"],
        "flag_events": summary["flag_events"],
        "benign_flag_rate": ff_rate,
        "objective": score,
    }
