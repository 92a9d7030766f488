"""Search space over the batchable defense constants.

The port's copy of ``byzantine_aircomp_tpu/tune/space.py``: the same
spaces, draws (``np.random.default_rng``) and schedules, so the port's
candidates equal JAX's bitwise.

The tuner can only search knobs that ride the experiment axis as per-lane
data — a structural knob (ladder names, aggregator identity) would force
one group per candidate and the whole population-per-group economy
collapses.  So the space is validated against the authoritative
batchable-knob split in ``serve/batch.py``: every searched knob must be
one of the detector/policy constants (``_DETECTOR_KNOBS`` /
``_POLICY_KNOBS``), integer knobs (warmup, ladder hysteresis counts,
min-flagged) must carry integer bounds, and bounds must be ordered.

A :class:`SearchSpace` is plain data — ``{knob: (lo, hi)}`` with an
optional ``"log"`` third element for scale-free constants (thresholds,
leak rates) — so a space can round-trip through the tune journal and a
resumed tune re-derives the exact candidate population.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..fed.config import FedConfig
from ..serve.batch import _DETECTOR_KNOBS, _INT_KNOBS, _POLICY_KNOBS

#: knob -> (lo, hi) or (lo, hi, "log"); plain dict so it journals as JSON
SearchSpace = Dict[str, tuple]

#: every knob the tuner may search: exactly the detector + policy
#: constants that are per-lane data on the experiment axis
TUNABLE_KNOBS: Tuple[str, ...] = tuple(_DETECTOR_KNOBS) + tuple(_POLICY_KNOBS)

#: the default space — wide brackets around the hand-picked IID defaults
#: (fed/config.py), log-scaled where the constant is scale-free.  The
#: z/cusum thresholds get generous headroom ABOVE the defaults because
#: the non-IID failure mode is thresholds that are too tight for honest
#: dispersion, and alpha/drift search the EMA baseline's adaptivity
DEFAULT_SPACE: SearchSpace = {
    "defense_z": (2.0, 16.0, "log"),
    "defense_cusum": (3.0, 48.0, "log"),
    "defense_alpha": (0.02, 0.5, "log"),
    "defense_drift": (0.1, 2.0, "log"),
    "defense_up": (2, 8),
    "defense_down": (8, 40),
    "defense_min_flagged": (1, 3),
    "defense_leak": (0.001, 0.05, "log"),
    "defense_floor": (0.5, 4.0),
}


def validate_space(space: SearchSpace) -> List[str]:
    """Raise ``ValueError`` naming the first contract violation; returns
    the sorted knob names on success."""
    if not space:
        raise ValueError("search space is empty")
    for knob, spec in space.items():
        if knob not in TUNABLE_KNOBS:
            raise ValueError(
                f"space knob {knob!r} is not a batchable defense constant "
                f"(tunable: {sorted(TUNABLE_KNOBS)}); structural knobs "
                f"cannot ride the experiment axis"
            )
        if not isinstance(spec, (tuple, list)) or len(spec) not in (2, 3):
            raise ValueError(
                f"space knob {knob!r}: spec must be (lo, hi) or "
                f"(lo, hi, 'log'), got {spec!r}"
            )
        lo, hi = spec[0], spec[1]
        if len(spec) == 3 and spec[2] != "log":
            raise ValueError(
                f"space knob {knob!r}: third element must be 'log', "
                f"got {spec[2]!r}"
            )
        if not (np.isfinite(lo) and np.isfinite(hi) and lo < hi):
            raise ValueError(
                f"space knob {knob!r}: bounds must be finite with lo < hi, "
                f"got ({lo}, {hi})"
            )
        if knob in _INT_KNOBS:
            if int(lo) != lo or int(hi) != hi:
                raise ValueError(
                    f"space knob {knob!r} is integer-valued; bounds must "
                    f"be integers, got ({lo}, {hi})"
                )
            if len(spec) == 3:
                raise ValueError(
                    f"space knob {knob!r} is integer-valued; log scale "
                    f"is not supported"
                )
        if len(spec) == 3 and lo <= 0:
            raise ValueError(
                f"space knob {knob!r}: log scale needs lo > 0, got {lo}"
            )
    return sorted(space)


def default_params(space: SearchSpace) -> Dict[str, float]:
    """The IID-default candidate: the hand-picked ``FedConfig`` defaults
    for every searched knob — the control lane each generation carries."""
    cfg = FedConfig()
    return {
        knob: (int if knob in _INT_KNOBS else float)(getattr(cfg, knob))
        for knob in sorted(space)
    }


def sample_candidates(
    space: SearchSpace, n: int, seed: int
) -> List[Dict[str, float]]:
    """``n`` deterministic candidates from ``space``.

    Candidate 0 is ALWAYS the IID defaults (:func:`default_params`) — the
    control the CI gate compares the winner against — and the remaining
    ``n - 1`` are independent draws from ``default_rng(seed)``.  Sampling
    is a pure function of ``(space, n, seed)``, which is what makes a
    journal-resumed tune bit-identical: the journal records the three
    inputs, not the floats."""
    if n < 1:
        raise ValueError(f"population must be >= 1, got {n}")
    validate_space(space)
    rng = np.random.default_rng(seed)
    out = [default_params(space)]
    for _ in range(n - 1):
        cand: Dict[str, float] = {}
        for knob in sorted(space):
            spec = space[knob]
            lo, hi = float(spec[0]), float(spec[1])
            if knob in _INT_KNOBS:
                cand[knob] = int(rng.integers(int(lo), int(hi) + 1))
            elif len(spec) == 3:
                cand[knob] = float(
                    np.exp(rng.uniform(np.log(lo), np.log(hi)))
                )
            else:
                cand[knob] = float(rng.uniform(lo, hi))
        out.append(cand)
    return out


def apply_params(cfg: FedConfig, params: Dict[str, float]) -> FedConfig:
    """A copy of ``cfg`` with the candidate's constants installed (the
    per-lane config the BatchRunner stacks)."""
    import copy

    out = copy.copy(cfg)
    for knob, value in params.items():
        setattr(out, knob, int(value) if knob in _INT_KNOBS else float(value))
    return out


def halving_schedule(
    population: int, generations: int, base_rounds: int, eta: int = 2
) -> List[Tuple[int, int]]:
    """The successive-halving plan: ``[(survivors_in, rounds)]`` per
    generation.  Generation g runs ``ceil(population / eta**g)``
    candidates (never below 1 — plus the always-resident control lane,
    handled by the tuner) for ``base_rounds * eta**g`` rounds, so the
    total lane-round budget stays roughly constant per generation while
    the surviving candidates earn longer horizons."""
    if eta < 2:
        raise ValueError(f"eta must be >= 2, got {eta}")
    plan = []
    for g in range(generations):
        count = max(1, -(-population // (eta ** g)))  # ceil div
        plan.append((count, base_rounds * (eta ** g)))
    return plan


def survivors(
    scores: Sequence[float], keep: int, protect: Sequence[int] = (0,)
) -> List[int]:
    """Indices promoted to the next generation: the ``protect``ed control
    lanes unconditionally, then the best-scoring candidates (ties broken
    by index, so the promotion is deterministic) until ``keep`` total."""
    order = sorted(
        range(len(scores)), key=lambda i: (-float(scores[i]), i)
    )
    out = [i for i in protect if i < len(scores)]
    for i in order:
        if len(out) >= keep:
            break
        if i not in out:
            out.append(i)
    return sorted(out)
