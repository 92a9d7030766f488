"""Byzantine attacks.

Port of the static attacks of ``byzantine_aircomp_tpu/ops/attacks.py``.  An
attack is an :class:`AttackSpec` with three surfaces:

* **data-level** — Byzantine clients corrupt their local training step:
  ``classflip`` trains on label ``C-1 - y`` (reference
  ``MNIST_Air_weight.py:317-323``; the EMNIST script's ``61 - y``),
  ``dataflip`` on inverted inputs ``1.0 - x`` (``:324-330``, the normalized
  tensor);
* **gradient-level** — ``gradascent`` scales the Byzantine clients'
  gradient by -1 (``grad_scale``), before weight decay;
* **message-level** — after the client weights are stacked to [K, d]:
  ``weightflip`` sets each Byzantine row to ``-w_b - 2*s/B`` where s is the
  honest sum (``:380-383``), ``signflip`` sends ``-w_b``, ``gaussian``
  sends ``sigma * N(0, 1)``, and the omniscient ``alie`` (Baruch et al.
  2019), ``ipm`` (Xie et al. 2020), ``minmax`` and ``minsum`` (Shejwalkar
  & Houmansadr, NDSS 2021) read the honest rows' statistics.

Byzantine clients occupy the LAST ``byz_size`` rows (``:291-341``).
``resolve("name@R")`` delays the onset to round R: the trainer gates every
surface on a device iteration counter, so before the onset the Byzantine
rows are bitwise what honest clients would send.

Knowledge tiers: *data-only* attacks corrupt their own batches or
gradients; *omniscient* attacks read the honest rows of the stack;
*defense-aware* attacks also read the defense's published state, a
:class:`DefenseView` of the detector's baselines and CUSUMs after the
previous iteration: ``mimic`` replays the honest client the detector
trusts most, ``under_radar`` bisects its perturbation so that every
Byzantine row's next z-score and CUSUM stay under ``margin`` times their
thresholds, and ``duty_cycle`` bursts and sleeps against the policy's
hysteresis (JAX ``ops/attacks.py:299-410``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from ..registry import ATTACKS

# bisection steps of the AGR-agnostic attacks' gamma search (JAX
# ``_agr_message``)
AGR_STEPS = 25


class DefenseView(NamedTuple):
    """What a defense-aware attacker sees at the message boundary: the
    detector state the server published after the PREVIOUS iteration (the
    attack runs before this iteration's scoring), with the per-client rows
    aligned to the stack, and the detector's and policy's knobs (run
    configuration, which a strong adversary is assumed to know)."""

    step: torch.Tensor    # i32 scalar: detector iteration counter
    ema: torch.Tensor     # [K] f32: robust-EMA score baselines
    dev: torch.Tensor     # [K] f32: robust deviation baselines
    cusum: torch.Tensor   # [K] f32: one-sided CUSUMs
    rung: torch.Tensor    # i32 scalar: the ladder rung in force
    detector: object      # defense.scores.DetectorParams
    policy: object        # defense.policy.PolicyParams
    guess: torch.Tensor   # [d] f32: the pre-iteration params (score reference)


@dataclass(frozen=True)
class AttackSpec:
    """A named Byzantine behavior.

    ``data_fn(x, y, num_classes) -> (x, y)`` corrupts a Byzantine client's
    batch before its local step; ``grad_scale`` multiplies its gradient (+1
    honest descent, -1 ascent); ``message_fn(wmatrix, byz_size, generator,
    **kw) -> wmatrix`` rewrites the stacked messages.  ``param_name`` names
    the message_fn keyword that ``--attack-param`` binds to (None: the
    attack has no knob); ``onset_round`` is the round of a delayed onset
    (``name@R``), None for an attack from round 0.
    """

    name: str
    data_fn: Optional[Callable] = None
    grad_scale: float = 1.0
    message_fn: Optional[Callable] = None
    param_name: Optional[str] = None
    onset_round: Optional[int] = None
    # knowledge tiers: an omniscient message attack reads the honest rows;
    # a defense-aware one also takes a DefenseView (needs a defense running)
    omniscient: bool = False
    defense_aware: bool = False

    def meta(self) -> dict:
        """Static capability metadata (JAX ``AttackSpec.meta``): ``data_level``
        (no message rewrite), ``omniscient``, ``defense_aware``, and
        ``streamable`` (data-level, or a row-local message attack)."""
        return {
            "data_level": self.message_fn is None,
            "omniscient": self.omniscient,
            "defense_aware": self.defense_aware,
            "streamable": self.message_fn is None or not self.omniscient,
        }

    def apply_data(self, x, y, num_classes: int):
        if self.data_fn is None:
            return x, y
        return self.data_fn(x, y, num_classes)

    def apply_message(self, wmatrix, byz_size: int, generator=None, param=None, noise=None,
                      defense: Optional[DefenseView] = None):
        """The attacked stack.  ``param`` binds to ``param_name``;
        ``noise`` [byz_size, d] replaces the gaussian attack's draws (the
        tests feed it the JAX package's); ``defense`` is the published
        detector state a defense-aware attack reads."""
        # checked before the no-op returns, so a knob on a knob-less attack
        # (or a defense-aware attack without a view) fails even where the
        # message pass does nothing
        if param is not None and self.param_name is None:
            raise ValueError(f"attack {self.name!r} takes no scalar parameter")
        if self.defense_aware and defense is None:
            raise ValueError(
                f"attack {self.name!r} is defense-aware: apply_message needs the "
                "published detector state (defense=DefenseView), which only "
                "exists under --defense monitor|adaptive"
            )
        if self.message_fn is None or byz_size == 0:
            return wmatrix
        kw = {self.param_name: param} if param is not None else {}
        if noise is not None:
            kw["noise"] = noise
        if self.defense_aware:
            kw["defense"] = defense
        return self.message_fn(wmatrix, byz_size, generator, **kw)


def _classflip_data(x, y, num_classes):
    # label map y -> (C-1) - y (the reference's `9.0 - targets`, :320)
    return x, (num_classes - 1) - y


def _dataflip_data(x, y, num_classes):
    # inputs are already normalized; the reference inverts the normalized
    # tensor (:326)
    return 1.0 - x, y


def honest_mean(honest: torch.Tensor) -> torch.Tensor:
    """Column mean as ``jnp.mean`` computes it: the sum times the f32
    reciprocal of the count (``torch.mean`` divides, which rounds
    differently).  The order of the f32 sum is each library's own."""
    return torch.sum(honest, dim=0) * (1.0 / honest.shape[0])


def _with_byz(wmatrix, byz_size, byz):
    honest = wmatrix[:-byz_size]
    byz = byz.expand(byz_size, wmatrix.shape[1]) if byz.dim() == 1 else byz
    return torch.cat([honest, byz.to(wmatrix.dtype)], dim=0)


def _weightflip_message(wmatrix, byz_size, generator):
    # s = honest sum; each Byzantine row -> -w_b - 2*s/B  (reference :380-383)
    s = torch.sum(wmatrix[:-byz_size], dim=0)
    return _with_byz(wmatrix, byz_size, -wmatrix[-byz_size:] - 2.0 * s / byz_size)


def _signflip_message(wmatrix, byz_size, generator):
    # Byzantine rows transmit their negated weights
    return _with_byz(wmatrix, byz_size, -wmatrix[-byz_size:])


def _gaussian_message(wmatrix, byz_size, generator, sigma: float = 1.0, noise=None):
    if noise is None:
        noise = torch.randn(
            (byz_size, wmatrix.shape[1]), generator=generator,
            device=wmatrix.device, dtype=wmatrix.dtype,
        )
    return _with_byz(wmatrix, byz_size, sigma * noise)


def _alie_message(wmatrix, byz_size, generator, z: float = 1.5):
    # "A Little Is Enough": Byzantine rows sit z honest standard deviations
    # from the honest mean per coordinate.  jnp.std divides by n: the
    # population std, correction=0
    honest = wmatrix[:-byz_size]
    mu = honest_mean(honest)
    sigma = torch.std(honest, dim=0, correction=0)
    return _with_byz(wmatrix, byz_size, mu - z * sigma)


def _ipm_message(wmatrix, byz_size, generator, eps: float = 0.5):
    # Inner-Product Manipulation: Byzantine rows are -eps times the honest
    # mean
    mu = honest_mean(wmatrix[:-byz_size])
    return _with_byz(wmatrix, byz_size, -eps * mu)


def pairwise_sq_dists(h: torch.Tensor) -> torch.Tensor:
    """[n, n] squared distances of the rows of ``h`` from their Gram
    matrix, clamped at 0 (JAX ``_pairwise_sq_dists``)."""
    sq = torch.sum(h * h, dim=1)
    gram = h @ h.T
    return torch.clamp(sq[:, None] + sq[None, :] - 2.0 * gram, min=0.0)


def agr_direction(honest: torch.Tensor):
    """(mu, p): the honest mean and the unit perturbation toward -mu."""
    mu = honest_mean(honest)
    p = -mu / torch.clamp(torch.linalg.vector_norm(mu), min=1e-12)
    return mu, p


def agr_malicious_row(honest: torch.Tensor, predicate, steps: int = AGR_STEPS):
    """``mu + gamma*p`` with gamma the largest value that satisfies
    ``predicate(row, pair)``, by ``steps`` bisection steps over [0, hi].
    gamma = 0 (the honest mean) satisfies both attacks' constraints, and
    ``hi = sqrt(max pair dist) + max dev + 1`` violates them.  Each step is
    a ``torch.where`` on device tensors: the search never reads a value on
    the host (no sync per step)."""
    mu, p = agr_direction(honest)
    dev = torch.linalg.vector_norm(honest - mu[None, :], dim=1)
    pair = pairwise_sq_dists(honest)
    hi = torch.sqrt(torch.max(pair)) + torch.max(dev) + 1.0
    lo = torch.zeros((), dtype=torch.float32, device=honest.device)
    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        ok = predicate(mu + mid * p, pair)
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return mu + lo * p


def _agr_message(wmatrix, byz_size, gamma, predicate):
    honest = wmatrix[:-byz_size]
    if gamma is not None:
        # the bisection bypassed by an explicit gamma (--attack-param)
        mu, p = agr_direction(honest)
        m = mu + float(gamma) * p
    else:
        m = agr_malicious_row(honest, lambda mm, pair: predicate(honest, mm, pair))
    return _with_byz(wmatrix, byz_size, m)


def _minmax_pred(honest, m, pair):
    # the row's largest distance to an honest row stays within the largest
    # honest pairwise distance
    d = torch.sum((honest - m[None, :]) ** 2, dim=1)
    return torch.max(d) <= torch.max(pair)


def _minsum_pred(honest, m, pair):
    # the row's summed distance to the honest rows stays within the worst
    # honest row's sum
    d = torch.sum((honest - m[None, :]) ** 2, dim=1)
    return torch.sum(d) <= torch.max(torch.sum(pair, dim=1))


def _minmax_message(wmatrix, byz_size, generator, gamma: Optional[float] = None):
    return _agr_message(wmatrix, byz_size, gamma, _minmax_pred)


def _minsum_message(wmatrix, byz_size, generator, gamma: Optional[float] = None):
    return _agr_message(wmatrix, byz_size, gamma, _minsum_pred)


def _mimic_message(wmatrix, byz_size, generator, defense=None):
    # every Byzantine row replays the honest client the defense trusts most:
    # the smallest published CUSUM, the EMA baseline as tie-break.  The row
    # is a genuine honest update; the damage is over-representation
    honest = wmatrix[:-byz_size]
    h = honest.shape[0]
    trust = defense.cusum[:h] + 1e-3 * defense.ema[:h]
    tgt = torch.argmin(trust)
    return _with_byz(wmatrix, byz_size, torch.index_select(honest, 0, tgt.reshape(1))[0])


def _under_radar_message(wmatrix, byz_size, generator, defense=None, margin: float = 0.9):
    # Byzantine rows at mu + gamma*u, u blending IPM's anti-mean push with
    # ALIE's per-coordinate honest-sigma disguise, gamma the largest value
    # (25 bisection steps) whose predicted detector step keeps every
    # Byzantine row's z and CUSUM under margin x their thresholds.  Before
    # the warm-up ends no flag is possible and the bracket's top is taken.
    # Every step stays on the device: no host sync
    from ..defense import scores as scores_lib  # defense imports ops

    honest = wmatrix[:-byz_size]
    mu = honest_mean(honest)
    sig = torch.std(honest, dim=0, correction=0)
    mu_n = torch.clamp(torch.linalg.vector_norm(mu), min=1e-12)
    sig_n = torch.clamp(torch.linalg.vector_norm(sig), min=1e-12)
    u = -(mu / mu_n + sig / sig_n)
    u = u / torch.clamp(torch.linalg.vector_norm(u), min=1e-12)
    dp = defense.detector
    warm = defense.step >= dp.warmup

    def stack_at(gamma):
        return _with_byz(wmatrix, byz_size, mu + gamma * u)

    def ok(gamma):
        score, _ = scores_lib.client_scores(stack_at(gamma), defense.guess)
        z = (score - defense.ema) / (defense.dev + dp.eps)
        cus = torch.clamp(
            torch.clamp(defense.cusum + torch.clamp(z, -dp.clip, dp.clip) - dp.drift, min=0.0),
            max=2.0 * dp.cusum_thresh,
        )
        under = ((z[-byz_size:] <= margin * dp.z_thresh)
                 & (cus[-byz_size:] <= margin * dp.cusum_thresh))
        return torch.all(under) | ~warm

    # the bracket's top: twice the honest mean and sigma scale plus the
    # honest spread; gamma = 0 (the honest mean) is feasible
    hi = 2.0 * (mu_n + sig_n) + torch.sqrt(torch.max(pairwise_sq_dists(honest)))
    lo = torch.zeros((), dtype=torch.float32, device=wmatrix.device)
    for _ in range(AGR_STEPS):
        mid = 0.5 * (lo + hi)
        good = ok(mid)
        lo, hi = torch.where(good, mid, lo), torch.where(good, hi, mid)
    return stack_at(lo)


def duty_cycle_schedule(policy) -> tuple:
    """``(on_p, period)`` of ``duty_cycle`` from the policy's constants: a
    burst long enough to climb the whole ladder, then a sleep long enough
    for the seed hysteresis to come all the way down."""
    on_p = policy.up_n * policy.n_rungs + 2
    return on_p, on_p + policy.down_m * policy.n_rungs + 2


def _duty_cycle_message(wmatrix, byz_size, generator, defense=None):
    # signflip for on_p iterations of each period, honest otherwise, keyed
    # on the detector's step counter (a device scalar)
    on_p, period = duty_cycle_schedule(defense.policy)
    active = torch.remainder(defense.step, period) < on_p
    byz = wmatrix[-byz_size:]
    return _with_byz(wmatrix, byz_size, torch.where(active, -byz, byz))


ATTACKS.register("classflip")(AttackSpec("classflip", data_fn=_classflip_data))
ATTACKS.register("dataflip")(AttackSpec("dataflip", data_fn=_dataflip_data))
ATTACKS.register("weightflip")(
    AttackSpec("weightflip", message_fn=_weightflip_message, omniscient=True)
)
ATTACKS.register("signflip")(AttackSpec("signflip", message_fn=_signflip_message))
ATTACKS.register("gradascent")(AttackSpec("gradascent", grad_scale=-1.0))
ATTACKS.register("alie")(
    AttackSpec("alie", message_fn=_alie_message, param_name="z", omniscient=True)
)
ATTACKS.register("ipm")(
    AttackSpec("ipm", message_fn=_ipm_message, param_name="eps", omniscient=True)
)
ATTACKS.register("gaussian")(
    AttackSpec("gaussian", message_fn=_gaussian_message, param_name="sigma")
)
ATTACKS.register("minmax")(
    AttackSpec("minmax", message_fn=_minmax_message, param_name="gamma", omniscient=True)
)
ATTACKS.register("minsum")(
    AttackSpec("minsum", message_fn=_minsum_message, param_name="gamma", omniscient=True)
)
ATTACKS.register("mimic")(
    AttackSpec("mimic", message_fn=_mimic_message, omniscient=True, defense_aware=True)
)
ATTACKS.register("under_radar")(
    AttackSpec("under_radar", message_fn=_under_radar_message, param_name="margin",
               omniscient=True, defense_aware=True)
)
ATTACKS.register("duty_cycle")(
    AttackSpec("duty_cycle", message_fn=_duty_cycle_message, defense_aware=True)
)


def resolve(name: Optional[str]) -> Optional[AttackSpec]:
    """Look up an attack by CLI name; None means no attack (all honest).

    ``name@R`` wraps the registered attack with a delayed onset at round R
    (``signflip@10``: honest for rounds 0..9, then sign-flipping).  The
    wrapped spec keeps the full spelled name, so titles and records tell it
    from the static attack."""
    if name is None:
        return None
    if "@" in name:
        base_name, _, onset_str = name.partition("@")
        base = ATTACKS.get(base_name)
        try:
            onset = int(onset_str)
        except ValueError:
            raise ValueError(
                f"attack onset {name!r}: expected '<attack>@<round>' with an "
                f"integer round, got {onset_str!r}"
            ) from None
        if onset < 0:
            raise ValueError(f"attack onset round must be >= 0, got {onset}")
        return dataclasses.replace(base, name=name, onset_round=onset)
    return ATTACKS.get(name)
