"""Non-adversarial fault injection, the imperfect-world counterpart of
:mod:`.attacks`.

Port of ``byzantine_aircomp_tpu/ops/faults.py``, with service mode's
deadline (:func:`apply_deadline`).  A :class:`FaultSpec` is a frozen,
registered bundle of per-round transforms on four axes:

* **dropout/straggler** (``dropout_prob``): a client fails to deliver with
  probability p, and the server replays its last delivered update from a
  carried [K, d] buffer (K copies of the initial params at first);
* **deep-fade erasure** (``fade_floor``): a client whose ``|h|^2`` falls
  below the threshold is in outage, and its row becomes NaN;
* **CSI estimation error** (``csi_std``): zero-forcing against an estimate
  ``|h| exp(eps)`` scales the row by ``exp(-eps)``; a Gilbert-Elliott
  good/bad state per client ([K] bool, carried) widens the error std by
  ``ge_bad_mult`` in the bad state;
* **payload corruption** (``corrupt_prob``/``corrupt_mode``/
  ``corrupt_size``): each of the FIRST ``corrupt_size`` clients (honest:
  the Byzantine rows are the last) emits NaN, Inf or a saturated float
  with probability p.

Dropout runs before the message attack (the buffer holds what clients
sent), corruption and the channel after it.  Every draw comes from one
``torch.Generator`` in a fixed order, or is passed in (the tests pass the
JAX package's draws).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ..registry import FAULTS
from . import channel

CORRUPT_MODES = ("nan", "inf", "saturate")
# "saturate": the largest-magnitude finite f32, a clipped or overflowed
# sender; finite, so it tests the rules' robustness, not their finite-row
# exclusion
SATURATE_VALUE = 3.0e38


@dataclass(frozen=True)
class FaultSpec:
    """A named non-adversarial failure mode; every axis is off by default,
    and :func:`resolve` overlays per-run overrides (the ``chaos`` preset
    turns them all on)."""

    name: str
    dropout_prob: float = 0.0
    # deep-fade outage threshold on |h|^2 (0 = off)
    fade_floor: float = 0.0
    # CSI estimation error, log-magnitude std (0 = perfect CSI)
    csi_std: float = 0.0
    # Gilbert-Elliott: P(good -> bad), P(bad -> good), bad-state std factor
    ge_p_gb: float = 0.0
    ge_p_bg: float = 1.0
    ge_bad_mult: float = 5.0
    corrupt_prob: float = 0.0
    corrupt_mode: str = "nan"
    corrupt_size: int = 0

    @property
    def needs_stale(self) -> bool:
        """Dropout carries the [K, d] last-delivered buffer."""
        return self.dropout_prob > 0.0

    @property
    def needs_ge(self) -> bool:
        """CSI error carries the [K] Gilbert-Elliott bad-state bools."""
        return self.csi_std > 0.0

    def validate(self) -> "FaultSpec":
        """Raise ``ValueError`` on an out-of-range knob; returns self."""
        for f in ("dropout_prob", "corrupt_prob", "ge_p_gb", "ge_p_bg"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f} must be in [0, 1], got {v}")
        if self.fade_floor < 0.0:
            raise ValueError(f"fade_floor must be >= 0, got {self.fade_floor}")
        if self.csi_std < 0.0:
            raise ValueError(f"csi_std must be >= 0, got {self.csi_std}")
        if self.ge_bad_mult < 1.0:
            raise ValueError(
                f"ge_bad_mult must be >= 1 (the bad state widens the error), "
                f"got {self.ge_bad_mult}"
            )
        if self.corrupt_mode not in CORRUPT_MODES:
            raise ValueError(
                f"corrupt_mode must be one of {CORRUPT_MODES}, got {self.corrupt_mode!r}"
            )
        if self.corrupt_size < 0:
            raise ValueError(f"corrupt_size must be >= 0, got {self.corrupt_size}")
        if self.corrupt_prob > 0.0 and self.corrupt_size < 1:
            raise ValueError("corrupt_prob > 0 needs corrupt_size >= 1 faulty clients")
        return self


# the registered scenarios, at the JAX package's documented magnitudes
FAULTS.register("dropout")(FaultSpec("dropout", dropout_prob=0.1))
FAULTS.register("deep_fade")(FaultSpec("deep_fade", fade_floor=0.05))
FAULTS.register("csi")(FaultSpec("csi", csi_std=0.2, ge_p_gb=0.1, ge_p_bg=0.5))
FAULTS.register("corrupt")(
    FaultSpec("corrupt", corrupt_prob=0.05, corrupt_mode="nan", corrupt_size=1)
)
FAULTS.register("chaos")(
    FaultSpec(
        "chaos", dropout_prob=0.1, fade_floor=0.05, csi_std=0.2, ge_p_gb=0.1,
        ge_p_bg=0.5, corrupt_prob=0.05, corrupt_mode="nan", corrupt_size=1,
    )
)


def resolve(name: Optional[str], overrides: Optional[dict] = None) -> Optional[FaultSpec]:
    """The named fault with the non-None config overrides laid over it;
    None is the ideal deployment."""
    if name is None:
        if overrides:
            raise ValueError(
                f"fault knobs {sorted(overrides)} require --fault (they override a "
                "named fault and would otherwise silently do nothing)"
            )
        return None
    spec = FAULTS.get(name)
    if overrides:
        spec = dataclasses.replace(spec, **overrides)
    return spec.validate()


class FaultState(NamedTuple):
    """The carried fault state: the stale-replay buffer [K, d] (None
    without dropout) and the Gilbert-Elliott bad states [K] (None without
    CSI error)."""

    stale: Optional[torch.Tensor]
    ge_bad: Optional[torch.Tensor]


def init_state(spec: FaultSpec, k: int, flat_params: torch.Tensor) -> FaultState:
    """The state before the first round: the buffer holds K copies of the
    initial params, so a client that drops out before it ever delivered
    replays "no progress"; every client starts in the good state."""
    stale = (
        flat_params.to(torch.float32)[None, :].repeat(k, 1) if spec.needs_stale else None
    )
    ge_bad = (
        torch.zeros(k, dtype=torch.bool, device=flat_params.device) if spec.needs_ge else None
    )
    return FaultState(stale, ge_bad)


def _bernoulli(p: float, k: int, generator, device) -> torch.Tensor:
    return torch.rand(k, generator=generator, device=device) < p


def apply_dropout(spec: FaultSpec, w_stack: torch.Tensor, stale, *,
                  generator: Optional[torch.Generator] = None,
                  dropped: Optional[torch.Tensor] = None):
    """Straggler replay, before the attack (JAX ``apply_dropout``, :195).

    Returns ``(delivered, new stale, n_dropped)``: a dropped row [K] bool
    (drawn as uniforms < p from ``generator``, or passed in) is replaced by
    the client's last delivered update, and the buffer becomes the
    delivered stack.  ``n_dropped`` is an f32 device scalar."""
    if not spec.needs_stale:
        return w_stack, stale, torch.zeros((), dtype=torch.float32, device=w_stack.device)
    k = w_stack.shape[0]
    if dropped is None:
        dropped = _bernoulli(spec.dropout_prob, k, generator, w_stack.device)
    delivered = torch.where(dropped[:, None], stale, w_stack)
    return delivered, delivered, torch.sum(dropped).to(torch.float32)


def apply_transmission(spec: FaultSpec, w_stack: torch.Tensor, ge_bad, *,
                       generator: Optional[torch.Generator] = None,
                       draws: Optional[dict] = None, row_offset: int = 0):
    """Corruption, then the channel's CSI error and deep-fade erasure,
    after the attack (JAX ``apply_transmission``, :214).

    Returns ``(w_stack, new ge_bad, n_erased, n_corrupt)``, the counts f32
    device scalars.  The draws, in the order they come from ``generator``
    (each may be passed in through ``draws``): ``"crash"`` [K] bool (uniform
    < corrupt_prob; only the first ``corrupt_size`` rows can crash),
    ``"fade"`` (h_r, h_i) [K] (:func:`.channel.rayleigh_fade`),
    ``"ge_recover"`` and ``"ge_degrade"`` [K] bool (uniform < ge_p_bg and
    < ge_p_gb), ``"csi_z"`` [K] standard normals.  The erasure tests the
    unfloored ``h_r^2 + h_i^2``.

    ``row_offset`` is the global client index of row 0: a cohort-streamed
    round passes one [cohort, d] chunk (with its ``ge_bad`` slice and its own
    generator), and the ``corrupt_size`` eligibility is judged against the
    global positions, so that the same clients can crash in any chunking
    (JAX ``row_offset``, :216)."""
    draws = draws or {}
    k = w_stack.shape[0]
    dev = w_stack.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    n_corrupt = n_erased = zero

    def draw(name, make):
        got = draws.get(name)
        return make() if got is None else got

    if spec.corrupt_prob > 0.0:
        eligible = row_offset + torch.arange(k, device=dev) < spec.corrupt_size
        crashed = eligible & draw(
            "crash", lambda: _bernoulli(spec.corrupt_prob, k, generator, dev))
        bad = {"nan": float("nan"), "inf": float("inf"),
               "saturate": SATURATE_VALUE}[spec.corrupt_mode]
        w_stack = torch.where(
            crashed[:, None], torch.tensor(bad, dtype=w_stack.dtype, device=dev), w_stack)
        n_corrupt = torch.sum(crashed).to(torch.float32)

    if spec.fade_floor > 0.0 or spec.csi_std > 0.0:
        h_r, h_i = draw("fade", lambda: channel.rayleigh_fade(k, generator=generator, device=dev))
        h_sq = h_r**2 + h_i**2
        if spec.csi_std > 0.0:
            recover = draw("ge_recover", lambda: _bernoulli(spec.ge_p_bg, k, generator, dev))
            degrade = draw("ge_degrade", lambda: _bernoulli(spec.ge_p_gb, k, generator, dev))
            ge_bad = torch.where(ge_bad, ~recover, degrade)
            std = spec.csi_std * torch.where(
                ge_bad, torch.tensor(spec.ge_bad_mult, device=dev),
                torch.tensor(1.0, device=dev))
            scale = channel.csi_error_scale(
                k, std, z=draw("csi_z", lambda: torch.randn(k, generator=generator, device=dev)))
            w_stack = w_stack * scale[:, None].to(w_stack.dtype)
        if spec.fade_floor > 0.0:
            erased = channel.deep_fade_mask(h_sq, spec.fade_floor)
            w_stack = torch.where(
                erased[:, None], torch.tensor(float("nan"), dtype=w_stack.dtype, device=dev),
                w_stack)
            n_erased = torch.sum(erased).to(torch.float32)

    return w_stack, ge_bad, n_erased, n_corrupt


def apply_deadline(w_stack: torch.Tensor, arrived: torch.Tensor, straggler_prob: float, *,
                   generator: Optional[torch.Generator] = None,
                   late: Optional[torch.Tensor] = None):
    """The service round's deadline (JAX ``apply_deadline``, :273): the rows
    of drawn clients that were offline (``arrived`` [k] False) and of
    arrived ones that miss the deadline (each with ``straggler_prob``:
    uniform < p from ``generator``, or the [k] bool ``late`` passed in; none
    at p = 0) are erased to NaN, the fault channel's "nothing received".

    Returns ``(w_stack, n_absent, n_late)``, the counts f32 device scalars."""
    missed, n_absent, n_late = deadline_misses(arrived, straggler_prob,
                                               generator=generator, late=late)
    return torch.where(missed[:, None], float("nan"), w_stack), n_absent, n_late


def deadline_misses(arrived: torch.Tensor, straggler_prob: float, *,
                    generator: Optional[torch.Generator] = None,
                    late: Optional[torch.Tensor] = None):
    """``(missed [k] bool, n_absent, n_late)`` of :func:`apply_deadline`,
    without the stack: a cohort-streamed round draws the [k] mask once and
    erases each rebuilt chunk's rows with its slice."""
    k = arrived.shape[0]
    if late is None:
        if straggler_prob > 0.0:
            late = _bernoulli(straggler_prob, k, generator, arrived.device)
        else:
            late = torch.zeros(k, dtype=torch.bool, device=arrived.device)
    late = late & arrived
    missed = late | ~arrived
    return (missed, torch.sum(~arrived).to(torch.float32),
            torch.sum(late).to(torch.float32))
