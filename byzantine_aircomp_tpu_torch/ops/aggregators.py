"""Robust aggregation rules over the [K, d] client stack.

Port of ``mean``, ``gm2``, ``gm``, ``median``, ``trimmed_mean``, ``krum``
and ``signmv`` from ``byzantine_aircomp_tpu/ops/aggregators.py`` (reference
``MNIST_Air_weight.py:131-204``; ``signmv`` goes beyond it).  Each
Weiszfeld step, each selection and each packed vote count runs through
:mod:`.kernels`: the hand-written CUDA kernel for a tensor on the card, its
plain version for one on the CPU.  Krum's Gram product is one matmul, as
the JAX package leaves it to XLA.

The JAX package keeps the Weiszfeld loop on the device
(``lax.while_loop``).  Here the loop runs in chunks of ``chunk`` steps with
no host sync inside a chunk: each step is one fused kernel launch on the
card (the Weiszfeld sums, the guess update and the stopping rule), and
once ``movement <= tol`` the guess stays as it is on the device; the host
reads the done flag once per chunk.  The result is exactly that of
stopping at the step where the JAX ``cond`` stops; steps run after
convergence change nothing, and their draws are discarded.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from ..registry import AGGREGATORS
from . import channel
from . import kernels

# Weiszfeld steps between host checks of the stopping rule
WEISZFELD_CHUNK = 16
# torch.profiler range around the Weiszfeld loop (its steps, not its set-up)
WEISZFELD_LOOP_RANGE = "weiszfeld_loop"

# aggregators of the JAX package that later slices of the port bring over
NOT_PORTED = ("multi_krum", "bulyan", "cclip", "bev", "dnc")


def _finite_rows(wmatrix: torch.Tensor) -> torch.Tensor:
    """Per-row all-finite mask [K]: an overflowed Byzantine row is a point
    at infinity, whose Weiszfeld weight is 0."""
    return torch.isfinite(wmatrix).all(dim=1)


def _finite_centroid(wmatrix: torch.Tensor, finite: torch.Tensor) -> torch.Tensor:
    # the max(.., 1) only keeps this division defined; a stack with no
    # finite row is unsupported (the aggregate is NaN regardless)
    masked = torch.where(finite[:, None], wmatrix, 0.0).to(torch.float32)
    return torch.sum(masked, dim=0) / torch.clamp(torch.sum(finite), min=1)


@AGGREGATORS.register("mean")
def mean(wmatrix: torch.Tensor, **_) -> torch.Tensor:
    """Column mean (reference ``mean``, ``:186-187``), accumulated in f32."""
    return torch.mean(wmatrix.to(torch.float32), dim=0)


def weiszfeld_solve(
    step: Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    init_guess: torch.Tensor,
    maxiter: int,
    chunk: int = WEISZFELD_CHUNK,
) -> Tuple[torch.Tensor, int]:
    """Run ``(g, active, steps) <- step(g, g_spare, active, steps, i)`` until
    the step clears ``active`` (``||g - g_next|| <= tol``) or ``maxiter``
    steps; returns ``(guess, steps run)``.

    ``step`` is a Weiszfeld step with the loop's update and stopping rule
    (:func:`.kernels.weiszfeld_advance`): on the card one fused launch that
    writes the guess into ``g_spare``, on the CPU its plain version.  The
    two guess buffers swap after each step.  Steps run in chunks of
    ``chunk`` with the done flag kept on the device; a step taken after
    convergence leaves the guess as it is, so the result equals the
    per-step loop's bit for bit (``chunk=1``).  The loop runs inside the
    profiler range ``WEISZFELD_LOOP_RANGE``, so a profile can count the
    kernels of its steps apart from the set-up's.
    """
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    # a private copy: on the card the buffers are written in place
    g = init_guess.clone()
    spare = torch.empty_like(g)
    active = torch.ones((), dtype=torch.int32, device=g.device)
    steps = torch.zeros((), dtype=torch.int64, device=g.device)
    i = 0
    with torch.profiler.record_function(WEISZFELD_LOOP_RANGE):
        while i < maxiter:
            for _ in range(min(chunk, maxiter - i)):
                g_next, active, steps = step(g, spare, active, steps, i)
                g, spare = g_next, g
                i += 1
            if not bool(active):  # the one host sync per chunk
                break
    return g, int(steps)


def _init_guess(wmatrix, guess):
    if guess is None:
        return _finite_centroid(wmatrix, _finite_rows(wmatrix))
    return guess.to(torch.float32)


def gm2_solve(
    wmatrix: torch.Tensor,
    *,
    guess: Optional[torch.Tensor] = None,
    maxiter: int = 1000,
    tol: float = 1e-5,
    chunk: int = WEISZFELD_CHUNK,
) -> Tuple[torch.Tensor, int]:
    """:func:`gm2` returning ``(aggregate, Weiszfeld steps run)``."""

    def step(g, g_out, active, steps, _i):
        return kernels.weiszfeld_step_fused(wmatrix, g, g_out, active, steps, tol)

    return weiszfeld_solve(step, _init_guess(wmatrix, guess), maxiter, chunk)


@AGGREGATORS.register("gm2")
def gm2(wmatrix: torch.Tensor, *, guess=None, maxiter: int = 1000,
        tol: float = 1e-5, **_) -> torch.Tensor:
    """Ideal geometric median by Weiszfeld iteration (reference ``gm2``,
    ``:162-184``): guess <- sum_i(w_i/d_i) / sum_i(1/d_i) with d_i clamped
    at 1e-4, stopping when the guess moves <= tol or after maxiter steps.
    Non-finite rows are excluded (weight 0)."""
    return gm2_solve(wmatrix, guess=guess, maxiter=maxiter, tol=tol)[0]


def gm_solve(
    wmatrix: torch.Tensor,
    *,
    noise_var: Optional[float] = None,
    guess: Optional[torch.Tensor] = None,
    maxiter: int = 1000,
    tol: float = 1e-5,
    p_max: float = 1.0,
    generator: Optional[torch.Generator] = None,
    fades: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    noise: Optional[torch.Tensor] = None,
    chunk: int = WEISZFELD_CHUNK,
) -> Tuple[torch.Tensor, int]:
    """:func:`gm` returning ``(aggregate, Weiszfeld steps run)``.

    Step t draws the fades' standard normals [K] twice and, with
    ``noise_var`` set, the receiver's standard normals [d+1] from
    ``generator`` in that order (the fades are ``channel.FADE_STD`` times
    the first two, as ``channel.rayleigh_fade`` makes them); or reads the
    fades from ``fades`` = (h_r [T, K], h_i [T, K]) and the normals from
    ``noise`` [T, d+1], T >= the steps run (the tests pass the JAX
    package's draws this way).  The scaler (RMS of the guess) is carried
    from step to step on the device."""
    k, d = wmatrix.shape
    dev = wmatrix.device
    noise_scale = None
    if noise_var is not None:
        # on the host: the kernel takes it as a float, the plain version as
        # this tensor, and both get the same bits
        noise_scale = torch.sqrt(torch.tensor(noise_var, dtype=torch.float32) / 2.0)
    init = _init_guess(wmatrix, guess)
    scaler = kernels.guess_rms(init)

    def step(g, g_out, active, steps, i):
        nonlocal scaler
        if fades is None:
            h_r = torch.randn(k, generator=generator, device=dev)
            h_i = torch.randn(k, generator=generator, device=dev)
            fade_scale = channel.FADE_STD
        else:
            h_r, h_i, fade_scale = fades[0][i], fades[1][i], None
        z = None
        if noise_scale is not None:
            z = torch.randn(d + 1, generator=generator, device=dev) if noise is None else noise[i]
        g, active, steps, scaler = kernels.aircomp_weiszfeld_step_fused(
            wmatrix, g, g_out, active, steps, tol, h_r, h_i, scaler,
            fade_scale=fade_scale, z=z, noise_scale=noise_scale, p_max=p_max,
        )
        return g, active, steps

    return weiszfeld_solve(step, init, maxiter, chunk)


@AGGREGATORS.register("gm", owns_channel=True)
def gm(wmatrix: torch.Tensor, *, noise_var=None, guess=None, maxiter: int = 1000,
       tol: float = 1e-5, p_max: float = 1.0, generator=None, fades=None,
       noise=None, **_) -> torch.Tensor:
    """AirComp geometric median (reference ``gm``, ``:131-160``).

    Each Weiszfeld step transmits the per-client messages
    ``[w_i/d_i, scaler/d_i]`` (scaler = RMS of the current guess) through
    OMA2 with P_max and threshold ``500 * scaler^2`` (``:146-152``), then
    sets ``guess <- noisy_num / noisy_den * scaler`` (``:153-155``).  Fades
    are floored at ``channel.HSQ_FLOOR`` as the JAX package's XLA path does.
    Non-finite rows transmit nothing."""
    return gm_solve(
        wmatrix, noise_var=noise_var, guess=guess, maxiter=maxiter, tol=tol,
        p_max=p_max, generator=generator, fades=fades, noise=noise,
    )[0]


@AGGREGATORS.register("median", supports_fused_epilogue=True)
def median(wmatrix: torch.Tensor, *, channel: Optional[channel.OmaTerms] = None,
           **_) -> torch.Tensor:
    """Coordinatewise median with torch semantics: the lower-middle order
    statistic ``sorted[(K-1)//2]`` (reference ``median``, ``:194-195``),
    selected over IEEE total-order keys, so a NaN or +-Inf row ranks as a
    sort ranks it.  ``channel``: the OMA link's terms, folded into the
    stack read (``w + oma_residual(channel)``, bitwise the received stack
    of ``channel.oma``)."""
    return kernels.fused_median(wmatrix.to(torch.float32).contiguous(), channel)


@AGGREGATORS.register("trimmed_mean", supports_fused_epilogue=True)
def trimmed_mean(wmatrix: torch.Tensor, *, trim_ratio: float = 0.1,
                 beta: Optional[int] = None,
                 channel: Optional[channel.OmaTerms] = None, **_) -> torch.Tensor:
    """Coordinatewise beta-trimmed mean: ``b = int(K * trim_ratio)`` (or
    ``beta``) entries dropped at each end, the mean of the middle K - 2b
    (reference ``trimmed_mean``, ``:189-192``), with the optional channel
    fold of :func:`median`."""
    k = wmatrix.shape[0]
    b = int(k * trim_ratio) if beta is None else int(beta)
    return kernels.fused_trimmed_mean(
        wmatrix.to(torch.float32).contiguous(), b, channel
    )


def pairwise_sq_dists(wmatrix: torch.Tensor) -> torch.Tensor:
    """[K, K] squared distances by the Gram form
    ``||w_i||^2 + ||w_j||^2 - 2 <w_i, w_j>``, clamped at 0 (JAX
    ``pairwise_sq_dists``, :340).  A NaN distance (Inf - Inf from a
    non-finite row) becomes +Inf: NaN would rank as the smallest distance.
    The diagonal is 0 for a row with a finite squared norm and +Inf for a
    poisoned one, so a poisoned row can never win the selection."""
    w = wmatrix.to(torch.float32)
    sq = torch.einsum("kd,kd->k", w, w)
    gram = w @ w.T
    dist = sq[:, None] + sq[None, :] - 2.0 * gram
    dist = torch.where(torch.isnan(dist), math.inf, dist)
    dist = torch.clamp(dist, min=0.0)
    k = w.shape[0]
    diag = torch.where(torch.isfinite(sq), 0.0, math.inf)
    eye = torch.eye(k, dtype=torch.bool, device=w.device)
    return torch.where(eye, diag[:, None], dist)


def krum_scores(wmatrix: torch.Tensor, honest_size: int) -> torch.Tensor:
    """Per-client Krum score: the sum of the ``honest_size - 1`` smallest
    entries of its distance row, self-distance included (reference
    ``:200-202``).  Summed directly, never as the row sum minus the largest
    entries: under attack the largest distances dwarf the honest ones and
    the f32 subtraction would cancel them away."""
    dist = pairwise_sq_dists(wmatrix)
    smallest = torch.topk(dist, honest_size - 1, dim=1, largest=False).values
    return torch.sum(smallest, dim=1)


@AGGREGATORS.register("krum", aliases=("Krum",), needs_honest_size=True)
def krum(wmatrix: torch.Tensor, *, honest_size: int, **_) -> torch.Tensor:
    """Single-Krum: the client row with the least Krum score (reference
    ``Krum``, ``:197-204``); ``argmin`` takes the first index on a tie."""
    return wmatrix[torch.argmin(krum_scores(wmatrix, honest_size))]


# packed one-bit sign channel: [K, W = ceil(d/32)] words, LSB-first,
# coordinate c at bit c % 32 of word c // 32 (JAX ops/aggregators.py:600-626).
# Bit 1 = ballot +1 (delta >= 0, so a zero delta votes +1), bit 0 = ballot
# -1; a row with any non-finite delta packs all-zero and leaves k_valid.
# torch carries the words as int32 with the uint32 bits.


def packed_words(d: int) -> int:
    """Sign words per client for a d-coordinate delta."""
    return -(-d // kernels.SIGN_WORD_BITS)


def pack_signs(wmatrix: torch.Tensor, guess: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[K, d] stack + pre-round params -> ``(words [K, W] int32, k_valid)``,
    ``k_valid`` the count of all-finite rows (an int32 device scalar)."""
    k, d = wmatrix.shape
    w_cnt = packed_words(d)
    delta = wmatrix.to(torch.float32) - guess[None, :].to(torch.float32)
    finite = torch.isfinite(delta).all(dim=1)
    ballot_up = finite[:, None] & (delta >= 0.0)
    bits = F.pad(ballot_up, (0, w_cnt * kernels.SIGN_WORD_BITS - d))
    bits = bits.reshape(k, w_cnt, kernels.SIGN_WORD_BITS).to(torch.int64)
    shifts = torch.arange(kernels.SIGN_WORD_BITS, dtype=torch.int64, device=bits.device)
    # the word as int64 in [0, 2^32), then wrapped to the int32 with the same
    # bits (summing 1 << 31 in int32 would overflow)
    words = torch.sum(bits << shifts, dim=-1)
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    return words.contiguous(), torch.sum(finite).to(torch.int32)


def packed_sign_votes(words: torch.Tensor, d: int) -> torch.Tensor:
    """Per-coordinate set-bit counts [d] int32 of the packed sign words."""
    return kernels.packed_vote_counts(words, d)


def _packed_sign_step(wmatrix, guess, noise, sign_eta):
    """sign_bits = 1: pack, count the ballots, recover the signed votes
    ``2*counts - k_valid`` (each set bit +1, each clear bit of a valid row
    -1), and step ``sign_eta`` in the voted direction."""
    if sign_eta is None:
        raise ValueError(
            "signmv at sign_bits=1 needs an explicit sign_eta: the one-bit "
            "channel carries no magnitudes for the adaptive eta median"
        )
    words, k_valid = pack_signs(wmatrix, guess)
    counts = packed_sign_votes(words, wmatrix.shape[1])
    votes = (2 * counts - k_valid).to(torch.float32) + noise
    return guess + _f32(sign_eta, guess) * torch.sign(votes)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


@AGGREGATORS.register("signmv", owns_channel=True)
def sign_majority_vote(
    wmatrix: torch.Tensor,
    *,
    guess: Optional[torch.Tensor] = None,
    noise_var: Optional[float] = None,
    sign_eta: Optional[float] = None,
    sign_bits: int = 32,
    generator: Optional[torch.Generator] = None,
    vote_noise: Optional[torch.Tensor] = None,
    **_,
) -> torch.Tensor:
    """One-bit over-the-air aggregation, sign-SGD with majority vote (JAX
    ``sign_majority_vote``, :748; beyond the reference):

        new = guess + eta * sign( sum_i sign(w_i - guess) + n )

    Each client sends the sign of its delta; the receiver sees their sum
    over the air, plus ``n = sqrt(noise_var/2) * z`` with ``z`` [d] standard
    normals from ``generator`` (or ``vote_noise``) when ``noise_var`` is
    set.  A tied coordinate does not move.  ``eta`` is ``sign_eta``, else
    the coordinatewise median of ``|w_i - guess|``.  ``sign_bits``: 32 sends
    full-precision ballots (a non-finite delta casts a 0 ballot); 1 packs
    them into 32-bit words and counts them with the popcount kernel (a row
    with any non-finite delta casts none, and needs ``sign_eta``)."""
    if guess is None:
        raise ValueError("signmv needs the pre-round params as `guess`")
    if sign_bits not in (1, 32):
        raise ValueError(
            f"signmv sign_bits={sign_bits} is not ported to the torch package "
            "yet (1 and 32 are)"
        )
    d = wmatrix.shape[1]
    dev = wmatrix.device
    guess = guess.to(torch.float32)
    if noise_var is None:
        noise = torch.zeros(d, dtype=torch.float32, device=dev)
    else:
        z = (torch.randn(d, generator=generator, device=dev)
             if vote_noise is None else vote_noise)
        noise = torch.sqrt(_f32(noise_var, guess) / 2.0) * z
    if sign_bits == 1:
        return _packed_sign_step(wmatrix, guess, noise, sign_eta)
    delta = wmatrix.to(torch.float32) - guess[None, :]
    finite = torch.isfinite(delta)
    votes = torch.sum(torch.where(finite, torch.sign(delta), 0.0), dim=0) + noise
    if sign_eta is None:
        eta = median(torch.where(finite, torch.abs(delta), math.inf))
        # where >= ceil(K/2) deltas are non-finite the median is Inf, and
        # Inf * sign(0) on a tie would be NaN: no step there instead
        eta = torch.where(torch.isfinite(eta), eta, 0.0)
    else:
        eta = _f32(sign_eta, guess)
    return guess + eta * torch.sign(votes)


def resolve(name: str):
    """Look up an aggregator by its reference-compatible CLI name."""
    if name in NOT_PORTED:
        raise KeyError(
            f"aggregator {name!r} is not ported to the torch package yet; "
            f"ported: {', '.join(AGGREGATORS.names())}"
        )
    return AGGREGATORS.get(name)


def needs_oma_prepass(name: str) -> bool:
    """Channel-dispatch rule (reference ``:351-352``): with ``--var`` set,
    every aggregator except ``gm`` and ``signmv`` sees a one-shot per-client
    OMA corruption of the stack; ``gm`` runs its own OMA2 inside each
    Weiszfeld step, ``signmv`` adds receiver noise to its vote."""
    return not AGGREGATORS.meta(name).get("owns_channel", False)


def supports_fused_epilogue(name: str) -> bool:
    """Aggregators that take the OMA terms as ``channel=`` and fold the
    corruption into their one read of the stack (median, trimmed_mean)."""
    return bool(AGGREGATORS.meta(name).get("supports_fused_epilogue", False))
