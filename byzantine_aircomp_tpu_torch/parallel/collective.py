"""Collectives for the AirComp primitives on the (clients, model) grid of
ranks (JAX ``parallel/collective.py``).

The reference's over-the-air sum ``OMA2`` (``MNIST_Air_weight.py:408-414``)
is a sum with noise: every client transmits at once and the receiver sees
the superposition.  Over a process group that is one ``all_reduce`` over
the clients axis.  Every function here takes the rank's block of the
[K, d] stack (its rows :meth:`.mesh.RankGrid.row_block`, its columns
:meth:`.mesh.RankGrid.col_block`) and returns the rank's columns of the
[d] result, the same on every rank of a grid column.

Random draws (fades, receiver noise) are made once, from one generator, on
every rank, at the full sizes the single-device function draws; each rank
then takes its rows and columns, as the JAX package draws outside its
``shard_map``.  So a sharded step sees the single-device step's numbers.

With one model block a Weiszfeld step runs the hand-written kernels' num/den
mode on the rank's whole rows (:func:`..ops.kernels.weiszfeld_step`,
:func:`..ops.kernels.aircomp_weiszfeld_step`) and one ``all_reduce`` of
``[num, den]`` over the clients axis.  With several, a row's distance spans
the model blocks: its partial squared distances (and its finiteness) are
all-reduced over the model axis first, in plain torch ops, as JAX computes
them outside Pallas.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..ops import aggregators as agg_lib
from ..ops import channel
from ..ops import kernels
from .mesh import CLIENT_AXIS, MODEL_AXIS, RankGrid


def air_sum(grid: RankGrid, message: torch.Tensor, d: int, fades, noise=None,
            p_max: float = 10.0, noise_var: Optional[float] = None,
            threshold=1.0) -> torch.Tensor:
    """Sharded OMA2: the rank's [K/P, d/M] block -> its [d/M] columns of
    :func:`..ops.channel.oma2` on the same draws.  ``fades`` = (h_r, h_i)
    [K] and ``noise`` the [d] receiver normals, both whole.  The row power
    (a mean over all d) is one all_reduce over the model axis, the
    superposition one over the clients axis.  The fade is floored at
    ``channel.HSQ_FLOOR`` as the port's ``oma2`` floors it."""
    rows, cols = grid.row_block(fades[0].shape[0]), grid.col_block(d)
    h_sq = channel.floored_hsq(fades[0][rows], fades[1][rows])
    row_sumsq = grid.all_reduce(torch.sum(message**2, dim=1), MODEL_AXIS)
    p_upper = torch.clamp(row_sumsq / d / h_sq, min=threshold)
    gain = torch.sqrt(p_max / p_upper)
    total = grid.all_reduce(torch.sum(message * gain[:, None], dim=0), CLIENT_AXIS)
    if noise_var is None:
        return total
    scale = torch.sqrt(torch.tensor(noise_var, dtype=torch.float32, device=total.device) / 2.0)
    return total + scale * noise[cols]


def sharded_mean(grid: RankGrid, w: torch.Tensor, k: int) -> torch.Tensor:
    """Column mean of the sharded stack: one all_reduce over clients."""
    return grid.all_reduce(torch.sum(w.to(torch.float32), dim=0), CLIENT_AXIS) / k


def _global_finite(grid: RankGrid, w: torch.Tensor) -> torch.Tensor:
    """[K/P] bool: the row is finite in every model block."""
    bad = (~torch.isfinite(w)).any(dim=1).to(torch.float32)
    return grid.all_reduce(bad, MODEL_AXIS) == 0.0


def _num_den(grid: RankGrid, num: torch.Tensor, den: torch.Tensor):
    """One all_reduce of ``[num, den]`` over the clients axis."""
    both = grid.all_reduce(torch.cat([num, den.reshape(1)]), CLIENT_AXIS)
    return both[:-1], both[-1]


def sharded_weiszfeld_step(grid: RankGrid, w: torch.Tensor, guess: torch.Tensor) -> torch.Tensor:
    """One ideal Weiszfeld update on the sharded stack; ``guess`` is the
    rank's columns.  A non-finite row weighs 0 on every block (without the
    mask, ``0 * Inf`` would sum NaN into every coordinate)."""
    if grid.n_model == 1:
        # whole rows: the kernel's num/den mode on this rank's rows
        num, den = kernels.weiszfeld_step(w.contiguous(), guess)
    else:
        finite = _global_finite(grid, w)
        wm = torch.where(finite[:, None], w.to(torch.float32), 0.0)
        d_part = torch.sum((wm - guess[None, :]) ** 2, dim=1)
        dist_ = torch.clamp(torch.sqrt(grid.all_reduce(d_part, MODEL_AXIS)),
                            min=kernels.DIST_CLAMP)
        inv = torch.where(finite, 1.0 / dist_, 0.0)
        num, den = torch.sum(wm * inv[:, None], dim=0), torch.sum(inv)
    num, den = _num_den(grid, num, den)
    return num / den


def _advance(grid: RankGrid, g, g_next, active, steps, tol):
    """The Weiszfeld loop's update and stopping rule on the device
    (:func:`..ops.kernels.weiszfeld_advance`), the movement over all d (a
    model-axis all_reduce of the rank's columns' squares)."""
    if grid.n_model == 1:
        return kernels.weiszfeld_advance(g, g_next, active, steps, tol)
    on = active != 0
    movement = torch.sqrt(grid.all_reduce(torch.sum((g - g_next) ** 2), MODEL_AXIS))
    return (torch.where(on, g_next, g), (on & (movement > tol)).to(torch.int32),
            steps + on.to(torch.int64))


def _finite_centroid(grid: RankGrid, w: torch.Tensor) -> torch.Tensor:
    finite = _global_finite(grid, w)
    s = torch.sum(torch.where(finite[:, None], w.to(torch.float32), 0.0), dim=0)
    s, n = _num_den(grid, s, torch.sum(finite).to(torch.float32))
    return s / torch.clamp(n, min=1.0)


def sharded_gm2(grid: RankGrid, w: torch.Tensor, *, guess: Optional[torch.Tensor] = None,
                maxiter: int = 1000, tol: float = 1e-5) -> Tuple[torch.Tensor, int]:
    """Sharded :func:`..ops.aggregators.gm2`: :func:`sharded_weiszfeld_step`
    in the one-device loop (:func:`..ops.aggregators.weiszfeld_solve`: the
    stopping rule on the device, its done flag read on the host once per 16
    steps, the same on every rank), until the step whose movement is not
    above ``tol``, or ``maxiter`` steps.  ``guess`` is the rank's columns.
    Returns ``(columns, steps)``."""
    g0 = _finite_centroid(grid, w) if guess is None else guess.to(torch.float32)

    def step(g, _g_out, active, steps, _i):
        return _advance(grid, g, sharded_weiszfeld_step(grid, w, g), active, steps, tol)

    return agg_lib.weiszfeld_solve(step, g0, maxiter, unrolled=False)


def sharded_aircomp_weiszfeld_step(grid: RankGrid, w: torch.Tensor, guess: torch.Tensor,
                                   h_sq: torch.Tensor, scaler: torch.Tensor, d: int,
                                   p_max: float = 1.0):
    """The noiseless receiver sums ``(num [d/M], den [])`` of one AirComp
    Weiszfeld step (:func:`..ops.kernels.aircomp_weiszfeld_step`) over the
    whole stack; ``h_sq`` holds the rank's rows' fades.  The caller adds
    the receiver noise."""
    if grid.n_model == 1:
        num, den = kernels.aircomp_weiszfeld_step(w.contiguous(), guess, h_sq, scaler, p_max)
    else:
        finite = _global_finite(grid, w)
        wz = torch.where(finite[:, None], w.to(torch.float32), 0.0)
        s = scaler.reshape(())
        parts = grid.all_reduce(torch.stack([torch.sum((wz - guess[None, :]) ** 2, dim=1),
                                             torch.sum(wz * wz, dim=1)]), MODEL_AXIS)
        inv = 1.0 / torch.clamp(torch.sqrt(parts[0]), min=kernels.DIST_CLAMP)
        p_message = inv * inv * (parts[1] + s * s) / (d + 1.0) / h_sq
        gain = torch.sqrt(p_max / torch.maximum(p_message,
                                                kernels.GM_THRESHOLD_FACTOR * s * s))
        coeff = torch.where(finite, gain * inv, 0.0)
        num, den = torch.sum(wz * coeff[:, None], dim=0), torch.sum(coeff) * s
    return _num_den(grid, num, den)


def sharded_gm(grid: RankGrid, w: torch.Tensor, *, d: int, noise_var=None, guess=None,
               maxiter: int = 1000, tol: float = 1e-5, p_max: float = 1.0,
               generator=None) -> Tuple[torch.Tensor, int]:
    """Sharded :func:`..ops.aggregators.gm` (the paper's AirComp geometric
    median) in the one-device loop (as :func:`sharded_gm2`): step t draws
    the fades' normals [K] twice and the receiver's [d+1] from
    ``generator``, in ``gm_solve``'s order, on every rank (a step after the
    stop within its chunk of 16 draws too, and leaves the guess as it is,
    as the one-device loop does); ``guess`` is the rank's columns.  Returns
    ``(columns, steps)``."""
    k_loc = w.shape[0]
    k = k_loc * grid.n_clients
    rows, cols = grid.row_block(k), grid.col_block(d)
    dev = w.device
    noise_scale = None
    if noise_var is not None:
        noise_scale = torch.sqrt(torch.tensor(noise_var, dtype=torch.float32) / 2.0)
    g0 = _finite_centroid(grid, w) if guess is None else guess.to(torch.float32)

    def rms(v):
        return torch.sqrt(grid.all_reduce(torch.sum(v * v), MODEL_AXIS) / d).reshape(1)

    scaler = rms(g0)

    def step(g, _g_out, active, steps, _i):
        nonlocal scaler
        h_r = torch.randn(k, generator=generator, device=dev)
        h_i = torch.randn(k, generator=generator, device=dev)
        h_sq = channel.floored_hsq(channel.FADE_STD * h_r[rows], channel.FADE_STD * h_i[rows])
        num, den = sharded_aircomp_weiszfeld_step(grid, w, g, h_sq, scaler, d, p_max)
        if noise_scale is not None:
            n = noise_scale * torch.randn(d + 1, generator=generator, device=dev)
            num, den = num + n[:-1][cols], den + n[-1]
        g, active, steps = _advance(grid, g, num / den * scaler, active, steps, tol)
        scaler = rms(g)
        return g, active, steps

    return agg_lib.weiszfeld_solve(step, g0, maxiter, unrolled=False)


def _ring_shift(grid: RankGrid, buf: torch.Tensor) -> torch.Tensor:
    """Send ``buf`` to the next rank of the clients axis and receive the
    previous one's: one hop of the ring (``batch_isend_irecv``)."""
    nxt, prv = grid.ring_peers()
    out = torch.empty_like(buf)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, buf, nxt),
                                   dist.P2POp(dist.irecv, out, prv)])
    for r in reqs:
        r.wait()
    return out


def ring_krum_scores(grid: RankGrid, w: torch.Tensor, honest_size: int,
                     d: Optional[int] = None) -> torch.Tensor:
    """Krum scores [K] of the sharded stack by a ring over the clients axis.

    Each of the P client blocks keeps its [K/P, d] rows; over P - 1 hops
    (``batch_isend_irecv``) the blocks travel the ring while each rank
    computes one [K/P, K/P] Gram block per hop, so no rank holds the whole
    stack.  Then the guards of :func:`..ops.aggregators.pairwise_sq_dists`
    (NaN -> +Inf, cancellation clamped at 0, the diagonal 0 for a finite row
    and +Inf for a poisoned one), the sum of the ``honest_size - 1``
    smallest entries of each row, and one all_gather of the tiny [K/P]
    scores over the clients axis.

    With a model axis the block's columns are gathered over it first
    (``d`` is the full width).  The JAX package all-reduces partial
    distances over the model axis instead; whole rows make each distance
    an entry of the one-device Gram product, so honest rows whose scores
    lie within rounding of each other rank as they do on one device."""
    if grid.n_model > 1:
        if d is None:
            raise ValueError("ring_krum_scores on a model axis needs the full width d")
        w = grid.gather_cols(w, d)
    p = grid.n_clients
    k_loc = w.shape[0]
    k = k_loc * p
    me = grid.client_index
    w32 = w.to(torch.float32)
    my_sq = torch.einsum("kd,kd->k", w32, w32)
    dist_rows = torch.empty((k_loc, k), dtype=torch.float32, device=w.device)
    # the block and its squared norms travel together, one buffer per hop
    buf = torch.cat([w32, my_sq[:, None]], dim=1)
    for s in range(p):
        src = (me - s) % p
        blk, blk_sq = buf[:, :-1], buf[:, -1]
        dist_rows[:, src * k_loc:(src + 1) * k_loc] = (
            my_sq[:, None] + blk_sq[None, :] - 2.0 * (w32 @ blk.T))
        if s < p - 1:
            buf = _ring_shift(grid, buf)
    full_sq = my_sq
    dist_rows = torch.where(torch.isnan(dist_rows), math.inf, dist_rows)
    dist_rows = torch.clamp(dist_rows, min=0.0)
    self_val = torch.where(torch.isfinite(full_sq), 0.0, math.inf)
    idx = torch.arange(k_loc, device=w.device)
    dist_rows[idx, me * k_loc + idx] = self_val
    smallest = torch.topk(dist_rows, honest_size - 1, dim=1, largest=False).values
    return grid.gather_rows(torch.sum(smallest, dim=1))


def _weighted_rows(grid: RankGrid, w: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``weights @ stack`` of the sharded stack (the rank's rows' [K]
    weights, zero-weight rows selected to 0), one all_reduce over clients."""
    local = weights[grid.row_block(weights.shape[0])]
    part = local @ torch.where(local[:, None] > 0, w, 0.0).to(torch.float32)
    return grid.all_reduce(part, CLIENT_AXIS)


def ring_krum(grid: RankGrid, w: torch.Tensor, *, honest_size: int,
              d: Optional[int] = None, **_) -> torch.Tensor:
    """Single-Krum on the sharded stack: the least score's row as a one-hot
    weighted sum (rejected rows selected to 0, so an Inf row cannot make
    ``0 * Inf``)."""
    scores = ring_krum_scores(grid, w, honest_size, d)
    weights = torch.zeros_like(scores)
    weights[torch.argmin(scores)] = 1.0
    return _weighted_rows(grid, w, weights)


def ring_multi_krum(grid: RankGrid, w: torch.Tensor, *, honest_size: int,
                    m: Optional[int] = None, d: Optional[int] = None, **_) -> torch.Tensor:
    """Multi-Krum on the sharded stack: the mean of the m lowest-scoring
    rows (ties lowest index first, :func:`..ops.aggregators.lowest`)."""
    m_sel = honest_size if m is None else int(m)
    scores = ring_krum_scores(grid, w, honest_size, d)
    weights = torch.zeros_like(scores)
    weights[agg_lib.lowest(scores, m_sel)] = 1.0 / m_sel
    return _weighted_rows(grid, w, weights)


def ring_bulyan(grid: RankGrid, w: torch.Tensor, *, honest_size: int,
                d: Optional[int] = None, **_) -> torch.Tensor:
    """Bulyan on the sharded stack: the ring's Krum scores pick theta rows;
    the rank's picked rows go into a [theta, d/M] selection in score order
    (unpicked slots selected to 0), one all_reduce over clients completes
    it, and the coordinatewise tail (:func:`..ops.aggregators.bulyan_tail`)
    runs on the rank's columns."""
    scores = ring_krum_scores(grid, w, honest_size, d)
    k = scores.shape[0]
    theta, beta = agg_lib.bulyan_sizes(k, k - honest_size)
    idx = agg_lib.lowest(scores, theta)
    rows = grid.row_block(k)
    mine = (idx >= rows.start) & (idx < rows.stop)
    local = torch.clamp(idx - rows.start, 0, w.shape[0] - 1)
    sel = torch.where(mine[:, None], w[local].to(torch.float32), 0.0)
    return agg_lib.bulyan_tail(grid.all_reduce(sel, CLIENT_AXIS).to(w.dtype), beta)
