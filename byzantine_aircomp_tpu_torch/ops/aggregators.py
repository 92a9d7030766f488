"""Robust aggregation rules over the [K, d] client stack.

Port of every rule of ``byzantine_aircomp_tpu/ops/aggregators.py``: the
reference's ``mean``, ``gm2``, ``gm``, ``median``, ``trimmed_mean`` and
``krum`` (``MNIST_Air_weight.py:131-204``), and beyond it ``multi_krum``,
``bulyan``, ``cclip``, ``dnc``, ``signmv`` and ``bev``, with the degraded
(fault-mode) variants.  Each Weiszfeld step, each coordinatewise median or
trimmed mean over a static K and each packed vote count runs through
:mod:`.kernels`: the hand-written CUDA kernel for a tensor on the card, its
plain version for one on the CPU, or what the trainer's ``agg_impl`` picks
(:func:`.kernels.implementation`).  Krum's Gram product is one matmul, and
the degraded rules' dynamic ranks a ``torch.sort``, as the JAX package
leaves both to XLA.

Selections that JAX makes with ``lax.top_k`` take ties lowest index first;
``torch.topk`` promises no order on ties, so every selection whose tie
order reaches the result (multi_krum's winners, bulyan's theta rows and
beta closest values, dnc's removals) is a stable ``torch.sort`` instead.

The JAX package keeps the Weiszfeld loop on the device
(``lax.while_loop``).  Here the loop runs in chunks of ``chunk`` steps with
no host sync inside a chunk: each step is one fused kernel launch on the
card (the Weiszfeld sums, the guess update and the stopping rule), and
once ``movement <= tol`` the guess stays as it is on the device; the host
reads the done flag once per chunk.  The result is exactly that of
stopping at the step where the JAX ``cond`` stops; steps run after
convergence change nothing, and their draws are discarded.  Inside a
CUDA-graph capture (``fed/graphs.py``) the loop reads nothing on the host
and gives the same bits: gm2's runs the same chunks as a conditional WHILE
node, which the device stops after the chunk in which it converges; gm's
steps draw, so its loop is unrolled to ``maxiter`` steps.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from ..obs.span import span
from ..registry import AGGREGATORS
from . import channel
from . import kernels
from . import shardctx

# Weiszfeld steps between host checks of the stopping rule
WEISZFELD_CHUNK = 16
# the span around the Weiszfeld loop (its steps, not its set-up)
WEISZFELD_LOOP_RANGE = "weiszfeld_loop"

# one-shot budget, in elements, of the dense selection paths' largest
# temporary (JAX ``_DENSE_MAX_ELEMS``): above it multi_krum, bulyan and the
# sign votes run over column blocks
_DENSE_MAX_ELEMS = 1 << 25


def _finite_rows(wmatrix: torch.Tensor) -> torch.Tensor:
    """Per-row all-finite mask [K]: an overflowed Byzantine row is a point
    at infinity, whose Weiszfeld weight is 0."""
    return torch.isfinite(wmatrix).all(dim=1)


def _finite_centroid(wmatrix: torch.Tensor, finite: torch.Tensor) -> torch.Tensor:
    # the max(.., 1) only keeps this division defined; a stack with no
    # finite row is unsupported (the aggregate is NaN regardless)
    masked = torch.where(finite[:, None], wmatrix, 0.0).to(torch.float32)
    return torch.sum(masked, dim=0) / torch.clamp(torch.sum(finite), min=1)


def _nan_unless(ok: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    return torch.where(ok, out, math.nan)


def _f32_scalar(x) -> torch.Tensor:
    """A Python float as a 0-dim f32 CPU tensor (which takes part in a CUDA
    op with no copy), or a device scalar as it is (no host read)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.tensor(x, dtype=torch.float32)


@AGGREGATORS.register("mean", streamable=True, graphable=True)
def mean(wmatrix: torch.Tensor, *, degraded: bool = False, **_) -> torch.Tensor:
    """Column mean (reference ``mean``, ``:186-187``), accumulated in f32.
    ``degraded``: the mean of the finite rows only, NaN when there is none
    (the trainer's finite guard then keeps the previous params)."""
    if degraded:
        finite = _finite_rows(wmatrix)
        return _nan_unless(torch.sum(finite) > 0, _finite_centroid(wmatrix, finite))
    return torch.mean(wmatrix.to(torch.float32), dim=0)


def solve_mode(unrolled: Optional[bool], capturing: bool,
               loop_kernel: Optional[str]) -> str:
    """How :func:`weiszfeld_solve` runs its loop: ``"chunked"`` (a host read
    of the done flag per chunk), ``"unrolled"`` (all ``maxiter`` steps, no
    host read) or ``"loop"`` (a conditional WHILE node of a CUDA graph).
    ``unrolled`` None takes the first where no capture runs, and inside a
    capture the loop node where the step is one launch of ``loop_kernel``
    alone, else (a step that draws) the unrolled loop."""
    if unrolled is None:
        if not capturing:
            return "chunked"
        return "unrolled" if loop_kernel is None else "loop"
    return "unrolled" if unrolled else "chunked"


def weiszfeld_solve(
    step: Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    init_guess: torch.Tensor,
    maxiter: int,
    chunk: int = WEISZFELD_CHUNK,
    unrolled: Optional[bool] = None,
    loop_kernel: Optional[str] = None,
) -> Tuple[torch.Tensor, "int | torch.Tensor"]:
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
    span ``WEISZFELD_LOOP_RANGE``, so a profile can count the kernels of
    its steps apart from the set-up's.  The steps run are counted in
    :func:`.kernels.live_steps`.

    Inside a CUDA-graph capture no host read can end the loop
    (:func:`solve_mode`).  ``loop_kernel`` names the kernel (a key of
    :data:`.kernels.LAUNCHES`) where a step is one launch of it and nothing
    else: then the chunks run as a conditional WHILE node, its body one
    chunk of steps and :func:`.kernels.weiszfeld_loop_condition`, which
    stops the loop after the chunk in which ``active`` clears, and an IF
    node runs the last ``maxiter % chunk`` steps while the solve is active;
    the body's steps are counted on the device.  Else (a step that draws or
    runs a torch op, which a body run again and again would repeat) the
    loop is unrolled to ``maxiter`` steps, those after convergence copying
    the guess.  Either way the guess is the chunked loop's bit for bit, and
    the steps run come back as a device int64 scalar instead of an int,
    which one in-place add (a node of the graph) counts on the device.
    ``unrolled=True`` unrolls the loop anywhere, ``False`` chunks it.
    """
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    mode = solve_mode(unrolled, init_guess.device.type == "cuda"
                      and torch.cuda.is_current_stream_capturing(), loop_kernel)
    # a private copy: on the card the buffers are written in place
    g = init_guess.clone()
    spare = torch.empty_like(g)
    active = torch.ones((), dtype=torch.int32, device=g.device)
    steps = torch.zeros((), dtype=torch.int64, device=g.device)
    live = kernels.live_step_count(g.device)
    if loop_kernel is not None and g.device.type == "cuda":
        # allocated outside a capture (by the eager warm-up's solve), as
        # `live` is
        launched = kernels.LAUNCHES.device_count(loop_kernel, g.device)
    with span(WEISZFELD_LOOP_RANGE):
        if mode == "loop":
            _loop_nodes(step, g, spare, active, steps, maxiter, chunk, loop_kernel, launched)
        else:
            i = 0
            while i < maxiter:
                for _ in range(maxiter - i if mode == "unrolled" else min(chunk, maxiter - i)):
                    g_next, active, steps = step(g, spare, active, steps, i)
                    g, spare = g_next, g
                    i += 1
                if mode == "chunked" and not bool(active):  # the one host sync per chunk
                    break
    if mode != "chunked":
        live.add_(steps)
        return g, steps
    ran = int(steps)
    kernels.add_live_steps(ran)
    return g, ran


def _loop_nodes(step, g, spare, active, steps, maxiter, chunk, kernel, launched):
    """The captured loop of :func:`weiszfeld_solve`: a WHILE node of
    ``chunk``-step bodies (where ``maxiter >= chunk``), then an IF node of
    the ``maxiter % chunk`` left (where any are), the guess ending in ``g``
    after every body run.  A body's capture launches nothing, so its
    launches are taken back out of :data:`.kernels.LAUNCHES` (its runs count
    on the device, into ``launched``)."""
    from ..fed import graphs

    full, tail = maxiter // chunk, maxiter % chunk
    tail_handle = graphs.conditional_handle(1) if tail else None

    def body(n, loop_handle):
        a, b = g, spare
        for j in range(n):
            out, _, _ = step(a, b, active, steps, j)
            a, b = out, a
        if a is not g:  # an odd count leaves the guess in the spare buffer
            graphs.copy_async(g, a)
        kernels.weiszfeld_loop_condition(active, steps, launched, n, maxiter,
                                         loop=loop_handle,
                                         tail=tail_handle if loop_handle else None)
        kernels.LAUNCHES.add(kernel, -n)

    if full:
        handle = graphs.conditional_handle(1)
        with graphs.conditional_body(handle, loop=True):
            body(chunk, handle)
    if tail:
        with graphs.conditional_body(tail_handle, loop=False):
            body(tail, None)


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
) -> Tuple[torch.Tensor, "int | torch.Tensor"]:
    """:func:`gm2` returning ``(aggregate, Weiszfeld steps run)``.  Inside
    a CUDA-graph capture the loop is :func:`weiszfeld_solve`'s loop node
    where the step launches the fused kernel (one launch a step), and
    unrolled where it runs the plain version (torch ops, which a loop body
    may not hold)."""

    def step(g, g_out, active, steps, _i):
        return kernels.weiszfeld_step_fused(wmatrix, g, g_out, active, steps, tol)

    loop_kernel = "weiszfeld_step" if kernels._use_kernel(wmatrix) else None
    return weiszfeld_solve(step, _init_guess(wmatrix, guess), maxiter, chunk,
                           loop_kernel=loop_kernel)


@AGGREGATORS.register("gm2", streamable=True, graphable=True)
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
    unrolled: Optional[bool] = None,
) -> Tuple[torch.Tensor, "int | torch.Tensor"]:
    """:func:`gm` returning ``(aggregate, Weiszfeld steps run)``;
    ``unrolled`` as in :func:`weiszfeld_solve` (its steps after convergence
    draw too, and the draws are discarded).

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

    # its step draws (or indexes the given draws): never a loop node
    return weiszfeld_solve(step, init, maxiter, chunk, unrolled, loop_kernel=None)


@AGGREGATORS.register("gm", owns_channel=True, graphable=True, unrolled_solve=True)
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


def _received(wmatrix: torch.Tensor, terms: Optional[channel.OmaTerms]) -> torch.Tensor:
    return wmatrix if terms is None else wmatrix + channel.oma_residual(terms)


def _sorted_finite_columns(wmatrix: torch.Tensor):
    """``(sorted [K, d], n)``: each column sorted with every row that holds
    a non-finite entry moved to +Inf, and n the finite-row count as a
    device scalar.  Sorted on total-order keys, so the order is the one
    ``jnp.sort`` gives (-0.0 below +0.0)."""
    w = wmatrix.to(torch.float32)
    finite = _finite_rows(w)
    keys = kernels.total_order_keys(torch.where(finite[:, None], w, math.inf))
    return kernels.total_order_vals(torch.sort(keys, dim=0).values), torch.sum(finite)


@AGGREGATORS.register("median", supports_fused_epilogue=True, streamable=True,
                       graphable=True)
def median(wmatrix: torch.Tensor, *, channel: Optional[channel.OmaTerms] = None,
           degraded: bool = False, **_) -> torch.Tensor:
    """Coordinatewise median with torch semantics: the lower-middle order
    statistic ``sorted[(K-1)//2]`` (reference ``median``, ``:194-195``),
    selected over IEEE total-order keys, so a NaN or +-Inf row ranks as a
    sort ranks it.  ``channel``: the OMA link's terms, folded into the
    stack read (``w + oma_residual(channel)``, bitwise the received stack
    of ``channel.oma``).

    ``degraded``: the median of the n finite rows, ``sorted[(n-1)//2]``
    with the non-finite rows sorted to +Inf (+Inf when n = 0).  n is a
    device scalar, so this is a sort and a gather at a device index, as
    the JAX package's degraded rounds always take its sort path."""
    if not degraded:
        return kernels.fused_median(wmatrix.to(torch.float32).contiguous(), channel)
    srt, n = _sorted_finite_columns(_received(wmatrix, channel))
    idx = torch.clamp(n - 1, min=0) // 2
    return torch.index_select(srt, 0, idx.reshape(1))[0]


@AGGREGATORS.register("trimmed_mean", supports_fused_epilogue=True, streamable=True,
                       graphable=True)
def trimmed_mean(wmatrix: torch.Tensor, *, trim_ratio=0.1,
                 beta: Optional[int] = None,
                 channel: Optional[channel.OmaTerms] = None,
                 degraded: bool = False, **_) -> torch.Tensor:
    """Coordinatewise beta-trimmed mean: ``b = int(K * trim_ratio)`` (or
    ``beta``) entries dropped at each end, the mean of the middle K - 2b
    (reference ``trimmed_mean``, ``:189-192``), with the optional channel
    fold of :func:`median`.

    ``degraded``: over the n finite rows, ``b = int(f32(n) * trim_ratio)``
    (computed in f32 on the device, as JAX does), an explicit ``beta``
    clamped to ``(n-1)//2``; the mean of sorted ranks [b, n - b) with the
    non-finite rows sorted to +Inf, NaN when n = 0.  Here ``trim_ratio``
    may be a device f32 scalar (a service round's rollback-widened
    fraction), read with no host sync."""
    k = wmatrix.shape[0]
    if not degraded:
        b = int(k * trim_ratio) if beta is None else int(beta)
        return kernels.fused_trimmed_mean(
            wmatrix.to(torch.float32).contiguous(), b, channel
        )
    srt, n = _sorted_finite_columns(_received(wmatrix, channel))
    if beta is None:
        b = (n.to(torch.float32) * _f32_scalar(trim_ratio)).to(n.dtype)
    else:
        b = torch.clamp(torch.clamp(n - 1, min=0) // 2, max=int(beta))
    ranks = torch.arange(k, device=srt.device)[:, None]
    keep = (ranks >= b) & (ranks < n - b)
    total = torch.sum(torch.where(keep, srt, 0.0), dim=0)
    kept_n = torch.clamp(n - 2 * b, min=1).to(torch.float32)
    return _nan_unless(n > 0, total / kept_n)


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


def krum_scores_degraded(wmatrix: torch.Tensor, honest_size: int) -> torch.Tensor:
    """Krum scores whose neighbour count adapts to the n finite rows (JAX
    ``krum_scores_degraded``, :398): each row sums its
    ``c = clip(min(honest_size - 1, n - 1), 1, K)`` smallest finite
    distances (the sorted row masked at the device rank c); a non-finite
    row scores +Inf."""
    k = wmatrix.shape[0]
    dist = pairwise_sq_dists(wmatrix)
    finite = _finite_rows(wmatrix)
    n = torch.sum(finite)
    c = torch.clamp(torch.clamp(n - 1, max=honest_size - 1), 1, k)
    srt = torch.sort(dist, dim=1).values
    ranks = torch.arange(k, device=dist.device)[None, :]
    scores = torch.sum(torch.where((ranks < c) & torch.isfinite(srt), srt, 0.0), dim=1)
    return torch.where(finite, scores, math.inf)


def _krum_scores(wmatrix, honest_size, degraded):
    if degraded:
        return krum_scores_degraded(wmatrix, honest_size)
    return krum_scores(wmatrix, honest_size)


def lowest(scores: torch.Tensor, m: int) -> torch.Tensor:
    """Indices of the m lowest scores, ties lowest index first, in
    ascending score order: ``lax.top_k(-scores, m)``'s indices."""
    return torch.sort(scores, stable=True).indices[:m]


@AGGREGATORS.register("krum", aliases=("Krum",), needs_honest_size=True,
                      krum_like=True)
def krum(wmatrix: torch.Tensor, *, honest_size: int, degraded: bool = False,
         **_) -> torch.Tensor:
    """Single-Krum: the client row with the least Krum score (reference
    ``Krum``, ``:197-204``); ``argmin`` takes the first index on a tie.
    ``degraded``: the adaptive-neighbour scores of
    :func:`krum_scores_degraded`."""
    return wmatrix[torch.argmin(_krum_scores(wmatrix, honest_size, degraded))]


def _blocked_columns(arrays, fn, max_block_elems: int = 1 << 26) -> torch.Tensor:
    """``fn(*column_blocks) -> [block]`` over column blocks of one or more
    tensors whose last axis is d (the [K, d] stack and optional [d]
    vectors, sliced together), concatenated to [d] (JAX
    ``_blocked_columns``, :1036): peak extra memory O(K * block)."""
    if not isinstance(arrays, (tuple, list)):
        arrays = (arrays,)
    k, d = arrays[0].shape[0], arrays[0].shape[-1]
    block = max(128, (min(d, max_block_elems // k) // 128) * 128)
    return torch.cat([
        fn(*(a[..., lo:lo + block] for a in arrays)) for lo in range(0, d, block)
    ])


def _dense_or_blocked(arrays, fn, elems: int) -> torch.Tensor:
    if elems <= _DENSE_MAX_ELEMS:
        return fn(*arrays) if isinstance(arrays, (tuple, list)) else fn(arrays)
    return _blocked_columns(arrays, fn)


def _row_weights_mean(wmatrix: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``weights @ wmatrix`` with the zero-weight rows selected (never
    multiplied) to 0, so a rejected row holding Inf cannot make 0 * Inf."""
    k, d = wmatrix.shape

    def wmean(cols):
        return weights @ torch.where(weights[:, None] > 0, cols, 0.0).to(torch.float32)

    return _dense_or_blocked(wmatrix, wmean, k * d)


def selected_rows_mean(wmatrix: torch.Tensor, idx: torch.Tensor, m_sel: int) -> torch.Tensor:
    """Mean of the ``idx`` rows as a [K]-weight matvec, 1/m on the picked
    rows (JAX ``selected_rows_mean``, :1016)."""
    weights = torch.zeros(wmatrix.shape[0], dtype=torch.float32, device=wmatrix.device)
    weights[idx] = 1.0 / m_sel
    return _row_weights_mean(wmatrix, weights)


@AGGREGATORS.register("multi_krum", needs_honest_size=True, krum_like=True)
def multi_krum(wmatrix: torch.Tensor, *, honest_size: int, m: Optional[int] = None,
               degraded: bool = False, **_) -> torch.Tensor:
    """Multi-Krum: the mean of the m lowest-scoring clients (JAX
    ``multi_krum``, :451; beyond the reference), m = honest_size unless
    given.  ``degraded``: adaptive-neighbour scores, and the mean over the
    finite rows among the m winners only (NaN when there is none)."""
    m_sel = honest_size if m is None else int(m)
    idx = lowest(_krum_scores(wmatrix, honest_size, degraded), m_sel)
    if not degraded:
        return selected_rows_mean(wmatrix, idx, m_sel)
    keep = _finite_rows(wmatrix)[idx]
    count = torch.sum(keep)
    weights = torch.zeros(wmatrix.shape[0], dtype=torch.float32, device=wmatrix.device)
    weights[idx] = keep.to(torch.float32) / torch.clamp(count, min=1)
    return _nan_unless(count > 0, _row_weights_mean(wmatrix, weights))


def bulyan_sizes(k: int, b: int) -> Tuple[int, int]:
    """(theta, beta) for Bulyan at K clients / B Byzantine; raises unless
    K > 4B, so that both the selection and the trimmed set are non-empty."""
    theta = k - 2 * b
    beta = theta - 2 * b
    if beta < 1:
        raise ValueError(
            f"bulyan needs K > 4B for a nonempty trimmed set "
            f"(K={k}, B={b} -> theta={theta}, beta={beta})"
        )
    return theta, beta


def bulyan_tail(sel: torch.Tensor, beta: int) -> torch.Tensor:
    """Coordinatewise Bulyan over the selected [theta, d] rows: the mean of
    the beta values closest to the lower-middle median (JAX
    ``bulyan_tail``, :1069).  The median is :func:`median` (the
    ``select_columns`` kernel on the card); the closest values are taken by
    a stable sort of the distances, ties in ``sel``'s row order."""
    med = median(sel)
    dist = torch.abs(sel - med[None, :])
    rows = torch.sort(dist, dim=0, stable=True).indices[:beta]  # [beta, d]
    return torch.mean(torch.gather(sel, 0, rows).to(torch.float32), dim=0)


def impute_non_finite(wmatrix: torch.Tensor) -> torch.Tensor:
    """The stack with every row that holds a non-finite entry replaced by
    the finite rows' centroid (all NaN when no row is finite): degraded
    bulyan's imputation (JAX ``bulyan``, :978-982)."""
    finite = _finite_rows(wmatrix)
    cent = _finite_centroid(wmatrix, finite).to(wmatrix.dtype)
    wmatrix = torch.where(finite[:, None], wmatrix, cent[None, :])
    return _nan_unless(torch.sum(finite) > 0, wmatrix)


@AGGREGATORS.register("bulyan", needs_honest_size=True)
def bulyan(wmatrix: torch.Tensor, *, honest_size: int, degraded: bool = False,
           **_) -> torch.Tensor:
    """Bulyan (El Mhamdi et al., ICML 2018; JAX ``bulyan``, :954): the
    theta = K - 2B lowest Krum scores, then per coordinate the mean of the
    beta = theta - 2B values closest to their median.  ``degraded``:
    non-finite rows are replaced by the finite rows' centroid first (all
    NaN when no row is finite)."""
    k, d = wmatrix.shape
    theta, beta = bulyan_sizes(k, k - honest_size)
    if degraded:
        wmatrix = impute_non_finite(wmatrix)
    idx = lowest(krum_scores(wmatrix, honest_size), theta)
    return _dense_or_blocked(
        wmatrix, lambda cols: bulyan_tail(cols[idx].contiguous(), beta), theta * d
    )


@AGGREGATORS.register("cclip")
def centered_clip(wmatrix: torch.Tensor, *, guess: Optional[torch.Tensor] = None,
                  clip_tau: Optional[float] = None, clip_iters: int = 3,
                  **_) -> torch.Tensor:
    """Centered clipping (Karimireddy, He & Jaggi, ICML 2021; JAX
    ``centered_clip``, :903): ``clip_iters`` fixed steps from ``guess``,

        v <- v + mean_i( (w_i - v) * min(1, tau / ||w_i - v||) )

    over all K rows, a non-finite row's delta selected to 0.  ``clip_tau``
    None: tau is the lower-middle median of the delta norms, non-finite
    rows counted as +Inf, found by :func:`median` on a [K, 1] column (one
    ``select_columns`` launch per step on the card); an Inf tau makes the
    step a no-op."""
    finite = _finite_rows(wmatrix)
    v = (_finite_centroid(wmatrix, finite) if guess is None else guess).to(torch.float32)
    for _ in range(clip_iters):
        delta = torch.where(finite[:, None], wmatrix - v[None, :], 0.0)
        norms = torch.clamp(torch.linalg.vector_norm(delta, dim=1), min=1e-12)
        if clip_tau is None:
            tau = median(torch.where(finite, norms, math.inf)[:, None])[0]
            tau = torch.where(torch.isfinite(tau), tau, 0.0)
        else:
            tau = _f32(clip_tau, v)
        scale = torch.clamp(tau / norms, max=1.0)
        v = v + torch.mean(delta * scale[:, None], dim=0)
    return v


def dnc_removals(k: int, honest_size: int, dnc_iters: int, dnc_c: float) -> int:
    """Clients dnc removes per round, ceil(c * B); raises unless K exceeds
    all the removals."""
    n_remove = math.ceil(dnc_c * (k - honest_size))
    if n_remove * dnc_iters >= k:
        raise ValueError(
            f"dnc removes ceil(c*B)={n_remove} clients per round x "
            f"{dnc_iters} rounds but K={k}; need K > removals (K >> is the "
            f"paper's regime) - lower dnc_c/dnc_iters or raise K"
        )
    return n_remove


@AGGREGATORS.register("dnc", needs_honest_size=True)
def dnc(wmatrix: torch.Tensor, *, honest_size: int, dnc_iters: int = 3,
        dnc_sub_dim: int = 10000, dnc_c: float = 1.0,
        generator: Optional[torch.Generator] = None, dnc_draws=None,
        **_) -> torch.Tensor:
    """Divide-and-Conquer (Shejwalkar & Houmansadr, NDSS 2021; JAX ``dnc``,
    :511).  Each of ``dnc_iters`` rounds draws r = min(d, dnc_sub_dim)
    columns with replacement, centers them over the finite rows, finds the
    top right-singular vector by 10 power steps (norms clamped at 1e-12),
    scores each row by its squared projection (a non-finite row -Inf) and
    removes the ceil(c*B) highest scorers, ties lowest index first.  The
    aggregate is the mean of the rows never removed and never non-finite,
    the finite centroid when none is left.

    Round t draws its columns [r] (``torch.randint``) and then ``v0`` [r]
    (standard normals) from ``generator``, or reads them from
    ``dnc_draws[t] = (cols, v0)`` (the tests pass the JAX package's)."""
    k, d = wmatrix.shape
    n_remove = dnc_removals(k, honest_size, dnc_iters, dnc_c)
    dev = wmatrix.device
    finite = _finite_rows(wmatrix)
    n_finite = torch.clamp(torch.sum(finite), min=1).to(torch.float32)
    r = min(d, int(dnc_sub_dim))
    keep = finite
    for it in range(dnc_iters):
        if dnc_draws is None:
            cols = torch.randint(0, d, (r,), generator=generator, device=dev)
            v0 = torch.randn(r, generator=generator, device=dev)
        else:
            cols, v0 = dnc_draws[it]
        sub = torch.where(finite[:, None], wmatrix[:, cols], 0.0).to(torch.float32)
        centered = sub - torch.sum(sub, dim=0) / n_finite
        centered = torch.where(finite[:, None], centered, 0.0)
        v = v0 / torch.clamp(torch.linalg.vector_norm(v0), min=1e-12)
        for _ in range(10):
            v2 = centered.T @ (centered @ v)
            v = v2 / torch.clamp(torch.linalg.vector_norm(v2), min=1e-12)
        # a row-wise reduce, not a matvec: equal rows score bit-equal (as
        # in JAX), so a tie among them goes to the lowest index
        scores = torch.where(finite, torch.sum(centered * v[None, :], dim=1) ** 2, -math.inf)
        if n_remove:
            out = torch.sort(scores, descending=True, stable=True).indices[:n_remove]
            keep = keep.clone()
            keep[out] = False
    return torch.where(torch.sum(keep) > 0, _finite_centroid(wmatrix, keep),
                       _finite_centroid(wmatrix, finite))


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


def _quantize_deltas(wmatrix: torch.Tensor, guess: torch.Tensor, bits: int) -> torch.Tensor:
    """b-bit symmetric uniform quantize-dequantize emulation of the delta
    channel (sign_bits 8 or 16; JAX ``_quantize_deltas``, :695): per-client
    scale ``s_i = max |delta_i|`` over the finite rows, ``Q = 2^(b-1) - 1``
    levels, ``q = round(delta / max(s, 1e-30) * Q)`` (half to even) and the
    stack ``guess + q * s / Q``.  A row with a non-finite entry passes
    through unchanged; an all-zero delta row dequantizes to exactly 0."""
    g = guess[None, :].to(torch.float32)
    delta = wmatrix.to(torch.float32) - g
    finite = _finite_rows(delta)
    q_max = _f32(2 ** (bits - 1) - 1, delta)
    scale = torch.amax(torch.abs(torch.where(finite[:, None], delta, 0.0)), dim=1, keepdim=True)
    q = torch.clamp(torch.round(delta / torch.clamp(scale, min=1e-30) * q_max), -q_max, q_max)
    dq = torch.where(scale > 0.0, q * scale / q_max, 0.0)
    return torch.where(finite[:, None], g + dq, wmatrix)


def _packed_sign_step(wmatrix, guess, noise, sign_eta, name):
    """sign_bits = 1: pack, count the ballots, recover the signed votes
    ``2*counts - k_valid`` (each set bit +1, each clear bit of a valid row
    -1), and step ``sign_eta`` in the voted direction."""
    if sign_eta is None:
        raise ValueError(
            f"{name} at sign_bits=1 needs an explicit sign_eta: the one-bit "
            "channel carries no magnitudes for the adaptive eta median"
        )
    words, k_valid = pack_signs(wmatrix, guess)
    counts = packed_sign_votes(words, wmatrix.shape[1])
    votes = (2 * counts - k_valid).to(torch.float32) + noise
    return guess + _f32(sign_eta, guess) * torch.sign(votes)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _vote_step(wmatrix, guess, noise, sign_eta, sign_bits, name):
    """The vote of signmv and bev, after the receiver noise is drawn:
    ``guess + eta * sign(sum_i sign(w_i - guess) + noise)``."""
    if sign_bits == 1:
        return _packed_sign_step(wmatrix, guess, noise, sign_eta, name)
    if sign_bits in (8, 16):
        wmatrix = _quantize_deltas(wmatrix, guess, sign_bits)
    elif sign_bits != 32:
        raise ValueError(f"{name} sign_bits must be one of 1, 8, 16, 32, got {sign_bits}")

    def tail(cols, g, n):
        delta = cols.to(torch.float32) - g[None, :]
        finite = torch.isfinite(delta)
        votes = torch.sum(torch.where(finite, torch.sign(delta), 0.0), dim=0) + n
        if sign_eta is None:
            eta = median(torch.where(finite, torch.abs(delta), math.inf))
            # where >= ceil(K/2) deltas are non-finite the median is Inf,
            # and Inf * sign(0) on a tie would be NaN: no step there instead
            eta = torch.where(torch.isfinite(eta), eta, 0.0)
        else:
            eta = _f32(sign_eta, g)
        return g + eta * torch.sign(votes)

    noise = torch.broadcast_to(noise, guess.shape)
    k, d = wmatrix.shape
    return _dense_or_blocked((wmatrix, guess, noise), tail, k * d)


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
    full-precision ballots (a non-finite delta casts a 0 ballot); 8 and 16
    vote on the quantize-dequantize emulated stack
    (:func:`_quantize_deltas`); 1 packs the ballots into 32-bit words and
    counts them with the popcount kernel (a row with any non-finite delta
    casts none, and needs ``sign_eta``)."""
    if guess is None:
        raise ValueError("signmv needs the pre-round params as `guess`")
    d = wmatrix.shape[1]
    dev = wmatrix.device
    guess = guess.to(torch.float32)
    if noise_var is None:
        noise = torch.zeros(d, dtype=torch.float32, device=dev)
    else:
        z = (torch.randn(d, generator=generator, device=dev)
             if vote_noise is None else vote_noise)
        noise = torch.sqrt(_f32(noise_var, guess) / 2.0) * z
    return _vote_step(wmatrix, guess, noise, sign_eta, sign_bits, "signmv")


@AGGREGATORS.register("bev")
def best_effort_voting(
    wmatrix: torch.Tensor,
    *,
    guess: Optional[torch.Tensor] = None,
    sign_eta: Optional[float] = None,
    sign_bits: int = 32,
    **_,
) -> torch.Tensor:
    """Best-effort voting (BEV-SGD, Jin et al. 2021; JAX
    ``best_effort_voting``, :835) as a receiver-side rule: the signmv vote
    on the received stack, with no receiver noise of its own (the OMA
    prepass corrupts the stack, as for the other receiver-side rules).  At
    ``sign_bits=1`` it is the same packed wire and popcount kernel as
    signmv's, at 8/16 the same quantize emulation."""
    if guess is None:
        raise ValueError("bev needs the pre-round params as `guess`")
    guess = guess.to(torch.float32)
    return _vote_step(wmatrix, guess, _f32(0.0, guess), sign_eta, sign_bits, "bev")


def resolve(name: str):
    """Look up an aggregator by its reference-compatible CLI name."""
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


# ---------------------------------------------------------------------------
# cohort-streamed rules (JAX ``ops/aggregators.py:1295-1670``)
#
# A streamed round never holds the [K, d] stack: ``rebuild(c)`` remakes the
# [cohort, d] chunk c, and must be pure in c, since every pass below calls it
# once per chunk and relies on each pass seeing the same chunks.  The JAX
# package scans the chunks with ``lax.scan``; here a pass is a Python loop
# over the chunk indices.  Float partial sums add in chunk order; integer
# counts merge by plain addition, so the exact median is bitwise the
# resident selection.  Every pass runs through a population-shard context
# (:mod:`.shardctx`, ``ctx``): LOCAL (the default) is one loop over all the
# chunks; under ``--pop-shards`` each shard passes over its own chunk range
# and the partial carries merge by their tags.


def streamable(name: str) -> bool:
    """Whether the rule has a streamed realization (registration metadata,
    shared by the config's checks and the defense ladder)."""
    return bool(AGGREGATORS.meta(name).get("streamable", False))


def _chunk_pass(rebuild, n_chunks: int, body, carry, spec, ctx):
    """``carry <- body(carry, rebuild(c))`` over the chunks, under ``ctx``
    (``ctx.scan_merge``) with the carry's merge tags ``spec``."""
    return ctx.scan_merge(rebuild, n_chunks, lambda cy, chunk, _c: body(cy, chunk), carry,
                          spec)


def stream_stats(rebuild, n_chunks: int, d: int, device, ctx=shardctx.LOCAL):
    """One pass: (sum over all rows [d], sum over the finite rows [d], the
    finite-row count): what mean and gm2 need, also supplied by the
    trainer's observation pass so that they cost no extra pass."""

    def acc(carry, chunk):
        s_all, s_fin, n_fin = carry
        fin = _finite_rows(chunk)
        c32 = chunk.to(torch.float32)
        return (s_all + torch.sum(c32, dim=0),
                s_fin + torch.sum(torch.where(fin[:, None], c32, 0.0), dim=0),
                n_fin + torch.sum(fin).to(torch.int32))

    zeros = torch.zeros(d, dtype=torch.float32, device=device)
    return _chunk_pass(rebuild, n_chunks, acc,
                       (zeros, zeros, torch.zeros((), dtype=torch.int32, device=device)),
                       ("sum", "sum", "sum"), ctx)


def _stream_count_le(rebuild, n_chunks: int, degraded: bool, ctx=shardctx.LOCAL):
    """``count_le(mids [r, d] int32) -> [r, d]`` int32 counts of the
    total-order keys <= mid per column (of the finite rows when degraded),
    one pass over the chunks."""

    def count_le(mids):
        def acc(cnt, chunk):
            keys = kernels.total_order_keys(chunk.to(torch.float32))
            le = keys[None, :, :] <= mids[:, None, :]  # [r, cohort, d]
            if degraded:
                le = le & _finite_rows(chunk)[None, :, None]
            return cnt + torch.sum(le, dim=1, dtype=torch.int32)

        return _chunk_pass(rebuild, n_chunks, acc, torch.zeros_like(mids), "sum", ctx)

    return count_le


def _stream_bisect_keys(count_le, ns: torch.Tensor, r: int, d: int, device) -> torch.Tensor:
    """The ranks ``ns`` [r] (0-indexed) of every column's keys by 32 steps
    of a key bisection, each step one counting pass (JAX
    ``_stream_bisect_keys``)."""
    lo = torch.full((r, d), kernels.KEY_MIN, dtype=torch.int32, device=device)
    hi = torch.full((r, d), kernels.KEY_MAX, dtype=torch.int32, device=device)
    targets = ns.to(torch.int32).reshape(r, 1)
    for _ in range(32):
        # floor((lo + hi) / 2) without overflow; >> on int32 is arithmetic
        mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1)
        above = count_le(mid) <= targets
        lo, hi = torch.where(above, mid + 1, lo), torch.where(above, hi, mid)
    return lo


def _f32_to_key(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 rounding toward zero and saturating at the int32 range,
    as XLA converts (a plain cast of an out-of-range float is undefined)."""
    # 2**31 - 128 is the largest f32 below 2**31
    inside = torch.clamp(x, -(2.0**31), 2.0**31 - 128.0).to(torch.int32)
    return torch.where(x >= 2.0**31, kernels.KEY_MAX, inside)


def _stream_sketch_keys(rebuild, n_chunks: int, d: int, ns: torch.Tensor, r: int,
                        bins: int, degraded: bool, device, ctx=shardctx.LOCAL) -> torch.Tensor:
    """A mergeable quantile sketch over total-order keys (JAX
    ``_stream_sketch_keys``): a min/max pass, a [bins, d] int32 histogram
    pass, and the ranks' bucket upper edges from its cumulative sum, each
    at most one bucket width above the exact key.  The bucket geometry is
    f32 in JAX's op order."""

    def chunk_keys(chunk):
        keys = kernels.total_order_keys(chunk.to(torch.float32))
        return keys, (_finite_rows(chunk)[:, None] if degraded else None)

    def minmax(carry, chunk):
        kmin, kmax = carry
        keys, fin = chunk_keys(chunk)
        lo_keys = keys if fin is None else torch.where(fin, keys, kernels.KEY_MAX)
        hi_keys = keys if fin is None else torch.where(fin, keys, kernels.KEY_MIN)
        return (torch.minimum(kmin, torch.amin(lo_keys, dim=0)),
                torch.maximum(kmax, torch.amax(hi_keys, dim=0)))

    kmin, kmax = _chunk_pass(rebuild, n_chunks, minmax, (
        torch.full((d,), kernels.KEY_MAX, dtype=torch.int32, device=device),
        torch.full((d,), kernels.KEY_MIN, dtype=torch.int32, device=device)),
        ("min", "max"), ctx)
    kminf = kmin.to(torch.float32)
    span = torch.clamp(kmax.to(torch.float32) - kminf, min=1.0)
    col = torch.arange(d, dtype=torch.int64, device=device)

    def hist_pass(hist, chunk):
        keys, fin = chunk_keys(chunk)
        t = (keys.to(torch.float32) - kminf[None, :]) / span[None, :]
        idx = torch.clamp(_f32_to_key(t * bins), 0, bins - 1).to(torch.int64)
        ones = (fin.to(torch.int32).expand(keys.shape) if fin is not None
                else torch.ones(keys.shape, dtype=torch.int32, device=device))
        flat = hist.view(-1)
        flat.index_add_(0, (idx * d + col[None, :]).reshape(-1), ones.reshape(-1))
        return hist

    hist = _chunk_pass(rebuild, n_chunks, hist_pass,
                       torch.zeros((bins, d), dtype=torch.int32, device=device), "sum", ctx)
    cum = torch.cumsum(hist, dim=0, dtype=torch.int32)
    targets = ns.to(torch.int32).reshape(r, 1, 1)
    # the first bucket whose cumulative count passes the rank (0 if none)
    bucket = torch.argmax((cum[None, :, :] > targets).to(torch.uint8), dim=1).to(torch.float32)
    est = kminf[None, :] + (bucket + 1.0) * (span[None, :] / bins)
    return torch.minimum(_f32_to_key(est), kmax[None, :])


def _stream_trimmed_tail(rebuild, n_chunks: int, lo_k, hi_k, n, b,
                         degraded: bool, ctx=shardctx.LOCAL) -> torch.Tensor:
    """The trimmed mean's last pass given the kept band's boundary keys
    [d] (JAX ``_stream_trimmed_tail``): the strict interior's sum plus each
    boundary value times its kept multiplicity, over the actual kept count
    (so the same tail serves the exact and the sketched boundaries)."""
    d = lo_k.shape[0]
    zero_i = torch.zeros(d, dtype=torch.int32, device=lo_k.device)

    def acc(carry, chunk):
        total, lt_lo, le_lo, lt_hi, le_hi = carry
        w32 = chunk.to(torch.float32)
        keys = kernels.total_order_keys(w32)
        live = _finite_rows(chunk)[:, None] if degraded else None

        def count(cmp):
            if live is not None:
                cmp = cmp & live
            return torch.sum(cmp, dim=0, dtype=torch.int32)

        interior = (keys > lo_k[None, :]) & (keys < hi_k[None, :])
        if live is not None:
            interior = interior & live
        return (total + torch.sum(torch.where(interior, w32, 0.0), dim=0),
                lt_lo + count(keys < lo_k[None, :]), le_lo + count(keys <= lo_k[None, :]),
                lt_hi + count(keys < hi_k[None, :]), le_hi + count(keys <= hi_k[None, :]))

    total, lt_lo, le_lo, lt_hi, le_hi = _chunk_pass(rebuild, n_chunks, acc, (
        torch.zeros(d, dtype=torch.float32, device=lo_k.device),
        zero_i, zero_i, zero_i, zero_i), ("sum",) * 5, ctx)
    last = n - b - 1  # the highest kept rank

    def kept_copies(n_lt, n_le):
        run = torch.minimum(n_le - 1, last) - torch.maximum(n_lt, b) + 1
        return torch.clamp(run, min=0)

    def boundary_sum(boundary, copies):
        v = kernels.total_order_vals(boundary)
        return torch.where(copies > 0, copies.to(torch.float32) * v, 0.0)

    copies_lo = kept_copies(lt_lo, le_lo)
    copies_hi = torch.where(lo_k == hi_k, 0, kept_copies(lt_hi, le_hi))
    interior_cnt = torch.clamp(lt_hi - le_lo, min=0)
    total = total + boundary_sum(lo_k, copies_lo)
    total = total + boundary_sum(hi_k, copies_hi)
    kept = interior_cnt + copies_lo + copies_hi
    return total / torch.clamp(kept, min=1).to(torch.float32)


def _stream_quantile_keys(rebuild, n_chunks, d, ns, r, *, quantile, sketch_bins,
                          degraded, device, ctx=shardctx.LOCAL):
    if quantile == "sketch":
        return _stream_sketch_keys(rebuild, n_chunks, d, ns, r, sketch_bins, degraded, device,
                                   ctx)
    return _stream_bisect_keys(_stream_count_le(rebuild, n_chunks, degraded, ctx), ns, r, d,
                               device)


def _stats_or(rebuild, n_chunks, d, device, sum_all, sum_finite, n_finite, ctx):
    if sum_all is None or sum_finite is None or n_finite is None:
        return stream_stats(rebuild, n_chunks, d, device, ctx)
    return sum_all, sum_finite, n_finite


def stream_mean(rebuild, *, k, d, n_chunks, device, degraded=False, sum_all=None,
                sum_finite=None, n_finite=None, ctx=shardctx.LOCAL, **_) -> torch.Tensor:
    """Streamed :func:`mean`, exact up to the chunk sums' order; the sums
    normally come from the trainer's observation pass (no extra pass)."""
    sum_all, sum_finite, n_finite = _stats_or(rebuild, n_chunks, d, device,
                                              sum_all, sum_finite, n_finite, ctx)
    if degraded:
        return _nan_unless(n_finite > 0,
                           sum_finite / torch.clamp(n_finite, min=1).to(torch.float32))
    return sum_all / torch.tensor(float(k), dtype=torch.float32)


def stream_gm2_solve(rebuild, *, k, d, n_chunks, device, guess=None, maxiter=1000,
                     tol=1e-5, sum_all=None, sum_finite=None, n_finite=None,
                     ctx=shardctx.LOCAL, **_) -> Tuple[torch.Tensor, int]:
    """:func:`stream_gm2` returning ``(aggregate, Weiszfeld steps run)``."""
    if guess is None:
        _, sum_finite, n_finite = _stats_or(rebuild, n_chunks, d, device,
                                            sum_all, sum_finite, n_finite, ctx)
        g = sum_finite / torch.clamp(n_finite, min=1).to(torch.float32)
    else:
        g = guess.to(torch.float32)
    steps = 0
    with span(WEISZFELD_LOOP_RANGE):
        while steps < maxiter:
            def acc(carry, chunk, _c, g=g):
                n_c, d_c = kernels.weiszfeld_step(chunk.contiguous(), g)
                return carry[0] + n_c, carry[1] + d_c

            num, den = ctx.scan_merge(
                rebuild, n_chunks, acc,
                (torch.zeros(d, dtype=torch.float32, device=device),
                 torch.zeros((), dtype=torch.float32, device=device)), ("sum", "sum"))
            g_next = num / den
            movement = torch.linalg.vector_norm(g - g_next)
            g = g_next
            steps += 1
            if not bool(movement > tol):  # the one host read per step
                break
    return g, steps


def stream_gm2(rebuild, **kw) -> torch.Tensor:
    """Streamed :func:`gm2` (JAX ``stream_gm2``): every Weiszfeld step
    rebuilds each chunk and runs one num/den launch of the Weiszfeld kernel
    on it (:func:`.kernels.weiszfeld_step`: ``inv = 1/max(||w_i - g||,
    DIST_CLAMP)``, 0 for a non-finite row; ``num += sum inv*w``, ``den +=
    sum inv``), the partials added in chunk order; then ``g <- num/den``.
    It stops as JAX's ``while_loop`` does: after the step whose movement
    ``||g - g_next||`` is not above ``tol``, or after ``maxiter`` steps.
    Since every step rebuilds every chunk anyway, the movement is read on
    the host once per step.  Starts from ``guess`` (the trainer passes the
    pre-iteration params), else the finite rows' mean.  Under a shard
    context the (num, den) partials of the shards merge by the canonical
    shard-order fold, so every engine walks the same guesses and takes the
    same number of steps (JAX ``stream_gm2``)."""
    return stream_gm2_solve(rebuild, **kw)[0]


def stream_median(rebuild, *, k, d, n_chunks, device, degraded=False, n_finite=None,
                  quantile="exact", sketch_bins=512, ctx=shardctx.LOCAL,
                  **_) -> torch.Tensor:
    """Streamed :func:`median` (the lower middle): the ``(n-1)//2`` rank key
    by bisection (exact: bitwise the resident selection) or the sketch, and
    back to its value; n is the finite-row count when degraded."""
    if degraded:
        if n_finite is None:
            _, _, n_finite = stream_stats(rebuild, n_chunks, d, device, ctx)
        n = n_finite.to(torch.int32)
    else:
        n = torch.tensor(k, dtype=torch.int32, device=device)
    rank = torch.clamp(n - 1, min=0) // 2
    key = _stream_quantile_keys(rebuild, n_chunks, d, rank.reshape(1), 1, quantile=quantile,
                                sketch_bins=sketch_bins, degraded=degraded, device=device,
                                ctx=ctx)
    return kernels.total_order_vals(key[0])


def stream_trimmed_mean(rebuild, *, k, d, n_chunks, device, trim_ratio=0.1, beta=None,
                        degraded=False, n_finite=None, quantile="exact",
                        sketch_bins=512, ctx=shardctx.LOCAL, **_) -> torch.Tensor:
    """Streamed :func:`trimmed_mean`: the kept band's boundary ranks by
    bisection or sketch, then one pass of the interior and the boundary
    multiplicities.  Degraded, the trim adapts to the finite-row count as
    the resident sort path does (``trim_ratio`` may be a device scalar)."""
    if degraded:
        if n_finite is None:
            _, _, n_finite = stream_stats(rebuild, n_chunks, d, device, ctx)
        n = n_finite.to(torch.int32)
        if beta is None:
            b = (n.to(torch.float32) * _f32_scalar(trim_ratio)).to(torch.int32)
        else:
            b = torch.clamp(torch.clamp(n - 1, min=0) // 2, max=int(beta))
    else:
        n = torch.tensor(k, dtype=torch.int32, device=device)
        b = torch.tensor(int(k * trim_ratio) if beta is None else int(beta),
                         dtype=torch.int32, device=device)
    ns = torch.stack([b, torch.clamp(n - b - 1, min=0)])
    keys = _stream_quantile_keys(rebuild, n_chunks, d, ns, 2, quantile=quantile,
                                 sketch_bins=sketch_bins, degraded=degraded, device=device,
                                 ctx=ctx)
    out = _stream_trimmed_tail(rebuild, n_chunks, keys[0], keys[1], n, b, degraded, ctx)
    return _nan_unless(n > 0, out) if degraded else out


_STREAM_FNS = {
    "mean": stream_mean,
    "median": stream_median,
    "trimmed_mean": stream_trimmed_mean,
    "gm2": stream_gm2,
}


def stream_aggregate(name: str, rebuild, **kw) -> torch.Tensor:
    """The streamed realization of a streamable rule.  ``rebuild(c) ->
    [cohort, d]`` must be pure in c.  The keywords are the resident rules'
    (guess, maxiter, tol, trim_ratio, degraded) plus ``k``, ``d``,
    ``n_chunks``, ``device``, ``quantile``, ``sketch_bins``, the optional
    observation-pass stats ``sum_all``, ``sum_finite``, ``n_finite``, and
    the population-shard context ``ctx`` (default LOCAL)."""
    fn = AGGREGATORS.get(name)
    for stream_name, stream_fn in _STREAM_FNS.items():
        if fn is AGGREGATORS.get(stream_name):
            return stream_fn(rebuild, **kw)
    raise ValueError(
        f"aggregator {name!r} has no streaming realization (streamable: "
        f"{sorted(_STREAM_FNS)})"
    )
