"""NumPy oracle implementations of the server-side math.

The port's copy of ``byzantine_aircomp_tpu/backends/numpy_ref.py``, kept
the same program line for line so that the two referees compute the same
bits on the same inputs: the ``--backend ref`` path and a unit-test
oracle, a direct, loop-style NumPy transcription of the reference's
semantics (aggregators ``MNIST_Air_weight.py:131-204``, channel
``:385-414``, weightflip ``:380-383``; SURVEY.md).  Deliberately not
GPU-idiomatic: its job is to be obviously correct so that the kernels and
their plain torch versions can be tested against it.  NumPy only.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np

DIST_CLAMP = 1e-4


def mean(w: np.ndarray) -> np.ndarray:
    return w.mean(axis=0)


def median(w: np.ndarray) -> np.ndarray:
    # torch.median(dim=0) semantics: lower middle order statistic for even K
    k = w.shape[0]
    return np.sort(w, axis=0)[(k - 1) // 2]


def trimmed_mean(w: np.ndarray, trim_ratio: float = 0.1) -> np.ndarray:
    k = w.shape[0]
    beta = int(k * trim_ratio)
    srt = np.sort(w, axis=0)
    return srt[beta : k - beta].mean(axis=0)


def _krum_scores(w: np.ndarray, honest_size: int) -> np.ndarray:
    # Mask non-finite rows BEFORE the broadcast: Inf - Inf would emit a
    # RuntimeWarning and produce NaN distances.  Matching the JAX path
    # (ops.aggregators.pairwise_sq_dists), any distance involving a
    # non-finite row is +Inf (never selected) and the diagonal is 0.
    # "poisoned" = non-finite entries OR an f32-overflowing squared norm
    # (finite ~1e20 entries overflow ||w||^2 to Inf and behave exactly like
    # an Inf row in the JAX path's f32 Gram form).  Overflow is judged by
    # ROUNDING the f64 sum to f32 (round-to-nearest-even, like the JAX
    # path's f32 accumulate) rather than a raw ``> f32max`` compare: f64
    # values in (f32max, f32max * (1 + 2^-25)] round DOWN to f32max — a
    # strict threshold test would call them overflowed when f32 arithmetic
    # keeps them finite.  Caveat: within a few ULP of the boundary the two
    # backends can still legitimately disagree — f32 accumulation ORDER in
    # the JAX reduce may overflow (or not) where the correctly-rounded f64
    # sum lands on the other side; exact parity there is unattainable.
    finite = np.isfinite(w).all(axis=1)
    sq64 = (w.astype(np.float64) ** 2).sum(axis=1)

    def _f32_overflows(x64: np.ndarray) -> np.ndarray:
        with np.errstate(over="ignore"):
            return np.isinf(x64.astype(np.float32))

    bad = ~finite | _f32_overflows(sq64)
    wz = np.where(~bad[:, None], w, 0.0).astype(np.float64)
    dist = ((wz[:, None, :] - wz[None, :, :]) ** 2).sum(axis=-1)
    # emulate the JAX path's f32 Gram-form overflow for rows that are NOT
    # individually poisoned: when sq_i + sq_j overflows f32, the Gram form
    # computes Inf - 2*gram -> Inf (or Inf - Inf = NaN -> +Inf), so two
    # colluding rows with norm^2 just under f32max are "infinitely far"
    # from each other in f32 even though their true distance is small (the
    # broadcast form above would see 0 and let them win selection, which
    # the JAX path rejects — parity demands the f32 semantics).  By AM-GM
    # 2*|gram| <= sq_i + sq_j, so the sq-sum test covers the gram term.
    pair_over = _f32_overflows(sq64[:, None] + sq64[None, :])
    dist[pair_over] = np.inf
    dist[_f32_overflows(dist)] = np.inf  # f32 saturation of the distance
    dist[bad, :] = np.inf
    dist[:, bad] = np.inf
    np.fill_diagonal(dist, 0.0)
    # a poisoned row's own diagonal is ALSO +Inf (not the usual exact 0):
    # with honest_size=2, k_sel=1 and a 0 diagonal would give the poisoned
    # row score 0 — winning the selection.  Inf on the diagonal makes its
    # score Inf for ANY k_sel, closing the degenerate case (matching
    # ops.aggregators.pairwise_sq_dists).
    dist[bad, bad] = np.inf
    k_sel = honest_size - 2 + 1
    scores = np.sort(dist, axis=1)[:, :k_sel].sum(axis=1)
    # the f32 emulation must extend to the SCORE level too: in the
    # colluding band the distances are huge-but-finite in f64 while the
    # JAX path's f32 top_k sum saturates to Inf — saturate to match, so
    # rejected rows rank identically (all Inf) in both backends
    scores[_f32_overflows(scores)] = np.inf
    return scores


def krum(w: np.ndarray, honest_size: int) -> np.ndarray:
    return w[int(np.argmin(_krum_scores(w, honest_size)))]


def multi_krum(w: np.ndarray, honest_size: int, m: Optional[int] = None) -> np.ndarray:
    m_sel = honest_size if m is None else m
    idx = np.argsort(_krum_scores(w, honest_size))[:m_sel]
    return w[idx].mean(axis=0)


def _exclude_nonfinite_rows(w: np.ndarray) -> "tuple[np.ndarray, np.ndarray]":
    """(masked stack, per-row finite mask): rows containing Inf/NaN zeroed —
    the iterative aggregators (gm/gm2/centered_clip) EXCLUDE non-finite
    rows, same semantics as the JAX paths (ops.aggregators._finite_rows)."""
    finite = np.isfinite(w).all(axis=1)
    return np.where(finite[:, None], w, 0.0), finite


def gm2(
    w: np.ndarray,
    guess: Optional[np.ndarray] = None,
    maxiter: int = 1000,
    tol: float = 1e-5,
) -> np.ndarray:
    w, finite = _exclude_nonfinite_rows(w)
    if guess is None:
        guess = w.sum(axis=0) / max(finite.sum(), 1)
    else:
        guess = guess.copy()
    for _ in range(maxiter):
        dist = np.maximum(DIST_CLAMP, np.linalg.norm(w - guess, axis=1))
        inv = np.where(finite, 1.0 / dist, 0.0)
        nxt = (w * inv[:, None]).sum(axis=0) / inv.sum()
        movement = np.linalg.norm(guess - nxt)
        guess = nxt
        if movement <= tol:
            break
    return guess


def oma(
    rng: np.random.Generator, message: np.ndarray, noise_var: float
) -> np.ndarray:
    k, d = message.shape
    std = 1.0 / math.sqrt(2.0)
    h_r = rng.normal(0.0, std, (k, 1))
    h_i = rng.normal(0.0, std, (k, 1))
    n_r = rng.normal(0.0, math.sqrt(noise_var), (k, d))
    n_i = rng.normal(0.0, math.sqrt(noise_var), (k, d))
    return message + (h_r * n_r + h_i * n_i) / (h_r**2 + h_i**2)


def oma2(
    rng: np.random.Generator,
    message: np.ndarray,
    p_max: float = 10.0,
    noise_var: Optional[float] = None,
    threshold: float = 1.0,
) -> np.ndarray:
    k, d = message.shape
    std = 1.0 / math.sqrt(2.0)
    h_r = rng.normal(0.0, std, (k,))
    h_i = rng.normal(0.0, std, (k,))
    h_sq = h_r**2 + h_i**2
    p_upper = np.maximum((message**2).mean(axis=-1) / h_sq, threshold)
    gain = np.sqrt(p_max / p_upper)
    out = (message * gain[:, None]).sum(axis=0)
    if noise_var is not None:
        out = out + rng.normal(0.0, math.sqrt(noise_var / 2.0), (d,))
    return out


def gm(
    rng: np.random.Generator,
    w: np.ndarray,
    noise_var: Optional[float] = None,
    guess: Optional[np.ndarray] = None,
    maxiter: int = 1000,
    tol: float = 1e-5,
    p_max: float = 1.0,
) -> np.ndarray:
    w, finite = _exclude_nonfinite_rows(w)
    if guess is None:
        guess = w.sum(axis=0) / max(finite.sum(), 1)
    else:
        guess = guess.copy()
    # np.errstate: in the noise-dominated regime the AirComp GM can diverge
    # (the reference physics — torch produces Inf/NaN silently there); the
    # oracle must transcribe that semantics without NumPy's RuntimeWarnings,
    # which pytest escalates to errors for backends/ (pyproject).  The
    # guards are NARROW by design (round-4 advisor): the expressions that
    # consume a possibly-diverged ``guess``/``noisy`` are always masked,
    # but the message build and the oma2 channel are masked ONLY once the
    # iterate has demonstrably diverged (non-finite scaler) — before that
    # point a warning there is a genuine numeric bug and stays an error.
    for _ in range(maxiter):
        with np.errstate(over="ignore", invalid="ignore"):
            scaler = math.sqrt(float((guess**2).mean()))
            dist = np.maximum(DIST_CLAMP, np.linalg.norm(w - guess, axis=1))
        inv = np.where(finite, 1.0 / dist, 0.0)
        # nan-safe: NaN < x is False, so a NaN scaler is also guarded.  The
        # threshold marks divergence BEFORE the first masked overflow: msg
        # entries scale like scaler/DIST_CLAMP = 1e4*scaler, so their f32
        # squares overflow once scaler ~ 1e15 — no convergent federated
        # iterate is within 10 orders of magnitude of that norm.
        guard = (
            contextlib.nullcontext()
            if scaler < 1e15
            else np.errstate(over="ignore", invalid="ignore")
        )
        with guard:
            msg = np.concatenate(
                [w * inv[:, None], scaler * inv[:, None]], axis=1
            )
            noisy = oma2(
                rng, msg, p_max=p_max, noise_var=noise_var,
                threshold=500.0 * scaler**2,
            )
        with np.errstate(over="ignore", invalid="ignore"):
            nxt = noisy[:-1] / noisy[-1] * scaler
            movement = np.linalg.norm(guess - nxt)
        guess = nxt
        if movement <= tol:
            break
    return guess


def weightflip(w: np.ndarray, byz_size: int) -> np.ndarray:
    out = w.copy()
    s = w[:-byz_size].sum(axis=0)
    out[-byz_size:] = -w[-byz_size:] - 2.0 * s / byz_size
    return out


def bulyan(w: np.ndarray, honest_size: int) -> np.ndarray:
    """Oracle for the framework's batch Bulyan (an extension — the reference
    ships single-Krum only): theta = K - 2B lowest Krum scores selected, then
    per coordinate the beta = theta - 2B values closest to the selection's
    (lower-middle) median are averaged."""
    k = len(w)
    b = k - honest_size
    theta = k - 2 * b
    beta = theta - 2 * b
    if beta < 1:  # same K > 4B contract as the JAX path
        raise ValueError(
            f"bulyan needs K > 4B (K={k}, B={b} -> theta={theta}, beta={beta})"
        )
    idx = np.argsort(_krum_scores(w, honest_size))[:theta]
    sel = w[idx]
    med = median(sel)
    out = np.empty(w.shape[1], np.float32)
    for j in range(w.shape[1]):
        order = np.argsort(np.abs(sel[:, j] - med[j]), kind="stable")[:beta]
        out[j] = sel[order, j].mean()
    return out


def dnc(
    w: np.ndarray,
    honest_size: int,
    rng: np.random.Generator,
    dnc_iters: int = 3,
    dnc_sub_dim: int = 10000,
    dnc_c: float = 1.0,
) -> np.ndarray:
    """Oracle for the framework's DnC (an extension; Shejwalkar &
    Houmansadr NDSS 2021): per round, sample coordinates, center, score
    clients by squared projection onto the top singular vector, flag the
    ceil(c*B) highest; aggregate = mean of never-flagged clients.  Uses
    exact SVD where the jax path power-iterates — agreement is
    distributional (same flagged sets on well-separated stacks)."""
    k, d = w.shape
    b = k - honest_size
    n_remove = int(np.ceil(dnc_c * b))
    if n_remove * dnc_iters >= k:  # same contract as the jax path
        raise ValueError(
            f"dnc removes ceil(c*B)={n_remove} clients per round x "
            f"{dnc_iters} rounds but K={k}; need K > removals"
        )
    finite = np.isfinite(w).all(axis=1)
    keep = finite.copy()
    r = min(d, dnc_sub_dim)
    for _ in range(dnc_iters):
        cols = rng.integers(0, d, r)  # with replacement, as the jax path
        sub = np.where(finite[:, None], w[:, cols], 0.0)
        centered = sub - sub.sum(axis=0) / max(finite.sum(), 1)
        centered = np.where(finite[:, None], centered, 0.0)
        _, _, vt = np.linalg.svd(centered, full_matrices=False)
        scores = (centered @ vt[0]) ** 2
        # -Inf, as the jax path: the removal budget targets live rows
        scores = np.where(finite, scores, -np.inf)
        if n_remove:
            keep[np.argsort(scores)[-n_remove:]] = False
    if keep.any():
        return w[keep].mean(axis=0).astype(np.float32)
    return (
        np.where(finite[:, None], w, 0.0).sum(axis=0)
        / max(finite.sum(), 1)
    ).astype(np.float32)


def sign_majority_vote(
    w: np.ndarray,
    guess: np.ndarray,
    noise_var: Optional[float] = None,
    sign_eta: Optional[float] = None,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Oracle for the framework's one-bit OTA aggregator (an extension):
    new = guess + eta * sign(sum_i sign(w_i - guess) + n), eta = sign_eta or
    the coordinatewise LOWER-MIDDLE median of |w_i - guess| (torch
    order-statistic semantics, matching the jax path).  Non-finite deltas
    cast a 0 ballot and count as Inf for the eta median, as in the jax
    path."""
    delta = w - guess[None, :]
    finite = np.isfinite(delta)
    votes = np.where(finite, np.sign(delta), 0.0).sum(axis=0)
    if noise_var is not None:
        assert rng is not None
        votes = votes + rng.normal(
            0.0, np.sqrt(noise_var / 2.0), votes.shape
        )
    if sign_eta is None:
        absd = np.where(finite, np.abs(delta), np.inf)
        eta = np.sort(absd, axis=0)[(len(w) - 1) // 2]
        # mirror the jax path: an Inf median (>= ceil(K/2) non-finite
        # deltas, outside the B < K/2 contract) degrades to a no-op step
        # rather than Inf * sign(0) = NaN on tied votes
        eta = np.where(np.isfinite(eta), eta, 0.0)
    else:
        eta = np.float32(sign_eta)
    return (guess + eta * np.sign(votes)).astype(np.float32)


# ---------------------------------------------------------------------------
# packed one-bit sign wire (sign_bits=1) — oracles for the jax pipeline in
# ops/aggregators.py (pack_signs / packed_sign_votes) and the pallas
# popcount kernel.  Wire format: [K, W = ceil(d/32)] uint32, LSB-first
# (coordinate c at bit c % 32 of word c // 32); bit 1 = ballot +1
# (delta >= 0, +0.0 votes +1), bit 0 = ballot -1; a row with ANY
# non-finite coordinate packs all-zero words and leaves k_valid, so it
# casts zero ballots in both the packed and (row-coarsened) unpacked vote.


def pack_signs(w: np.ndarray, guess: np.ndarray):
    """Oracle packer: ``(words [K, ceil(d/32)] uint32, k_valid int)``."""
    delta = np.asarray(w, np.float32) - np.asarray(guess, np.float32)[None, :]
    finite = np.isfinite(delta).all(axis=1)
    k, d = delta.shape
    w_cnt = -(-d // 32)
    bits = np.zeros((k, w_cnt * 32), np.uint32)
    bits[:, :d] = (delta >= 0) & finite[:, None]
    weights = (np.uint32(1) << np.arange(32, dtype=np.uint32))
    words = (bits.reshape(k, w_cnt, 32) * weights).sum(
        axis=-1, dtype=np.uint64
    ).astype(np.uint32)
    return words, int(finite.sum())


def packed_vote_counts(words: np.ndarray, d: int) -> np.ndarray:
    """Oracle popcount reduce: per-coordinate set-bit counts [d] int64."""
    planes = (
        words[:, :, None] >> np.arange(32, dtype=np.uint32)[None, None, :]
    ) & np.uint32(1)
    return planes.sum(axis=0).reshape(-1)[:d].astype(np.int64)


def packed_sign_step(
    w: np.ndarray,
    guess: np.ndarray,
    sign_eta: float,
    noise: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Oracle for the sign_bits=1 signmv/bev step: pack, popcount, recover
    the signed ballot sum as ``2*counts - k_valid`` (each set bit +1, each
    clear bit of a valid row -1), step ``sign_eta`` in the voted
    direction.  ``noise`` is the receiver AWGN draw for signmv (bev, a
    receiver-side rung, passes None)."""
    words, k_valid = pack_signs(w, guess)
    counts = packed_vote_counts(words, w.shape[1])
    votes = (2 * counts - k_valid).astype(np.float64)
    if noise is not None:
        votes = votes + noise
    return (
        np.asarray(guess, np.float32)
        + np.float32(sign_eta) * np.sign(votes).astype(np.float32)
    )


def centered_clip(
    w: np.ndarray,
    guess: Optional[np.ndarray] = None,
    clip_tau: Optional[float] = None,
    clip_iters: int = 3,
) -> np.ndarray:
    """Oracle for the framework's centered-clipping aggregator (an
    extension; Karimireddy et al. 2021): v += mean(clip(w_i - v, tau)).
    ``clip_tau=None`` = adaptive per-step tau: the LOWER-MIDDLE median of
    the client delta norms (non-finite rows counted as +Inf, Inf median
    degraded to 0), matching the jax path."""
    w, finite = _exclude_nonfinite_rows(w)
    if guess is None:
        v = w.sum(axis=0) / max(finite.sum(), 1)
    else:
        v = np.asarray(guess, np.float64)
    for _ in range(clip_iters):
        delta = np.where(finite[:, None], w - v[None, :], 0.0)
        norms = np.maximum(np.linalg.norm(delta, axis=1), 1e-12)
        if clip_tau is None:
            srt = np.sort(np.where(finite, norms, np.inf))
            tau = srt[(len(w) - 1) // 2]
            tau = tau if np.isfinite(tau) else 0.0
        else:
            tau = clip_tau
        scale = np.minimum(1.0, tau / norms)
        v = v + (delta * scale[:, None]).mean(axis=0)
    return v.astype(np.float32)


def alie(w: np.ndarray, byz_size: int, z: float = 1.5) -> np.ndarray:
    """Oracle for the framework's ALIE attack: Byzantine rows at
    mu_honest - z * sigma_honest per coordinate."""
    out = w.copy()
    honest = w[:-byz_size]
    out[-byz_size:] = honest.mean(axis=0) - z * honest.std(axis=0)
    return out


def ipm(w: np.ndarray, byz_size: int, eps: float = 0.5) -> np.ndarray:
    """Oracle for the framework's IPM attack: Byzantine rows at
    -eps * mean(honest)."""
    out = w.copy()
    out[-byz_size:] = -eps * w[:-byz_size].mean(axis=0)
    return out


def _agr_row(honest: np.ndarray, predicate, iters: int = 25) -> np.ndarray:
    """Oracle bisection for the AGR-agnostic attacks (minmax/minsum): the
    malicious row mu + gamma * p, p = -mu/|mu|, with the largest gamma
    satisfying ``predicate(row)``."""
    mu = honest.mean(axis=0)
    p = -mu / max(np.linalg.norm(mu), 1e-12)
    diff = honest[:, None, :] - honest[None, :, :]
    pair = (diff**2).sum(axis=-1)
    dev = np.linalg.norm(honest - mu[None, :], axis=1)
    lo, hi = 0.0, float(np.sqrt(pair.max()) + dev.max() + 1.0)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if predicate(mu + mid * p, pair):
            lo = mid
        else:
            hi = mid
    return (mu + lo * p).astype(np.float32)


def _gamma_row(honest: np.ndarray, gamma: float) -> np.ndarray:
    # mu + gamma*p with p = -mu/|mu| — the fixed-gamma bypass of _agr_row
    mu = honest.mean(axis=0)
    return mu - gamma * mu / max(np.linalg.norm(mu), 1e-12)


def minmax(w: np.ndarray, byz_size: int, gamma: Optional[float] = None) -> np.ndarray:
    """Oracle for the framework's min-max AGR-agnostic attack."""
    out = w.copy()
    honest = w[:-byz_size]
    if gamma is not None:
        row = _gamma_row(honest, gamma)
    else:
        row = _agr_row(
            honest,
            lambda m, pair: ((honest - m) ** 2).sum(axis=1).max() <= pair.max(),
        )
    out[-byz_size:] = row
    return out


def minsum(w: np.ndarray, byz_size: int, gamma: Optional[float] = None) -> np.ndarray:
    """Oracle for the framework's min-sum AGR-agnostic attack."""
    out = w.copy()
    honest = w[:-byz_size]
    if gamma is not None:
        row = _gamma_row(honest, gamma)
    else:
        row = _agr_row(
            honest,
            lambda m, pair: ((honest - m) ** 2).sum() <= pair.sum(axis=1).max(),
        )
    out[-byz_size:] = row
    return out


def bev(
    w: np.ndarray,
    guess: np.ndarray,
    sign_eta: Optional[float] = None,
) -> np.ndarray:
    """Oracle for the framework's best-effort-voting rung (an extension;
    BEV-SGD, arXiv:2110.09660): new = guess + eta * sign(sum_i
    sign(w_i - guess)), equal-weight per-coordinate ballots.  eta =
    sign_eta or the coordinatewise LOWER-MIDDLE median of |w_i - guess|
    with non-finite deltas counted as +Inf (an Inf median degrades the
    coordinate to a no-op step), matching the jax path."""
    delta = w - guess[None, :]
    finite = np.isfinite(delta)
    votes = np.where(finite, np.sign(delta), 0.0).sum(axis=0)
    if sign_eta is None:
        absd = np.where(finite, np.abs(delta), np.inf)
        eta = np.sort(absd, axis=0)[(len(w) - 1) // 2]
        eta = np.where(np.isfinite(eta), eta, 0.0)
    else:
        eta = np.float32(sign_eta)
    return (guess + eta * np.sign(votes)).astype(np.float32)


def _masked_median(x: np.ndarray, mask: np.ndarray) -> float:
    srt = np.sort(np.where(mask, x, np.inf))
    return float(srt[max(int(mask.sum()) - 1, 0) // 2])


def defense_client_scores(
    w: np.ndarray, guess: np.ndarray
) -> "tuple[np.ndarray, np.ndarray]":
    """Oracle for ``defense/scores.client_scores``: per-client composite
    anomaly score (relative norm excess + direction disagreement +
    pairwise-distance excess), medians/centroid over finite rows only,
    non-finite rows scoring exactly 0."""
    finite = np.isfinite(w).all(axis=1)
    delta = (w - guess[None, :]).astype(np.float32)
    safe = np.where(finite[:, None], delta, 0.0)
    norms = np.sqrt((safe * safe).sum(axis=1))
    med_norm = _masked_median(norms, finite)
    norm_term = np.maximum(norms / max(med_norm, 1e-12) - 1.0, 0.0)
    cent = safe.sum(axis=0) / max(int(finite.sum()), 1)
    cent_norm = np.sqrt((cent * cent).sum())
    cos = (safe * cent[None, :]).sum(axis=1) / (
        np.maximum(norms, 1e-12) * max(cent_norm, 1e-12)
    )
    cos_term = np.maximum(1.0 - cos, 0.0)
    diff = w[:, None, :] - w[None, :, :]
    dists = (diff * diff).sum(axis=-1)
    pair_mask = finite[None, :] & ~np.eye(len(w), dtype=bool)
    n_others = np.maximum(pair_mask.sum(axis=1), 1)
    dist_mean = np.where(pair_mask, dists, 0.0).sum(axis=1) / n_others
    med_dist = _masked_median(dist_mean, finite)
    dist_term = np.maximum(dist_mean / max(med_dist, 1e-12) - 1.0, 0.0)
    score = np.where(finite, norm_term + cos_term + dist_term, 0.0)
    return score.astype(np.float32), finite


def mimic(
    w: np.ndarray, byz_size: int, ema: np.ndarray, cusum: np.ndarray
) -> np.ndarray:
    """Oracle for the framework's mimic attack (an extension; the ByzFL
    taxonomy's replay attacker): every Byzantine row replays the honest
    client the detector currently trusts most (minimal CUSUM, EMA as the
    tie-break)."""
    out = w.copy()
    honest = w[:-byz_size]
    h = len(honest)
    tgt = int(np.argmin(cusum[:h] + 1e-3 * ema[:h]))
    out[-byz_size:] = honest[tgt]
    return out


def under_radar(
    w: np.ndarray,
    byz_size: int,
    step: int,
    ema: np.ndarray,
    dev: np.ndarray,
    cusum: np.ndarray,
    guess: np.ndarray,
    *,
    alpha: float = 0.1,
    drift: float = 0.5,
    z_thresh: float = 4.0,
    cusum_thresh: float = 8.0,
    warmup: int = 5,
    clip: float = 3.0,
    eps: float = 1e-6,
    margin: float = 0.9,
    iters: int = 25,
) -> np.ndarray:
    """Oracle for the framework's under-the-radar attack (an extension):
    fixed-count bisection on the push distance gamma along the steered
    ALIE/IPM direction, landing the Byzantine rows' NEXT detector scores
    just under margin * the flag thresholds (instantaneous z AND the
    would-be CUSUM).  During detector warmup the constraint is vacuous
    and gamma runs to the top of the bracket."""
    honest = w[:-byz_size]
    mu = honest.mean(axis=0)
    sig = honest.std(axis=0)
    mu_n = max(np.linalg.norm(mu), 1e-12)
    sig_n = max(np.linalg.norm(sig), 1e-12)
    u = -(mu / mu_n + sig / sig_n)
    u = u / max(np.linalg.norm(u), 1e-12)
    warm = step >= warmup

    def stack_at(gamma):
        out = w.copy()
        out[-byz_size:] = mu + gamma * u
        return out

    def ok(gamma):
        if not warm:
            return True
        score, _ = defense_client_scores(stack_at(gamma), guess)
        z = (score - ema) / (dev + eps)
        cus = np.minimum(
            np.maximum(cusum + np.clip(z, -clip, clip) - drift, 0.0),
            2.0 * cusum_thresh,
        )
        return bool(
            (z[-byz_size:] <= margin * z_thresh).all()
            and (cus[-byz_size:] <= margin * cusum_thresh).all()
        )

    diff = honest[:, None, :] - honest[None, :, :]
    pair = (diff * diff).sum(axis=-1)
    lo, hi = 0.0, float(2.0 * (mu_n + sig_n) + np.sqrt(pair.max()))
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if ok(mid):
            lo = mid
        else:
            hi = mid
    return stack_at(lo)
