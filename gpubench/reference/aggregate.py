"""The aggregation rules and the OMA channel, in plain float32 PyTorch
(``MNIST_Air_weight.py`` ``gm2`` :162-184, ``gm`` :131-160, ``median``
:194-195, ``trimmed_mean`` :189-192, ``OMA`` :385-394, ``OMA2`` :396-414,
``getVarience`` :127-129)."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .draws import HSQ_FLOOR

#: the distance floor of a Weiszfeld step
DIST_CLAMP = 1e-4
#: gm's power-control threshold is this times the scaler squared
THRESHOLD_FACTOR = 500.0
#: steps between host checks of a Weiszfeld loop's stopping rule
CHECK_EVERY = 32


def received(w: torch.Tensor, terms) -> torch.Tensor:
    """``w + (h_r n_r + h_i n_i) / |h|^2`` with |h|^2 floored: each
    client's row after the orthogonal link."""
    h_r, h_i, n_r, n_i = terms
    h_sq = torch.clamp(h_r * h_r + h_i * h_i, min=HSQ_FLOOR)
    return w + (h_r[:, None] * n_r + h_i[:, None] * n_i) / h_sq[:, None]


def honest_variance(w: torch.Tensor, honest: int) -> torch.Tensor:
    """Mean over the honest rows of the squared distance to their mean."""
    h = w[:honest]
    c = h - h.mean(dim=0)
    return (c * c).sum(dim=1).mean()


def _weiszfeld(next_guess: Callable[[torch.Tensor, int], torch.Tensor], guess: torch.Tensor,
               maxiter: int, tol: float,
               after: Optional[Callable[[torch.Tensor], None]] = None) -> Tuple[torch.Tensor, int]:
    """Iterate ``guess <- next_guess(guess, step)`` until a step moves the
    guess by at most ``tol`` (that step is taken) or ``maxiter`` steps;
    ``after(guess)`` sees the guess each step leaves.  Returns the guess and
    the steps taken.  The stopping test is read on the host every
    ``CHECK_EVERY`` steps; a step after the stop leaves the guess as it is."""
    g = guess.clone()
    active = torch.ones((), dtype=torch.bool, device=g.device)
    steps = torch.zeros((), dtype=torch.int64, device=g.device)
    i = 0
    while i < maxiter:
        for _ in range(min(CHECK_EVERY, maxiter - i)):
            nxt = next_guess(g, i)
            moved = torch.linalg.vector_norm(nxt - g) > tol
            g = torch.where(active, nxt, g)
            if after is not None:
                after(g)
            steps = steps + active.to(torch.int64)
            active = active & moved
            i += 1
        if not bool(active):
            break
    return g, int(steps)


def gm2(w: torch.Tensor, guess: torch.Tensor, maxiter: int, tol: float):
    """The ideal geometric median by Weiszfeld's iteration:
    ``guess <- sum_i w_i / d_i / sum_i 1 / d_i``, ``d_i`` floored."""

    def next_guess(g, _i):
        inv = 1.0 / torch.clamp(torch.linalg.vector_norm(w - g, dim=1), min=DIST_CLAMP)
        return (w * inv[:, None]).sum(dim=0) / inv.sum()

    return _weiszfeld(next_guess, guess, maxiter, tol)


def rms(g: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(g * g))


def gm(w: torch.Tensor, guess: torch.Tensor, maxiter: int, tol: float, p_max: float,
       noise_var: Optional[float], draw: Callable[[int], tuple]):
    """The AirComp geometric median: each Weiszfeld step sends the messages
    ``m_i = [w_i / d_i, s / d_i]`` (s: the RMS of the guess) over the air
    with truncated channel inversion, gain ``sqrt(P / max(mean(m_i^2) /
    |h_i|^2, 500 s^2))``, and receiver noise of variance ``noise_var / 2``;
    the new guess is ``sum[:d] / sum[d] * s``.  ``mean(m_i^2)`` is
    ``(|w_i|^2 + s^2) / d_i^2 / (d + 1)``.  ``draw(step)`` gives the step's
    fades and standard normals (:func:`.draws.gm_step_draws`)."""
    d = w.shape[1]
    noise_std = None
    if noise_var is not None:
        noise_std = torch.sqrt(torch.tensor(noise_var, dtype=torch.float32) / 2.0).to(w.device)
    sq_norm = (w * w).sum(dim=1)
    scaler = [rms(guess)]

    def next_guess(g, i):
        h_r, h_i, z = draw(i)
        s = scaler[0]
        h_sq = torch.clamp(h_r * h_r + h_i * h_i, min=HSQ_FLOOR)
        inv = 1.0 / torch.clamp(torch.linalg.vector_norm(w - g, dim=1), min=DIST_CLAMP)
        power = inv * inv * (sq_norm + s * s) / (d + 1) / h_sq
        coeff = inv * torch.sqrt(p_max / torch.clamp(power, min=THRESHOLD_FACTOR * s * s))
        num = (w * coeff[:, None]).sum(dim=0)
        den = coeff.sum() * s
        if noise_std is not None:
            num = num + noise_std * z[:d]
            den = den + noise_std * z[d]
        return num / den * s

    def after(g):
        scaler[0] = rms(g)

    return _weiszfeld(next_guess, guess, maxiter, tol, after)


def median(w: torch.Tensor) -> torch.Tensor:
    """The coordinatewise lower median, ``sorted[(K - 1) // 2]``."""
    return torch.kthvalue(w, (w.shape[0] - 1) // 2 + 1, dim=0).values


def trimmed_mean(w: torch.Tensor, trim_ratio: float) -> torch.Tensor:
    """The coordinatewise mean of the middle ``K - 2b`` values,
    ``b = int(K * trim_ratio)``, summed in float64: the f32 rounding of a
    sum of hundreds of noisy values is as large as what the control
    changes."""
    k = w.shape[0]
    b = int(k * trim_ratio)
    return torch.sort(w, dim=0).values[b:k - b].double().mean(dim=0).float()
