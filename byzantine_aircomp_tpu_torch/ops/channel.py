"""Simulated wireless channels (AirComp PHY layer).

Port of ``byzantine_aircomp_tpu/ops/channel.py`` (reference
``MNIST_Air_weight.py:385-414``).  Every random term is either drawn from an
explicit ``torch.Generator`` or passed in, so the tests can feed both
packages the same numbers.

* ``oma`` — orthogonal multiple access: per-client Rayleigh fade
  ``h = h_r + j*h_i`` with ``h_r, h_i ~ N(0, 1/2)``, elementwise complex
  AWGN of std ``sqrt(noise_var)``, post-equalization residual
  ``(h_r*n_r + h_i*n_i) / |h|^2`` added to each client's message.
* ``oma2`` — over-the-air sum with truncated channel-inversion power
  control ``gain_i = sqrt(P_max / max(mean(m_i^2)/|h_i|^2, threshold))``
  and receiver noise ``N(0, noise_var/2)``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

# |h|^2 floor for channel-inversion divisions: a deep fade (|h|^2 ~ 0)
# would otherwise explode the equalization residual to +-Inf
HSQ_FLOOR = 1e-6
# std of each fade component: h_r, h_i ~ N(0, 1/2)
FADE_STD = 1.0 / math.sqrt(2.0)


class OmaTerms(NamedTuple):
    """The OMA link's random terms: fades [K], floored |h|^2 [K], and the
    scaled complex-noise draws [K, d]."""

    h_r: torch.Tensor
    h_i: torch.Tensor
    h_sq: torch.Tensor
    n_r: torch.Tensor
    n_i: torch.Tensor


def rayleigh_fade(
    k: int,
    *,
    generator: Optional[torch.Generator] = None,
    device=None,
):
    """Per-client complex fade components h_r, h_i ~ N(0, 1/2), shape [K]."""
    h_r = FADE_STD * torch.randn(k, generator=generator, device=device)
    h_i = FADE_STD * torch.randn(k, generator=generator, device=device)
    return h_r, h_i


def floored_hsq(h_r: torch.Tensor, h_i: torch.Tensor) -> torch.Tensor:
    return torch.clamp(h_r**2 + h_i**2, min=HSQ_FLOOR)


def deep_fade_mask(h_sq: torch.Tensor, fade_floor: float) -> torch.Tensor:
    """[K] bool: the clients whose channel power |h|^2 lies below the
    truncation threshold (JAX ``deep_fade_mask``, :66).  Under truncated
    channel inversion they are in outage: the receiver decodes nothing
    from them, and the fault layer erases their rows to NaN."""
    return h_sq < torch.tensor(fade_floor, dtype=torch.float32, device=h_sq.device)


def csi_error_scale(
    k: int,
    csi_std,
    *,
    generator: Optional[torch.Generator] = None,
    device=None,
    z: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[K] post-equalization magnitude scale under CSI error (JAX
    ``csi_error_scale``, :75): the estimate ``|h_hat| = |h| exp(eps)`` with
    ``eps = csi_std * z``, z [K] standard normals from ``generator`` (or
    passed in), so zero-forcing scales the delivered row by ``exp(-eps)``.
    ``csi_std`` is a scalar or a [K] tensor."""
    if z is None:
        z = torch.randn(k, generator=generator, device=device)
    std = torch.broadcast_to(torch.as_tensor(csi_std, dtype=torch.float32, device=z.device), (k,))
    return torch.exp(-(std * z))


def oma_terms(
    k: int,
    d: int,
    noise_var: float,
    *,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> OmaTerms:
    """Draw the OMA link's terms (fades first, then real/imag noise)."""
    h_r, h_i = rayleigh_fade(k, generator=generator, device=device)
    scale = torch.sqrt(torch.tensor(noise_var, dtype=torch.float32, device=device))
    n_r = scale * torch.randn((k, d), generator=generator, device=device)
    n_i = scale * torch.randn((k, d), generator=generator, device=device)
    return OmaTerms(h_r, h_i, floored_hsq(h_r, h_i), n_r, n_i)


def oma_residual(terms: OmaTerms) -> torch.Tensor:
    """The post-equalization residual ``(h_r*n_r + h_i*n_i)/|h|^2`` [K, d]
    that the OMA link adds to each client's message.  One op per launch,
    each rounded to f32, in this order: the selection kernel's in-read
    channel fold (``csrc/select_columns.cu``) and the trainer's variance use
    the same order, so all three agree bit for bit."""
    return (
        terms.h_r[:, None] * terms.n_r + terms.h_i[:, None] * terms.n_i
    ) / terms.h_sq[:, None]


def oma(
    message: torch.Tensor,
    noise_var: float,
    *,
    generator: Optional[torch.Generator] = None,
    terms: Optional[OmaTerms] = None,
) -> torch.Tensor:
    """Per-client orthogonal-link corruption of a [K, d] message stack:
    ``message + (h_r*n_r + h_i*n_i)/|h|^2`` (reference ``OMA``, ``:385-394``)."""
    k, d = message.shape
    if terms is None:
        terms = oma_terms(k, d, noise_var, generator=generator, device=message.device)
    return message + oma_residual(terms)


def oma2(
    message: torch.Tensor,
    p_max: float = 10.0,
    noise_var: Optional[float] = None,
    threshold=1.0,
    *,
    generator: Optional[torch.Generator] = None,
    fades=None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Over-the-air sum of a [K, d] message stack -> [d] (reference
    ``OMA2``, ``:396-414``).  ``fades`` = (h_r, h_i) and ``noise`` = the
    [d] standard-normal receiver draws may be passed in; ``noise_var=None``
    is the ideal (noiseless) receiver."""
    k, d = message.shape
    if fades is None:
        fades = rayleigh_fade(k, generator=generator, device=message.device)
    h_sq = floored_hsq(*fades)
    p_message = torch.mean(message**2, dim=-1) / h_sq  # [K]
    p_upper = torch.clamp(p_message, min=threshold)
    p_gain = torch.sqrt(p_max / p_upper)  # [K]
    air_sum = torch.sum(message * p_gain[:, None], dim=0)  # [d]
    if noise_var is None:
        return air_sum
    if noise is None:
        noise = torch.randn(d, generator=generator, device=message.device)
    scale = torch.sqrt(
        torch.tensor(noise_var, dtype=torch.float32, device=message.device) / 2.0
    )
    return air_sum + scale * noise
