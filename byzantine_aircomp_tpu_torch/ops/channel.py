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
* ``oma_by_id`` — ``oma`` with each row's link a function of the row's
  stable client id (service rounds), drawn by a counter-based generator:
  see :func:`oma_by_id_terms`.

A cohort-streamed round draws each chunk's channel, fault and attack noise
from a generator of its own, keyed on the chunk's index
(:func:`cohort_stream`), where the JAX package folds the cohort index into
the round key (``cohort_key``, :42).
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

#: per-chunk streams of a cohort-streamed round are numbered from here
COHORT_STREAM_BASE = 16


def cohort_stream(stream: int) -> int:
    """The generator stream number of a cohort chunk's draws for the
    iteration stream ``stream`` (1 channel, 3 message, 4 fault): the chunk
    index then extends the seed, so every chunk draws its own terms, and
    none of them shares a seed with the resident stream of that number."""
    return COHORT_STREAM_BASE + stream


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
    # a 0-d f32 CPU tensor takes part in a CUDA op with no host-to-device
    # copy, so a CUDA graph can capture the draw (IEEE sqrt is correctly
    # rounded on both, so the scale has the bits it had on the card)
    scale = torch.sqrt(torch.tensor(noise_var, dtype=torch.float32))
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


# ---------------------------------------------------------------------------
# the per-id link: a counter-based draw
#
# A client's link under service rounds is a function of the iteration's key
# and the client's stable population id, whatever stack row the draw placed
# it in.  The JAX package folds the id into the key (threefry ``fold_in``);
# here a 32-bit integer hash of (key, id, counter) gives each uniform, in
# int64 tensor ops that hold values below 2**63 (so no op overflows), and
# Box-Muller turns pairs of uniforms into normals.  The integer part gives
# the same bits on the CPU and the card.

_M32 = 0xFFFFFFFF
# the multiplier of a well-mixing 32-bit hash (xorshift-multiply, 3 rounds);
# below 2**31, so a product with a 32-bit value fits in int64
_HASH_MUL = 0x45D9F3B
# counters: 0, 1 for the fade's two uniforms, 2 + 2j and 3 + 2j for the
# noise of element j
_FADE_COUNTERS = 2


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit mixing hash of int64 values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = (x * _HASH_MUL) & _M32
    x = x ^ (x >> 16)
    x = (x * _HASH_MUL) & _M32
    return x ^ (x >> 16)


def _unit_interval(h: torch.Tensor, open_at_zero: bool) -> torch.Tensor:
    """f32 uniforms from 32-bit hashes: the top 24 bits, exact in f32, in
    (0, 1] (``open_at_zero``, for the logarithm) or [0, 1)."""
    top = (h >> 8) + (1 if open_at_zero else 0)
    return top.to(torch.float32) * (1.0 / (1 << 24))


def _box_muller(h1: torch.Tensor, h2: torch.Tensor):
    """Two independent standard normals from two hash words."""
    u1 = _unit_interval(h1, open_at_zero=True)
    u2 = _unit_interval(h2, open_at_zero=False)
    rad = torch.sqrt(-2.0 * torch.log(u1))
    theta = (2.0 * math.pi) * u2
    return rad * torch.cos(theta), rad * torch.sin(theta)


def link_row_words(key: int, ids: torch.Tensor) -> torch.Tensor:
    """[k] int64 per-row hash words of (key, id): the seed of each row's
    counters.  ``key`` is a non-negative Python int (64 bits are used)."""
    lo, hi = key & _M32, (key >> 32) & _M32
    r = _hash32(ids.to(torch.int64) & _M32)
    r = _hash32(r ^ lo)
    return _hash32(r ^ hi)


def oma_by_id_terms(key: int, ids: torch.Tensor, d: int, noise_var: float) -> OmaTerms:
    """The OMA link's terms for the rows of the stable ids ``ids`` [k]:
    fades h_r, h_i ~ N(0, 1/2) [k] and noise of std ``sqrt(noise_var)``
    [k, d], each a function of (``key``, the row's id, the element) alone.
    So the same id at two stack positions gets the same terms, and the terms
    of a slice of ``ids`` are the slice of the terms."""
    dev = ids.device
    rows = link_row_words(key, ids)[:, None]
    fade_c = _hash32(torch.arange(_FADE_COUNTERS, dtype=torch.int64, device=dev))
    z_r, z_i = _box_muller(_hash32(rows ^ fade_c[0]), _hash32(rows ^ fade_c[1]))
    h_r, h_i = FADE_STD * z_r[:, 0], FADE_STD * z_i[:, 0]
    j = torch.arange(d, dtype=torch.int64, device=dev)
    c_r = _hash32(_FADE_COUNTERS + 2 * j)
    c_i = _hash32(_FADE_COUNTERS + 1 + 2 * j)
    n_r, n_i = _box_muller(_hash32(rows ^ c_r[None, :]), _hash32(rows ^ c_i[None, :]))
    scale = torch.sqrt(torch.tensor(noise_var, dtype=torch.float32, device=dev))
    return OmaTerms(h_r, h_i, floored_hsq(h_r, h_i), scale * n_r, scale * n_i)


def oma_by_id(message: torch.Tensor, ids: torch.Tensor, noise_var: float, *,
              key: Optional[int] = None, terms: Optional[OmaTerms] = None) -> torch.Tensor:
    """OMA corruption of a [k, d] stack whose row i is the message of the
    stable client id ``ids[i]`` (JAX ``oma_by_id``, :115): each row's link
    is drawn from (``key``, ``ids[i]``) (:func:`oma_by_id_terms`), so a
    cohort-streamed round that applies it chunk by chunk with the slice of
    ``ids`` gets the resident stack's rows bit for bit.  The physics per row
    is :func:`oma`'s (JAX ``_oma_row``): ``row + (h_r*n_r + h_i*n_i)/h_sq``
    with ``h_sq`` floored at ``HSQ_FLOOR``.  ``terms`` may be passed in."""
    if terms is None:
        terms = oma_by_id_terms(key, ids, message.shape[1], noise_var)
    return message + oma_residual(terms)
