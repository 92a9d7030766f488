"""The iteration's random streams, made again from the seed.

A frozen copy of the port's convention (``fed/train.py``): every iteration
``it`` of round ``r`` has a generator per stream (0 batch, 1 channel,
2 aggregation, 3 message), seeded with 63 bits of
``SeedSequence([seed, r, it, stream])``.  Drawn on the same device with the
same calls in the same order, the reference gets the numbers the program
drew, so the two sides can be compared draw for draw.  A change of the
port's streams (their seeds, order or shapes) shows here as a run that is
not correct.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BATCH, CHANNEL, AGGREGATION, MESSAGE = range(4)
#: the std of each fade component: h_r, h_i ~ N(0, 1/2)
FADE_STD = 1.0 / math.sqrt(2.0)
#: |h|^2 floor of the channel inversion
HSQ_FLOOR = 1e-6


def stream_seed(seed: int, round_idx: int, it: int, stream: int) -> int:
    hi, lo = np.random.SeedSequence([seed, round_idx, it, stream]).generate_state(2)
    return ((int(hi) << 32) | int(lo)) & (2**63 - 1)


def generator(seed: int, round_idx: int, it: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, round_idx, it, stream))
    return g


def batch_uniforms(gen, k: int, b: int, device) -> torch.Tensor:
    """[K, B] f32 uniforms that pick each client's batch."""
    return torch.rand((k, b), generator=gen, device=device, dtype=torch.float32)


def oma_terms(gen, k: int, d: int, noise_var: float, device):
    """The OMA link's fades h_r, h_i [K] and noise n_r, n_i [K, d] of std
    sqrt(noise_var), drawn in that order."""
    h_r = FADE_STD * torch.randn(k, generator=gen, device=device)
    h_i = FADE_STD * torch.randn(k, generator=gen, device=device)
    scale = torch.sqrt(torch.tensor(noise_var, dtype=torch.float32))
    n_r = scale * torch.randn((k, d), generator=gen, device=device)
    n_i = scale * torch.randn((k, d), generator=gen, device=device)
    return h_r, h_i, n_r, n_i


def gm_step_draws(gen, k: int, d: int, noisy: bool, device):
    """One AirComp Weiszfeld step's fades [K] twice and, on a noisy
    receiver, its standard normals [d+1]."""
    h_r = FADE_STD * torch.randn(k, generator=gen, device=device)
    h_i = FADE_STD * torch.randn(k, generator=gen, device=device)
    z = torch.randn(d + 1, generator=gen, device=device) if noisy else None
    return h_r, h_i, z
