"""Server optimizers over the pseudo-gradient: FedAvgM and FedAdam.

The JAX package runs ``optax.sgd(lr, momentum)`` and ``optax.adam(lr)`` on
``delta = flat - aggregated`` and adds the update to ``flat``
(``fed/train.py:263-271, :1055-1063``).  These are the same formulas as
plain functions on tensors, in optax's order of operations, not
``torch.optim``'s (which dampens, and bias-corrects in another order):

* ``momentum``: ``t <- g + mu*t``, update ``-lr*t`` (no dampening, no
  Nesterov);
* ``adam``: ``m <- (1-b1)*g + b1*m``, ``v <- (1-b2)*g^2 + b2*v``, the count
  incremented first, then ``mhat = m / (1 - b1^count)``, ``vhat = v /
  (1 - b2^count)``, update ``-lr * mhat / (sqrt(vhat + eps_root) + eps)``.

The state is a tuple of tensors in the order of optax's state leaves:
``(trace,)`` for momentum, ``(count int32, mu, nu)`` for adam, so a
checkpoint's leaves are interchangeable with the JAX package's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8
ADAM_EPS_ROOT = 0.0

State = Tuple[torch.Tensor, ...]


def init(kind: str, params: torch.Tensor) -> Optional[State]:
    """The zero state of ``kind`` ("none", "momentum", "adam") for
    ``params`` (None for "none")."""
    if kind == "none":
        return None
    if kind == "momentum":
        return (torch.zeros_like(params),)
    if kind == "adam":
        count = torch.zeros((), dtype=torch.int32, device=params.device)
        return (count, torch.zeros_like(params), torch.zeros_like(params))
    raise ValueError(f"server_opt must be none|momentum|adam, got {kind!r}")


def momentum_update(delta: torch.Tensor, state: State, lr: float, momentum: float):
    """``optax.sgd(lr, momentum)``: returns ``(update, new state)``."""
    (trace,) = state
    trace = delta + momentum * trace
    return trace * (-lr), (trace,)


def adam_update(delta: torch.Tensor, state: State, lr: float):
    """``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0): returns
    ``(update, new state)``."""
    count, mu, nu = state
    mu = (1 - ADAM_B1) * delta + ADAM_B1 * mu
    nu = (1 - ADAM_B2) * (delta * delta) + ADAM_B2 * nu
    # optax's safe_increment: the int32 count saturates instead of wrapping
    count = torch.where(count < torch.iinfo(torch.int32).max, count + 1, count)
    # b^count in f32 on the device (no host read, no copy to the card)
    c = count.to(torch.float32)
    mu_hat = mu / (1 - torch.pow(ADAM_B1, c))
    nu_hat = nu / (1 - torch.pow(ADAM_B2, c))
    update = mu_hat / (torch.sqrt(nu_hat + ADAM_EPS_ROOT) + ADAM_EPS)
    return update * (-lr), (count, mu, nu)


def update(kind: str, delta: torch.Tensor, state: State, lr: float, momentum: float):
    """``(update, new state)`` of the optimizer of ``kind`` on the
    pseudo-gradient ``delta``."""
    if kind == "momentum":
        return momentum_update(delta, state, lr, momentum)
    if kind == "adam":
        return adam_update(delta, state, lr)
    raise ValueError(f"no server optimizer {kind!r}")


def step(kind: str, flat: torch.Tensor, aggregated: torch.Tensor, state: State,
         lr: float, momentum: float):
    """The server's new params and state: the optimizer of ``kind`` on the
    pseudo-gradient ``flat - aggregated``, its update added to ``flat``."""
    upd, state = update(kind, flat - aggregated, state, lr, momentum)
    return flat + upd, state
