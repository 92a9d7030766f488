"""Run configuration for the main path.

The main-path subset of ``byzantine_aircomp_tpu/fed/config.py``: the same
field names and defaults, which mirror the reference's ``optConfig`` / CLI
surface (``MNIST_Air_weight.py:16-28, :516-544``): K=50 honest clients, 100
rounds x displayInterval 10, batch 50, gamma 1e-2, weight_decay 0, seed
2021, gm/gm2 maxiter 1000 tol 1e-5 (``:350``).  There is no ``agg_impl``:
on CUDA the hand-written kernels always run, on the CPU their plain
versions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class FedConfig:
    # topology
    honest_size: int = 50
    byz_size: int = 0

    # schedule (reference: rounds=100, displayInterval=10)
    rounds: int = 100
    display_interval: int = 10

    # optimizer (reference SGD: w <- w - gamma*(grad + wd*w))
    gamma: float = 1e-2
    weight_decay: float = 0.0
    batch_size: int = 50

    # dispatch
    agg: str = "gm"
    attack: Optional[str] = None
    noise_var: Optional[float] = None

    # aggregator options (reference options dict, :350)
    agg_maxiter: int = 1000
    agg_tol: float = 1e-5
    gm_p_max: float = 1.0
    # signmv (one-bit OTA majority vote) step; None = the coordinatewise
    # median of |w_i - guess|
    sign_eta: Optional[float] = None
    # sign-channel payload width for signmv: 32 = full-precision ballots,
    # 1 = bit-packed words + popcount reduce (needs sign_eta); the JAX
    # package's 8/16 quantize emulation is not ported
    sign_bits: int = 32

    # determinism
    seed: int = 2021
    fix_seed: bool = True

    # model / data
    model: str = "MLP"
    dataset: str = "mnist"

    # eval
    eval_batch: int = 2000
    eval_train: bool = True

    # federated optimizer (reference --opt, only SGD exists)
    opt: str = "SGD"

    # misc
    mark: str = ""
    cache_dir: str = ""

    @property
    def node_size(self) -> int:
        return self.honest_size + self.byz_size

    def validate(self) -> "FedConfig":
        """Reject configurations the main path cannot run; returns self."""
        from ..ops import aggregators as agg_lib
        from ..ops import attacks as attack_lib
        from ..registry import DATASETS, MODELS

        # reference asserts (MNIST_Air_weight.py:229-230)
        if not (self.byz_size == 0 or self.attack is not None):
            raise ValueError("byz_size > 0 requires an attack")
        if self.honest_size <= 0:
            raise ValueError("honest_size must be positive")
        if self.byz_size < 0:
            raise ValueError(f"byz_size must be >= 0, got {self.byz_size}")
        for name in ("rounds", "display_interval", "batch_size",
                     "agg_maxiter", "eval_batch"):
            if getattr(self, name) < 1:
                raise ValueError(
                    f"{name} must be >= 1, got {getattr(self, name)}"
                )
        if self.agg_tol < 0:
            raise ValueError(f"agg_tol must be >= 0, got {self.agg_tol}")
        if self.gm_p_max <= 0:
            raise ValueError(f"gm_p_max must be > 0, got {self.gm_p_max}")
        if self.noise_var is not None and self.noise_var < 0:
            raise ValueError(f"noise_var must be >= 0, got {self.noise_var}")
        if self.sign_eta is not None and not self.sign_eta > 0:
            raise ValueError(f"sign_eta must be positive when set, got {self.sign_eta}")
        if self.sign_bits not in (1, 8, 16, 32):
            raise ValueError(
                f"sign_bits must be one of 1, 8, 16, 32 (payload width of the "
                f"sign channel), got {self.sign_bits}"
            )
        if self.sign_bits in (8, 16):
            raise ValueError(
                f"sign_bits={self.sign_bits} (quantize emulation) is not ported "
                "to the torch package yet; use 1 or 32"
            )
        if self.sign_bits != 32 and self.agg != "signmv":
            raise ValueError(
                f"sign_bits={self.sign_bits} narrows the SIGN channel; only "
                f"signmv transmits it, agg={self.agg!r} sends full-precision "
                "weights (use --agg signmv, or leave sign_bits at 32)"
            )
        if self.sign_bits == 1 and self.sign_eta is None:
            raise ValueError(
                "sign_bits=1 requires an explicit --sign-eta: the one-bit wire "
                "carries no delta magnitudes for the adaptive eta"
            )
        if self.opt != "SGD":
            raise ValueError(f"opt must be 'SGD' (the only optimizer), got {self.opt!r}")
        # unknown names fail here, not mid-run (KeyError lists known names)
        agg_lib.resolve(self.agg)
        attack_lib.resolve(self.attack)
        DATASETS.get(self.dataset)
        MODELS.get(self.model)
        return self
