"""The federated training engine of the main path.

Port of the resident round of ``byzantine_aircomp_tpu/fed/train.py``
(``_iteration`` :605 with faults, defense, service, streaming, bucketing,
momentum and sharding off).  One global iteration is

    flat_params [d] --per-client local SGD step--> weight stack [K, d]
      --message attack--> --OMA channel (not for gm, signmv)--> --aggregate--> [d]

with per-client gradients taken with respect to the flat parameter vector
through ``torch.func`` (``functional_call`` + ``vmap(grad)``), so the
[K, d] stack is produced with no per-parameter Python plumbing.  The u8
train set stays on the device and is normalized after the gather.

Random draws: every iteration of every round has four streams, as the JAX
package splits its iteration key into (batch, channel, aggregation,
message); here each is a ``torch.Generator`` seeded from
``(seed, round, iteration, stream)``.  ``iteration`` also takes the draws
as inputs (``draws``), so the tests can feed it the JAX package's numbers.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call, grad, vmap

from ..data import datasets as data_lib
from ..device import resolve_device
from ..ops import aggregators as agg_lib
from ..ops import attacks as attack_lib
from ..ops import channel as channel_lib
from ..ops import flatten as flatten_lib
from ..registry import MODELS
from .config import FedConfig


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample softmax cross entropy with integer labels."""
    return F.cross_entropy(logits, labels, reduction="none")


def honest_variance(w_stack: torch.Tensor, honest_size: int) -> torch.Tensor:
    """Mean over honest clients of ||w_i - mean_honest||^2
    (reference ``getVarience``, ``:127-129``)."""
    w_h = w_stack[:honest_size]
    centered = w_h - torch.mean(w_h, dim=0, keepdim=True)
    return torch.mean(torch.sum(centered**2, dim=1))


class IterationGenerators(NamedTuple):
    """One iteration's random streams, in the JAX package's split order."""

    batch: torch.Generator
    channel: torch.Generator
    aggregation: torch.Generator
    message: torch.Generator


class Trainer:
    """Drives the main path on one device (``"cuda"`` unless the caller
    passes ``device="cpu"``).  ``params`` (flat [d], JAX layout) replaces
    the seeded initialization, e.g. with weights carried over from the JAX
    package (:mod:`..interop`)."""

    def __init__(
        self,
        cfg: FedConfig,
        dataset: Optional[data_lib.Dataset] = None,
        device: str = "cuda",
        params: Optional[torch.Tensor] = None,
    ):
        self.cfg = cfg.validate()
        self.device = resolve_device(device)
        self.dataset = dataset or data_lib.load(cfg.dataset)
        self.attack = attack_lib.resolve(cfg.attack)
        self.agg_fn = agg_lib.resolve(cfg.agg)
        self.num_classes = self.dataset.num_classes

        # init params (reference modelFactory + setup_seed(2021), :98-104)
        init_gen = torch.Generator().manual_seed(cfg.seed)
        self.model = MODELS.get(cfg.model)(
            input_shape=self.dataset.input_shape,
            num_classes=self.num_classes,
            generator=init_gen,
        ).to(self.device)
        self.spec = flatten_lib.make_flat_spec(self.model)
        self.dim = self.spec.total
        if params is None:
            params = flatten_lib.flatten(dict(self.model.named_parameters()), self.spec)
        self.flat_params = params.detach().to(self.device, torch.float32).clone()

        # device-resident u8 train rows [N, features]; ((u8/255) - mean)/std
        # folded into one multiply-add after the gather, with the same f32
        # constants as the JAX package
        ds = self.dataset
        sharding = data_lib.contiguous_shards(len(ds.y_train), cfg.node_size)
        if ds.x_train_raw is not None:
            raw = ds.x_train_raw.reshape(len(ds.x_train_raw), -1)
            self.x_train = torch.from_numpy(np.ascontiguousarray(raw)).to(self.device)
            mean, std = ds.stats
            m = np.broadcast_to(np.asarray(mean, np.float32), ds.input_shape).reshape(-1)
            s = np.broadcast_to(np.asarray(std, np.float32), ds.input_shape).reshape(-1)
            self._norm_scale = torch.from_numpy(1.0 / (255.0 * s)).to(self.device)
            self._norm_bias = torch.from_numpy(-m / s).to(self.device)
        else:
            x = np.asarray(ds.x_train, np.float32).reshape(len(ds.x_train), -1)
            self.x_train = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
            self._norm_scale = self._norm_bias = None
        self.y_train = torch.from_numpy(np.asarray(ds.y_train, np.int64)).to(self.device)
        self.offsets = torch.from_numpy(sharding.offsets).to(self.device)
        self.sizes = torch.from_numpy(sharding.sizes).to(self.device)

        # static per-client Byzantine mask: LAST byz_size clients (:291)
        mask = np.zeros(cfg.node_size, bool)
        if cfg.byz_size:
            mask[-cfg.byz_size:] = True
        self.byz_mask = torch.from_numpy(mask).to(self.device)

        self._per_client_grad = vmap(grad(self._loss), in_dims=(None, 0, 0))
        self._eval_cache: Dict[str, tuple] = {}

    # ------------------------------------------------------------------
    # one iteration

    def _loss(self, flat_params, x, y):
        params = flatten_lib.unflatten(flat_params, self.spec)
        logits = functional_call(self.model, params, (x,))
        return torch.mean(cross_entropy(logits, y))

    def client_stack(self, flat_params, x, y, is_byz) -> torch.Tensor:
        """[K, d] weights after each client's local SGD step
        ``w <- w - gamma*(g + wd*w)`` (``:302-303``), with the data-level
        attack applied to the Byzantine clients' batches."""
        cfg = self.cfg
        if self.attack is not None and self.attack.data_fn is not None:
            x_att, y_att = self.attack.apply_data(x, y, self.num_classes)
            x = torch.where(is_byz[:, None, None], x_att, x)
            y = torch.where(is_byz[:, None], y_att, y)
        g = self._per_client_grad(flat_params, x, y)
        return flat_params - cfg.gamma * (g + cfg.weight_decay * flat_params)

    def iteration_generators(self, round_idx: int, it: int) -> IterationGenerators:
        gens = []
        for stream in range(4):
            hi, lo = np.random.SeedSequence(
                [self.cfg.seed, round_idx, it, stream]
            ).generate_state(2)
            g = torch.Generator(device=self.device)
            g.manual_seed(((int(hi) << 32) | int(lo)) & (2**63 - 1))
            gens.append(g)
        return IterationGenerators(*gens)

    def iteration(
        self,
        flat_params: torch.Tensor,
        generators: Optional[IterationGenerators] = None,
        draws: Optional[dict] = None,
        want_variance: bool = False,
    ):
        """One global iteration: local steps -> attack -> channel -> agg.

        Returns ``(new flat params, honest variance or None)``.  ``draws``
        may supply any of: ``"u"`` [K, B] batch uniforms, ``"oma"`` the
        OMA link's terms (:class:`..ops.channel.OmaTerms`), ``"fades"``
        (h_r, h_i) [T, K] and ``"noise"`` [T, d+1] for gm's Weiszfeld
        steps, ``"vote_noise"`` [d] for signmv's receiver; the rest comes
        from ``generators``.

        With ``--var`` set, median and trimmed_mean take the OMA terms as
        ``channel=`` and fold the corruption into their one read of the
        stack; the other rules (except gm and signmv, which own their
        channel) get the corrupted stack.  Either way the terms are the
        same draws, and the honest variance is taken on the post-channel
        stack, as the reference does (``:351-352``, ``:360-361``)."""
        cfg = self.cfg
        draws = draws or {}
        gens = generators or IterationGenerators(None, None, None, None)

        idx = data_lib.sample_client_batch_indices(
            self.offsets, self.sizes, cfg.batch_size,
            generator=gens.batch, u=draws.get("u"),
        )
        x = self.x_train[idx]  # [K, B, features] on-device gather
        if self._norm_scale is not None:
            x = x.to(torch.float32) * self._norm_scale + self._norm_bias
        y = self.y_train[idx]
        w_stack = self.client_stack(flat_params, x, y, self.byz_mask)

        if self.attack is not None:
            w_stack = self.attack.apply_message(
                w_stack, cfg.byz_size, gens.message
            )
        terms = None
        if cfg.noise_var is not None and agg_lib.needs_oma_prepass(cfg.agg):
            terms = draws.get("oma")
            if terms is None:
                k, d = w_stack.shape
                terms = channel_lib.oma_terms(
                    k, d, cfg.noise_var, generator=gens.channel,
                    device=w_stack.device,
                )
            if not agg_lib.supports_fused_epilogue(cfg.agg):
                w_stack = channel_lib.oma(w_stack, cfg.noise_var, terms=terms)
                terms = None

        new_flat = self.agg_fn(
            w_stack,
            guess=flat_params,
            honest_size=cfg.honest_size,
            noise_var=cfg.noise_var,
            channel=terms,
            maxiter=cfg.agg_maxiter,
            tol=cfg.agg_tol,
            p_max=cfg.gm_p_max,
            sign_eta=cfg.sign_eta,
            sign_bits=cfg.sign_bits,
            generator=gens.aggregation,
            fades=draws.get("fades"),
            noise=draws.get("noise"),
            vote_noise=draws.get("vote_noise"),
        ).to(torch.float32)  # reference semantics (:354-358)
        variance = None
        if want_variance:
            w_h = w_stack[: cfg.honest_size]
            if terms is not None:
                # the received honest rows, bitwise those channel.oma makes
                w_h = w_h + channel_lib.oma_residual(
                    channel_lib.OmaTerms(*(t[: cfg.honest_size] for t in terms))
                )
            variance = honest_variance(w_h, cfg.honest_size)
        return new_flat, variance

    def run_round(self, round_idx: int) -> torch.Tensor:
        """``display_interval`` iterations; returns the honest dispersion of
        the last iteration's stack (reference ``:360-361``) as a device
        scalar, without a host sync."""
        interval = self.cfg.display_interval
        variance = None
        for it in range(interval):
            self.flat_params, variance = self.iteration(
                self.flat_params,
                self.iteration_generators(round_idx, it),
                want_variance=it == interval - 1,
            )
        return variance

    # ------------------------------------------------------------------
    # eval and the host-side training loop

    def _eval_arrays(self, split: str):
        if split not in self._eval_cache:
            ds = self.dataset
            x, y = (ds.x_val, ds.y_val) if split == "val" else (ds.x_train, ds.y_train)
            self._eval_cache[split] = (
                torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device),
                torch.from_numpy(np.asarray(y, np.int64)).to(self.device),
            )
        return self._eval_cache[split]

    @torch.no_grad()
    def evaluate(self, split: str = "val"):
        """Full-dataset (loss, accuracy) (reference ``calculateAccuracy``,
        ``:106-125``), in chunks of ``eval_batch``."""
        x, y = self._eval_arrays(split)
        params = flatten_lib.unflatten(self.flat_params, self.spec)
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        for lo in range(0, len(y), self.cfg.eval_batch):
            xc, yc = x[lo : lo + self.cfg.eval_batch], y[lo : lo + self.cfg.eval_batch]
            logits = functional_call(self.model, params, (xc,))
            loss += torch.sum(cross_entropy(logits, yc))
            correct += torch.sum(torch.argmax(logits, dim=1) == yc)
        n = len(y)
        return float(loss) / n, int(correct) / n

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self, log_fn: Optional[Callable[[str], None]] = None) -> Dict[str, List[float]]:
        """Full training run; returns the reference-schema metric paths
        (``trainLossPath`` etc., pickled record keys at ``:481-489``)."""
        cfg = self.cfg
        log = log_fn or (lambda s: None)

        def eval_pair():
            tr = self.evaluate("train") if cfg.eval_train else (0.0, 0.0)
            return tr, self.evaluate("val")

        (tr_loss, tr_acc), (va_loss, va_acc) = eval_pair()
        paths = {
            "trainLossPath": [tr_loss],
            "trainAccPath": [tr_acc],
            "valLossPath": [va_loss],
            "valAccPath": [va_acc],
            "variencePath": [],  # sic — reference spelling
            "roundsPerSec": [],
        }
        log(
            f"[0/{cfg.rounds}](interval: {cfg.display_interval}) "
            f"train: loss={tr_loss:.4f} acc={tr_acc:.4f} "
            f"val: loss={va_loss:.4f} acc={va_acc:.4f}"
        )
        var_str = f" var={cfg.noise_var:.2e}" if cfg.noise_var is not None else ""
        for r in range(cfg.rounds):
            self._sync()
            t0 = time.perf_counter()
            variance = self.run_round(r)
            self._sync()
            dt = time.perf_counter() - t0
            (tr_loss, tr_acc), (va_loss, va_acc) = eval_pair()
            paths["trainLossPath"].append(tr_loss)
            paths["trainAccPath"].append(tr_acc)
            paths["valLossPath"].append(va_loss)
            paths["valAccPath"].append(va_acc)
            paths["variencePath"].append(float(variance))
            paths["roundsPerSec"].append(1.0 / dt)
            log(
                f"[{r + 1}/{cfg.rounds}](interval: {cfg.display_interval}) "
                f"train: loss={tr_loss:.4f} acc={tr_acc:.4f} "
                f"val: loss={va_loss:.4f} acc={va_acc:.4f}{var_str}"
            )
        return paths
