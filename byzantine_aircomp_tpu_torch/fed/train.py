"""The federated training engine of the main path.

Port of the resident round of ``byzantine_aircomp_tpu/fed/train.py``
(``_iteration`` :605 with defense, service, streaming, bucketing, momentum
and sharding off).  One global iteration is

    flat_params [d] --per-client local SGD step--> weight stack [K, d]
      [--fault: dropout replay-->] --message attack-->
      [--fault: corruption, CSI error, deep-fade erasure-->]
      --OMA channel (not for gm, signmv)--> --aggregate--> [d]

With a fault set the rule runs in its degraded mode, and a finite guard
keeps the previous params wherever the aggregate is not finite.

with per-client gradients taken with respect to the flat parameter vector
through ``torch.func`` (``functional_call`` + ``vmap(grad)``), so the
[K, d] stack is produced with no per-parameter Python plumbing.  The u8
train set stays on the device and is normalized after the gather.

Random draws: every iteration of every round has four streams, as the JAX
package splits its iteration key into (batch, channel, aggregation,
message), and a fifth for the fault channel when a fault is set; here each
is a ``torch.Generator`` seeded from ``(seed, round, iteration, stream)``.
``iteration`` also takes the draws as inputs (``draws``), so the tests can
feed it the JAX package's numbers.  No generator carries state from one
round to the next, so a run resumed at round R draws exactly what the
uninterrupted run drew from round R on.

A delayed attack (``name@R``) counts global iterations in ``attack_iter``,
a device int32 scalar, and one device bool, ``attack_iter >= R *
display_interval``, gates every Byzantine behavior (the data swap, the
gradient scale and the message attack), as the JAX trainer's carried
counter does (``fed/train.py:100-108``, ``:639-645``, ``:800-803``): the
counter is never read on the host inside a round.
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
from ..ops import faults as fault_lib
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
    """One iteration's random streams, in the JAX package's split order;
    ``fault`` (stream 4) exists only when a fault is set, so a fault-free
    run draws what it drew before the fault channel was ported."""

    batch: torch.Generator
    channel: torch.Generator
    aggregation: torch.Generator
    message: torch.Generator
    fault: Optional[torch.Generator] = None


# the record's paths of the fault counts (dropped, erased and corrupt rows,
# then the effective K: the finite rows aggregated), in the order of the
# JAX package's fault_metrics; the first three are summed over a round, the
# effective K is the round's minimum
FAULT_PATHS = ("faultDroppedPath", "faultErasedPath", "faultCorruptPath", "effectiveKPath")


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
        self.fault = fault_lib.resolve(cfg.fault, cfg.fault_overrides())
        self.num_classes = self.dataset.num_classes

        # init params (reference modelFactory + setup_seed(2021), :98-104)
        # (the factories take the knobs they use: fc_width the CNN's,
        # width and remat ResNet-18's, as in JAX fed/train.py:111-118)
        init_gen = torch.Generator().manual_seed(cfg.seed)
        self.model = MODELS.get(cfg.model)(
            input_shape=self.dataset.input_shape,
            num_classes=self.num_classes,
            generator=init_gen,
            fc_width=cfg.fc_width,
            width=cfg.resnet_width,
            remat=cfg.remat,
        ).to(self.device)
        self.spec = flatten_lib.make_flat_spec(self.model)
        self.dim = self.spec.total
        if params is None:
            params = flatten_lib.flatten(dict(self.model.named_parameters()), self.spec)
        self.flat_params = params.detach().to(self.device, torch.float32).clone()

        # device-resident u8 train rows [N, features]; ((u8/255) - mean)/std
        # folded into one multiply-add after the gather, with the same f32
        # constants as the JAX package.  Spatial models (CNN, ResNet-18)
        # get each batch back in the image shape after the gather, as the
        # JAX trainer does (fed/train.py:730); the MLP takes the rows.
        ds = self.dataset
        self._sample_shape = (
            tuple(ds.input_shape) if getattr(type(self.model), "SPATIAL_INPUT", True)
            else (-1,)
        )
        # the client partition (JAX fed/train.py:138-178): the reference's
        # contiguous equal slices, or the label-Dirichlet split, whose
        # shards are made contiguous by permuting the train rows and labels
        # once on the host; then the Zipf re-cut of that index stream
        y_host = np.asarray(ds.y_train)
        perm = None
        if cfg.partition == "dirichlet":
            perm, sharding = data_lib.dirichlet_shards(
                y_host, cfg.node_size, cfg.dirichlet_alpha, seed=cfg.seed
            )
            y_host = y_host[perm]
        else:
            sharding = data_lib.contiguous_shards(len(y_host), cfg.node_size)
        skew = data_lib.parse_size_skew(cfg.size_skew)
        if skew is not None:
            sharding = data_lib.zipf_shards(len(y_host), cfg.node_size, skew)
        if ds.x_train_raw is not None:
            raw = ds.x_train_raw if perm is None else ds.x_train_raw[perm]
            raw = raw.reshape(len(raw), -1)
            self.x_train = torch.from_numpy(np.ascontiguousarray(raw)).to(self.device)
            mean, std = ds.stats
            m = np.broadcast_to(np.asarray(mean, np.float32), ds.input_shape).reshape(-1)
            s = np.broadcast_to(np.asarray(std, np.float32), ds.input_shape).reshape(-1)
            self._norm_scale = torch.from_numpy(1.0 / (255.0 * s)).to(self.device)
            self._norm_bias = torch.from_numpy(-m / s).to(self.device)
        else:
            x = np.asarray(ds.x_train, np.float32)
            if perm is not None:
                x = x[perm]
            x = x.reshape(len(x), -1)
            self.x_train = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
            self._norm_scale = self._norm_bias = None
        self.y_train = torch.from_numpy(y_host.astype(np.int64)).to(self.device)
        self.offsets = torch.from_numpy(sharding.offsets).to(self.device)
        self.sizes = torch.from_numpy(sharding.sizes).to(self.device)

        # static per-client Byzantine mask: LAST byz_size clients (:291)
        mask = np.zeros(cfg.node_size, bool)
        if cfg.byz_size:
            mask[-cfg.byz_size:] = True
        self.byz_mask = torch.from_numpy(mask).to(self.device)

        # delayed onset ("name@R"): the threshold in global iterations, and
        # the device counter of iterations run (None without an onset)
        self._attack_onset = None
        self.attack_iter: Optional[torch.Tensor] = None
        if self.attack is not None and self.attack.onset_round is not None:
            self._attack_onset = self.attack.onset_round * cfg.display_interval
            self.attack_iter = torch.zeros((), dtype=torch.int32, device=self.device)

        self._per_client_grad = vmap(grad(self._loss), in_dims=(None, 0, 0))
        self._eval_cache: Dict[str, tuple] = {}

        # the fault channel's carried state (stale buffer, Gilbert-Elliott
        # states), and the [4] counts of FAULT_PATHS: of the last iteration,
        # and reduced over the last round (device tensors)
        self.fault_state = (
            fault_lib.init_state(self.fault, cfg.node_size, self.flat_params)
            if self.fault is not None else None
        )
        self.iteration_fault_metrics: Optional[torch.Tensor] = None
        self.last_fault_metrics: Optional[torch.Tensor] = None

    # ------------------------------------------------------------------
    # one iteration

    def _loss(self, flat_params, x, y):
        params = flatten_lib.unflatten(flat_params, self.spec)
        logits = functional_call(self.model, params, (x,))
        return torch.mean(cross_entropy(logits, y))

    def client_stack(self, flat_params, x, y, is_byz) -> torch.Tensor:
        """[K, d] weights after each client's local SGD step
        ``w <- w - gamma*(g + wd*w)`` (``:302-303``), with the data-level
        attack applied to the Byzantine clients' batches and a gradient-
        scale attack to their gradient, before weight decay (JAX
        ``fed/train.py:475-483``)."""
        cfg = self.cfg
        attack = self.attack
        if attack is not None and attack.data_fn is not None:
            x_att, y_att = attack.apply_data(x, y, self.num_classes)
            x = torch.where(is_byz.reshape((-1,) + (1,) * (x.dim() - 1)), x_att, x)
            y = torch.where(is_byz[:, None], y_att, y)
        g = self._per_client_grad(flat_params, x, y)
        if attack is not None and attack.grad_scale != 1.0:
            one = torch.ones((), dtype=g.dtype, device=g.device)
            g = g * torch.where(is_byz, attack.grad_scale * one, one)[:, None]
        return flat_params - cfg.gamma * (g + cfg.weight_decay * flat_params)

    def iteration_generators(self, round_idx: int, it: int) -> IterationGenerators:
        gens = []
        for stream in range(4 if self.fault is None else 5):
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
        """One global iteration: local steps -> [dropout] -> attack ->
        [corruption, CSI error, erasure] -> channel -> agg.

        Returns ``(new flat params, honest variance or None)``.  ``draws``
        may supply any of: ``"u"`` [K, B] batch uniforms, ``"oma"`` the
        OMA link's terms (:class:`..ops.channel.OmaTerms`), ``"fades"``
        (h_r, h_i) [T, K] and ``"noise"`` [T, d+1] for gm's Weiszfeld
        steps, ``"vote_noise"`` [d] for signmv's receiver, ``"dnc"`` dnc's
        ``[(cols, v0)]`` per filtering round, ``"message"`` the gaussian
        attack's [B, d] normals, and ``"fault"`` a dict of the
        fault channel's draws (``"dropped"`` for
        :func:`..ops.faults.apply_dropout`, the keys of
        :func:`..ops.faults.apply_transmission`); the rest comes from
        ``generators``.

        With a fault set, the carried ``fault_state`` advances, the rule
        runs degraded, every non-finite coordinate of the aggregate keeps
        its previous value, and ``iteration_fault_metrics`` holds this
        iteration's [4] counts (in the order of :data:`FAULT_PATHS`).

        With ``--var`` set, median and trimmed_mean take the OMA terms as
        ``channel=`` and fold the corruption into their one read of the
        stack, except under a fault (their degraded modes take the received
        stack, as the JAX package's degraded rounds do); the other rules
        (except gm and signmv, which own their channel) get the corrupted
        stack.  Either way the terms are the same draws, and the honest
        variance is taken on the post-channel stack, as the reference does
        (``:351-352``, ``:360-361``)."""
        cfg = self.cfg
        draws = draws or {}
        gens = generators or IterationGenerators(None, None, None, None)
        fault = self.fault
        fault_draws = draws.get("fault") or {}

        idx = data_lib.sample_client_batch_indices(
            self.offsets, self.sizes, cfg.batch_size,
            generator=gens.batch, u=draws.get("u"),
        )
        x = self.x_train[idx]  # [K, B, features] on-device gather
        if self._norm_scale is not None:
            x = x.to(torch.float32) * self._norm_scale + self._norm_bias
        x = x.reshape(x.shape[:2] + self._sample_shape)
        y = self.y_train[idx]
        # one device bool gates every Byzantine behavior until the onset
        is_byz, attack_on = self.byz_mask, None
        if self._attack_onset is not None:
            attack_on = self.attack_iter >= self._attack_onset
            is_byz = is_byz & attack_on
        w_stack = self.client_stack(flat_params, x, y, is_byz)

        if fault is not None:
            # before the attack: the buffer keeps what the clients sent
            stale, ge_bad = self.fault_state
            w_stack, stale, n_dropped = fault_lib.apply_dropout(
                fault, w_stack, stale, generator=gens.fault,
                dropped=fault_draws.get("dropped"),
            )
        if self.attack is not None:
            w_att = self.attack.apply_message(
                w_stack, cfg.byz_size, gens.message, param=cfg.attack_param,
                noise=draws.get("message"),
            )
            w_stack = w_att if attack_on is None else torch.where(attack_on, w_att, w_stack)
        if fault is not None:
            # after it: corruption and the channel's faults hit every row
            w_stack, ge_bad, n_erased, n_corrupt = fault_lib.apply_transmission(
                fault, w_stack, ge_bad, generator=gens.fault, draws=fault_draws,
            )
            self.fault_state = fault_lib.FaultState(stale, ge_bad)
        terms = None
        if cfg.noise_var is not None and agg_lib.needs_oma_prepass(cfg.agg):
            terms = draws.get("oma")
            if terms is None:
                k, d = w_stack.shape
                terms = channel_lib.oma_terms(
                    k, d, cfg.noise_var, generator=gens.channel,
                    device=w_stack.device,
                )
            if fault is not None or not agg_lib.supports_fused_epilogue(cfg.agg):
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
            m=cfg.krum_m,
            clip_tau=cfg.clip_tau,
            clip_iters=cfg.clip_iters,
            sign_eta=cfg.sign_eta,
            sign_bits=cfg.sign_bits,
            dnc_iters=cfg.dnc_iters,
            dnc_sub_dim=cfg.dnc_sub_dim,
            dnc_c=cfg.dnc_c,
            degraded=fault is not None,
            generator=gens.aggregation,
            fades=draws.get("fades"),
            noise=draws.get("noise"),
            vote_noise=draws.get("vote_noise"),
            dnc_draws=draws.get("dnc"),
        ).to(torch.float32)  # reference semantics (:354-358)
        if fault is not None:
            # the receiver's finite guard: a coordinate that no finite row
            # reached keeps its previous value
            new_flat = torch.where(torch.isfinite(new_flat), new_flat, flat_params)
            eff_k = torch.sum(agg_lib._finite_rows(w_stack)).to(torch.float32)
            self.iteration_fault_metrics = torch.stack([n_dropped, n_erased, n_corrupt, eff_k])
        variance = None
        if want_variance:
            w_h = w_stack[: cfg.honest_size]
            if terms is not None:
                # the received honest rows, bitwise those channel.oma makes
                w_h = w_h + channel_lib.oma_residual(
                    channel_lib.OmaTerms(*(t[: cfg.honest_size] for t in terms))
                )
            variance = honest_variance(w_h, cfg.honest_size)
        if self.attack_iter is not None:
            self.attack_iter = self.attack_iter + 1
        return new_flat, variance

    def run_round(self, round_idx: int) -> torch.Tensor:
        """``display_interval`` iterations; returns the honest dispersion of
        the last iteration's stack (reference ``:360-361``) as a device
        scalar, without a host sync.  With a fault set,
        ``last_fault_metrics`` becomes the round's counts: dropped, erased
        and corrupt rows summed over its iterations, the effective K at its
        minimum (device tensors too)."""
        interval = self.cfg.display_interval
        variance = None
        counts = []
        for it in range(interval):
            self.flat_params, variance = self.iteration(
                self.flat_params,
                self.iteration_generators(round_idx, it),
                want_variance=it == interval - 1,
            )
            if self.fault is not None:
                counts.append(self.iteration_fault_metrics)
        if counts:
            per_it = torch.stack(counts)
            self.last_fault_metrics = torch.cat(
                [torch.sum(per_it[:, :3], dim=0), torch.amin(per_it[:, 3:], dim=0)]
            )
        return variance

    # ------------------------------------------------------------------
    # eval and the host-side training loop

    def _eval_arrays(self, split: str):
        if split not in self._eval_cache:
            ds = self.dataset
            x, y = (ds.x_val, ds.y_val) if split == "val" else (ds.x_train, ds.y_train)
            x = np.ascontiguousarray(x, np.float32).reshape((len(x),) + self._sample_shape)
            self._eval_cache[split] = (
                torch.from_numpy(x).to(self.device),
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

    def train(
        self,
        log_fn: Optional[Callable[[str], None]] = None,
        checkpoint_fn: Optional[Callable[[int, "Trainer", Dict[str, List[float]]], None]] = None,
        start_round: int = 0,
    ) -> Dict[str, List[float]]:
        """Full training run; returns the reference-schema metric paths
        (``trainLossPath`` etc., pickled record keys at ``:481-489``).
        ``start_round > 0`` resumes a checkpointed run (the caller restores
        the state first, ``harness.restore_trainer``): the paths start with
        the eval of the restored params.  ``checkpoint_fn(r, trainer, paths)``
        runs after every round, with ``r`` the number of rounds done and
        ``paths`` those recorded so far."""
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
        if self.fault is not None:
            for key in FAULT_PATHS:
                paths[key] = []
        log(
            f"[{start_round}/{cfg.rounds}](interval: {cfg.display_interval}) "
            f"train: loss={tr_loss:.4f} acc={tr_acc:.4f} "
            f"val: loss={va_loss:.4f} acc={va_acc:.4f}"
        )
        var_str = f" var={cfg.noise_var:.2e}" if cfg.noise_var is not None else ""
        for r in range(start_round, cfg.rounds):
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
            fault_str = ""
            if self.fault is not None:
                # the round's counts, read with the eval: one host read
                dropped, erased, corrupt, eff_k = self.last_fault_metrics.tolist()
                for key, v in zip(FAULT_PATHS, (dropped, erased, corrupt, eff_k)):
                    paths[key].append(v)
                fault_str = (f" effK={eff_k:.0f} drop={dropped:.0f} "
                             f"erase={erased:.0f} corrupt={corrupt:.0f}")
            log(
                f"[{r + 1}/{cfg.rounds}](interval: {cfg.display_interval}) "
                f"train: loss={tr_loss:.4f} acc={tr_acc:.4f} "
                f"val: loss={va_loss:.4f} acc={va_acc:.4f}{var_str}{fault_str}"
            )
            if checkpoint_fn is not None:
                checkpoint_fn(r + 1, self, paths)
        return paths
