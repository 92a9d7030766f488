"""The federated training engine of the main path.

Port of the resident round of ``byzantine_aircomp_tpu/fed/train.py``
(``_iteration`` :605 with service, streaming and sharding off).  One global
iteration is

    flat_params [d] [--participants: m of K drawn-->]
      --per-client local SGD steps (FedAvg, FedProx, client momentum)-->
      weight stack [m, d] [--fault: dropout replay-->] --message attack-->
      [--fault: corruption, CSI error, deep-fade erasure-->]
      --OMA channel (not for gm, signmv)--> [--defense: score, detector,
      policy-->] [--bucket means-->] --aggregate (or the defense's rung)-->
      [--server optimizer-->] [d]

With a fault set the rule runs in its degraded mode, and a finite guard
keeps the previous params wherever the aggregate is not finite.

with per-client gradients taken with respect to the flat parameter vector
through ``torch.func`` (``functional_call`` + ``vmap(grad)``), so the
[K, d] stack is produced with no per-parameter Python plumbing.  The u8
train set stays on the device and is normalized after the gather.

Random draws: every iteration of every round has four streams, as the JAX
package splits its iteration key into (batch, channel, aggregation,
message), a fifth for the fault channel when a fault is set, and one each
for the participants' draw and the buckets' permutation when those are on;
here each is a ``torch.Generator`` seeded from ``(seed, round, iteration,
stream)``, with a fixed stream number per feature, so a run without a
feature draws what it drew before the feature was ported.
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

from .. import defense as defense_lib
from ..data import datasets as data_lib
from ..device import resolve_device
from ..ops import aggregators as agg_lib
from ..ops import attacks as attack_lib
from ..ops import channel as channel_lib
from ..ops import faults as fault_lib
from ..ops import flatten as flatten_lib
from ..registry import MODELS
from . import server_opt as server_opt_lib
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
    ``fault`` (stream 4), ``participation`` (5) and ``bucket`` (6) exist only
    when their feature is on, so a run without them draws what it drew
    before they were ported."""

    batch: torch.Generator
    channel: torch.Generator
    aggregation: torch.Generator
    message: torch.Generator
    fault: Optional[torch.Generator] = None
    participation: Optional[torch.Generator] = None
    bucket: Optional[torch.Generator] = None


#: the stream number of each optional generator
_OPTIONAL_STREAMS = (("fault", 4), ("participation", 5), ("bucket", 6))

# torch.profiler range around the clients' local steps (all E of them)
CLIENT_STEP_RANGE = "client_step"


# the record's paths of the fault counts (dropped, erased and corrupt rows,
# then the effective K: the finite rows aggregated), in the order of the
# JAX package's fault_metrics; the first three are summed over a round, the
# effective K is the round's minimum
FAULT_PATHS = ("faultDroppedPath", "faultErasedPath", "faultCorruptPath", "effectiveKPath")


def bucket_means(w_stack: torch.Tensor, perm: torch.Tensor, s: int) -> torch.Tensor:
    """[m/s, d] bucket means: bucket i holds the rows ``perm[i*s:(i+1)*s]``
    (JAX ``fed/train.py:950-972``, where row ``perm[j]`` goes to bucket
    ``j // s``).  The s gathered [m/s, d] slices are added in a fixed order,
    with no float atomics, so reruns give the same bits; a non-finite row
    poisons its own bucket only."""
    cols = perm.reshape(-1, s)
    total = torch.index_select(w_stack, 0, cols[:, 0])
    for j in range(1, s):
        total = total + torch.index_select(w_stack, 0, cols[:, j])
    return total / s


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
        # the online defense (None when off: no defense code runs)
        self.defense = defense_lib.from_config(cfg)
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

        # partial participation: m_h honest and m_b Byzantine clients drawn
        # every iteration (the Byzantine rows last); only the counts are
        # static, so the [m, d] stack keeps one shape
        self._part_h, self._part_b = cfg.participant_counts()
        if cfg.participation < 1.0:
            pmask = np.zeros(self._part_h + self._part_b, bool)
            if self._part_b:
                pmask[-self._part_b:] = True
            self._part_mask = torch.from_numpy(pmask).to(self.device)
        else:
            self._part_mask = self.byz_mask

        # delayed onset ("name@R"): the threshold in global iterations, and
        # the device counter of iterations run (None without an onset)
        self._attack_onset = None
        self.attack_iter: Optional[torch.Tensor] = None
        if self.attack is not None and self.attack.onset_round is not None:
            self._attack_onset = self.attack.onset_round * cfg.display_interval
            self.attack_iter = torch.zeros((), dtype=torch.int32, device=self.device)

        self._per_client_grad = vmap(grad(self._loss), in_dims=(None, 0, 0))
        # local steps past the first: every client carries its own params
        self._per_client_grad_own = vmap(grad(self._loss), in_dims=(0, 0, 0))
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

        # the server optimizer's state (fed/server_opt.py; None for "none"),
        # the [K, d] client momentum (None when off), and the defense's
        # (detector, policy) state (None when off), all carried across
        # rounds and checkpointed; the defense's [5] observations of the
        # last iteration and [6] round vector of the last round
        self.server_opt_state = server_opt_lib.init(cfg.server_opt, self.flat_params)
        self.client_m = (
            torch.zeros((cfg.node_size, self.dim), dtype=torch.float32, device=self.device)
            if cfg.client_momentum else None
        )
        self.defense_state = defense_lib.init_state(self.defense, cfg.node_size, self.device)
        self.iteration_defense_metrics: Optional[torch.Tensor] = None
        self.last_defense_metrics: Optional[torch.Tensor] = None

    # ------------------------------------------------------------------
    # one iteration

    def _loss(self, flat_params, x, y):
        params = flatten_lib.unflatten(flat_params, self.spec)
        logits = functional_call(self.model, params, (x,))
        return torch.mean(cross_entropy(logits, y))

    def _attacked_batch(self, x, y, is_byz):
        """The data-level attack on the Byzantine clients' batches."""
        attack = self.attack
        if attack is None or attack.data_fn is None:
            return x, y
        x_att, y_att = attack.apply_data(x, y, self.num_classes)
        x = torch.where(is_byz.reshape((-1,) + (1,) * (x.dim() - 1)), x_att, x)
        y = torch.where(is_byz.reshape((-1,) + (1,) * (y.dim() - 1)), y_att, y)
        return x, y

    def _grad_scale(self, g, is_byz):
        """The gradient-scale attack on the Byzantine clients' gradients."""
        attack = self.attack
        if attack is None or attack.grad_scale == 1.0:
            return g
        one = torch.ones((), dtype=g.dtype, device=g.device)
        return g * torch.where(is_byz, attack.grad_scale * one, one)[:, None]

    def client_stack(self, flat_params, x, y, is_byz) -> torch.Tensor:
        """[m, d] weights after each client's ``local_steps`` local SGD
        steps ``w <- w - gamma*(g + wd*w)`` (``:302-303``; JAX
        ``_per_client_weights``, ``fed/train.py:467-486``), each on its own
        batch: ``x`` is [m, B, ...] at one local step and [m, E, B, ...]
        above.  The data-level attack applies to the Byzantine clients'
        batches, a gradient-scale attack to their gradient at every step,
        then FedProx's ``mu*(w - w_round_start)``, then weight decay.  One
        local step without FedProx is the reference's FedSGD."""
        cfg = self.cfg
        x, y = self._attacked_batch(x, y, is_byz)
        if cfg.local_steps == 1:
            x, y = x[:, None], y[:, None]
        # the first step starts every client from the round's params [d];
        # from the second on each client carries its own row of [m, d]
        w = flat_params
        for e in range(cfg.local_steps):
            grad_fn = self._per_client_grad if e == 0 else self._per_client_grad_own
            g = self._grad_scale(grad_fn(w, x[:, e], y[:, e]), is_byz)
            if cfg.fedprox_mu:
                g = g + cfg.fedprox_mu * (w - flat_params)
            w = w - cfg.gamma * (g + cfg.weight_decay * w)
        return w

    def client_stack_momentum(self, flat_params, x, y, is_byz, m_prev):
        """Client momentum (JAX ``_per_client_momentum_step``,
        ``fed/train.py:488-502``; local_steps == 1): ``m <- beta*m +
        (1-beta)*(g*scale + wd*w)``, each client sends ``w - gamma*m``.
        Returns ``(weights [m, d], new momentum rows [m, d])``."""
        cfg = self.cfg
        x, y = self._attacked_batch(x, y, is_byz)
        g = self._grad_scale(self._per_client_grad(flat_params, x, y), is_byz)
        g = g + cfg.weight_decay * flat_params
        beta = cfg.client_momentum
        m_new = beta * m_prev + (1.0 - beta) * g
        return flat_params - cfg.gamma * m_new, m_new

    def draw_participants(self, generator) -> torch.Tensor:
        """[m] drawn client indices: ``m_h`` of the honest clients, then
        ``m_b`` of the Byzantine ones (JAX ``fed/train.py:658-672``)."""
        cfg = self.cfg
        part = torch.randperm(cfg.honest_size, generator=generator,
                              device=self.device)[: self._part_h]
        if self._part_b:
            byz = torch.randperm(cfg.byz_size, generator=generator,
                                 device=self.device)[: self._part_b]
            part = torch.cat([part, cfg.honest_size + byz])
        return part

    def _generator(self, round_idx: int, it: int, stream: int) -> torch.Generator:
        hi, lo = np.random.SeedSequence(
            [self.cfg.seed, round_idx, it, stream]
        ).generate_state(2)
        g = torch.Generator(device=self.device)
        g.manual_seed(((int(hi) << 32) | int(lo)) & (2**63 - 1))
        return g

    def iteration_generators(self, round_idx: int, it: int) -> IterationGenerators:
        cfg = self.cfg
        on = {"fault": self.fault is not None, "participation": cfg.participation < 1.0,
              "bucket": cfg.bucket_size > 1}
        return IterationGenerators(
            *(self._generator(round_idx, it, s) for s in range(4)),
            **{name: self._generator(round_idx, it, s)
               for name, s in _OPTIONAL_STREAMS if on[name]},
        )

    def iteration(
        self,
        flat_params: torch.Tensor,
        generators: Optional[IterationGenerators] = None,
        draws: Optional[dict] = None,
        want_variance: bool = False,
    ):
        """One global iteration: [participants] -> local steps -> [dropout]
        -> attack -> [corruption, CSI error, erasure] -> channel ->
        [defense] -> [buckets] -> agg -> [server optimizer].

        Returns ``(new flat params, honest variance or None)``.  ``draws``
        may supply any of: ``"u"`` [m, E*B] batch uniforms, ``"oma"`` the
        OMA link's terms (:class:`..ops.channel.OmaTerms`), ``"fades"``
        (h_r, h_i) [T, K] and ``"noise"`` [T, d+1] for gm's Weiszfeld
        steps, ``"vote_noise"`` [d] for signmv's receiver, ``"dnc"`` dnc's
        ``[(cols, v0)]`` per filtering round, ``"message"`` the gaussian
        attack's [B, d] normals, ``"fault"`` a dict of the
        fault channel's draws (``"dropped"`` for
        :func:`..ops.faults.apply_dropout`, the keys of
        :func:`..ops.faults.apply_transmission`), ``"part"`` the [m] drawn
        clients (:meth:`draw_participants`) and ``"bucket"`` the [m]
        permutation of :func:`bucket_means`; the rest comes from
        ``generators``.

        With a fault set, the carried ``fault_state`` advances, the rule
        runs degraded, every non-finite coordinate of the aggregate keeps
        its previous value, and ``iteration_fault_metrics`` holds this
        iteration's [4] counts (in the order of :data:`FAULT_PATHS`).  The
        carried ``client_m``, ``defense_state`` and ``server_opt_state``
        advance too, and with a defense ``iteration_defense_metrics`` holds
        this iteration's [5] observations (rung, flagged, suspicious, max
        score, max CUSUM).

        With ``--var`` set, median and trimmed_mean take the OMA terms as
        ``channel=`` and fold the corruption into their one read of the
        stack, except under a fault (their degraded modes take the received
        stack, as the JAX package's degraded rounds do), with buckets (the
        means are of received rows) and under the adaptive defense (every
        rung reads the same received stack, JAX ``fed/train.py:236-241``);
        the other rules (except gm and signmv, which own their channel) get
        the corrupted stack.  Either way the terms are the same draws, and
        the honest variance and the defense's scores are taken on the
        post-channel stack, as the reference takes the variance
        (``:351-352``, ``:360-361``).  Under ``--defense adaptive`` the rung
        is read on the host once per iteration to call its aggregator
        (:func:`..defense.policy.aggregate_rung`), the one host sync the
        defense adds."""
        cfg = self.cfg
        draws = draws or {}
        gens = generators or IterationGenerators(None, None, None, None)
        fault = self.fault
        fault_draws = draws.get("fault") or {}
        spec = self.defense
        m_h, m_b = self._part_h, self._part_b

        part, offsets, sizes = None, self.offsets, self.sizes
        if cfg.participation < 1.0:
            part = draws.get("part")
            if part is None:
                part = self.draw_participants(gens.participation)
            offsets, sizes = self.offsets[part], self.sizes[part]
        # the [m, E*B] indices in one draw: at E = 1 the stream of the
        # single-step trainer
        steps = cfg.local_steps
        idx = data_lib.sample_client_batch_indices(
            offsets, sizes, steps * cfg.batch_size,
            generator=gens.batch, u=draws.get("u"),
        )
        x = self.x_train[idx]  # [m, E*B, features] on-device gather
        if self._norm_scale is not None:
            x = x.to(torch.float32) * self._norm_scale + self._norm_bias
        y = self.y_train[idx]
        if steps > 1:
            batch = (idx.shape[0], steps, cfg.batch_size)
            x, y = x.reshape(batch + self._sample_shape), y.reshape(batch)
        else:
            x = x.reshape(x.shape[:2] + self._sample_shape)
        # one device bool gates every Byzantine behavior until the onset
        is_byz, attack_on = self._part_mask, None
        if self._attack_onset is not None:
            attack_on = self.attack_iter >= self._attack_onset
            is_byz = is_byz & attack_on
        with torch.profiler.record_function(CLIENT_STEP_RANGE):
            if self.client_m is not None:
                m_prev = self.client_m if part is None else self.client_m[part]
                w_stack, m_rows = self.client_stack_momentum(flat_params, x, y, is_byz,
                                                             m_prev)
                # the drawn rows written back (distinct indices: no accumulation)
                self.client_m = (m_rows if part is None
                                 else self.client_m.index_put((part,), m_rows))
            else:
                w_stack = self.client_stack(flat_params, x, y, is_byz)

        if fault is not None:
            # before the attack: the buffer keeps what the clients sent
            stale, ge_bad = self.fault_state
            w_stack, stale, n_dropped = fault_lib.apply_dropout(
                fault, w_stack, stale, generator=gens.fault,
                dropped=fault_draws.get("dropped"),
            )
        if self.attack is not None:
            view = None
            if self.attack.defense_aware:
                # the detector state published after the previous iteration
                (step, ema, dev, cusum), pol = self.defense_state
                view = attack_lib.DefenseView(
                    step=step, ema=ema, dev=dev, cusum=cusum, rung=pol[0],
                    detector=spec.detector, policy=spec.policy, guess=flat_params,
                )
            w_att = self.attack.apply_message(
                w_stack, m_b, gens.message, param=cfg.attack_param,
                noise=draws.get("message"), defense=view,
            )
            w_stack = w_att if attack_on is None else torch.where(attack_on, w_att, w_stack)
        if fault is not None:
            # after it: corruption and the channel's faults hit every row
            w_stack, ge_bad, n_erased, n_corrupt = fault_lib.apply_transmission(
                fault, w_stack, ge_bad, generator=gens.fault, draws=fault_draws,
            )
            self.fault_state = fault_lib.FaultState(stale, ge_bad)
        adaptive = spec is not None and spec.mode == "adaptive"
        terms = None
        if cfg.noise_var is not None and agg_lib.needs_oma_prepass(cfg.agg):
            terms = draws.get("oma")
            if terms is None:
                k, d = w_stack.shape
                terms = channel_lib.oma_terms(
                    k, d, cfg.noise_var, generator=gens.channel,
                    device=w_stack.device,
                )
            if (fault is not None or not agg_lib.supports_fused_epilogue(cfg.agg)
                    or cfg.bucket_size > 1 or adaptive):
                w_stack = channel_lib.oma(w_stack, cfg.noise_var, terms=terms)
                terms = None

        rung = None
        if spec is not None:
            # the scores read the received stack: under monitor with the
            # channel folded into the rule's read, its received rows (bitwise
            # those of channel.oma) are made for the scores alone
            seen = w_stack if terms is None else channel_lib.oma(
                w_stack, cfg.noise_var, terms=terms)
            det, pol = self.defense_state
            score, finite, _ = defense_lib.client_score_components(seen, flat_params)
            det, flags = defense_lib.detector_update(det, score, finite, spec.detector)
            n_flagged = torch.sum(flags)
            pol, suspicious = defense_lib.policy_update(pol, n_flagged, spec.policy)
            rung = pol[0]
            self.defense_state = (det, pol)
            self.iteration_defense_metrics = torch.stack([
                rung.to(torch.float32), n_flagged.to(torch.float32),
                suspicious.to(torch.float32), torch.max(score), torch.max(det[3]),
            ])
            del seen

        agg_honest, w_agg = m_h, w_stack
        if cfg.bucket_size > 1:
            # the worst case: every Byzantine row in a bucket of its own
            m, s = m_h + m_b, cfg.bucket_size
            perm = draws.get("bucket")
            if perm is None:
                perm = torch.randperm(m, generator=gens.bucket, device=self.device)
            w_agg = bucket_means(w_stack, perm, s)
            agg_honest = m // s - m_b

        agg_kw = dict(
            guess=flat_params,
            honest_size=agg_honest,
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
        )
        if adaptive:
            # rung 0 is cfg.agg, so a quiet run aggregates as --defense off
            aggregated = defense_lib.aggregate_rung(rung, spec.ladder, w_agg, **agg_kw)
        else:
            # reference semantics (:354-358)
            aggregated = self.agg_fn(w_agg, **agg_kw).to(torch.float32)
        if fault is not None:
            # the receiver's finite guard: a coordinate that no finite row
            # reached keeps its previous value
            aggregated = torch.where(torch.isfinite(aggregated), aggregated, flat_params)
            eff_k = torch.sum(agg_lib._finite_rows(w_stack)).to(torch.float32)
            self.iteration_fault_metrics = torch.stack([n_dropped, n_erased, n_corrupt, eff_k])
        new_flat = aggregated
        if self.server_opt_state is not None:
            # FedOpt: the aggregate defines the pseudo-gradient
            new_flat, self.server_opt_state = server_opt_lib.step(
                cfg.server_opt, flat_params, aggregated, self.server_opt_state,
                cfg.server_lr, cfg.server_momentum,
            )
        variance = None
        if want_variance:
            w_h = w_stack[:m_h]
            if terms is not None:
                # the received honest rows, bitwise those channel.oma makes
                w_h = w_h + channel_lib.oma_residual(
                    channel_lib.OmaTerms(*(t[:m_h] for t in terms))
                )
            variance = honest_variance(w_h, m_h)
        if self.attack_iter is not None:
            self.attack_iter = self.attack_iter + 1
        return new_flat, variance

    def run_round(self, round_idx: int) -> torch.Tensor:
        """``display_interval`` iterations; returns the honest dispersion of
        the last iteration's stack (reference ``:360-361``) as a device
        scalar, without a host sync.  With a fault set,
        ``last_fault_metrics`` becomes the round's counts: dropped, erased
        and corrupt rows summed over its iterations, the effective K at its
        minimum (device tensors too).  With a defense,
        ``last_defense_metrics`` becomes the round's [6] vector
        (:func:`..defense.events.reduce_round`)."""
        interval = self.cfg.display_interval
        variance = None
        counts, observed = [], []
        rung_in = self.defense_state[1][0] if self.defense is not None else None
        for it in range(interval):
            self.flat_params, variance = self.iteration(
                self.flat_params,
                self.iteration_generators(round_idx, it),
                want_variance=it == interval - 1,
            )
            if self.fault is not None:
                counts.append(self.iteration_fault_metrics)
            if self.defense is not None:
                observed.append(self.iteration_defense_metrics)
        if counts:
            per_it = torch.stack(counts)
            self.last_fault_metrics = torch.cat(
                [torch.sum(per_it[:, :3], dim=0), torch.amin(per_it[:, 3:], dim=0)]
            )
        if observed:
            self.last_defense_metrics = defense_lib.events.reduce_round(rung_in, observed)
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
        if self.defense is not None:
            for key in defense_lib.events.PATH_KEYS.values():
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
            if self.defense is not None:
                events = defense_lib.events
                dm = events.round_metrics(self.last_defense_metrics)
                for key, path_key in events.PATH_KEYS.items():
                    paths[path_key].append(dm[key])
                agg_name = events.active_agg(self.defense.mode, self.defense.ladder,
                                             int(dm["rung"]), cfg.agg)
                fault_str += f" rung={int(dm['rung'])}({agg_name}) flag={dm['flagged']:.0f}"
            log(
                f"[{r + 1}/{cfg.rounds}](interval: {cfg.display_interval}) "
                f"train: loss={tr_loss:.4f} acc={tr_acc:.4f} "
                f"val: loss={va_loss:.4f} acc={va_acc:.4f}{var_str}{fault_str}"
            )
            if checkpoint_fn is not None:
                checkpoint_fn(r + 1, self, paths)
        return paths
