"""The multi-GPU federated trainer (JAX ``parallel/sharded.py``).

``ShardedFedTrainer`` runs the base trainer's iteration over a (clients,
model) grid of ranks (:mod:`.mesh`), one process per card:

* every rank makes the same draws (participants, batch indices, channel
  terms, the attack's and the rule's), at the single-device sizes, and
  takes its own rows; it runs the client step on its clients' batches
  only, so no rank gathers the client batch or another rank's rows of it;
* the [K, d] stack stays split: the rank's rows, and with ``model_parallel``
  > 1 its columns (the client step is replicated over the model axis, as
  JAX's ``shard_map`` pin replicates it);
* the carries follow the stack's layout: the client momentum and the
  fault's stale-replay buffer hold the rank's rows (under partial
  participation the momentum stays whole, its drawn rows written back on
  every rank); the defense's, service's and attack's counters, the GE
  states and the server optimizer's state are replicated.  A checkpoint
  gathers the rows and a resume takes its own
  (:meth:`checkpoint_carries`);
* the aggregation runs its collective form (:mod:`.collective`): ``mean``
  (one all_reduce), ``gm2`` (the ``weiszfeld_step`` kernel's num/den mode on
  the rank's rows, then one all_reduce a step), ``gm`` (the
  ``aircomp_weiszfeld_step`` kernel likewise), ``krum``, ``multi_krum`` and
  ``bulyan`` (the ring of Krum scores, ``batch_isend_irecv``) and the sign
  vote of ``signmv``/``bev`` at one bit (the ``packed_vote_counts`` kernel
  on the rank's word rows, then an all_reduce, :func:`.popmesh.
  sharded_packed_vote_counts`) or at 32 bits with a fixed ``sign_eta``;
* the result's columns are gathered over the model axis, and the server
  step, the params, eval and every counter run replicated.

A configuration with a stage that has no collective form in the JAX package
gathers the stack across the clients axis (``all_gather``) right after the
client step and runs the single-device stages from there on, as GSPMD
gathers an operand it has no partitioning rule for.  This is a layout, not
a fallback; the banner's ``[layout]`` line names the stage.  The stages that
gather:

* the rules ``median``, ``trimmed_mean``, ``cclip``, ``dnc``, and
  ``signmv``/``bev`` at 8 or 16 bits or with the adaptive eta (a
  coordinatewise median over all rows);
* the fault channel past its straggler replay (corruption, CSI error,
  erasure, and the degraded rules), the online defense (its scores and
  detector), service rounds, bucket means, the omniscient and the
  defense-aware attacks (they read the honest rows);
* cohort-streamed rounds: each chunk's client step is split over the
  clients axis and the chunk gathered (the chunk, not K, must divide).

A gathering configuration still runs the client step and the straggler
replay on the rank's rows, with its carries by rows; it gathers the stack
right after them.

Unlike the JAX package, which forces its XLA realization here because GSPMD
cannot partition a ``pallas_call`` (``parallel/sharded.py:74-80``), each rank
keeps ``agg_impl`` ``pallas`` on its own rows: the kernels compute the same
function.  The fused epilogue is off with more than one rank, as in JAX
(:81-89), and the dispatch runs eagerly (the collectives and the Weiszfeld
stopping test are not captured in a CUDA graph).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..data import datasets as data_lib
from ..fed.config import FedConfig
from ..fed.train import Trainer
from ..ops import aggregators as agg_lib
from ..ops import attacks as attack_lib
from ..ops import channel as channel_lib
from . import collective
from . import mesh as mesh_lib
from .mesh import CLIENT_AXIS, MODEL_AXIS
from .popmesh import sharded_packed_vote_counts


def check_layout(cfg: FedConfig, n_clients_axis: int) -> None:
    """The JAX package's divisibility checks (``parallel/sharded.py:
    34-71``): every stack the clients axis splits must divide evenly."""
    axis = mesh_lib.CLIENT_AXIS
    if cfg.node_size % n_clients_axis:
        raise ValueError(
            f"node_size {cfg.node_size} must be divisible by the "
            f"'{axis}' mesh axis ({n_clients_axis})")
    if cfg.participation < 1.0:
        m = sum(cfg.participant_counts())
        if m % n_clients_axis:
            raise ValueError(
                f"participation {cfg.participation} gives a {m}-row stack, not "
                f"divisible by the '{axis}' mesh axis ({n_clients_axis}); pick a "
                "fraction whose participant count divides the mesh")
    if cfg.bucket_size > 1:
        n_buckets = sum(cfg.participant_counts()) // cfg.bucket_size
        if n_buckets % n_clients_axis:
            raise ValueError(
                f"bucket_size {cfg.bucket_size} leaves {n_buckets} buckets, not "
                f"divisible by the '{axis}' mesh axis ({n_clients_axis})")
    if cfg.cohort_size > 0 and cfg.cohort_size % n_clients_axis:
        raise ValueError(
            f"cohort_size {cfg.cohort_size} is not divisible by the '{axis}' mesh "
            f"axis ({n_clients_axis}); streamed chunks are sharded over that axis")


class ShardedFedTrainer(Trainer):
    """The base trainer's iteration over the grid of ranks ``mesh`` (the
    process group's, :func:`.mesh.make_mesh`, by default).  Every rank of
    the group builds one, with the same config and seed.  One iteration
    body serves both paths: the split path overrides its hooks
    (:meth:`_whole_stack`, :meth:`_attack_stage`, :meth:`_held_terms`,
    :meth:`_aggregate`, :meth:`_variance`) to run on the rank's block; the
    gathering path gathers in :meth:`_whole_stack` and keeps the others."""

    def __init__(self, cfg: FedConfig, dataset: Optional[data_lib.Dataset] = None,
                 device: str = "cuda", params: Optional[torch.Tensor] = None,
                 mesh: Optional[mesh_lib.RankGrid] = None):
        self.mesh = mesh if mesh is not None else mesh_lib.make_mesh(cfg.model_parallel)
        check_layout(cfg, self.mesh.n_clients)
        super().__init__(cfg, dataset=dataset, device=device, params=params, graphs=False)
        self.dispatch_graph = (
            False, "the sharded layout runs its collectives and the Weiszfeld stopping "
                   "test eagerly")
        if self.mesh.size > 1:
            # (JAX :81-89) the channel is applied to the stack, never folded
            self._fused_epilogue = False
            self.channel_fused = False
        # the carries by rows (faults need full participation, so the stale
        # buffer's rows are always the stack's)
        rows = self.mesh.row_block(cfg.node_size)
        self._m_by_rows = self.client_m is not None and cfg.participation == 1.0
        if self._m_by_rows:
            self.client_m = self.client_m[rows].clone()
        if self.fault_state is not None and self.fault_state.stale is not None:
            self.fault_state = self.fault_state._replace(
                stale=self.fault_state.stale[rows].clone())
        self._collective = self._collective_rule()
        self.gathers = self._gather_reason()
        stages = "the stack is gathered after the client step: " + self.gathers \
            if self.gathers else f"{cfg.agg} by its collective form, the stack kept split"
        self.layout_desc = (
            f"sharded over the ranks {self.mesh.describe()}; {stages}")

    # -- which path -----------------------------------------------------------

    def _collective_rule(self):
        """``fn(block, **agg_kw) -> the rank's columns`` of the rule's
        collective form, or None when it has none."""
        cfg, grid, fn = self.cfg, self.mesh, self.agg_fn
        d = self.dim
        cols = grid.col_block(d)
        m = self._part_h + self._part_b
        if fn is agg_lib.mean:
            return lambda w, **_: collective.sharded_mean(grid, w, m)
        if fn is agg_lib.gm2:
            return lambda w, *, guess, maxiter, tol, **_: collective.sharded_gm2(
                grid, w, guess=guess[cols], maxiter=maxiter, tol=tol)[0]
        if fn is agg_lib.gm:
            return lambda w, *, guess, maxiter, tol, noise_var, p_max, generator, **_: (
                collective.sharded_gm(grid, w, d=d, noise_var=noise_var, guess=guess[cols],
                                      maxiter=maxiter, tol=tol, p_max=p_max,
                                      generator=generator)[0])
        ring = {agg_lib.krum: collective.ring_krum, agg_lib.multi_krum:
                collective.ring_multi_krum, agg_lib.bulyan: collective.ring_bulyan}
        if fn in ring:
            return functools.partial(ring[fn], grid, d=d)
        if fn in (agg_lib.sign_majority_vote, agg_lib.best_effort_voting) and (
                cfg.sign_bits == 1 or (cfg.sign_bits == 32 and cfg.sign_eta is not None)):
            return functools.partial(self._sign_vote, fn is agg_lib.sign_majority_vote)
        return None

    def _gather_reason(self) -> Optional[str]:
        """Why this configuration gathers the stack, or None when every
        stage keeps it split."""
        cfg, attack = self.cfg, self.attack
        if self._collective is None:
            return f"the rule {cfg.agg!r} (at these knobs) has no collective form"
        for on, stage in (
            (cfg.cohort_size > 0, "cohort streaming (each chunk's rows)"),
            (self.fault is not None, "the fault channel"),
            (self.defense is not None, "the defense's scores and detector"),
            (cfg.service == "on", "service rounds"),
            (cfg.bucket_size > 1, "bucket means"),
            (attack is not None and attack.message_fn is not None
             and (attack.omniscient or attack.defense_aware),
             f"the attack {cfg.attack!r} (it reads the honest rows)"),
        ):
            if on:
                return stage
        return None

    # -- the rows' stages and the carries --------------------------------------

    def _client_stage(self, flat_params, idx, is_byz, part):
        """This rank's clients only: their batches, their local steps, their
        momentum rows."""
        rows = self.mesh.row_block(idx.shape[0])
        x, y = self._batches(idx[rows])
        is_byz = is_byz[rows]
        if self.client_m is None:
            return Trainer.client_stack(self, flat_params, x, y, is_byz)
        if self._m_by_rows:
            w, self.client_m = Trainer.client_stack_momentum(self, flat_params, x, y, is_byz,
                                                             self.client_m)
            return w
        w, m_rows = Trainer.client_stack_momentum(self, flat_params, x, y, is_byz,
                                                  self.client_m[part][rows])
        self.client_m = self.client_m.index_put((part,), self.mesh.gather_rows(m_rows))
        return w

    def _dropout_stage(self, w_rows, gens, fault_draws):
        """The straggler replay on this rank's rows and stale rows; the [K]
        dropped mask is drawn whole on every rank (the one-device draw) and
        the count all-reduced."""
        if not self.fault.needs_stale:
            return super()._dropout_stage(w_rows, gens, fault_draws)
        k = w_rows.shape[0] * self.mesh.n_clients
        dropped = fault_draws.get("dropped")
        if dropped is None:
            dropped = torch.rand(k, generator=gens.fault,
                                 device=w_rows.device) < self.fault.dropout_prob
        rows = self.mesh.row_block(k)
        w_rows, n_dropped = super()._dropout_stage(w_rows, gens, dict(
            fault_draws, dropped=dropped[rows]))
        return w_rows, self.mesh.all_reduce(n_dropped, CLIENT_AXIS)

    def _whole_stack(self, w_rows):
        """The gathering path's stack: every rank's rows, in rank order; the
        split path's: the rank's block (its rows, and its columns over a
        model axis)."""
        if self.gathers:
            return self.mesh.gather_rows(w_rows)
        if self.mesh.n_model > 1:
            return w_rows[:, self.mesh.col_block(self.dim)].contiguous()
        return w_rows

    def _attack_stage(self, w_stack, gens, draws, view):
        """The split path's message attack on the rank's block: the
        Byzantine rows are the stack's last ``m_b``, so the block's are its
        last rows; the gaussian attack's [m_b, d] normals are drawn whole, as
        one device draws them, and the block's taken."""
        if self.gathers:
            return super()._attack_stage(w_stack, gens, draws, view)
        attack, grid = self.attack, self.mesh
        m_b, m, d = self._part_b, self._part_h + self._part_b, self.dim
        rows, cols = grid.row_block(m), grid.col_block(d)
        noise = draws.get("message")
        if noise is None and attack.message_fn is attack_lib._gaussian_message:
            noise = torch.randn((m_b, d), generator=gens.message, device=w_stack.device,
                                dtype=w_stack.dtype)
        b_lo = max(rows.start, m - m_b)
        if noise is not None:
            noise = noise[b_lo - (m - m_b):rows.stop - (m - m_b), cols]
        return attack.apply_message(w_stack, max(rows.stop - b_lo, 0), gens.message,
                                    param=self.cfg.attack_param, noise=noise)

    def _held_terms(self, terms):
        """The split path's OMA terms: the block's rows and columns of the
        whole draw."""
        if self.gathers:
            return terms
        rows = self.mesh.row_block(self._part_h + self._part_b)
        cols = self.mesh.col_block(self.dim)
        return channel_lib.OmaTerms(terms.h_r[rows], terms.h_i[rows], terms.h_sq[rows],
                                    terms.n_r[rows][:, cols], terms.n_i[rows][:, cols])

    def _aggregate(self, w_agg, agg_kw):
        """The split path's rule: its collective form on the block, the
        result's columns gathered over the model axis."""
        if self.gathers:
            return super()._aggregate(w_agg, agg_kw)
        cols = self._collective(w_agg, **agg_kw).to(torch.float32)
        return self.mesh.gather_cols(cols, self.dim)

    def _variance(self, w_stack, m_h, terms, service):
        """The split path's honest dispersion: the honest rows come first,
        so the block's are its first rows; sums all-reduced over the grid."""
        if self.gathers:
            return super()._variance(w_stack, m_h, terms, service)
        grid = self.mesh
        rows = grid.row_block(self._part_h + self._part_b)
        w_h = w_stack[:max(min(rows.stop, m_h) - rows.start, 0)].to(torch.float32)
        mean_h = grid.all_reduce(torch.sum(w_h, dim=0), CLIENT_AXIS) / m_h
        sq = grid.all_reduce(torch.sum((w_h - mean_h[None, :]) ** 2), CLIENT_AXIS)
        return grid.all_reduce(sq, MODEL_AXIS) / m_h

    def client_stack(self, flat_params, x, y, is_byz):
        """A streamed chunk's client step (``make_rebuild``): this rank's rows
        of the chunk, then the chunk gathered over the clients axis."""
        rows = self.mesh.row_block(x.shape[0])
        w = super().client_stack(flat_params, x[rows], y[rows], is_byz[rows])
        return self.mesh.gather_rows(w)

    def checkpoint_carries(self):
        """The carries whole: the momentum's and stale buffer's rows
        gathered (every rank calls this, a checkpoint being collective)."""
        client_m, fault_state = self.client_m, self.fault_state
        if self._m_by_rows:
            client_m = self.mesh.gather_rows(client_m)
        if fault_state is not None and fault_state.stale is not None:
            fault_state = fault_state._replace(stale=self.mesh.gather_rows(fault_state.stale))
        return client_m, fault_state

    def restore_carries(self, client_m, fault_state):
        """Take this rank's rows of whole carries read from a checkpoint."""
        rows = self.mesh.row_block(self.cfg.node_size)
        if self._m_by_rows:
            client_m = client_m[rows].contiguous()
        if fault_state is not None and fault_state.stale is not None:
            fault_state = fault_state._replace(stale=fault_state.stale[rows].contiguous())
        self.client_m, self.fault_state = client_m, fault_state

    # -- the split path --------------------------------------------------------

    def _sign_vote(self, is_signmv, w, *, guess, noise_var=None, sign_eta=None,
                   sign_bits=32, generator=None, vote_noise=None, **_):
        """signmv/bev on the split stack: at one bit the rank packs its rows'
        ballots (rows non-finite in any block cast none) and the popcount
        kernel counts them, then one all_reduce of the integer counts; at 32
        bits with a fixed eta the partial vote sums are all-reduced."""
        grid, d = self.mesh, self.dim
        cols = grid.col_block(d)
        g = guess[cols].to(torch.float32)
        noise = torch.zeros_like(g)
        if is_signmv and noise_var is not None:
            z = (torch.randn(d, generator=generator, device=g.device)
                 if vote_noise is None else vote_noise)
            noise = torch.sqrt(torch.tensor(noise_var, dtype=torch.float32,
                                             device=g.device) / 2.0) * z[cols]
        eta = torch.tensor(sign_eta, dtype=torch.float32, device=g.device)
        if sign_bits == 1:
            finite = collective._global_finite(grid, w)
            words, k_valid = agg_lib.pack_signs(
                torch.where(finite[:, None], w, torch.nan), g)
            counts = sharded_packed_vote_counts(words, g.shape[0], grid.group(CLIENT_AXIS))
            k_valid = grid.all_reduce(k_valid, CLIENT_AXIS)
            votes = (2 * counts - k_valid).to(torch.float32) + noise
        else:
            delta = w.to(torch.float32) - g[None, :]
            part = torch.sum(torch.where(torch.isfinite(delta), torch.sign(delta), 0.0), dim=0)
            votes = grid.all_reduce(part, CLIENT_AXIS) + noise
        return g + eta * torch.sign(votes)
