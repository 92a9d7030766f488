"""The process-group engine of population shards (JAX
``parallel/popmesh.py``).

``ops/shardctx.py`` defines the merge algebra and the two one-process
engines; this module gives the third: :class:`MeshShardCtx`, over a process
group of S ranks, each passing over its own chunk range ``[p*cpp,
(p+1)*cpp)`` of a streamed round, the partial carries merged by their tags:

* integer ``"sum"`` leaves by ``all_reduce SUM`` (integer addition is
  exact in any order, so this is the sequential fold: the bisection's rank
  counts, the sketch histograms, finite and flag counts);
* ``"min"`` / ``"max"`` by ``all_reduce MIN`` / ``MAX``;
* float ``"sum"`` leaves by one ``all_gather`` in rank order, then the
  sequential engine's own left fold (``shardctx.fold_leaves``), so the
  result is bitwise :class:`..ops.shardctx.SeqShardCtx`'s at the same S by
  construction;
* ``"stack"`` leaves by one ``all_gather``, stacked in rank order.

The merged values are the same on every rank, so everything after a merge
(the bisection's guesses, the gm2 loop's steps and its stopping test, the
defense policy) runs alike on every rank and the next collectives stay
aligned.  Everything outside the chunk passes (the service draw and churn,
the round's draws, the server update, eval) runs replicated: every rank
draws the same numbers.

``sharded_packed_vote_counts`` is the one-bit vote's reduce with the [K, W]
sign-word rows split over ranks: the ``packed_vote_counts`` kernel on each
rank's rows, then one ``all_reduce``.  The counts are integers, so the
result is bitwise the one-device count for any row placement.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..ops import kernels
from ..ops import shardctx
from ..fed.train import Trainer


def make_pop_mesh(n_shards: int):
    """The process group of population shards: the whole group, whose world
    size must be ``n_shards`` (one shard per rank).  Returns ``None``, the
    default group, for the collectives."""
    if n_shards < 2:
        raise ValueError(f"a population mesh wants >= 2 shards, got {n_shards}")
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if world != n_shards:
        raise ValueError(
            f"pop_shards={n_shards} runs one shard per rank and needs a process group "
            f"of {n_shards} ranks, have {world} (start one process per card with "
            "--multihost, or use the sequential engine with --sharding off)")
    return None


def _is_int_leaf(x: torch.Tensor) -> bool:
    return not (torch.is_floating_point(x) or torch.is_complex(x))


class MeshShardCtx:
    """The collective population-shard engine of one rank of the group."""

    def __init__(self, n_shards: int, group=None):
        if n_shards < 2:
            raise ValueError("MeshShardCtx wants n_shards >= 2; use LOCAL")
        self.n_shards = n_shards
        self.group = group
        self.rank = dist.get_rank(group)

    def _gather(self, part: torch.Tensor):
        """Every rank's ``part`` in rank order (bools ride as uint8)."""
        is_bool = part.dtype == torch.bool
        x = part.to(torch.uint8) if is_bool else part
        flat = x.reshape(-1).contiguous()
        out = [torch.empty_like(flat) for _ in range(self.n_shards)]
        dist.all_gather(out, flat, group=self.group)
        out = [o.reshape(part.shape) for o in out]
        return [o.to(torch.bool) for o in out] if is_bool else out

    def _merge_leaf(self, tag, part):
        if tag in ("min", "max") or (tag == "sum" and _is_int_leaf(part)
                                     and part.dtype != torch.bool):
            op = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
                  "max": dist.ReduceOp.MAX}[tag]
            out = part.clone()
            dist.all_reduce(out, op=op, group=self.group)
            return out
        parts = self._gather(part)
        if tag == "stack":
            return torch.stack(parts)
        # float sums: the sequential engine's own fold, for its bits
        return shardctx.fold_leaves(parts, tag, self.n_shards)

    def scan_idx_merge(self, n_chunks: int, body, init, spec):
        cpp = shardctx._check_split(n_chunks, self.n_shards)
        carry = init
        for c in range(self.rank * cpp, (self.rank + 1) * cpp):
            carry = body(carry, c)
        return shardctx.merge_spec_tree(spec, carry, self.n_shards, self._merge_leaf)

    def scan_merge(self, rebuild, n_chunks: int, body, init, spec):
        return self.scan_idx_merge(
            n_chunks, lambda carry, c: body(carry, rebuild(c), c), init, spec)


def sharded_packed_vote_counts(words: torch.Tensor, d: int, group=None) -> torch.Tensor:
    """The packed sign vote's per-coordinate counts [d] int32 of the
    group's word rows: this rank's rows ``words`` [K/P, W] through the
    ``packed_vote_counts`` kernel, then one ``all_reduce`` over ``group``
    (None: the default group; no group: this rank's counts)."""
    counts = kernels.packed_vote_counts(words.contiguous(), d)
    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(counts, group=group)
    return counts


class PopShardedFedTrainer(Trainer):
    """A :class:`..fed.train.Trainer` whose streamed chunk passes run over
    a process group of ``pop_shards`` ranks (``--pop-shards``, one rank per
    card): every rank builds the same trainer, runs the same replicated
    draws, and passes over its own chunks (:class:`MeshShardCtx`).  Each
    rank holds one cohort chunk's rebuild plus the replicated state, the
    per-host budget ``obs/hbm.py`` models."""

    def __init__(self, cfg, dataset=None, device: str = "cuda",
                 params: Optional[torch.Tensor] = None):
        if cfg.pop_shards < 2:
            raise ValueError(
                "PopShardedFedTrainer wants pop_shards >= 2 (use Trainer for the single "
                "loop and the sequential engine)")
        self.pop_group = make_pop_mesh(cfg.pop_shards)
        super().__init__(cfg, dataset=dataset, device=device, params=params)
        self.layout_desc = (f"population shards over {cfg.pop_shards} ranks, one chunk "
                            "range each, merged by collectives")

    def _make_pop_ctx(self):
        return MeshShardCtx(self.cfg.pop_shards, self.pop_group)
