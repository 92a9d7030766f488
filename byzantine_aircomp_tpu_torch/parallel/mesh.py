"""The (clients, model) grid of ranks (JAX ``parallel/mesh.py``).

The scaling axes of this workload: **clients** (K, the reference's
sequential Python loop, here split over ranks) and **model** (d, the flat
parameter dimension, split for large models so that the [K, d] client stack
fits on the cards; K=1000 x ResNet-18 is ~44 GB in f32).  A process group
of ``n`` ranks is laid out as an ``(n // model_parallel, model_parallel)``
grid, rank ``c * n_model + m`` at row ``c``, column ``m``, as JAX reshapes
its device list.  Each axis has its own subgroups (``dist.new_group``): the
ranks of one grid column share the model block and sum over clients, the
ranks of one grid row share the client block and sum over the model axis.

A rank holds the rows :meth:`RankGrid.row_block` of the [K, d] stack and
the columns :meth:`RankGrid.col_block` of [d].  Column blocks are cut at
multiples of 32, so that a block of sign words (``ops.aggregators.
pack_signs``) never straddles two ranks.  With no process group the grid is
one rank and every collective is the identity.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

CLIENT_AXIS = "clients"
MODEL_AXIS = "model"

#: the unit column blocks are cut at (one sign word)
COL_UNIT = 32


def factor_devices(n: int, model_parallel: Optional[int] = None) -> Tuple[int, int]:
    """Split n ranks into (clients, model) axis sizes: all-client by default
    (model axis 1); an explicit ``model_parallel`` must divide n."""
    if model_parallel is None:
        return n, 1
    if n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} must divide {n} devices")
    return n // model_parallel, model_parallel


def _block(n: int, parts: int, idx: int, unit: int = 1) -> Tuple[int, int]:
    """``[lo, hi)`` of block ``idx`` when ``n`` items split into ``parts``
    blocks of whole units, the first blocks one unit larger."""
    units = -(-n // unit)
    base, extra = divmod(units, parts)
    lo = idx * base + min(idx, extra)
    hi = lo + base + (1 if idx < extra else 0)
    return min(lo * unit, n), min(hi * unit, n)


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


class RankGrid:
    """This process's place in the (clients, model) grid, its two axis
    groups and the collectives over them."""

    def __init__(self, model_parallel: Optional[int] = None):
        self.distributed = _initialized()
        world = dist.get_world_size() if self.distributed else 1
        self.rank = dist.get_rank() if self.distributed else 0
        self.n_clients, self.n_model = factor_devices(world, model_parallel)
        self.shape = {CLIENT_AXIS: self.n_clients, MODEL_AXIS: self.n_model}
        self.size = world
        self.client_index, self.model_index = divmod(self.rank, self.n_model)
        self._groups = {CLIENT_AXIS: None, MODEL_AXIS: None}
        self._ranks = {CLIENT_AXIS: [self.rank], MODEL_AXIS: [self.rank]}
        if not self.distributed:
            return
        # every rank creates every subgroup, in one order
        for m in range(self.n_model):
            ranks = [c * self.n_model + m for c in range(self.n_clients)]
            g = dist.new_group(ranks)
            if m == self.model_index:
                self._groups[CLIENT_AXIS], self._ranks[CLIENT_AXIS] = g, ranks
        for c in range(self.n_clients):
            ranks = [c * self.n_model + m for m in range(self.n_model)]
            g = dist.new_group(ranks)
            if c == self.client_index:
                self._groups[MODEL_AXIS], self._ranks[MODEL_AXIS] = g, ranks

    # -- blocks ------------------------------------------------------------

    def row_block(self, k: int) -> slice:
        """This rank's rows of a [K, ...] client axis (K divides evenly)."""
        if k % self.n_clients:
            raise ValueError(f"K={k} not divisible by the clients axis ({self.n_clients})")
        per = k // self.n_clients
        return slice(self.client_index * per, (self.client_index + 1) * per)

    def col_bounds(self, d: int, m: Optional[int] = None) -> Tuple[int, int]:
        return _block(d, self.n_model, self.model_index if m is None else m, COL_UNIT)

    def col_block(self, d: int) -> slice:
        """This rank's columns of a [d] model axis (whole sign words)."""
        return slice(*self.col_bounds(d))

    def ring_peers(self) -> Tuple[int, int]:
        """(next, previous) global ranks along the clients axis."""
        ranks = self._ranks[CLIENT_AXIS]
        i = ranks.index(self.rank)
        return ranks[(i + 1) % len(ranks)], ranks[(i - 1) % len(ranks)]

    # -- collectives ---------------------------------------------------------

    def group(self, axis: str):
        """The process subgroup of ``axis`` that holds this rank (None
        without a process group)."""
        return self._groups[axis]

    def all_reduce(self, t: torch.Tensor, axis: str,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` reduced over ``axis`` (in place; returns it).  A model axis
        of one rank is the identity (whole rows: nothing to complete); the
        clients axis always reduces through the group."""
        if self.distributed and not (axis == MODEL_AXIS and self.n_model == 1):
            dist.all_reduce(t, op=op, group=self._groups[axis])
        return t

    def all_gather(self, t: torch.Tensor, axis: str) -> List[torch.Tensor]:
        """Every rank of ``axis``'s ``t`` (equal shapes), in axis order."""
        if not self.distributed:
            return [t]
        out = [torch.empty_like(t) for _ in self._ranks[axis]]
        dist.all_gather(out, t.contiguous(), group=self._groups[axis])
        return out

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The full [K, ...] from every client block's rows."""
        return torch.cat(self.all_gather(t, CLIENT_AXIS))

    def gather_cols(self, v: torch.Tensor, d: int) -> torch.Tensor:
        """The full [..., d] from every model block's columns (blocks may
        differ by a word: padded to the widest, then trimmed)."""
        if self.n_model == 1:
            return v
        widths = [hi - lo for lo, hi in (self.col_bounds(d, m) for m in range(self.n_model))]
        pad = max(widths) - v.shape[-1]
        padded = torch.nn.functional.pad(v, (0, pad)) if pad else v
        parts = self.all_gather(padded, MODEL_AXIS)
        return torch.cat([p[..., :w] for p, w in zip(parts, widths)], dim=-1)

    def describe(self) -> str:
        return f"{{'{CLIENT_AXIS}': {self.n_clients}, '{MODEL_AXIS}': {self.n_model}}}"


# the grids of the live process group, one per model_parallel: its
# subgroups (and their NCCL communicators) are made once, not per trainer
_GRIDS = {}


def make_mesh(model_parallel: Optional[int] = None) -> RankGrid:
    """The grid of the process group's ranks (one rank without a group),
    made once per ``model_parallel`` while the group lives."""
    if not _initialized():
        return RankGrid(model_parallel)
    key = (dist.get_world_size(), model_parallel)
    if key not in _GRIDS:
        _GRIDS[key] = RankGrid(model_parallel)
    return _GRIDS[key]


def forget_grids() -> None:
    """Drop the cached grids (the process group is going away)."""
    _GRIDS.clear()
