"""Multi-GPU layouts on ``torch.distributed`` (JAX ``parallel/``): the
(clients, model) grid of ranks, its collectives, the sharded trainer, the
population-shard engine and the multi-process start-up."""

from . import collective, mesh, multihost, popmesh  # noqa: F401
from .popmesh import PopShardedFedTrainer  # noqa: F401
from .sharded import ShardedFedTrainer  # noqa: F401
