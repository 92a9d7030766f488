"""Multi-tenant experiment serving of the port (``byzantine_aircomp_tpu/serve/``).

* :mod:`.batch`   — N same-shape configs as lanes of one group: one set-up
  (one dataset on the device, one load of the kernels), per-lane knobs
  that swap without a rebuild, each lane's round run in turn through the
  solo trainer's code, so a lane is bitwise its solo run.
* :mod:`.elastic` — streamed and population-shard tenants batch too (their
  gating knobs pinned), and drained lanes refill from the admission queue
  between rounds, with journaled seat decisions.
* :mod:`.journal` — the write-ahead log a restarted server replays.
* :mod:`.runs` + :mod:`.server` — the control plane: a stdlib HTTP surface
  on the metrics exporter's routes hook to submit, inspect, cancel and
  hot-swap runs, with per-run obs subtrees, ``run_id``-labelled metrics,
  checkpoints and a watchdog.
* :mod:`.edge` + :mod:`.root` — the two-tier aggregation: edge processes
  each run the streamed aggregators over their shard of the cohort chunks
  and exchange signed partials with one root, which folds them in shard
  order, so the tree's results are bitwise the flat aggregate.
"""

from .batch import (  # noqa: F401
    BATCHABLE_KNOBS,
    PINNED_STREAM_KNOBS,
    BatchRunner,
    applicable_knobs,
    static_signature,
    validate_batch,
)
from .edge import (  # noqa: F401
    EdgeClient,
    EdgeCompute,
    EdgeQuarantined,
    EdgeShardCtx,
    RoundRestart,
    TopologyConfig,
    canonical_bytes,
    round_stack,
    run_edge,
    sign_envelope,
)
from .elastic import (  # noqa: F401
    ElasticBatchRunner,
    pinned_knobs,
    runner_for,
    seat_order,
    validate_stream_batch,
)
from .root import Reject, RootServer, RootState  # noqa: F401
from .runs import RunManager  # noqa: F401
from .server import ExperimentServer  # noqa: F401
