"""Defense auto-tuner of the port (``byzantine_aircomp_tpu/tune/``):
population-based search over the batchable detector/policy constants,
each generation one group of lanes (``serve/batch.py``)."""

from .space import (  # noqa: F401
    DEFAULT_SPACE,
    SearchSpace,
    default_params,
    sample_candidates,
    validate_space,
)
from .objective import fold_pair, objective_score  # noqa: F401
from .tuner import TuneJournal, Tuner  # noqa: F401
