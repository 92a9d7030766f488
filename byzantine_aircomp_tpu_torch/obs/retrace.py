"""Program builds of the trainer, counted: the port's retrace detector.

The JAX package counts lowerings of its jitted round, multi-round and eval
functions (``byzantine_aircomp_tpu/obs/retrace.py``); a steady-state run
lowers each once, and a second lowering means a shape or static-argument
leak re-entered the compiler.  The port compiles nothing per round, so
here a count is **one per program the trainer builds**:

* ``multi_round_fn``: one per CUDA-graph capture of the round
  (``fed/graphs.py::RoundGraph``, its ``captures``).  A trainer captures
  once; a second capture in one trainer is the leak this audit exists for;
* ``round_fn``: one for the eager round's one-time set-up, the first round
  a trainer runs eagerly, which loads the nvcc-built kernels
  (``ops/kernels.py``) and allocates their workspaces, where the card has
  them (and, on the CPU, the first round run);
* ``eval_fn``: stays 0 (eval builds nothing).

The harness builds the counts at the run's end from the trainer
(``fed/harness.py::_retrace``).  The keys are JAX's, so the JAX package's
stream readers parse the port's ``retrace`` event.  The round span's
``compiled`` field is true in the run's first round (or dispatch), the one
that pays for the set-up or the capture.  ``steady_state_ok`` is false
when one trainer captured more than once.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

#: the counted programs, JAX's names
KEYS = ("round_fn", "multi_round_fn", "eval_fn")


class RetraceError(RuntimeError):
    """Raised by :meth:`RetraceDetector.check` in ``error`` mode."""


class RetraceDetector:
    """Build counts by program name.  ``keys`` are the programs reported
    at 0 before their first build (the trainer's :data:`KEYS`; the edges of
    the two-tier topology start empty and report what they built)."""

    def __init__(self, keys=KEYS) -> None:
        self.counts: Dict[str, int] = {k: 0 for k in keys}

    def build(self, name: str) -> None:
        """Count one build of the program ``name``."""
        self.counts[name] = self.counts.get(name, 0) + 1

    def count(self, name: str) -> int:
        return self.counts.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        return dict(self.counts)

    def check(
        self,
        name: str,
        max_lowerings: int = 1,
        error: bool = False,
        warn_fn: Optional[Callable[[str], None]] = None,
    ) -> bool:
        """True iff ``name`` was built at most ``max_lowerings`` times.

        On violation: raises :class:`RetraceError` when ``error``,
        otherwise calls ``warn_fn`` (if given) with a diagnostic line.
        """
        n = self.count(name)
        ok = n <= max_lowerings
        if not ok:
            msg = (
                f"steady-state rebuild: {name} built {n}x (expected <= "
                f"{max_lowerings}) — a second capture or set-up happened mid-run"
            )
            if error:
                raise RetraceError(msg)
            if warn_fn is not None:
                warn_fn(f"WARNING: {msg}")
        return ok
