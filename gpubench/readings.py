"""What a per-layer metric's reader reads: one run's window, its traced
stretch and the reference's solves.  A reader is ``read(r: Readings)`` in
``metrics/<metric>.py``; it returns the metric's value, or None where it
finds nothing to read."""

from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import List, Optional

from .profiling import Stretch


@dataclass
class Readings:
    cell: dict                 # the traffic file's contents
    config: dict               # the configuration file's contents
    device_kind: str           # torch.cuda.get_device_name()
    window_s: float            # the untraced window's seconds
    rounds: int                # rounds completed in the window
    host_s: List[float]        # each dispatch's host seconds in the call
    stretch: Stretch           # the traced stretch
    kernels_whole: bool        # every launch the program counted is in the trace
    solve_steps: List[int] = field(default_factory=list)  # the reference's, per solve

    @property
    def clients(self) -> int:
        return self.cell["honest_size"] + self.cell["byz_size"]

    @property
    def dim(self) -> int:
        return self.config["params"]

    def iterations(self, rounds: int) -> int:
        return rounds * self.config["display_interval"]

    def needed_steps(self) -> Optional[float]:
        """The mean Weiszfeld steps a solve needs, from the reference's
        solves of the checked stacks."""
        return statistics.fmean(self.solve_steps) if self.solve_steps else None

    def kernel_s(self, counts) -> Optional[float]:
        """The device seconds of a kernel's records in the traced stretch,
        None where the trace lost records or holds none."""
        if not self.kernels_whole:
            return None
        ns, n = self.stretch.kernel_ns(lambda name: any(k in name for k in counts.TIMED))
        return ns / 1e9 if n else None
