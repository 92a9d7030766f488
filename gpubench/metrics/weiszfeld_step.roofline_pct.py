"""The gm2 Weiszfeld step's share of its roofline: the least time of the
needed work (each solve of the stretch at the reference's mean steps a
solve, each step one read of the stack, ``counts/weiszfeld_step.py``) over
the kernel's summed device time in the stretch."""

from gpubench import cells
from gpubench.counts import peak


def read(r):
    counts = cells.module("counts", "weiszfeld_step")
    bw, busy, steps = peak(r.device_kind, "hbm_bytes_per_s"), r.kernel_s(counts), r.needed_steps()
    if None in (bw, busy, steps):
        return None
    solves = r.iterations(r.stretch.rounds)
    return 100.0 * solves * steps * counts.step_bytes(r.clients, r.dim) / bw / busy
