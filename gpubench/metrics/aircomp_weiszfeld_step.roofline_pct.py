"""The gm (AirComp) Weiszfeld step's share of its roofline: as the gm2
step's, with the fades and the receiver's normals among the bytes
(``counts/aircomp_weiszfeld_step.py``)."""

from gpubench import cells
from gpubench.counts import peak


def read(r):
    counts = cells.module("counts", "aircomp_weiszfeld_step")
    bw, busy, steps = peak(r.device_kind, "hbm_bytes_per_s"), r.kernel_s(counts), r.needed_steps()
    if None in (bw, busy, steps):
        return None
    solves = r.iterations(r.stretch.rounds)
    noisy = r.cell["noise_var"] is not None
    return 100.0 * solves * steps * counts.step_bytes(r.clients, r.dim, noisy) / bw / busy
