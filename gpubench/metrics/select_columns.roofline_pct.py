"""The coordinatewise selection's share of its roofline: one call an
iteration, each reading the stack and the channel's arrays once
(``counts/select_columns.py``), over the kernel's summed device time in
the stretch."""

from gpubench import cells
from gpubench.counts import peak


def read(r):
    counts = cells.module("counts", "select_columns")
    bw, busy = peak(r.device_kind, "hbm_bytes_per_s"), r.kernel_s(counts)
    if None in (bw, busy):
        return None
    calls = r.iterations(r.stretch.rounds)
    channel = r.cell["noise_var"] is not None
    return 100.0 * calls * counts.call_bytes(r.clients, r.dim, channel) / bw / busy
