"""The host's milliseconds in a dispatch's call, from the call of
``run_round`` or ``run_rounds_stacked`` to its return (before the host
read): the median over the untraced window's dispatches."""

import statistics


def read(r):
    return 1e3 * statistics.median(r.host_s) if r.host_s else None
