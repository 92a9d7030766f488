"""Device milliseconds per iteration of the kernels launched inside the
program's ``client_step`` ranges.  A CUDA-graph replay opens no range, so a
graphed cell has nothing to read."""

from gpubench.program import CLIENT_STEP_RANGE


def read(r):
    ranges, ns = r.stretch.range_kernel_ns(CLIENT_STEP_RANGE)
    if not ranges or not ns:
        return None
    return ns / 1e6 / r.iterations(r.stretch.rounds)
