"""Device milliseconds an iteration of the channel stage (the span
``channel``: the OMA link's draws and terms).  In a graphed cell, the
nodes a replay runs inside it, over the traced stretch's qualifying
replays (``replays.stage_ms``, which reads the port's capture layout from
its module); in an eager cell, the kernels launched inside the program's
``channel`` ranges (as ``client_step.device_ms`` reads its range)."""

from gpubench import replays


def read(r):
    graphed = replays.stage_ms(r.stretch, "channel")
    if graphed is not None:
        return graphed
    ranges, ns = r.stretch.range_kernel_ns("channel")
    if not ranges or not ns:
        return None
    return ns / 1e6 / r.iterations(r.stretch.rounds)
