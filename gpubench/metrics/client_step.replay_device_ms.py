"""Device milliseconds an iteration of the nodes that a CUDA-graph replay
runs inside the round's ``client_step`` span, over the traced stretch's
qualifying replays (``replays.stage_ms``).  Reads the port's capture
layout (``fed/graphs.py::LAST_CAPTURE``) from its module; an eager cell
has nothing to read (``client_step.device_ms`` reads it there)."""

from gpubench import replays


def read(r):
    return replays.stage_ms(r.stretch, "client_step")
