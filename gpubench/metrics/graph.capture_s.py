"""Seconds of the cell's round graph's set-up: the eager warm-up round,
then the capture with its instantiation (the port's ``graph.warmup`` and
``graph.capture`` spans, kept in ``fed/graphs.py::LAST_CAPTURE``, read
from its module).  An eager cell has nothing to read."""

from gpubench import replays


def read(r):
    layout = replays.capture_layout()
    if layout is None:
        return None
    return layout.warmup_seconds + layout.capture_seconds
