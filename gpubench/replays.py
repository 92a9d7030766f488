"""What the port's spans give the per-layer readers: each CUDA-graph
replay's device records put down to the stages of the round by the layout
of the port's last capture (``fed/graphs.py::LAST_CAPTURE``).  A replay's
records share the correlation id of its ``cudaGraphLaunch``, the runtime
call inside its ``graph.replay`` range; sorted by start, the k-th record
is the k-th node the capture counted.  A conditional node (a graphed
solve's WHILE node) is not counted, and its body's records fall among the
counted ones, as many as the body ran: they are put down to the counted
node before them.  On a program that keeps no layout or opens no such
ranges, every reading here is None."""

from __future__ import annotations

from typing import List, Optional, Set, Tuple

from . import cells
from .profiling import base_name

#: the port's span around each replay
REPLAY_SPAN = "graph.replay"
#: the runtime call that launches a graph (its record's name begins so)
GRAPH_LAUNCH = "cudaGraphLaunch"
#: how far a record may start before the previous one's end and still come
#: after it: on the H100 up to a third of a chain's consecutive records
#: overlap, by up to 1.31 us over 216 replays, the next node starting before
#: the last one's end is stamped; 1.5 us leaves that maximum a seventh more.
#: Records that overlap by more ran side by side, so the round was not one
#: chain of nodes
JITTER_NS = 1500

Record = Tuple[str, int, int, int, bool]


def capture_layout():
    """The port's layout of its last capture, or None where it keeps none
    (read from the port's module, as ``program.launches`` reads its
    counter)."""
    try:
        from byzantine_aircomp_tpu_torch.fed import graphs
    except ImportError:
        return None
    return getattr(graphs, "LAST_CAPTURE", None)


def kind(rec: Record) -> str:
    """A device record's node kind, by the letter the capture layout's
    ``kinds`` gives: a copy node may run as a copy kernel
    (``memcpy32_post``), so the name decides."""
    name = rec[0].lower()
    return "c" if "memcpy" in name else "s" if "memset" in name else "k"


def body_kernels() -> Set[str]:
    """The kernels that a conditional node's body runs: each kernel count's
    ``LOOP_BODY`` (``counts/<kernel>.py``)."""
    return {n for m in cells.kernel_counts() for n in getattr(m, "LOOP_BODY", ())}


def thin(recs: List[Record], body: Set[str]) -> Optional[list]:
    """A replay's records without those of the kernels ``body``, as
    ``[record, ns]``: each kept record with the device ns of the body
    records between it and the next kept one; None where a body record
    comes before every kept one."""
    out = []
    for r in recs:
        if base_name(r[0]) in body:
            if not out:
                return None
            out[-1][1] += r[2] - r[1]
        else:
            out.append([r, 0])
    return out


def replay_records(stretch, layout) -> List[List[Record]]:
    """The device records of each replay of the stretch that qualifies,
    sorted by start: exactly ``layout.nodes`` records, of the kinds
    ``layout.kinds`` gives in its order, with no two overlapping by more
    than :data:`JITTER_NS` (records that overlap mean the round was not one
    chain of nodes).  A replay with more records loses its conditional
    bodies' records first (:func:`thin`); each kept record's end then moves
    out by the device ns of the bodies after it, so that a stage's time
    holds the loops that run in it.  A replay that already holds exactly
    ``layout.nodes`` records keeps them all: an unrolled loop's steps are
    counted nodes of the same kernels."""
    launches = {s for name, s, _ in stretch.host if name.startswith(GRAPH_LAUNCH)}
    corr = {t: c for t, c in stretch.runtime if t in launches}
    by_corr = {}
    for rec in stretch.device:
        by_corr.setdefault(rec[3], []).append(rec)
    body = body_kernels()
    out = []
    for s, e in sorted((s, e) for name, s, e in stretch.host if name == REPLAY_SPAN):
        inside = [c for t, c in corr.items() if s <= t <= e]
        if len(inside) != 1:
            continue
        recs = [(r, 0) for r in sorted(by_corr.get(inside[0], []), key=lambda r: r[1])]
        if len(recs) > layout.nodes:
            recs = thin([r for r, _ in recs], body) or []
        kept = [r for r, _ in recs]
        if (len(kept) == layout.nodes
                and all(b[1] >= a[2] - JITTER_NS for a, b in zip(kept, kept[1:]))
                and "".join(kind(r) for r in kept) == layout.kinds):
            out.append([(n, a, b + ns, c, k) for (n, a, b, c, k), ns in recs])
    return out


def stage_ns(recs: List[Record], ranges) -> int:
    """Device ns of a replay's records in the node ranges ``[first, end)``."""
    return sum(r[2] - r[1] for first, end in ranges for r in recs[first:end])


def stage_ms(stretch, name: str, layout=None) -> Optional[float]:
    """Device ms an entry of the span ``name`` in the captured round (a
    stage's: an iteration), over the stretch's qualifying replays; None
    where there is no layout, the span was not captured, or no replay
    qualifies."""
    layout = capture_layout() if layout is None else layout
    if layout is None or not layout.spans or name not in layout.spans:
        return None
    recs = replay_records(stretch, layout)
    if not recs:
        return None
    ranges = layout.spans[name]
    return sum(stage_ns(x, ranges) for x in recs) / 1e6 / (len(recs) * len(ranges))

