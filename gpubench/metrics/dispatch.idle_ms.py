"""Device idle milliseconds a dispatch while the host was inside the
program's ``dispatch`` span (``Trainer.run_round`` or
``Trainer.run_rounds_stacked``) and outside its ``graph.replay`` spans:
the device waiting on the program, not on the benchmark's loop or its host
read.  A replay's span is left out because under torch.profiler a graph's
launch costs the host some microseconds a node, so the device's idle time
inside it measures the tracer (a replay of the gm2 round: ~43 ms traced
against ~1.5 ms untraced); what is left is the idle time around the
launches, in the state copy-in, the outputs' copies and an eager round's
host work.  Over the traced stretch's outermost ``dispatch`` ranges;
nothing to read without a device trace."""

#: the port's span around each dispatch
DISPATCH_SPAN = "dispatch"
#: the port's span around each CUDA-graph replay
REPLAY_SPAN = "graph.replay"


def outermost(spans):
    """The ``(start, end)`` spans that no other one encloses."""
    out = []
    for s, e in sorted(spans, key=lambda x: (x[0], -x[1])):
        if not out or s >= out[-1][1]:
            out.append((s, e))
    return out


def read(r):
    s = r.stretch
    spans = outermost([(a, b) for name, a, b in s.host if name == DISPATCH_SPAN])
    if not s.device or not spans:
        return None
    # the device's work and the replays' launches, merged: neither is idle
    covered = [(a, b) for _, a, b, _, _ in s.device]
    covered += [(a, b) for name, a, b in s.host if name == REPLAY_SPAN]
    busy = []
    for a, b in sorted(covered):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    idle = sum((e - a) - sum(max(0, min(y, e) - max(x, a)) for x, y in busy)
               for a, e in spans)
    return idle / 1e6 / len(spans)
