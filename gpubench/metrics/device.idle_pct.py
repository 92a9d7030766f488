"""The device's idle share of the traced stretch: one minus the union of
its work's spans over the stretch's length."""


def read(r):
    s = r.stretch
    window = s.end_ns - s.start_ns
    return 100.0 * (1.0 - s.busy_ns() / window) if window > 0 else None
