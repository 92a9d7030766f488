"""The Weiszfeld steps that the port's solves ran while active, over the
launches of both Weiszfeld kernels (``weiszfeld_step`` and
``aircomp_weiszfeld_step``), over every solve the program ran in the run:
the useful share of the launched steps.  Reads the port's counters
(``ops/kernels.py::live_steps`` and ``LAUNCHES``) from its module, as
``program.launches`` does; a program without the live-step count has
nothing to read."""


def read(r):
    try:
        from byzantine_aircomp_tpu_torch.ops import kernels
    except ImportError:
        return None
    live = getattr(kernels, "live_steps", None)
    launched = sum(kernels.LAUNCHES.get(k, 0)
                   for k in ("weiszfeld_step", "aircomp_weiszfeld_step"))
    if live is None or not launched:
        return None
    return 100.0 * live() / launched
