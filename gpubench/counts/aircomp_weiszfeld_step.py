"""The AirComp Weiszfeld step (gm, ``ops/csrc/aircomp_weiszfeld_step.cu``):
the bytes one needed step has to move, each once: the [K, d] f32 stack, the
[d] guess, the two [K] fade draws and, with a noisy receiver, the [d + 1]
standard normals read; the [d] next guess written."""

#: the port's launch counter key; the ideal step's kernels are its own
WRAPPER = "aircomp_weiszfeld_step"
COUNTED = ("step_kernel", "wide_kernel")
TIMED = COUNTED


def step_bytes(k: int, d: int, noisy: bool) -> int:
    return 4 * (k * d + 2 * d + 2 * k + ((d + 1) if noisy else 0))
