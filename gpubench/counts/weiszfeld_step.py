"""The ideal Weiszfeld step (gm2, ``ops/csrc/weiszfeld_step.cu``): the bytes
one needed step has to move, each once: the [K, d] f32 stack and the [d]
guess read, the [d] next guess written."""

#: the port's launch counter key (``ops/kernels.py::LAUNCHES``)
WRAPPER = "weiszfeld_step"
#: the device kernels of a launch, by name (one per launch: the step plan or
#: the wide plan)
COUNTED = ("step_kernel", "wide_kernel")
#: the device kernels whose time is the wrapper's
TIMED = COUNTED
#: the device kernels of a conditional node's body (a graphed solve's WHILE
#: node: its steps and its stopping test), which the capture does not count
#: as nodes (``gpubench/replays.py``)
LOOP_BODY = COUNTED + ("loop_condition_kernel",)


def step_bytes(k: int, d: int) -> int:
    return 4 * (k * d + 2 * d)
