"""Run one cell of ``BENCHMARK.json`` once, on the chip this process finds.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the data set and the initial weights from the seed, builds the
port's trainer and drives its first dispatches (``check_dispatches`` in the
cell's traffic file) through the window's own call: they warm up every
shape and are what the reference later checks.  The window then runs
dispatches back to back for ``--seconds``.  With ``--trace 1`` a few more
dispatches run under torch.profiler and the per-layer metrics are read.
Last, with the program freed, the plain reference follows the checked
dispatches from the same weights, data and draws, and decides ``correct``.

The last line of standard output is the result, one JSON object; the last
lines of standard error are the numbers compared, each beside its limit.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    # Python's bytecode cache, in a fixed directory of the checkout: where
    # the environment keeps none, every run compiles torch from its source
    sys.pycache_prefix = str(ROOT / "build" / "pycache")
    sys.dont_write_bytecode = False
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

T_TORCH = time.perf_counter()

from gpubench import cells, check, inputs, profiling, program, replays  # noqa: E402
from gpubench import data as data_lib  # noqa: E402
from gpubench.readings import Readings  # noqa: E402
from gpubench.reference.follow import follow  # noqa: E402

T_IMPORTS = time.perf_counter()

#: top-level modules that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "byzantine_aircomp_tpu")
#: traced stretches tried before a run gives up on the kernels' shares
TRACE_TRIES = 3


def p90(xs):
    """The 90th percentile, nearest rank."""
    s = sorted(xs)
    return s[max(0, math.ceil(0.9 * len(s)) - 1)]


def launch_shortfall(stretch) -> list:
    """Where the trace holds fewer (or more) of a kernel's records than the
    port's launch counter counted in the stretch: one line each."""
    groups = {}
    for m in cells.kernel_counts():
        groups.setdefault(tuple(m.COUNTED), []).append(m.WRAPPER)
    found = {}
    for name, *_ in stretch.kernels():
        base = profiling.base_name(name)
        found[base] = found.get(base, 0) + 1
    lines = []
    for names, wrappers in groups.items():
        want = sum(stretch.launches.get(w, 0) for w in wrappers)
        got = sum(found.get(n, 0) for n in names)
        if got != want:
            lines.append(f"trace: {got} records of {'/'.join(names)}, the port counted {want} "
                         f"launches of {'+'.join(wrappers)}")
    return lines


def start(config, cell, seed: int, dev):
    """Set-up: the inputs from the seed, the port's trainer on them, and its
    first ``check_dispatches`` dispatches through the window's own call.
    Returns ``(data, p0, dispatch, weights after each checked dispatch,
    variances of each checked round)``."""
    marks = [("import torch", T_TORCH), ("import harness", T_IMPORTS),
             ("start", time.perf_counter())]
    if dev.type == "cuda":
        # the card's context, made here so that its time shows apart
        torch.empty(1, device=dev)
        torch.cuda.synchronize(dev)
    marks.append(("card", time.perf_counter()))
    data = inputs.of(config).make_data(config, seed, dev)
    p0 = data_lib.make_params(config, seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    marks.append(("inputs", time.perf_counter()))
    program.import_port()
    marks.append(("import port", time.perf_counter()))
    trainer = program.make_trainer(config, cell, data, p0, seed, dev)
    marks.append(("trainer", time.perf_counter()))
    dispatch = program.Dispatcher(trainer, cell["rounds_per_dispatch"])
    checked, check_vars = [], []
    for i in range(cell["check_dispatches"]):
        check_vars += dispatch()[2]
        checked.append(dispatch.params().clone())
        marks.append((f"dispatch{i + 1}", time.perf_counter()))
    prev, parts = T0, []
    for label, t in marks:
        parts.append(f"{label} {t - prev:.3f}")
        prev = t
    print("setup seconds: " + ", ".join(parts), file=sys.stderr)
    return data, p0, dispatch, checked, check_vars


def reference_numbers(config, cell, seed: int, data, p0, checked, check_vars, **fault):
    """The reference over the checked dispatches, and the comparison's
    numbers (:func:`.check.numbers`).  ``fault`` goes to the reference."""
    ref = follow(config, cell, inputs.of(config).on_device(data, p0.device), p0, seed,
                 cell["check_dispatches"], **fault)
    nums = check.numbers(config["layout"], p0, checked, check_vars, ref["params"],
                         ref["variances"])
    return nums, ref


def measure(work, config, cell, seed: int, seconds: float, trace: bool, device="cuda"):
    """One run of a cell; returns the result's fields, the numbers compared
    (``checks``) last, and every number of the comparison."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    rounds_per = cell["rounds_per_dispatch"]
    data, p0, dispatch, checked, check_vars = start(config, cell, seed, dev)
    setup_s = time.perf_counter() - T0
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    host_s, total_s, failed = [], [], 0
    opened = time.perf_counter()
    while True:
        host, total, variances = dispatch()
        host_s.append(host)
        total_s.append(total)
        failed += not all(math.isfinite(v) for v in variances)
        if time.perf_counter() - opened >= seconds:
            break
    if cuda:
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - opened
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    print(f"peak bytes: {setup_peak} after set-up, {peak} after the window", file=sys.stderr)
    print("dispatch ms: " + " ".join(f"{1e3 * t:.1f}" for t in total_s), file=sys.stderr)

    stretch = None
    if trace:
        for _ in range(TRACE_TRIES):
            stretch = profiling.trace(dispatch, cell["trace_dispatches"], rounds_per,
                                      program.launches, dev)
            short = launch_shortfall(stretch)
            for line in short:
                print(line, file=sys.stderr)
            if not short:
                break
        layout = replays.capture_layout()
        if layout is not None:
            spans = sum(name == replays.REPLAY_SPAN for name, _, _ in stretch.host)
            print(f"replays: {len(replays.replay_records(stretch, layout))} of {spans} qualify",
                  file=sys.stderr)

    del dispatch
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    nums, ref = reference_numbers(config, cell, seed, data, p0, checked, check_vars)
    correct, checks = check.judge(nums, cell.get("limits", {}))

    name = work["name"]
    rounds = len(total_s) * rounds_per
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(total_s), "failed": failed}
    if not trace:
        values = {"rounds_per_s": rounds / window_s, "dispatch_ms_p90": 1e3 * p90(total_s),
                  "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cells.metrics_of(name, "end_to_end")}
    else:
        r = Readings(cell=cell, config=config, device_kind=device_info["kind"],
                     window_s=window_s, rounds=rounds, host_s=host_s, stretch=stretch,
                     kernels_whole=not launch_shortfall(stretch),
                     solve_steps=ref["solve_steps"])
        metrics = {}
        for m in cells.metrics_of(name, "per_layer"):
            value = cells.module("metrics", m["name"]).read(r)
            if value is None:
                print(f"metric {m['name']}: nothing to read", file=sys.stderr)
            else:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        window = (stretch.end_ns - stretch.start_ns) / 1e9
        device_info.update(busy_s=stretch.busy_ns() / 1e9, window_s=window)
        result["breakdown"] = {"device_ops": [list(x) for x in stretch.device_ops()[:profiling.TOP]],
                               "idle_gaps": [list(x) for x in stretch.idle_gaps()[:profiling.TOP]]}
    result["metrics"] = metrics
    result["device"] = device_info
    result["checks"] = checks
    return result, nums


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    work, config, cell = cells.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < work["chips"]:
        print(f"{args.workload} needs {work['chips']} CUDA device(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, nums = measure(work, config, cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"the run holds the modules {found}: the benchmark runs without JAX",
              file=sys.stderr)
        return 3
    print(f"comparison numbers: {json.dumps(nums)}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
