"""The readings the limits of ``correct`` are set from, for one cell, in one
process, at the cell's own size (no measured window):

* ``program``: sound runs of the program (set-up's checked dispatches)
  against the reference, one per seed: the lower readings;
* ``control``: the reference computed with TF32 products, put in the
  program's place: has to come out not correct;
* ``half_batch``: the reference with each client's batch cut to its first
  half (the mean over the rest), put in the program's place: a fault that
  has to come out not correct.

    python3 gpubench/calibrate.py --workload <cell> --seeds 1 2 3 \\
        [--control-seeds 4 5 6] [--fault-seeds 7 8 9] [--out readings.json]

Each reading is the comparison's numbers (``check.numbers``); the summary
gives each number's largest sound reading and smallest control and fault
readings.  A state left unchanged reads 1 on the step numbers by
construction, and needs no run.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from gpubench import cells, data as data_lib, inputs  # noqa: E402
from gpubench.run import reference_numbers, start  # noqa: E402
from gpubench.reference.follow import follow  # noqa: E402


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def program_reading(config, cell, seed, device):
    data, p0, dispatch, checked, check_vars = start(config, cell, seed, device)
    del dispatch
    _free(device)
    nums, _ = reference_numbers(config, cell, seed, data, p0, checked, check_vars)
    return nums


def stand_in_reading(config, cell, seed, device, **fault):
    """The reference with ``fault`` in the program's place, against the
    sound reference."""
    kind = inputs.of(config)
    data = kind.make_data(config, seed, device)
    p0 = data_lib.make_params(config, seed, device)
    sub = follow(config, cell, kind.on_device(data, device), p0, seed,
                 cell["check_dispatches"], **fault)
    nums, _ = reference_numbers(config, cell, seed, data, p0, sub["params"], sub["variances"])
    return nums


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    _, config, cell = cells.cell(args.workload)
    device = torch.device("cuda")
    readings = {"program": {}, "control": {}, "half_batch": {}}
    plan = ([("program", s, {}) for s in args.seeds]
            + [("control", s, {"tf32": True}) for s in args.control_seeds]
            + [("half_batch", s, {"half_batch": True}) for s in args.fault_seeds])
    for kind, seed, fault in plan:
        t0 = time.perf_counter()
        nums = (program_reading(config, cell, seed, device) if kind == "program"
                else stand_in_reading(config, cell, seed, device, **fault))
        _free(device)
        readings[kind][str(seed)] = nums
        print(json.dumps({"kind": kind, "seed": seed, "seconds": time.perf_counter() - t0,
                          **nums}), flush=True)
    summary = {}
    for kind, rows in readings.items():
        if rows:
            pick = max if kind == "program" else min
            names = next(iter(rows.values()))
            summary[kind] = {n: pick(r[n] for r in rows.values()) for n in names}
    out = {"workload": args.workload, "device": torch.cuda.get_device_name(device),
           "readings": readings, "summary": summary}
    print(json.dumps({"summary": summary}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
