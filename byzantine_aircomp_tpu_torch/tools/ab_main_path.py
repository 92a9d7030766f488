"""Runs (a)-(e) of ``chip_smoke.py`` from two checkouts in turns, on one GPU.

    python -m byzantine_aircomp_tpu_torch.tools.ab_main_path PARENT CHANGE [--pairs N]

Each pair runs PARENT, CHANGE, CHANGE, PARENT, each side in a process of its
own started from that checkout's root, so that it imports that checkout's
package and ``chip_smoke.py`` and builds the kernels from its sources.  A
side drives ``chip_smoke.run_main_path`` over the runs of the paper's main
path, (a) gm K=50 var, (b) gm2 K=1000, (c) median K=50 var, (d)
trimmed_mean K=1000 var and (e) signmv-1 K=1000 var, with their launch
checks, and reports each run's rounds/sec (the pickled record's
``roundsPerSec``, host clock around a round that ends in a synchronize).
Prints one line per side and, last, one JSON object with every side's
numbers and the card's name and power limit.  Rounds/sec on the host clock
spread by tens of percent between calls, so two versions are compared only
within one call of this script.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# the first five runs are (a)-(e) in every checkout that has chip_smoke.RUNS;
# an older chip_smoke.py runs exactly (a)-(e)
_SIDE = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke
from byzantine_aircomp_tpu_torch.device import resolve_device
from byzantine_aircomp_tpu_torch.fed import harness
from byzantine_aircomp_tpu_torch.fed.config import FedConfig
from byzantine_aircomp_tpu_torch.ops import kernels

resolve_device("cuda")
kernels.build()
if hasattr(chip_smoke, "RUNS"):
    chip_smoke.RUNS = chip_smoke.RUNS[:5]
card = chip_smoke._card_line()
runs = chip_smoke.run_main_path(torch, kernels, harness, FedConfig, card,
                                os.path.join(os.getcwd(), "build", "ab_main_path"))
print("AB_RESULT " + json.dumps({
    "card": card,
    "rounds_per_sec": {k: v["rounds_per_sec"] for k, v in runs.items()},
    "idle_share": {k: v["profiled_iteration"]["idle_share"] for k, v in runs.items()},
}))
"""


# seconds a side may take: its kernel build and five short runs
SIDE_TIMEOUT = 600


def run_side(root: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", _SIDE], cwd=root, capture_output=True,
                          text=True, timeout=SIDE_TIMEOUT)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB_RESULT ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"side {root} failed ({proc.returncode}): {proc.stderr[-3000:]}")
    return json.loads(lines[-1][len("AB_RESULT "):])


def main(argv=None) -> int:
    p = argparse.ArgumentParser("ab_main_path")
    p.add_argument("parent", help="root of the parent checkout")
    p.add_argument("change", help="root of the changed checkout")
    p.add_argument("--pairs", type=int, default=1, help="parent, change, change, parent")
    args = p.parse_args(argv)
    sides = []
    for _ in range(args.pairs):
        for label in ("parent", "change", "change", "parent"):
            root = os.path.abspath(getattr(args, label))
            got = run_side(root)
            sides.append(dict(side=label, **got))
            print(f"{label}: rounds/sec {got['rounds_per_sec']} [{got['card']}]", flush=True)
    print(json.dumps({"sides": sides}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
