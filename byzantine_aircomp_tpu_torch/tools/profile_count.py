"""Counts a graphed dispatch's kernels on the device over repeated
torch.profiler sessions, from one or more checkouts, on one GPU.

    python -m byzantine_aircomp_tpu_torch.tools.profile_count ROOT [ROOT ...]
        [--run z7_cnn_gm2_K50] [--sessions 8] [--modes untimed,timed,untimed]

For each checkout, in a process of its own started from its root (so that it
imports that checkout's package and ``chip_smoke.py`` and builds the kernels
from its sources), drives one run of ``chip_smoke.GRAPH_RUNS`` as one graphed
R=2 dispatch, then, for each mode in turn, ``--sessions`` profiled dispatches
of two replays: back to back (``untimed``), or each followed by one more
dispatch timed with CUDA events (``timed``).  Each session's device kernels
of each wrapper group (``chip_smoke._device_launches``) are held against
twice what the wrappers counted at capture.  Prints one line per checkout
and, last, one JSON object with every session's counts and the card's name
and power limit.  Exits 0 whatever the counts: it measures, it checks
nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_SIDE = r"""
import dataclasses, json, os, sys
sys.path.insert(0, os.getcwd())
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke
from byzantine_aircomp_tpu_torch.device import resolve_device
from byzantine_aircomp_tpu_torch.fed import harness
from byzantine_aircomp_tpu_torch.fed.config import FedConfig
from byzantine_aircomp_tpu_torch.ops import kernels

run, sessions, modes = sys.argv[1], int(sys.argv[2]), sys.argv[3].split(",")
resolve_device("cuda")
kernels.build()
(kw,) = [kw for label, kw, _ in chip_smoke.GRAPH_RUNS if label == run]
cfg = FedConfig(**dict(dict(attack="classflip"), **kw), rounds=2, display_interval=10,
                rounds_per_dispatch=2,
                cache_dir=os.path.join(os.getcwd(), "build", "profile_count"))
trainer, _ = harness.run_with_trainer(cfg, device="cuda")
at_capture = trainer.round_graph.replay_launches
want = {"+".join(g): 2 * sum(at_capture[k] for k in g) for g in chip_smoke.DEVICE_GROUPS}
counts = {}
for i, mode in enumerate(modes):
    seen = []
    for _ in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trainer.run_rounds_stacked(cfg.rounds, 2)
            torch.cuda.synchronize()
        seen.append(chip_smoke._device_launches(torch, prof))
        if mode == "timed":
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            trainer.run_rounds_stacked(cfg.rounds, 2)
            end.record()
            torch.cuda.synchronize()
            start.elapsed_time(end)
    counts[f"{i}_{mode}"] = seen
print("COUNT_RESULT " + json.dumps({"card": chip_smoke._card_line(), "run": run,
                                    "want": want, "counts": counts}))
"""

# seconds a side may take: its kernel build, one run and its sessions
SIDE_TIMEOUT = 900


def run_side(root: str, run: str, sessions: int, modes: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", _SIDE, run, str(sessions), modes], cwd=root,
                          capture_output=True, text=True, timeout=SIDE_TIMEOUT)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("COUNT_RESULT ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"side {root} failed ({proc.returncode}): {proc.stderr[-3000:]}")
    return json.loads(lines[-1][len("COUNT_RESULT "):])


def main(argv=None) -> int:
    p = argparse.ArgumentParser("profile_count")
    p.add_argument("roots", nargs="+", help="roots of the checkouts, run in this order")
    p.add_argument("--run", default="z7_cnn_gm2_K50", help="a label of chip_smoke.GRAPH_RUNS")
    p.add_argument("--sessions", type=int, default=8, help="profiled dispatches per mode")
    p.add_argument("--modes", default="untimed,timed,untimed",
                   help="comma-separated, each 'untimed' or 'timed', run in this order")
    args = p.parse_args(argv)
    sides = []
    for root in args.roots:
        got = run_side(os.path.abspath(root), args.run, args.sessions, args.modes)
        sides.append(dict(root=root, **got))
        exact = {mode: sum(s == got["want"] for s in seen) for mode, seen in got["counts"].items()}
        print(f"{root}: {args.run} sessions exact per mode {exact} of {args.sessions}, want "
              f"{got['want']} [{got['card']}]", flush=True)
    print(json.dumps({"sides": sides}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
