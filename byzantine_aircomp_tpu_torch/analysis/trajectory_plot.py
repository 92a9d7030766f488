"""Plot per-round trajectory JSONL files (the JAX package's
``benchmarks/trajectory.py`` output).

The port's copy of ``byzantine_aircomp_tpu/analysis/trajectory_plot.py``.
The pickle-based figure (:mod:`.plots`) reads harness run records; the
convergence-evidence runs instead stream one JSON row per round (a header
line, optional ``{"resumed": N}`` seam markers, then ``{"round",
"val_loss", "val_acc", "secs"}`` rows: the format committed under
``docs/trajectories_r05/``).  This tool overlays any number of those
curves on one accuracy-vs-round axis, labeling each by filename (or an
explicit ``name=path`` pair):

    python -m byzantine_aircomp_tpu_torch.analysis.trajectory_plot \
        --out resnet_cells.png \
        honest=docs/trajectories_r05/resnet_honest_mean.jsonl \
        krum=docs/trajectories_r05/resnet_signflip_krum.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Tuple

from .plots import pyplot


def load_trajectory(path: str) -> Tuple[Dict, List[int], List[float]]:
    """(header, rounds, val_accs) from a trajectory JSONL; seam markers and
    duplicate rounds (crash-resume overlap) are tolerated — the LAST row
    for a round wins, matching the checkpoint-before-row write order."""
    header: Dict = {}
    by_round: Dict[int, float] = {}
    with open(path) as fh:
        for line in fh:
            if not line.strip():
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                # a kill mid-append leaves a truncated final line — the
                # crash-resume case this loader exists to tolerate
                continue
            if "config" in row:
                header = row
            elif "round" in row:
                by_round[int(row["round"])] = float(row["val_acc"])
    rounds = sorted(by_round)
    return header, rounds, [by_round[r] for r in rounds]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument(
        "curves", nargs="+", metavar="[NAME=]PATH",
        help="trajectory JSONL files; optional NAME= label prefix",
    )
    p.add_argument("--out", required=True, help="output PNG path")
    p.add_argument("--title", default="validation accuracy vs round")
    args = p.parse_args(argv)

    fig, ax = pyplot().subplots(figsize=(7, 4.5), constrained_layout=True)
    for spec in args.curves:
        name, sep, path = spec.partition("=")
        if not sep:
            name, path = os.path.splitext(os.path.basename(spec))[0], spec
        _, rounds, accs = load_trajectory(path)
        if not accs:  # header-only file (run not yet past round 0)
            print(f"skipping {path}: no round rows")
            continue
        ax.plot(rounds, accs, label=f"{name} (final {accs[-1]:.3f})")
    ax.set_xlabel("round")
    ax.set_ylabel("val accuracy")
    ax.set_title(args.title)
    ax.grid(True, alpha=0.3)
    ax.legend(fontsize=8)
    fig.savefig(args.out, dpi=150)
    print(args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
