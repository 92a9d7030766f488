"""Offline analysis: load pickled run records, render the paper figure.

The port's copy of ``byzantine_aircomp_tpu/analysis/plots.py``, a reader
of the harness's record schema that replaces the reference's
``draw.ipynb``: cell 0 unpickles runs by the title convention built in
``run()`` (``MNIST_Air_weight.py:446-455,:481-492``), cell 1 renders a
4-panel test-loss / test-accuracy vs iteration figure (x = round *
displayInterval).  The record keys used here (``valLossPath`` /
``valAccPath`` / ``variencePath`` / config scalars) are the reference's
pickle schema, so this module also reads the reference's and the JAX
package's pickles.  matplotlib (the Agg backend, headless) is imported
when a figure is drawn, not with the module.

Usage::

    python -m byzantine_aircomp_tpu_torch.analysis plots \
        --cache-dir ./MNIST_Air_weight_torch --out figure.png
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle
from typing import Dict, List, Optional, Sequence


def pyplot():
    """matplotlib's pyplot on the headless Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def load_record(path: str) -> Dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def find_records(cache_dir: str, pattern: str = "*") -> Dict[str, Dict]:
    """Load every record in ``cache_dir`` matching the glob ``pattern``;
    returns {filename: record}."""
    out = {}
    for path in sorted(glob.glob(os.path.join(cache_dir, pattern))):
        if os.path.isfile(path):
            try:
                out[os.path.basename(path)] = load_record(path)
            except (pickle.UnpicklingError, EOFError):
                continue
    return out


def _x_axis(record: Dict) -> List[int]:
    interval = record.get("displayInterval", 10)
    n = len(record["valLossPath"])
    return [i * interval for i in range(n)]


def plot_runs(
    ax,
    records: Dict[str, Dict],
    metric: str,
    title: str = "",
    ylabel: str = "",
):
    """One panel: ``metric`` path vs global iteration for each record."""
    for name, rec in records.items():
        ax.plot(_x_axis(rec), rec[metric], label=name, linewidth=1.2)
    ax.set_xlabel("iteration")
    ax.set_ylabel(ylabel or metric)
    if title:
        ax.set_title(title)
    ax.grid(True, alpha=0.3)
    ax.legend(fontsize=7)


def paper_figure(
    records: Dict[str, Dict],
    out_path: Optional[str] = None,
    attacks: Sequence[str] = ("classflip", "weightflip"),
):
    """The reference paper's 4-panel figure (draw.ipynb cell 1): per attack,
    one loss panel and one accuracy panel; every record whose ``attack``
    field matches lands on that attack's panels, labelled by aggregator /
    noise / Byzantine count."""
    fig, axes = pyplot().subplots(1, 2 * len(attacks), figsize=(6 * len(attacks), 4.2))
    for i, attack in enumerate(attacks):
        sel: Dict[str, Dict] = {}
        for fname, r in records.items():
            if r.get("attack") != attack:
                continue
            label = (
                f"{r.get('aggregate')}"
                # noise_var=0.0 is a (degenerate) noisy channel, not ideal
                + (
                    f"_var{r['noise_var']}"
                    if r.get("noise_var") is not None
                    else "_ideal"
                )
                + f"_B{r.get('byzantineSize', '?')}"
            )
            if "honestSize" in r:
                label += f"_K{r['honestSize'] + r.get('byzantineSize', 0)}"
            while label in sel:  # runs differing only in model/seed/mark
                label += f" [{fname}]"
            sel[label] = r
        plot_runs(axes[2 * i], sel, "valLossPath", f"{attack}: test loss", "loss")
        plot_runs(
            axes[2 * i + 1], sel, "valAccPath", f"{attack}: test accuracy", "accuracy"
        )
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=150)
    return fig


def main(argv=None):
    p = argparse.ArgumentParser("byzantine_aircomp_tpu_torch.analysis plots")
    p.add_argument("--cache-dir", type=str, required=True)
    p.add_argument("--pattern", type=str, default="*")
    p.add_argument("--out", type=str, default="figure.png")
    p.add_argument(
        "--attacks", type=str, default="classflip,weightflip", help="comma-separated"
    )
    args = p.parse_args(argv)
    records = find_records(args.cache_dir, args.pattern)
    if not records:
        raise SystemExit(f"no records found in {args.cache_dir}")
    paper_figure(records, args.out, attacks=args.attacks.split(","))
    print(f"wrote {args.out} ({len(records)} records)")


if __name__ == "__main__":
    main()
