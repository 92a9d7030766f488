"""Compare two ``chip_smoke.py`` result files on what must not move between
two checkouts: every run's kernel launch counts and its records, timings
left out.

    python -m byzantine_aircomp_tpu_torch.tools.smoke_diff PARENT.json CHANGE.json

Each file is the ``chip_smoke.json`` that ``chip_smoke.py`` writes.  The
tool walks the two trees side by side (the runs both files hold) and
compares, exactly, every value under a key of :data:`KEYS`: launch counts
(the wrappers' and the device's), accuracy and variance paths, fault,
defense and service paths, the bitwise verdicts of the twins, the model
width.  Exit 0 when every compared value is equal, 1 otherwise; the
compared and differing counts are printed as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, List, Tuple

# the keys whose values a change that alters no kernel and no default path
# leaves as they are
KEYS = frozenset((
    "launches", "launches_per_round", "capture_launches_per_round",
    "twin_launches_per_round", "replay_launches", "device_launches",
    "val_acc", "val_acc_path", "variance", "fault_paths", "defense_paths", "d",
    "records_equal", "params_bitwise_equal", "params_finite", "captures",
    "weiszfeld_live_steps_per_round", "effective_k_path",
))


def compare(a: Any, b: Any, path: str = "", found: List[Tuple[str, Any, Any]] = None,
            under: bool = False) -> Tuple[int, List[Tuple[str, Any, Any]]]:
    """(values compared, [(path, a, b) that differ]) over the keys both
    trees hold; below a key of :data:`KEYS` every leaf is compared."""
    found = [] if found is None else found
    n = 0
    if isinstance(a, dict) and isinstance(b, dict):
        for key in sorted(set(a) & set(b)):
            m, _ = compare(a[key], b[key], f"{path}/{key}", found, under or key in KEYS)
            n += m
        return n, found
    if isinstance(a, list) and isinstance(b, list) and under:
        if len(a) != len(b):
            found.append((path, len(a), len(b)))
            return 1, found
        for i, (x, y) in enumerate(zip(a, b)):
            m, _ = compare(x, y, f"{path}[{i}]", found, under)
            n += m
        return n, found
    if not under:
        return 0, found
    if a != b and not (a != a and b != b):  # NaN equals NaN here
        found.append((path, a, b))
    return 1, found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("byzantine_aircomp_tpu_torch.tools.smoke_diff")
    ap.add_argument("parent")
    ap.add_argument("change")
    args = ap.parse_args(argv)
    with open(args.parent) as f:
        parent = json.load(f)
    with open(args.change) as f:
        change = json.load(f)
    n, diffs = compare(parent, change)
    for path, x, y in diffs[:50]:
        print(f"differs: {path}: {x!r} -> {y!r}")
    only = sorted(set(change) - set(parent))
    print(json.dumps(dict(compared=n, differing=len(diffs), sections_only_in_change=only)))
    return 0 if n and not diffs else 1


if __name__ == "__main__":
    sys.exit(main())
