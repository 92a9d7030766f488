"""Accuracy-vs-bits matrix: the sign channel's payload widths
(``--sign-bits`` 1/8/16/32) against every registered attack, the static tier
and the defense-aware one (JAX ``analysis/bits_matrix.py``).

When the sign channel narrows from full-precision ballots to the
bit-packed wire (``pack_signs`` and the ``packed_vote_counts`` kernel,
~32x less traffic), what does each attack's damage do, and does
``under_radar`` get easier or harder at one bit?  Cells run the real vote
aggregators and the real ``defense/`` scoring on a small synthetic
quadratic descent (a tight honest cluster one SGD step from the params),
so the whole matrix takes seconds:

    python -m byzantine_aircomp_tpu_torch.analysis.bits_matrix \\
        --bits 1,8,16,32 --iters 40 --json bits_matrix.json

Semantics as in the trainer: honest clients descend ``0.5 * |x -
target|^2`` with per-client gradient noise; ``final_dist`` is the final
distance to the optimum and ``flip_frac`` the per-iteration share of
coordinates whose voted step differs from the 32-bit vote on the same
stack; a monitor-mode detector runs alongside, so a defense-aware attack
reads the previous iteration's published state; ``duty_cycle`` schedules
itself off the policy constants; a data-level attack with no
gradient-scale emulation never touches the stack and is ``skipped``.

The draws come from torch generators seeded from ``(--seed, stream)``,
with the JAX tool's stream numbers (3 the target, 100 + t the gradient
noise, 200 + t the attack), not from JAX's threefry, so a cell is the JAX
cell's up to its random numbers (:func:`normals` is the one draw site).

Output: one JSON line per cell on stdout (kind ``bits_cell``), markdown
tables on stderr, optionally a canonical JSON dump (``--json``) and a
markdown file (``--md``).  ``--assert-smoke``: every cell finite, each
attack's 1-bit ``final_dist`` within ``SMOKE_TOL_FACTOR`` x its 32-bit cell
plus ``SMOKE_TOL_ABS``.  Cells run on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import defense as defense_lib
from .. import obs as obs_lib
from ..ops import aggregators as agg_lib
from ..ops import attacks as attack_lib
from ..registry import ATTACKS

K, B, D = 16, 3, 24
HONEST = K - B

BITS = (1, 8, 16, 32)

#: the --assert-smoke tolerance: a 1-bit cell may lose ground to its 32-bit
#: sibling, but within this factor plus an absolute floor (cells that
#: converge to about the sign_eta deadband compare two near-zero distances)
SMOKE_TOL_FACTOR = 2.5
SMOKE_TOL_ABS = 0.5

Cell = Tuple[str, int]  # (attack, sign_bits)

DATA_LEVEL_SKIP = (
    "data-level attack leaves the transmitted stack untouched (no stack-level "
    "signature exists; see fault/attack tiers in DESIGN.md)")


def stream_seed(seed: int, stream: int) -> int:
    """The 63-bit seed of ``(seed, stream)``."""
    hi, lo = np.random.SeedSequence([seed, stream]).generate_state(2)
    return ((int(hi) << 32) | int(lo)) & (2**63 - 1)


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def normals(seed: int, stream: int, shape, device) -> torch.Tensor:
    """Standard f32 normals of one stream (the JAX tool's
    ``normal(fold_in(PRNGKey(seed), stream), shape)``)."""
    return torch.randn(shape, generator=generator(seed, stream, device), device=device)


def attacked(spec, w, base, gen, defense=None, byz=B):
    """The transmitted stack under ``spec``: the message attack where it
    acts, else the gradient-scale emulation (a scaled deviation from the
    global params is what a scaled gradient sends)."""
    w_att = spec.apply_message(w, byz, gen, defense=defense)
    if spec.grad_scale != 1.0 and bool(torch.all(w_att == w)):
        w_att = w.clone()
        w_att[-byz:] = base[None, :] + spec.grad_scale * (w[-byz:] - base[None, :])
    return w_att


def skip(reason: str) -> Dict[str, object]:
    return {"skipped": reason}


def simulate_cell(
    attack_name: str,
    bits: int,
    *,
    agg: str = "signmv",
    iters: int = 40,
    sign_eta: float = 0.05,
    seed: int = 0,
    det: Optional[defense_lib.DetectorParams] = None,
    pol: Optional[defense_lib.PolicyParams] = None,
    device: str = "cuda",
) -> Dict[str, object]:
    """One (attack, sign_bits) cell: ``iters`` vote-descent steps on the
    synthetic quadratic with the attack on throughout.  Reports
    ``final_dist`` / ``best_dist`` to the optimum, ``final_honest_dist`` to
    the last stack's honest mean, ``flip_frac`` (0 by construction at 32
    bits), and the monitor detector's ``detect_iter``, ``recall`` over the
    B attacker rows and ``rounds_suspicious``."""
    spec = attack_lib.resolve(attack_name)
    meta = spec.meta()
    if meta["data_level"] and spec.grad_scale == 1.0:
        return skip(DATA_LEVEL_SKIP)
    dev = torch.device(device)
    det = det or defense_lib.DetectorParams()
    pol = pol or defense_lib.PolicyParams(up_n=3, down_m=8, n_rungs=3, min_flagged=2)
    if attack_name.split("@")[0] == "duty_cycle":
        on_p, period = attack_lib.duty_cycle_schedule(pol)
        iters = max(iters, 2 * period + on_p)
    agg_fn = agg_lib.sign_majority_vote if agg == "signmv" else agg_lib.best_effort_voting
    target = 0.5 * normals(seed, 3, (D,), dev)
    x = torch.zeros(D, dtype=torch.float32, device=dev)
    d_state = defense_lib.init_detector(K, dev)
    p_state = defense_lib.init_policy(dev)
    detect_iter = None
    detected_rows: set = set()
    rounds_susp = 0
    best_dist = float(torch.linalg.vector_norm(x - target))
    flip_sum = 0.0
    w = x[None, :]
    for t in range(iters):
        grad = (x - target)[None, :] + 0.1 * normals(seed, 100 + t, (K, D), dev)
        w = x[None, :] - 0.05 * grad
        d_view = None
        if meta["defense_aware"]:
            # the attack reads the previous iteration's published state
            d_view = attack_lib.DefenseView(
                step=d_state[0], ema=d_state[1], dev=d_state[2], cusum=d_state[3],
                rung=p_state[0], detector=det, policy=pol, guess=x)
        w = attacked(spec, w, x, generator(seed, 200 + t, dev), defense=d_view)
        x_new = agg_fn(w, guess=x, sign_eta=sign_eta, sign_bits=bits)
        if bits != 32:
            x_ref = agg_fn(w, guess=x, sign_eta=sign_eta)
            flip_sum += float(torch.mean(
                (torch.sign(x_new - x) != torch.sign(x_ref - x)).to(torch.float32)))
        # the monitor detector alongside: it publishes the state the
        # defense-aware tier reads and never alters the aggregate
        score, finite = defense_lib.client_scores(w, x)
        d_state, flags = defense_lib.detector_update(d_state, score, finite, det)
        p_state, susp = defense_lib.policy_update(p_state, torch.sum(flags), pol)
        rounds_susp += int(bool(susp))
        flags = flags.tolist()
        if detect_iter is None and sum(flags) > 0:
            detect_iter = t
        detected_rows.update(K - B + i for i in range(B) if flags[K - B + i])
        x = x_new
        best_dist = min(best_dist, float(torch.linalg.vector_norm(x - target)))
    return {
        "final_dist": round(float(torch.linalg.vector_norm(x - target)), 5),
        "best_dist": round(best_dist, 5),
        "final_honest_dist": round(
            float(torch.linalg.vector_norm(x - torch.mean(w[:HONEST], dim=0))), 5),
        "flip_frac": round(flip_sum / iters, 5),
        "detect_iter": detect_iter,
        "recall": round(len(detected_rows) / B, 5),
        "rounds_suspicious": rounds_susp,
    }


def run_matrix(
    attacks: List[str],
    bits_list: List[int],
    log=lambda s: print(s, file=sys.stderr, flush=True),
    on_cell=None,
    **sim_kw,
) -> Dict[Cell, Dict[str, object]]:
    for a in attacks:
        attack_lib.resolve(a)  # fail fast on typos
    for b in bits_list:
        if b not in BITS:
            raise ValueError(f"unknown sign_bits {b}; pick from {BITS}")
    grid: Dict[Cell, Dict[str, object]] = {}
    for attack in attacks:
        for bits in bits_list:
            cell = simulate_cell(attack, bits, **sim_kw)
            grid[(attack, bits)] = cell
            log(f"[bits_matrix] attack={attack} bits={bits}: {cell}")
            if on_cell is not None:
                on_cell(attack, bits, cell)
    return grid


def markdown_table(grid: Dict[Cell, Dict[str, object]]) -> str:
    """One ``attack x bits`` block per metric: ``final_dist``,
    ``flip_frac`` and the detection latency (``-``: never detected)."""
    attacks = sorted({a for a, _ in grid})
    bits_list = sorted({b for _, b in grid})
    head_bits = " | ".join(f"{b}b" for b in bits_list)
    blocks = []
    for metric, fmt in (
        ("final_dist", lambda c: f"{c['final_dist']:.3f}"),
        ("flip_frac", lambda c: f"{c['flip_frac']:.3f}"),
        ("detect_iter", lambda c: "-" if c["detect_iter"] is None else str(c["detect_iter"])),
    ):
        rows = [f"**{metric} by sign_bits**\n\n| attack | {head_bits} |",
                "|---|" + "---|" * len(bits_list)]
        for a in attacks:
            cells = ["skipped" if "skipped" in grid[(a, b)] else fmt(grid[(a, b)])
                     for b in bits_list]
            rows.append(f"| {a} | " + " | ".join(cells) + " |")
        blocks.append("\n".join(rows))
    return "\n\n".join(blocks)


def under_radar_verdict(grid: Dict[Cell, Dict[str, object]]) -> Optional[Dict[str, object]]:
    """Is ``under_radar`` easier or harder at one bit?  Its 1-bit against
    32-bit damage and detection latency; ``harder`` means the packed wire
    did not hand the evasion attack extra damage."""
    lo, hi = grid.get(("under_radar", 1)), grid.get(("under_radar", 32))
    if not lo or not hi or "skipped" in lo or "skipped" in hi:
        return None
    ratio = lo["final_dist"] / hi["final_dist"] if hi["final_dist"] > 0 else float("inf")
    return {
        "final_dist_1b": lo["final_dist"],
        "final_dist_32b": hi["final_dist"],
        "damage_ratio_1b_over_32b": round(ratio, 4),
        "detect_iter_1b": lo["detect_iter"],
        "detect_iter_32b": hi["detect_iter"],
        "verdict": "harder_or_equal_at_1_bit" if ratio <= 1.0 + 1e-9 else "easier_at_1_bit",
    }


def assert_smoke(grid: Dict[Cell, Dict[str, object]]) -> None:
    """The gate of ``--assert-smoke``: every cell that ran is finite, and
    each attack's 1-bit final_dist is within ``SMOKE_TOL_FACTOR`` x its
    32-bit cell plus ``SMOKE_TOL_ABS``."""
    ran = {k: c for k, c in grid.items() if "skipped" not in c}
    if not ran:
        raise SystemExit("[bits_matrix] smoke: every cell was skipped")
    for k, c in ran.items():
        if not all(math.isfinite(c[f]) for f in ("final_dist", "best_dist", "flip_frac")):
            raise SystemExit(f"[bits_matrix] smoke: non-finite cell {k}: {c}")
    bits_ran = {b for _, b in ran}
    if not {1, 32} <= bits_ran:
        raise SystemExit(
            "[bits_matrix] smoke: needs both the 1-bit and 32-bit columns to compare "
            f"(ran {sorted(bits_ran)})")
    for a in sorted({a for a, _ in ran}):
        lo, hi = ran.get((a, 1)), ran.get((a, 32))
        if lo is None or hi is None:
            continue
        bound = SMOKE_TOL_FACTOR * hi["final_dist"] + SMOKE_TOL_ABS
        if lo["final_dist"] > bound:
            raise SystemExit(
                f"[bits_matrix] smoke: {a} at 1 bit lands at final_dist "
                f"{lo['final_dist']} vs {hi['final_dist']} at 32 bits — over the "
                f"{SMOKE_TOL_FACTOR}x + {SMOKE_TOL_ABS} tolerance ({bound:.3f}); the "
                "packed wire handed this attack a win")
    print("[bits_matrix] smoke assertions passed", file=sys.stderr)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--attacks", default=None,
                    help="comma list; default: every registered attack")
    ap.add_argument("--bits", default="1,8,16,32", help="comma list of sign-channel widths")
    ap.add_argument("--agg", default="signmv", choices=["signmv", "bev"],
                    help="which vote aggregator carries the channel")
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--sign-eta", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of every cell's streams; cells are a pure function of "
                         "(flags, seed)")
    ap.add_argument("--json", default=None, help="canonical sorted JSON dump here")
    ap.add_argument("--md", default=None, help="also write the markdown tables here")
    ap.add_argument("--obs-dir", default=None, help="also append bits_cell events here")
    ap.add_argument("--assert-smoke", action="store_true",
                    help="exit nonzero unless every cell is finite and the 1-bit column "
                         "stays within tolerance of 32 bits")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    attacks = ([a for a in args.attacks.split(",") if a] if args.attacks
               else sorted(ATTACKS.names()))
    bits_list = [int(b) for b in args.bits.split(",") if b]
    sinks = [obs_lib.StdoutSink()]
    if args.obs_dir:
        sinks.append(obs_lib.JsonlSink(obs_lib.events_path(args.obs_dir, "bits_matrix")))
    sink = obs_lib.MultiSink(sinks) if len(sinks) > 1 else sinks[0]
    try:
        grid = run_matrix(
            attacks, bits_list, agg=args.agg, iters=args.iters, sign_eta=args.sign_eta,
            seed=args.seed, device=args.device,
            on_cell=lambda attack, bits, cell: sink.emit(obs_lib.make_event(
                "bits_cell", attack=attack, sign_bits=bits, agg=args.agg, **cell)),
        )
    finally:
        sink.close()
    table = markdown_table(grid)
    print(table, file=sys.stderr, flush=True)
    verdict = under_radar_verdict(grid)
    if verdict is not None:
        print(f"[bits_matrix] under_radar: {verdict}", file=sys.stderr)
    if args.json:
        dump = {f"{a}|{b}": c for (a, b), c in grid.items()}
        if verdict is not None:
            dump["_under_radar"] = verdict
        with open(args.json, "w") as f:
            json.dump(dump, f, sort_keys=True, indent=1)
            f.write("\n")
        print(f"[bits_matrix] grid dumped to {args.json}", file=sys.stderr)
    if args.md:
        with open(args.md, "w") as f:
            f.write("# Accuracy vs sign-channel width (bits_matrix)\n\n"
                    f"`python -m byzantine_aircomp_tpu_torch.analysis.bits_matrix --agg "
                    f"{args.agg} --iters {args.iters} --seed {args.seed}`\n\n")
            f.write(table + "\n")
            if verdict is not None:
                f.write(f"\n**under_radar at one bit:** `{verdict['verdict']}` (damage "
                        f"ratio {verdict['damage_ratio_1b_over_32b']}x, detection "
                        f"{verdict['detect_iter_1b']} vs {verdict['detect_iter_32b']})\n")
        print(f"[bits_matrix] markdown written to {args.md}", file=sys.stderr)
    if args.assert_smoke:
        assert_smoke(grid)


if __name__ == "__main__":
    main()
