"""Attack x defense break-matrix: every registered attack, the static ones
and the defense-aware tier, against every defense mode and ladder variant
(JAX ``analysis/adaptive_matrix.py``).

For each attack: does the detector notice, and how fast; how long does the
policy call the run suspicious; does it climb the ladder, and back down
once the attacker goes quiet; and for the adaptive attackers, does their
evasion or persistence trick work?  Cells run the real ``defense/`` scoring
and policy on a small synthetic stack (a tight honest cluster one SGD step
apart), so the whole matrix takes seconds:

    python -m byzantine_aircomp_tpu_torch.analysis.adaptive_matrix \\
        --modes off,monitor,adaptive --iters 40 --onset 10 --stop 30 \\
        --ladders "mean,trimmed_mean,multi_krum;mean,bev,multi_krum"

Semantics as in the trainer: the attack runs before the iteration's
detector update, so a defense-aware attack reads the previous iteration's
published state; ``duty_cycle`` schedules itself off the policy constants
(its cells force ``onset=0, stop=None`` and run at least two burst/sleep
periods); ``mode=off`` has no detector, so the defense-aware attacks are
``skipped`` there; a data-level attack with no gradient-scale emulation is
``skipped`` too, instead of reading as "ran and went undetected".

``--alphas`` grows the matrix into the heterogeneity x attack x defense
cube: each Dirichlet level (``iid`` or a float alpha) adds per-client drift
to the honest stack (:func:`make_hetero`), and ``--tuned label=path`` runs
those levels with a tune artifact's constants too.

The draws come from torch generators seeded from ``(--seed, stream)`` with
the JAX tool's stream numbers (1 and 2 the fixture, 7 and 8 the drift,
100 + t the stack, 200 + t the attack, 300 + t the rule, 400 + t the drift
magnitude), not from threefry: :func:`normals` and :func:`gammas` are the
draw sites.  ``--batched`` (JAX's one-scan mode) runs every mode of an
(attack, ladder) family from one pass over the iterations
(:func:`simulate_cells_batched`); with ``--expect-speedup X`` or
``--perf-row PATH`` the per-cell loop is timed too, its batched/eager
ratio printed (and written as a ``matrix_wallclock`` row), and the run
fails below X.

Output: one JSON line per cell on stdout (kind ``adaptive_cell``), a
markdown table per (mode, ladder) on stderr, optionally an atomic pickle
(``--out``) and a canonical JSON dump (``--json``).  ``--assert-smoke``:
an adaptive-mode cell of a defense-aware attack must detect, and the
``duty_cycle`` adaptive cell must stay escalated between bursts
(``min_rung_post >= 1``).  Cells run on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import defense as defense_lib
from .. import obs as obs_lib
from ..ops import attacks as attack_lib
from ..registry import AGGREGATORS, ATTACKS
from ..utils import io as io_lib
from .bits_matrix import DATA_LEVEL_SKIP, attacked, generator, normals, skip, stream_seed

K, B, D = 16, 3, 24
HONEST = K - B

MODES = ("off", "monitor", "adaptive")

Cell = Tuple[str, str, str]  # (attack, mode, ladder)
CubeCell = Tuple[str, str, str, str, str]  # ... + (alpha label, constants)

DEFENSE_AWARE_OFF_SKIP = (
    "defense-aware attack observes the published detector state; --defense off "
    "publishes none (fed/config.py rejects the combination for real runs too)")

# the tune artifacts' knob -> field maps (the JAX package's serve/batch.py
# :73-90, copied: the port has no serve package)
_DETECTOR_KNOBS = {
    "defense_alpha": "alpha",
    "defense_drift": "drift",
    "defense_z": "z_thresh",
    "defense_cusum": "cusum_thresh",
    "defense_warmup": "warmup",
}
_POLICY_KNOBS = {
    "defense_up": "up_n",
    "defense_down": "down_m",
    "defense_min_flagged": "min_flagged",
    "defense_leak": "budget_leak",
    "defense_floor": "floor_thresh",
}
_INT_KNOBS = frozenset({"defense_warmup", "defense_up", "defense_down", "defense_min_flagged"})


def gammas(seed: int, stream: int, alpha: float, shape, device) -> torch.Tensor:
    """Gamma(alpha, 1) f32 draws of one stream (numpy's sampler, on the host)."""
    rng = np.random.default_rng(stream_seed(seed, stream))
    return torch.from_numpy(rng.gamma(alpha, size=shape).astype(np.float32)).to(device)


def honest_stack(seed: int = 0, device="cpu"):
    """The smoke-stack fixture: a tight honest cluster one SGD step from
    ``base``.  Returns ``(w [K, D] f32, base [D] f32)``."""
    base = 0.05 * normals(seed, 1, (D,), device)
    return base[None, :] + 1e-3 * normals(seed, 2, (K, D), device), base


def parse_alphas(spec: str) -> List[Tuple[str, Optional[float]]]:
    """``--alphas`` tokens -> ``[(label, alpha)]``; ``iid`` means no
    heterogeneity (``alpha=None``), anything else a positive Dirichlet
    concentration (lower = more heterogeneous)."""
    out: List[Tuple[str, Optional[float]]] = []
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if tok == "iid":
            out.append((tok, None))
            continue
        a = float(tok)
        if a <= 0:
            raise ValueError(f"--alphas entry must be positive, got {tok!r}")
        out.append((tok, a))
    if not out:
        raise ValueError("--alphas parsed to an empty list")
    return out


def make_hetero(alpha: Optional[float], seed: int = 0, *, classes: int = 8,
                scale: float = 5e-3, device="cpu") -> Optional[torch.Tensor]:
    """Per-client drift [K, D] for one Dirichlet level: client i's class
    mixture ``pi_i ~ Dir(alpha * 1)`` blends ``classes`` fixed class
    directions, and its drift is the mismatch between that blend and the
    uniform mixture.  Low alpha makes the mixtures near one-hot; ``None``
    (IID) returns None.  The loops add a per-iteration fluctuating
    magnitude on top, which the per-client EMA baseline cannot absorb."""
    if alpha is None:
        return None
    gam = gammas(seed, 7, float(alpha), (K, classes), device)
    pi = gam / torch.sum(gam, dim=1, keepdim=True)
    dirs = scale * normals(seed, 8, (classes, D), device)
    return pi @ dirs - torch.mean(dirs, dim=0)[None, :]


def _hetero_stack(w, hetero, seed, t):
    """The heterogeneous honest stack at iteration ``t``: the drift scaled
    by a half-normal magnitude around 1 per (client, iteration)."""
    if hetero is None:
        return w
    m = 1.0 + 0.5 * torch.abs(normals(seed, 400 + t, (K, 1), w.device))
    return w + m * hetero


def tuned_defense_params(params: Dict[str, float], n_rungs: int):
    """``(DetectorParams, PolicyParams)`` from a tune artifact's winning
    constants (key ``tuned.params``), by the JAX package's knob -> field
    maps."""
    def cast(k):
        return int(params[k]) if k in _INT_KNOBS else float(params[k])

    det = defense_lib.DetectorParams(**{
        field: cast(knob) for knob, field in _DETECTOR_KNOBS.items() if knob in params})
    pol = defense_lib.PolicyParams(n_rungs=n_rungs, **{
        field: cast(knob) for knob, field in _POLICY_KNOBS.items() if knob in params})
    return det, pol


def make_branches(ladder):
    """One closure per rung: ``fn(w, base, gen) -> [D] f32``, the rung's
    rule with the break-matrix's static knobs."""
    def branch(name):
        fn = AGGREGATORS.get(name)
        return lambda w, base, gen: fn(w, honest_size=HONEST, guess=base, generator=gen,
                                       maxiter=50, tol=1e-5, clip_iters=3).to(torch.float32)

    return [branch(n) for n in ladder]


def simulate_cell(
    attack_name: str,
    mode: str,
    **sim_kw,
) -> Dict[str, object]:
    """One (attack, mode) cell: the defense loop for ``iters`` iterations
    with the attack on during ``[onset, stop)``.  Reports the detection
    latency from onset (``detect_iter``), the suspicious iterations, the
    rung trajectory (max, final, transitions, ``min_rung_post``: the least
    rung after the max was first reached), whether the policy de-escalated
    after the attacker went quiet, the worst in-attack aggregate error
    (``agg_err``), the final aggregate's distance to the last stack's
    honest mean (``final_dist``), and the forensic columns against the
    cell's ground truth (rows ``[-B:]`` attack): ``precision``, ``recall``
    and ``time_to_detect``.  ``sim_kw`` are :func:`simulate_cells_batched`'s
    keywords."""
    return simulate_cells_batched(attack_name, [mode], **sim_kw)[mode]


def simulate_cells_batched(
    attack_name: str,
    modes: List[str],
    *,
    iters: int = 40,
    onset: int = 10,
    stop: Optional[int] = 30,
    ladder: Tuple[str, ...] = ("mean", "trimmed_mean", "multi_krum"),
    det: Optional[defense_lib.DetectorParams] = None,
    pol: Optional[defense_lib.PolicyParams] = None,
    seed: int = 0,
    hetero: Optional[torch.Tensor] = None,
    device: str = "cuda",
) -> Dict[str, Dict[str, object]]:
    """Every requested mode of one (attack, ladder) family from ONE pass
    over the iterations, the ``--batched`` path (JAX
    ``simulate_cells_batched``, ``adaptive_matrix.py:386``).  The
    aggregate never feeds back into the synthetic stack, so the
    detector/policy trajectory is the same for ``monitor`` and
    ``adaptive`` (and unused by ``off``): the pass runs it once, plus the
    rung-0 aggregate (off, monitor) and the live rung's (adaptive), each
    with the cell's own draws, and every mode's cell is read off the
    shared trajectory.  :func:`simulate_cell` is this pass for one mode,
    so a batched cell equals its eager one."""
    spec = attack_lib.resolve(attack_name)
    meta = spec.meta()
    out: Dict[str, Dict[str, object]] = {}
    run_modes = []
    for mode in modes:
        if mode == "off" and meta["defense_aware"]:
            out[mode] = skip(DEFENSE_AWARE_OFF_SKIP)
        elif meta["data_level"] and spec.grad_scale == 1.0:
            out[mode] = skip(DATA_LEVEL_SKIP)
        else:
            run_modes.append(mode)
    if not run_modes:
        return out
    dev = torch.device(device)
    det = det or defense_lib.DetectorParams()
    # min_flagged=2: a burst from the B=3 attackers flags all three, while a
    # lone honest z-spike must not count as suspicious
    pol = pol or defense_lib.PolicyParams(up_n=3, down_m=8, n_rungs=len(ladder),
                                          min_flagged=2)
    if attack_name.split("@")[0] == "duty_cycle":
        # the attack times itself: from 0, never stopping, two full periods
        on_p, period = attack_lib.duty_cycle_schedule(pol)
        onset, stop = 0, None
        iters = max(iters, 2 * period + on_p)
    branches = make_branches(ladder)
    _, base = honest_stack(seed, dev)
    if hetero is not None:
        hetero = hetero.to(dev)
    detect = any(m != "off" for m in run_modes)
    # the aggregates each mode reads: rung 0's (off, monitor), the live
    # rung's (adaptive)
    kinds = sorted({"live" if m == "adaptive" else "rung0" for m in run_modes})
    d_state = defense_lib.init_detector(K, dev)
    p_state = defense_lib.init_policy(dev)
    rungs, susp_t, flags_t = [], [], []
    err = {k: None for k in kinds}
    dist = dict(err)
    for t in range(iters):
        w = base[None, :] + 1e-3 * normals(seed, 100 + t, (K, D), dev)
        w = _hetero_stack(w, hetero, seed, t)
        active = onset <= t and (stop is None or t < stop)
        if active:
            d_view = None
            if meta["defense_aware"]:
                d_view = attack_lib.DefenseView(
                    step=d_state[0], ema=d_state[1], dev=d_state[2], cusum=d_state[3],
                    rung=p_state[0], detector=det, policy=pol, guess=base)
            w = attacked(spec, w, base, generator(seed, 200 + t, dev), defense=d_view)
        rung = 0
        if detect:
            score, finite = defense_lib.client_scores(w, base)
            d_state, flags = defense_lib.detector_update(d_state, score, finite, det)
            p_state, susp = defense_lib.policy_update(p_state, torch.sum(flags), pol)
            rung = int(p_state[0])
            susp_t.append(bool(susp))
            flags_t.append(flags.tolist())
        rungs.append(rung)
        aggs = {}
        for kind in kinds:
            r = rung if kind == "live" else 0
            if r not in aggs:
                # each aggregate from the cell's own draws of iteration t
                aggs[r] = branches[r](w, base, generator(seed, 300 + t, dev))
            agg = aggs[r]
            if active:
                err[kind] = float(torch.linalg.vector_norm(agg - base))
            if t == iters - 1:
                dist[kind] = float(torch.linalg.vector_norm(
                    agg - torch.mean(w[:HONEST], dim=0)))
    # the confusion ledger against the cell's ground truth (mode-independent)
    detect_iter = time_to_detect = None
    tp = fp = 0
    detected_rows: set = set()
    for t, flags in enumerate(flags_t):
        active = onset <= t and (stop is None or t < stop)
        if detect_iter is None and active and sum(flags) > 0:
            detect_iter = t - onset
        byz_hits = [K - B + i for i in range(B) if flags[K - B + i]]
        fp += sum(flags[:HONEST])
        if active:
            tp += len(byz_hits)
            detected_rows.update(byz_hits)
            if byz_hits and time_to_detect is None:
                time_to_detect = t - onset
        else:
            fp += len(byz_hits)
    n_flags = tp + fp
    for mode in run_modes:
        rt = [0] * iters if mode == "off" else rungs
        max_rung = transitions = prev_rung = rung_at_stop = 0
        max_seen_at = min_rung_post = None
        for t, rung in enumerate(rt):
            if rung > max_rung:
                max_rung, max_seen_at = rung, t
            transitions += int(rung != prev_rung)
            prev_rung = rung
            if stop is not None and t == stop - 1:
                rung_at_stop = rung
            if max_seen_at is not None and t > max_seen_at:
                min_rung_post = rung if min_rung_post is None else min(min_rung_post, rung)
        kind = "live" if mode == "adaptive" else "rung0"
        on = mode != "off"
        cell: Dict[str, object] = {
            "detect_iter": detect_iter if on else None,
            "precision": round(tp / n_flags, 5) if (on and n_flags) else None,
            "recall": round(len(detected_rows) / B, 5) if on else None,
            "time_to_detect": time_to_detect if on else None,
            "rounds_suspicious": sum(susp_t) if on else 0,
            "max_rung": max_rung,
            "min_rung_post": min_rung_post,
            "final_rung": rt[-1],
            "transitions": transitions,
            "deescalated": stop is not None and rt[-1] < rung_at_stop,
            "final_dist": round(dist[kind], 5),
        }
        if err[kind] is not None:
            cell["agg_err"] = round(err[kind], 5)
        out[mode] = cell
    return out


def run_matrix(
    attacks: List[str],
    modes: List[str],
    ladders: Optional[List[Tuple[str, ...]]] = None,
    log=lambda s: print(s, file=sys.stderr, flush=True),
    on_cell=None,
    batched: bool = False,
    **sim_kw,
) -> Dict[Cell, Dict[str, object]]:
    """The matrix over ladders x modes x attacks.  ``batched`` runs every
    mode of an (attack, ladder) family from one pass
    (:func:`simulate_cells_batched`); the cells equal the per-cell loop's."""
    for a in attacks:
        attack_lib.resolve(a)  # fail fast on typos (onset syntax included)
    if ladders is None:
        ladders = [sim_kw.pop("ladder", ("mean", "trimmed_mean", "multi_krum"))]
    else:
        sim_kw.pop("ladder", None)
    for m in modes:
        if m not in MODES:
            raise ValueError(f"unknown mode {m!r}; pick from {MODES}")
    grid: Dict[Cell, Dict[str, object]] = {}
    for lad in ladders:
        lad_name = ",".join(lad)
        if batched:
            # one pass per (attack, ladder); every mode from its trajectory
            for attack in attacks:
                cells = simulate_cells_batched(attack, modes, ladder=lad, **sim_kw)
                for mode in modes:
                    grid[(attack, mode, lad_name)] = cells[mode]
                    log(f"[adaptive_matrix] attack={attack} mode={mode} ladder={lad_name}: "
                        f"{cells[mode]}")
                    if on_cell is not None:
                        on_cell(attack, mode, lad_name, cells[mode])
            continue
        for mode in modes:
            for attack in attacks:
                cell = simulate_cell(attack, mode, ladder=lad, **sim_kw)
                grid[(attack, mode, lad_name)] = cell
                log(f"[adaptive_matrix] attack={attack} mode={mode} ladder={lad_name}: {cell}")
                if on_cell is not None:
                    on_cell(attack, mode, lad_name, cell)
    return grid


def run_cube(
    attacks: List[str],
    modes: List[str],
    ladders: List[Tuple[str, ...]],
    alphas: List[Tuple[str, Optional[float]]],
    tuned: Dict[str, Dict[str, float]],
    *,
    hetero_scale: float = 5e-3,
    hetero_classes: int = 8,
    log=lambda s: print(s, file=sys.stderr, flush=True),
    on_cell=None,
    batched: bool = False,
    **sim_kw,
) -> Dict[CubeCell, Dict[str, object]]:
    """The heterogeneity x attack x defense cube: the matrix over Dirichlet
    levels and constant variants.  Every level runs the ``default``
    constants; a level named in ``tuned`` runs the ``tuned`` ones too.  Keys
    are ``(attack, mode, ladder, "alpha=<label>", "default"|"tuned")``."""
    unknown = sorted(set(tuned) - {lab for lab, _ in alphas})
    if unknown:
        raise ValueError(
            f"--tuned labels {unknown} not in the --alphas sweep "
            f"({[lab for lab, _ in alphas]})")
    n_rungs = {len(lad) for lad in ladders}
    if len(n_rungs) != 1:
        raise ValueError(f"ladder variants must share a length: {sorted(n_rungs)}")
    n_rungs = n_rungs.pop()
    seed = int(sim_kw.get("seed", 0))
    grid: Dict[CubeCell, Dict[str, object]] = {}
    for label, alpha in alphas:
        hetero = make_hetero(alpha, seed, classes=hetero_classes, scale=hetero_scale,
                             device=sim_kw.get("device", "cuda"))
        variants = [("default", sim_kw.get("det"), sim_kw.get("pol"))]
        if label in tuned:
            det_t, pol_t = tuned_defense_params(tuned[label], n_rungs)
            variants.append(("tuned", det_t, pol_t))
        for vname, det_v, pol_v in variants:
            log(f"[adaptive_matrix] cube slice alpha={label} constants={vname}")
            sub = run_matrix(
                attacks, modes, ladders=ladders, log=log, batched=batched,
                on_cell=(None if on_cell is None else
                         lambda a, m, l, c, _lab=label, _v=vname: on_cell(a, m, l, _lab, _v, c)),
                **dict(sim_kw, det=det_v, pol=pol_v, hetero=hetero),
            )
            for (a, m, lad), cell in sub.items():
                grid[(a, m, lad, f"alpha={label}", vname)] = cell
    return grid


def markdown_table(grid: Dict[Cell, Dict[str, object]]) -> str:
    """One ``attack x metric`` table per (mode, ladder); an undetected cell
    shows ``-`` as its latency, a skipped cell says so."""
    groups = sorted({(m, l) for _, m, l in grid})
    attacks = sorted({a for a, _, _ in grid})
    blocks = []
    for m, lad in groups:
        head = (f"**mode: {m} | ladder: {lad}**\n\n| attack | detect_lat | prec | rec | "
                "ttd | susp | max_rung | min_post | final_rung | deesc | final_dist |")
        sep = "|---|---|---|---|---|---|---|---|---|---|---|"
        rows = []
        for a in attacks:
            c = grid[(a, m, lad)]
            if "skipped" in c:
                rows.append(f"| {a} | skipped | | | | | | | | | |")
                continue
            lat = "-" if c["detect_iter"] is None else str(c["detect_iter"])
            prec = "-" if c.get("precision") is None else f"{c['precision']:.2f}"
            rec = "-" if c.get("recall") is None else f"{c['recall']:.2f}"
            ttd = "-" if c.get("time_to_detect") is None else str(c["time_to_detect"])
            post = "-" if c["min_rung_post"] is None else str(c["min_rung_post"])
            rows.append(
                f"| {a} | {lat} | {prec} | {rec} | {ttd} | {c['rounds_suspicious']} | "
                f"{c['max_rung']} | {post} | {c['final_rung']} | {c['deescalated']} | "
                f"{c['final_dist']} |")
        blocks.append("\n".join([head, sep] + rows))
    return "\n\n".join(blocks)


def assert_smoke(grid: Dict[Cell, Dict[str, object]]) -> None:
    """The gate of ``--assert-smoke``: the defense-aware tier ran, one of
    its adaptive-mode cells detected, and every duty_cycle adaptive cell
    stayed escalated between bursts."""
    aware = [(k, c) for k, c in grid.items()
             if k[1] == "adaptive" and "skipped" not in c
             and attack_lib.resolve(k[0]).meta()["defense_aware"]]
    if not aware:
        raise SystemExit("[adaptive_matrix] smoke: no defense-aware adaptive cells ran")
    if not any(c["detect_iter"] is not None for _, c in aware):
        raise SystemExit(
            "[adaptive_matrix] smoke: no defense-aware attack was ever detected in "
            "adaptive mode — the detector lost every cell")
    duty = [c for (a, m, _), c in grid.items()
            if a.split("@")[0] == "duty_cycle" and m == "adaptive"]
    if not duty:
        raise SystemExit(
            "[adaptive_matrix] smoke: no duty_cycle adaptive cell in the grid (pass "
            "--attacks including duty_cycle)")
    for c in duty:
        if c.get("min_rung_post") is None or c["min_rung_post"] < 1:
            raise SystemExit(
                f"[adaptive_matrix] smoke: duty_cycle cell fully de-escalated between "
                f"bursts ({c}) — the hysteresis floor regressed")
    print("[adaptive_matrix] smoke assertions passed", file=sys.stderr)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--attacks", default=None,
                    help="comma list; default: every registered attack")
    ap.add_argument("--modes", default="off,monitor,adaptive")
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--onset", type=int, default=10, help="iteration the attack switches on")
    ap.add_argument("--stop", type=int, default=30,
                    help="iteration the attack switches off (-1: never)")
    ap.add_argument("--ladder", default="mean,trimmed_mean,multi_krum")
    ap.add_argument("--ladders", default=None,
                    help="semicolon-separated ladder variants (each a comma list); "
                         "overrides --ladder")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of every cell's streams; cells are a pure function of "
                         "(flags, seed)")
    ap.add_argument("--floor", type=float, default=1.5,
                    help="policy floor_thresh (0 = the seed hysteresis)")
    ap.add_argument("--leak", type=float, default=0.005, help="policy budget_leak")
    ap.add_argument("--alphas", default=None,
                    help="comma list of Dirichlet levels ('iid' or a positive float): "
                         "the hetero x attack x defense cube, with 5-part keys")
    ap.add_argument("--hetero-scale", type=float, default=5e-3)
    ap.add_argument("--hetero-classes", type=int, default=8)
    ap.add_argument("--tuned", default=None,
                    help="comma list label=path of tune artifacts; those --alphas levels "
                         "also run the artifact's tuned constants")
    ap.add_argument("--out", default=None, help="pickle the grid here")
    ap.add_argument("--json", default=None, help="canonical sorted JSON dump here")
    ap.add_argument("--obs-dir", default=None, help="also append adaptive_cell events here")
    ap.add_argument("--assert-smoke", action="store_true",
                    help="exit nonzero unless a defense-aware cell detects and "
                         "duty_cycle stays escalated")
    ap.add_argument("--batched", action="store_true",
                    help="every mode of an (attack, ladder) family from one pass "
                         "(simulate_cells_batched)")
    ap.add_argument("--expect-speedup", type=float, default=None,
                    help="with --batched: also time the per-cell loop and exit nonzero "
                         "unless batched is at least this many times faster")
    ap.add_argument("--perf-row", default=None, metavar="PATH",
                    help="with --batched: write a matrix_wallclock perf row here (value "
                         "= eager/batched wall-clock ratio)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if (args.expect_speedup is not None or args.perf_row) and not args.batched:
        ap.error("--expect-speedup/--perf-row require --batched")
    if args.alphas and (args.assert_smoke or args.expect_speedup or args.perf_row):
        ap.error("--assert-smoke/--expect-speedup/--perf-row gate the plain matrix; "
                 "run them without --alphas")
    if args.tuned and not args.alphas:
        ap.error("--tuned requires --alphas (it names levels of the sweep)")

    attacks = ([a for a in args.attacks.split(",") if a] if args.attacks
               else sorted(ATTACKS.names()))
    modes = [m for m in args.modes.split(",") if m]
    ladders = [tuple(n for n in lad.split(",") if n)
               for lad in (args.ladders or args.ladder).split(";") if lad]
    n_rungs = {len(lad) for lad in ladders}
    if len(n_rungs) != 1:
        raise SystemExit(
            "[adaptive_matrix] ladder variants must share a length (the policy is sized "
            f"once per run): {sorted(n_rungs)}")
    pol = defense_lib.PolicyParams(up_n=3, down_m=8, n_rungs=n_rungs.pop(), min_flagged=2,
                                   budget_leak=args.leak, floor_thresh=args.floor)
    sim_kw = dict(iters=args.iters, onset=args.onset,
                  stop=None if args.stop < 0 else args.stop, pol=pol, seed=args.seed,
                  device=args.device)
    alphas = parse_alphas(args.alphas) if args.alphas else None
    tuned: Dict[str, Dict[str, float]] = {}
    for item in (args.tuned or "").split(","):
        if not item:
            continue
        label, _, path = item.partition("=")
        if not path:
            ap.error(f"--tuned entry {item!r} is not label=path")
        with open(path) as f:
            tuned[label.strip()] = json.load(f)["tuned"]["params"]
    sinks = [obs_lib.StdoutSink()]
    if args.obs_dir:
        sinks.append(obs_lib.JsonlSink(obs_lib.events_path(args.obs_dir, "adaptive_matrix")))
    sink = obs_lib.MultiSink(sinks) if len(sinks) > 1 else sinks[0]
    t0 = time.perf_counter()
    try:
        if alphas is not None:
            grid = run_cube(
                attacks, modes, ladders, alphas, tuned, hetero_scale=args.hetero_scale,
                hetero_classes=args.hetero_classes, batched=args.batched,
                on_cell=lambda attack, mode, lad, alabel, var, cell: sink.emit(
                    obs_lib.make_event("adaptive_cell", attack=attack, mode=mode,
                                       ladder=lad, alpha=alabel, constants=var, **cell)),
                **sim_kw)
        else:
            grid = run_matrix(
                attacks, modes, ladders=ladders, batched=args.batched,
                on_cell=lambda attack, mode, lad, cell: sink.emit(obs_lib.make_event(
                    "adaptive_cell", attack=attack, mode=mode, ladder=lad, **cell)),
                **sim_kw)
    finally:
        sink.close()
    primary_secs = time.perf_counter() - t0
    wallclock = None
    if args.expect_speedup is not None or args.perf_row:
        # the reference timing: the per-cell loop over the same grid (no
        # events, no log: the batched pass above emitted them)
        t0 = time.perf_counter()
        eager_grid = run_matrix(attacks, modes, ladders=ladders, batched=False,
                                log=lambda s: None, **sim_kw)
        eager_secs = time.perf_counter() - t0
        speedup = eager_secs / max(primary_secs, 1e-9)
        wallclock = {"batched_secs": round(primary_secs, 3),
                     "eager_secs": round(eager_secs, 3), "speedup": round(speedup, 3)}
        print(f"[adaptive_matrix] wall-clock: eager {eager_secs:.2f}s / batched "
              f"{primary_secs:.2f}s = {speedup:.2f}x", file=sys.stderr, flush=True)
        drift = [(k, col) for k, cell in grid.items()
                 for col in ("detect_iter", "time_to_detect", "rounds_suspicious", "max_rung",
                             "min_rung_post", "final_rung", "transitions", "deescalated",
                             "recall")
                 if cell.get(col) != eager_grid[k].get(col)]
        if drift:
            print(f"[adaptive_matrix] WARNING: batched/eager drift on {len(drift)} integer "
                  f"column(s): {drift[:5]}", file=sys.stderr)
    if alphas is not None:
        # one table block per cube slice, in sweep order
        for label, _alpha in alphas:
            for var in ("default", "tuned"):
                sub = {(a, m, lad): c for (a, m, lad, alab, v), c in grid.items()
                       if alab == f"alpha={label}" and v == var}
                if sub:
                    print(f"\n## alpha={label} | constants: {var}\n", file=sys.stderr)
                    print(markdown_table(sub), file=sys.stderr, flush=True)
    else:
        print(markdown_table(grid), file=sys.stderr, flush=True)
    if args.out:
        io_lib.atomic_pickle(args.out, {"|".join(k): c for k, c in grid.items()})
        print(f"[adaptive_matrix] grid pickled to {args.out}", file=sys.stderr)
    if args.json:
        dump = {"|".join(k): c for k, c in grid.items()}
        if wallclock is not None:
            # the one clock-dependent key, absent in the default invocation
            dump["_wallclock"] = wallclock
        with open(args.json, "w") as f:
            json.dump(dump, f, sort_keys=True, indent=1)
            f.write("\n")
        print(f"[adaptive_matrix] grid dumped to {args.json}", file=sys.stderr)
    if args.perf_row:
        row = {"metric": "matrix_wallclock", "value": wallclock["speedup"], "unit": "x",
               "platform": args.device,
               "note": "eager/batched wall-clock ratio (adaptive_matrix)"}
        with open(args.perf_row, "w") as f:
            json.dump(row, f, indent=1)
            f.write("\n")
        print(f"[adaptive_matrix] perf row written to {args.perf_row}", file=sys.stderr)
    if args.expect_speedup is not None and wallclock["speedup"] < args.expect_speedup:
        raise SystemExit(
            f"[adaptive_matrix] batched speedup {wallclock['speedup']}x below the "
            f"--expect-speedup {args.expect_speedup}x bar")
    if args.assert_smoke:
        assert_smoke(grid)


if __name__ == "__main__":
    main()
