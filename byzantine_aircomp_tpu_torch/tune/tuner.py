"""ASHA-style successive halving over the lanes (the port of
``byzantine_aircomp_tpu/tune/tuner.py``).

One tuner *generation* is ONE :class:`serve.batch.BatchRunner`: every
surviving candidate contributes a paired (attacked, benign) lane — same
seed, same knob constants, the benign twin distinguished only by pinning
its attack-onset iteration counter far negative so the attack never
activates (``ops/attacks.AttackSpec.onset_round``: pre-onset Byzantine
rows are bit-identical to honest ones).  In the port the pin is a write
of the benign lane's own onset counter (``Trainer.attack_iter``).  All
lanes ride one group, one ``batch_round_fn`` build; candidate constants
are per-lane data (``BATCHABLE_KNOBS``), so a 16-candidate generation
builds exactly once — the property the retrace gate pins (lowerings ==
generations).

Durability: every generation boundary is journaled (append-one-line
JSONL, the ``serve/journal.py`` idiom — torn tails tolerated).  Because
candidate sampling is a pure function of ``(space, population, seed)``
and the rounds are deterministic (every stream derives from (seed,
round, iteration)), a SIGKILLed tune resumed from the journal
reproduces the uninterrupted tune bit-identically: completed
generations restore their recorded scores, a half-finished generation
re-runs from its recorded candidate set and lands on the same floats.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import threading
from typing import Any, Callable, Dict, List, Optional

import torch

from .. import obs as obs_lib
from ..fed.config import FedConfig
from ..serve.batch import BatchRunner
from ..utils import io as io_lib
from . import objective as objective_lib
from . import space as space_lib

#: the benign-lane pin for the attack-onset iteration counter (carry
#: slot 5): far enough below zero that no realistic horizon's +1 per
#: iteration ever reaches the onset threshold, comfortably inside int32
BENIGN_PIN = -(2 ** 30)


class TuneJournal:
    """Append-only generation journal: one JSON line per state change,
    fsync-per-line durability via the shared ``io.open_append`` helper,
    torn-tail-tolerant replay (a killed append truncates at worst its
    own line — ``iter_jsonl`` skips it)."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._lock = threading.Lock()
        self._fh = None

    def append(self, record: Dict[str, Any]) -> None:
        with self._lock:
            if self._fh is None:
                parent = os.path.dirname(self.path)
                if parent:
                    os.makedirs(parent, exist_ok=True)
                self._fh = io_lib.open_append(self.path)
            self._fh.write(json.dumps(record, sort_keys=True) + "\n")
            self._fh.flush()
            os.fsync(self._fh.fileno())

    def replay(self) -> List[Dict[str, Any]]:
        if not os.path.exists(self.path):
            return []
        return [r for r in io_lib.iter_jsonl(self.path) if "op" in r]

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


class Tuner:
    """Successive-halving defense tuner over one base config.

    ``base_cfg`` must carry an onset attack (``<name>@<round>``), a
    defense, and ``forensics`` on — the tuner validates rather than
    silently fixing, because those choices are part of what the tuned
    constants mean.  ``journal_path=None`` runs without durability (the
    unit-test / throwaway mode)."""

    def __init__(
        self,
        base_cfg: FedConfig,
        space: Optional[space_lib.SearchSpace] = None,
        *,
        population: int = 8,
        generations: int = 3,
        base_rounds: int = 8,
        eta: int = 2,
        seed: int = 0,
        journal_path: Optional[str] = None,
        obs: obs_lib.Observability = obs_lib.NULL,
        dataset=None,
        backend: str = "vmap",
        device: Optional[str] = None,
        ff_penalty: float = objective_lib.DEFAULT_FF_PENALTY,
        ttd_weight: float = objective_lib.DEFAULT_TTD_WEIGHT,
        log: Optional[Callable[[str], None]] = None,
    ) -> None:
        if base_cfg.attack is None or "@" not in str(base_cfg.attack):
            raise ValueError(
                "tuner base config needs an onset attack ('<name>@<round>') "
                "— the paired benign lane is carved out of the onset gate"
            )
        if base_cfg.defense == "off":
            raise ValueError("tuner base config needs --defense != off")
        if base_cfg.forensics == "off":
            raise ValueError(
                "tuner base config needs forensics on (the objective folds "
                "the client_flag stream)"
            )
        self.base_cfg = base_cfg
        self.space = dict(space if space is not None else
                          space_lib.DEFAULT_SPACE)
        space_lib.validate_space(self.space)
        self.population = int(population)
        self.generations = int(generations)
        self.base_rounds = int(base_rounds)
        self.eta = int(eta)
        self.seed = int(seed)
        self.obs = obs
        self.ff_penalty = float(ff_penalty)
        self.ttd_weight = float(ttd_weight)
        self.backend = backend
        self.device = device or ("cuda" if base_cfg.use_gpu else "cpu")
        self.log = log or (lambda s: None)
        self.journal = TuneJournal(journal_path) if journal_path else None
        #: ONE retrace detector across every generation: the CI gate reads
        #: ``lowerings`` at the end and asserts it equals generations run
        self.retrace = obs_lib.RetraceDetector()
        if dataset is None:
            from ..data import datasets as data_lib

            dataset = data_lib.load(base_cfg.dataset)
        self.dataset = dataset
        self.candidates = space_lib.sample_candidates(
            self.space, self.population, self.seed
        )
        #: per-generation trail: [{gen, rounds, scored: {idx: fold},
        #: survivors: [idx]}]
        self.trail: List[Dict[str, Any]] = []

    # ------------------------------------------------------------ plumbing

    @property
    def lowerings(self) -> int:
        return self.retrace.count("batch_round_fn")

    def _signature(self) -> Dict[str, Any]:
        """What a resumed tune must agree on — recorded at tune_start,
        asserted on resume so a journal can never silently mix runs."""
        return {
            "space": {k: list(v) for k, v in sorted(self.space.items())},
            "population": self.population,
            "generations": self.generations,
            "base_rounds": self.base_rounds,
            "eta": self.eta,
            "seed": self.seed,
            "attack": self.base_cfg.attack,
            "defense": self.base_cfg.defense,
            "partition": self.base_cfg.partition,
            "dirichlet_alpha": (
                self.base_cfg.dirichlet_alpha
                if self.base_cfg.partition == "dirichlet" else None
            ),
            "k": self.base_cfg.node_size,
            "byz": self.base_cfg.byz_size,
            "cfg_seed": self.base_cfg.seed,
        }

    def _lane_cfgs(self, params: Dict[str, float], rounds: int):
        """One candidate's (attacked, benign) lane configs: identical —
        the benign twin is made benign by the carry pin, not the cfg, so
        the pair shares every traced constant."""
        cfg = space_lib.apply_params(self.base_cfg, params)
        cfg.rounds = rounds
        return [cfg, copy.copy(cfg)]

    def _run_generation(
        self, gen: int, cand_idx: List[int], rounds: int
    ) -> Dict[int, Dict[str, Any]]:
        """Run one generation's candidates as paired lanes of ONE
        BatchRunner; returns {candidate index: objective fold}."""
        cfgs = []
        for idx in cand_idx:
            cfgs.extend(self._lane_cfgs(self.candidates[idx], rounds))
        runner = BatchRunner(
            cfgs, dataset=self.dataset, retrace=self.retrace,
            backend=self.backend, device=self.device,
        )
        # benign twins: pin the lane's attack-onset counter far negative —
        # a write of that lane's own state, so the generation still builds
        # exactly once
        for lane in range(1, runner.n, 2):
            t = runner.trainers[lane]
            t.attack_iter = torch.full_like(t.attack_iter, BENIGN_PIN)

        k = self.base_cfg.node_size
        byz = self.base_cfg.byz_size
        sinks = [obs_lib.MemorySink() for _ in range(runner.n)]
        obs_list = [obs_lib.Observability(s) for s in sinks]
        for lane, o in enumerate(obs_list):
            attacked = lane % 2 == 0
            o.emit(
                "run_start",
                title=f"tune_g{gen}_cand{cand_idx[lane // 2]}"
                      f"_{'attacked' if attacked else 'benign'}",
                backend="tune",
                rounds=rounds,
                start_round=0,
                k=k,
                byz=byz,
                # the explicit id set the audit pins on (last-byz resident
                # slots — the trainer's static mask); the benign twin's
                # header says byz too: its "byzantine" clients exist but
                # never activate, which is exactly why any flag there is
                # a false one
                byz_ids=list(range(k - byz, k)),
                agg=self.base_cfg.agg,
                attack=self.base_cfg.attack if attacked else None,
                defense=self.base_cfg.defense,
                seed=self.base_cfg.seed,
            )
        runner.train(obs_list=obs_list, log_fn=self.log)
        if runner.failed:
            raise RuntimeError(
                f"tune generation {gen}: lanes quarantined: {runner.failed}"
            )
        out: Dict[int, Dict[str, Any]] = {}
        for j, idx in enumerate(cand_idx):
            fold = objective_lib.fold_pair(
                sinks[2 * j].events, sinks[2 * j + 1].events,
                k=k, rounds=rounds,
                ff_penalty=self.ff_penalty, ttd_weight=self.ttd_weight,
            )
            out[idx] = fold
            self.obs.emit(
                "tune_candidate",
                gen=gen,
                candidate=idx,
                objective=fold["objective"],
                precision=fold["precision"],
                recall=fold["recall"],
                time_to_detect=fold["time_to_detect"],
                benign_flag_rate=fold["benign_flag_rate"],
                params=self.candidates[idx],
            )
        return out

    # ------------------------------------------------------------ the loop

    def run(self) -> Dict[str, Any]:
        """Drive the halving schedule to completion (resuming from the
        journal when one is attached); returns the result dict the
        tune artifacts (``--out``) persist."""
        plan = space_lib.halving_schedule(
            self.population, self.generations, self.base_rounds, self.eta
        )
        done: Dict[int, Dict[str, Any]] = {}
        if self.journal is not None:
            records = self.journal.replay()
            starts = [r for r in records if r["op"] == "tune_start"]
            if starts:
                if starts[0]["signature"] != self._signature():
                    raise ValueError(
                        f"tune journal {self.journal.path} was written by a "
                        f"different tune configuration; refusing to resume"
                    )
            else:
                self.journal.append(
                    {"op": "tune_start", "signature": self._signature()}
                )
            for r in records:
                if r["op"] == "gen_done":
                    done[int(r["gen"])] = r

        alive = list(range(self.population))
        last_scores: Dict[int, Dict[str, Any]] = {}
        for gen, (count, rounds) in enumerate(plan):
            cand_idx = alive[:count]
            if gen in done:
                # completed before the kill: restore the recorded scores
                # (bit-identical by determinism — the journal is the proof
                # of work, not an approximation)
                rec = done[gen]
                scored = {
                    int(i): fold for i, fold in rec["scored"].items()
                }
                alive = [int(i) for i in rec["survivors"]]
                last_scores = scored
                self.trail.append({
                    "gen": gen, "rounds": rounds,
                    "candidates": [int(i) for i in rec["candidates"]],
                    "scored": scored, "survivors": list(alive),
                    "resumed": True,
                })
                self.log(f"[tune] gen {gen}: restored from journal")
                continue
            if self.journal is not None:
                self.journal.append({
                    "op": "gen_start", "gen": gen, "rounds": rounds,
                    "candidates": cand_idx,
                })
            scored = self._run_generation(gen, cand_idx, rounds)
            keep = plan[gen + 1][0] if gen + 1 < len(plan) else 1
            order = space_lib.survivors(
                [scored[i]["objective"] for i in cand_idx], keep
            )
            alive = [cand_idx[j] for j in order]
            last_scores = scored
            self.trail.append({
                "gen": gen, "rounds": rounds, "candidates": list(cand_idx),
                "scored": scored, "survivors": list(alive),
                "resumed": False,
            })
            self.obs.emit(
                "tune_generation",
                gen=gen,
                population=len(cand_idx),
                rounds=rounds,
                survivors=len(alive),
            )
            if self.journal is not None:
                self.journal.append({
                    "op": "gen_done", "gen": gen, "rounds": rounds,
                    "candidates": cand_idx,
                    "scored": {str(i): scored[i] for i in cand_idx},
                    "survivors": alive,
                })
            self.log(
                f"[tune] gen {gen}: {len(cand_idx)} candidates x "
                f"{rounds} rounds -> survivors {alive} "
                f"(lowerings={self.lowerings})"
            )

        # the winner among the FINAL generation's scores; candidate 0 (the
        # IID defaults) rode every generation as the protected control, so
        # the comparison is at equal budget
        final_idx = max(
            last_scores, key=lambda i: (last_scores[i]["objective"], -i)
        )
        result = {
            "signature": self._signature(),
            "schedule": [
                {"gen": g, "candidates": c, "rounds": r}
                for g, ((c, r)) in enumerate(plan)
            ],
            "default": {
                "params": self.candidates[0],
                **(last_scores.get(0) or {}),
            },
            "tuned": {
                "candidate": final_idx,
                "params": self.candidates[final_idx],
                **last_scores[final_idx],
            },
            "trail": self.trail,
            "lowerings": self.lowerings,
        }
        self.obs.emit(
            "tune_result",
            generations=len(plan),
            objective=last_scores[final_idx]["objective"],
            params=self.candidates[final_idx],
            candidate=final_idx,
        )
        if self.journal is not None:
            self.journal.append({
                "op": "tune_done",
                "candidate": final_idx,
                "params": self.candidates[final_idx],
                "objective": last_scores[final_idx]["objective"],
            })
            self.journal.close()
        return result


# --------------------------------------------------------------------------
# CLI: ``python -m byzantine_aircomp_tpu_torch tune``
# --------------------------------------------------------------------------


def build_base_cfg(args) -> FedConfig:
    cfg = FedConfig()
    cfg.honest_size = args.k - args.b
    cfg.byz_size = args.b
    cfg.dataset = args.dataset
    cfg.model = args.model
    cfg.batch_size = args.batch_size
    cfg.gamma = args.gamma
    cfg.display_interval = args.interval
    cfg.seed = args.cfg_seed
    cfg.attack = f"{args.attack}@{args.onset}"
    cfg.agg = args.agg
    cfg.defense = args.defense
    cfg.defense_ladder = args.ladder
    cfg.forensics = "top"
    cfg.forensics_top = min(8, args.k)
    cfg.eval_train = False
    if args.alpha != "iid":
        cfg.partition = "dirichlet"
        cfg.dirichlet_alpha = float(args.alpha)
    if args.size_skew != "none":
        cfg.size_skew = args.size_skew
    cfg.rounds = 1  # per-generation budgets overwrite this
    cfg.use_gpu = args.device == "cuda"
    cfg.validate()
    return cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        "byzantine_aircomp_tpu_torch tune",
        description="population-based defense auto-tuner (successive "
        "halving over the lanes of one group per generation)",
    )
    ap.add_argument("--alpha", type=str, default="iid",
                    help="heterogeneity level: 'iid' (contiguous split) or "
                         "a Dirichlet concentration (e.g. 0.3, 0.1)")
    ap.add_argument("--size-skew", type=str, default="none",
                    help="per-client quantity skew ('zipf:<s>'), composed "
                         "with the label skew")
    ap.add_argument("--population", type=int, default=8)
    ap.add_argument("--generations", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=8,
                    help="generation-0 round budget (doubles per rung)")
    ap.add_argument("--eta", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0,
                    help="candidate-sampling seed")
    ap.add_argument("--cfg-seed", type=int, default=2021,
                    help="the lanes' training seed")
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--b", type=int, default=3)
    ap.add_argument("--attack", type=str, default="signflip")
    ap.add_argument("--onset", type=int, default=2,
                    help="attack onset round (benign lanes never reach it)")
    ap.add_argument("--agg", type=str, default="mean")
    ap.add_argument("--defense", type=str, default="adaptive")
    ap.add_argument("--ladder", type=str,
                    default="mean,trimmed_mean,multi_krum")
    ap.add_argument("--dataset", type=str, default="mnist_hard")
    ap.add_argument("--model", type=str, default="MLP")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--gamma", type=float, default=1e-2)
    ap.add_argument("--interval", type=int, default=2,
                    help="iterations per round (displayInterval)")
    ap.add_argument("--synthetic-train", type=int, default=8192)
    ap.add_argument("--synthetic-val", type=int, default=1024)
    ap.add_argument("--ff-penalty", type=float,
                    default=objective_lib.DEFAULT_FF_PENALTY)
    ap.add_argument("--ttd-weight", type=float,
                    default=objective_lib.DEFAULT_TTD_WEIGHT)
    ap.add_argument("--backend", choices=["vmap", "map"], default="vmap",
                    help="the lanes' backend; both run the lanes in turn")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default; fails without a GPU) or cpu")
    ap.add_argument("--journal", type=str, default="",
                    help="tune journal path (enables SIGKILL resume)")
    ap.add_argument("--obs-dir", type=str, default="",
                    help="write the tuner's event stream here")
    ap.add_argument("--out", type=str, default="",
                    help="write the result artifact JSON here")
    ap.add_argument("--assert-single-lowering", action="store_true",
                    help="exit 1 unless lowerings (batch_round_fn builds) == "
                         "generations run live")
    ap.add_argument("--assert-winner-at-least-default", action="store_true",
                    help="exit 1 unless the winner's objective >= the "
                         "IID-default control lane's (CI smoke gate)")
    args = ap.parse_args(argv)

    from ..data import datasets as data_lib

    dataset = data_lib.load(
        args.dataset,
        synthetic_train=args.synthetic_train,
        synthetic_val=args.synthetic_val,
    )
    base_cfg = build_base_cfg(args)
    obs = obs_lib.NULL
    if args.obs_dir:
        os.makedirs(args.obs_dir, exist_ok=True)
        sink = obs_lib.JsonlSink(
            os.path.join(args.obs_dir, f"tune_{args.alpha}.events.jsonl")
        )
        obs = obs_lib.Observability(sink)
    tuner = Tuner(
        base_cfg,
        population=args.population,
        generations=args.generations,
        base_rounds=args.rounds,
        eta=args.eta,
        seed=args.seed,
        journal_path=args.journal or None,
        obs=obs,
        dataset=dataset,
        backend=args.backend,
        device=args.device,
        ff_penalty=args.ff_penalty,
        ttd_weight=args.ttd_weight,
        log=lambda s: print(s, flush=True),
    )
    result = tuner.run()
    result["alpha"] = args.alpha
    live_gens = sum(1 for t in tuner.trail if not t["resumed"])
    print(
        f"tune done: winner candidate {result['tuned']['candidate']} "
        f"objective={result['tuned']['objective']:.4f} "
        f"(default {result['default'].get('objective', float('nan')):.4f}) "
        f"benign_ff={result['tuned']['benign_flag_rate']:.4f} "
        f"(default {result['default'].get('benign_flag_rate', float('nan')):.4f}) "
        f"lowerings={tuner.lowerings}/{live_gens} live generations"
    )
    if args.out:
        parent = os.path.dirname(args.out)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, sort_keys=True, indent=1)
            f.write("\n")
        print(f"artifact -> {args.out}")
    obs.close()
    rc = 0
    if args.assert_single_lowering and tuner.lowerings != live_gens:
        print(
            f"FAIL: {tuner.lowerings} lowerings != {live_gens} live "
            f"generations (the one-lowering-per-generation contract broke)"
        )
        rc = 1
    if args.assert_winner_at_least_default:
        if result["tuned"]["objective"] < result["default"].get(
            "objective", -float("inf")
        ):
            print("FAIL: winner scored below the IID-default control lane")
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
