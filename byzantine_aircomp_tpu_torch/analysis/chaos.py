"""Chaos harness: kill the experiment server and prove it heals.

The port of ``byzantine_aircomp_tpu/analysis/chaos.py``, its one-server
scenarios.

The crash-safety story (serve/journal.py write-ahead log, per-round
checkpoints with the metric paths riding the npz, lane quarantine,
watchdog requeue) is only real if an actual ``kill -9``
mid-round leaves records bit-identical to an uninterrupted run.  This
module drives a REAL server subprocess on an ephemeral port through
failure scenarios and asserts the recovery invariants:

* ``kill9``        — SIGKILL mid-run; restart; every run completes, the
  resumed batch lowers exactly once, and the final records are
  bit-identical (modulo the timing-only ``roundsPerSec``) to a baseline
  server that was never killed.
* ``refill_kill``  — SIGKILL after an elastic lane refill; the restarted
  server reseats the same tenant into the same lane, records bitwise.
* ``torn_tail``    — SIGKILL, then byte-truncate the journal's last line
  (the worst a torn append can do); restart still recovers.
* ``kill_midckpt`` — SIGKILL, then truncate a run's checkpoint npz to
  simulate torn durable state (the atomic-write discipline makes this
  impossible in practice; recovery must still tolerate it by restarting
  the run from round 0 — the record stays identical, only wall-clock is
  lost).
* ``kill_midckpt_rd4`` — the same torn-checkpoint recovery with
  ``--rounds-per-dispatch 4``: the run executes as 4-round dispatches
  with R-boundary checkpoints (solo-routed), and the recovered record
  must still match the uninterrupted multi-round baseline bit-for-bit.
* ``poisoned``     — a tenant with a divergent config (``gamma`` huge)
  is quarantined (run_failed, status failed) while cotenants complete
  unperturbed in the same group.
* ``slow_tenant``  — a long run in flight never blocks the control
  plane: /healthz stays 200, listing stays responsive, cancel works.
* ``smoke``        — the CI composite: three tenants (one poisoned),
  SIGKILL mid-run, restart, assert the healthy runs complete with
  ``lowerings == 1`` and records bit-identical to an unkilled baseline,
  and the poisoned run failed as quarantined — not fatally.

The two-tier scenarios (``edge_kill``, ``edge_replay``, ``edge_ledger``,
``trace_smoke``) drive the JAX package's aggregation root and edges
(``serve/root.py``, ``serve/edge.py``), which are ported in the next
slice: they are refused with that reason.

Usage::

    python -m byzantine_aircomp_tpu_torch.analysis.chaos --scenario smoke

Stdlib-only on the client side (urllib against the server's HTTP API);
the server runs as ``python -m byzantine_aircomp_tpu_torch serve``
exactly as an operator would launch it, on the card unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import pickle
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional

#: tiny-but-real run the scenarios submit (mirrors the serve-smoke CI
#: body); rounds is high enough that the kill lands mid-run on CI CPUs
BASE_CFG: Dict[str, Any] = {
    "dataset": "mnist",
    "honest_size": 6,
    "byz_size": 0,
    "rounds": 8,
    "display_interval": 4,
    "batch_size": 16,
    "agg": "mean",
    "eval_train": False,
}

_BOOT_DEADLINE = 180.0
_RUN_DEADLINE = 600.0

#: the servers' device (``--device``)
DEVICE = "cuda"

#: the repository root, put on the servers' import path
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: the scenarios of the two-tier aggregation, ported in the next slice
EDGE_SCENARIOS = ("edge_kill", "edge_replay", "edge_ledger", "trace_smoke")
EDGE_REFUSAL = "serve/root.py and serve/edge.py are ported in the next slice"


class Server:
    """One ``serve`` subprocess on an ephemeral port."""

    def __init__(self, obs_root: str, log_path: str, extra: List[str] = ()):
        self.obs_root = obs_root
        self.log_path = log_path
        self._log_fh = open(log_path, "ab")
        self.proc = subprocess.Popen(
            [
                sys.executable, "-m", "byzantine_aircomp_tpu_torch", "serve",
                "--port", "0", "--host", "127.0.0.1",
                "--obs-root", obs_root, "--batch-window", "0.2",
                "--device", DEVICE,
                *extra,
            ],
            stdout=self._log_fh,
            stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONPATH": os.pathsep.join(
                p for p in (_REPO, os.environ.get("PYTHONPATH")) if p)},
        )
        self.port = self._await_port()

    def _await_port(self) -> int:
        deadline = time.time() + _BOOT_DEADLINE
        marker = "experiment server on 127.0.0.1:"
        while time.time() < deadline:
            if self.proc.poll() is not None:
                raise AssertionError(
                    f"server exited rc={self.proc.returncode} before "
                    f"binding; see {self.log_path}"
                )
            try:
                with open(self.log_path) as f:
                    for line in f:
                        if marker in line:
                            tail = line.split(marker, 1)[1]
                            return int(tail.split()[0].strip("()"))
            except OSError:
                pass
            time.sleep(0.2)
        raise AssertionError(f"server never bound a port; see {self.log_path}")

    # ------------------------------------------------------ HTTP client

    def _url(self, path: str) -> str:
        return f"http://127.0.0.1:{self.port}{path}"

    def request(
        self, method: str, path: str, body: Optional[dict] = None
    ) -> Any:
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self._url(path), data=data, method=method
        )
        with urllib.request.urlopen(req, timeout=30) as resp:
            return json.loads(resp.read().decode())

    def submit(self, **overrides) -> str:
        return self.request("POST", "/runs", {**BASE_CFG, **overrides})[
            "run_id"
        ]

    def runs(self) -> List[dict]:
        return self.request("GET", "/runs")["runs"]

    def healthz(self) -> int:
        try:
            with urllib.request.urlopen(
                self._url("/healthz"), timeout=10
            ) as resp:
                return resp.status
        except urllib.error.HTTPError as exc:
            return exc.code

    def wait_all_terminal(self, deadline: float = _RUN_DEADLINE) -> List[dict]:
        end = time.time() + deadline
        while time.time() < end:
            runs = self.runs()
            if runs and all(
                r["status"] in ("completed", "failed", "cancelled")
                for r in runs
            ):
                return runs
            time.sleep(0.5)
        raise AssertionError(f"runs never finished: {self.runs()}")

    def wait_round(self, run_id: str, rnd: int, deadline: float = _RUN_DEADLINE):
        """Block until ``run_id`` durably reached round ``rnd`` (or went
        terminal — a fast machine may finish before the kill lands; the
        scenarios tolerate that, recovery of completed runs is also an
        invariant)."""
        end = time.time() + deadline
        while time.time() < end:
            info = self.request("GET", f"/runs/{run_id}")
            if info["round"] >= rnd or info["status"] in (
                "completed", "failed", "cancelled",
            ):
                return info
            time.sleep(0.05)
        raise AssertionError(f"{run_id} never reached round {rnd}")

    # ------------------------------------------------------- lifecycle

    def kill9(self) -> None:
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=30)
        self._log_fh.close()

    def close(self) -> None:
        if self._log_fh.closed:  # killed already
            return
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
        self._log_fh.close()


def _load_record(info: dict) -> dict:
    assert "record" in info, f"no record for {info['run_id']}: {info}"
    with open(info["record"], "rb") as f:
        record = pickle.load(f)
    record.pop("roundsPerSec", None)  # timing-only, excluded everywhere
    return record


def _assert_records_match(chaos_runs, base_runs, seeds) -> None:
    """Final records for ``seeds`` must be bit-identical between the
    killed/recovered server and the never-killed baseline."""
    chaos_by_seed = {r["knobs"]["seed"]: r for r in chaos_runs}
    base_by_seed = {r["knobs"]["seed"]: r for r in base_runs}
    for seed in seeds:
        a = _load_record(chaos_by_seed[seed])
        b = _load_record(base_by_seed[seed])
        assert pickle.dumps(a) == pickle.dumps(b), (
            f"seed {seed}: recovered record differs from uninterrupted "
            f"baseline"
        )
        print(f"  seed {seed}: record bit-identical across kill -9")


def _baseline(workdir: str, seeds, rounds: int, **overrides) -> List[dict]:
    """Run the same healthy tenants on a fresh root, uninterrupted."""
    root = os.path.join(workdir, "baseline")
    srv = Server(root, os.path.join(workdir, "baseline.log"))
    try:
        for seed in seeds:
            srv.submit(seed=seed, rounds=rounds, **overrides)
        return srv.wait_all_terminal()
    finally:
        srv.close()


# ------------------------------------------------------------ scenarios


def scenario_kill9(workdir: str) -> None:
    root = os.path.join(workdir, "root")
    seeds, rounds = (1, 2), BASE_CFG["rounds"]
    srv = Server(root, os.path.join(workdir, "serve.log"))
    ids = [srv.submit(seed=s) for s in seeds]
    srv.wait_round(ids[0], 2)
    srv.kill9()
    print("killed -9 mid-run; restarting on the same obs root")
    srv2 = Server(root, os.path.join(workdir, "serve2.log"))
    try:
        runs = srv2.wait_all_terminal()
        for r in runs:
            assert r["status"] == "completed", r
            assert r.get("lowerings") == 1, (
                f"{r['run_id']}: resumed batch lowered "
                f"{r.get('lowerings')} times, expected 1"
            )
    finally:
        srv2.close()
    base = _baseline(workdir, seeds, rounds)
    _assert_records_match(runs, base, seeds)
    print("kill9: OK")


def scenario_refill_kill(workdir: str) -> None:
    """SIGKILL the server after an elastic lane refill: a short tenant
    drains its lane mid-group, a late tenant refills the slot (the
    ``refill`` journal record is the WAL), then kill -9 lands.  The
    restarted server must reseat the SAME tenant into the SAME lane and
    every record must be bit-identical to a never-killed baseline."""
    root = os.path.join(workdir, "root")
    rounds = BASE_CFG["rounds"]
    srv = Server(root, os.path.join(workdir, "serve.log"))
    a = srv.submit(seed=1, rounds=3)  # drains early -> frees its lane
    b = srv.submit(seed=2)  # keeps the group alive for the refill
    # the group must have formed before the late tenant arrives, or it
    # would just widen the initial batch instead of refilling
    srv.wait_round(a, 1)
    c = srv.submit(seed=3)
    # wait until the refill decision is DURABLE (the journal is the
    # write-ahead log: the record lands before the device splice), then
    # kill.  On a fast box C may even finish first — recovery of a
    # completed refill is an invariant too, so both timings are valid.
    journal = os.path.join(root, "journal.jsonl")
    refill_lane = None
    end = time.time() + _RUN_DEADLINE
    while time.time() < end:
        try:
            with open(journal) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if rec.get("op") == "refill" and rec.get("run_id") == c:
                        refill_lane = rec["lane"]
        except OSError:
            pass
        if refill_lane is not None or all(
            r["status"] in ("completed", "failed", "cancelled")
            for r in srv.runs()
        ):
            break
        time.sleep(0.05)
    assert refill_lane is not None, (
        f"late tenant {c} never refilled a lane (journal has no refill "
        f"record); the group drained without reseating it"
    )
    srv.kill9()
    print(
        f"killed -9 after {c} refilled lane {refill_lane}; restarting "
        f"on the same obs root"
    )
    srv2 = Server(root, os.path.join(workdir, "serve2.log"))
    try:
        runs = srv2.wait_all_terminal()
        by_id = {r["run_id"]: r for r in runs}
        for rid in (a, b, c):
            assert by_id[rid]["status"] == "completed", by_id[rid]
            assert by_id[rid].get("lowerings") == 1, by_id[rid]
        # the replay invariant: same tenant, same seat
        assert by_id[c]["lane"] == refill_lane, (
            f"{c} reseated into lane {by_id[c]['lane']}, journal "
            f"said {refill_lane}"
        )
    finally:
        srv2.close()
    # baseline: same three tenants on a fresh root, never killed
    broot = os.path.join(workdir, "baseline")
    bsrv = Server(broot, os.path.join(workdir, "baseline.log"))
    try:
        bsrv.submit(seed=1, rounds=3)
        bsrv.submit(seed=2, rounds=rounds)
        bsrv.submit(seed=3, rounds=rounds)
        base = bsrv.wait_all_terminal()
    finally:
        bsrv.close()
    _assert_records_match(runs, base, (1, 2, 3))
    print("refill_kill: OK")


def scenario_torn_tail(workdir: str) -> None:
    root = os.path.join(workdir, "root")
    srv = Server(root, os.path.join(workdir, "serve.log"))
    rid = srv.submit(seed=1)
    srv.wait_round(rid, 2)
    srv.kill9()
    journal = os.path.join(root, "journal.jsonl")
    size = os.path.getsize(journal)
    with open(journal, "ab") as f:  # a torn append: half a JSON line
        f.write(b'{"op": "checkpoint", "run_id": "run-0001", "rou')
    print(f"tore the journal tail ({size} -> {os.path.getsize(journal)} bytes)")
    srv2 = Server(root, os.path.join(workdir, "serve2.log"))
    try:
        runs = srv2.wait_all_terminal()
        assert all(r["status"] == "completed" for r in runs), runs
        assert all(r.get("lowerings") == 1 for r in runs), runs
    finally:
        srv2.close()
    print("torn_tail: OK")


def _kill_midckpt(workdir: str, label: str, **overrides) -> None:
    root = os.path.join(workdir, "root")
    seeds, rounds = (1,), BASE_CFG["rounds"]
    srv = Server(root, os.path.join(workdir, "serve.log"))
    rid = srv.submit(seed=seeds[0], **overrides)
    srv.wait_round(rid, 2)
    srv.kill9()
    ckpts = glob.glob(os.path.join(root, rid, "**", "*.npz"), recursive=True)
    assert ckpts, f"no checkpoint landed under {root}/{rid}"
    with open(ckpts[0], "r+b") as f:  # torn durable state: half an npz
        f.truncate(os.path.getsize(ckpts[0]) // 2)
    print(f"truncated {ckpts[0]} to simulate a torn checkpoint write")
    srv2 = Server(root, os.path.join(workdir, "serve2.log"))
    try:
        runs = srv2.wait_all_terminal()
        assert all(r["status"] == "completed" for r in runs), runs
    finally:
        srv2.close()
    base = _baseline(workdir, seeds, rounds, **overrides)
    _assert_records_match(runs, base, seeds)
    print(f"{label}: OK (run restarted from round 0, record identical)")


def scenario_kill_midckpt(workdir: str) -> None:
    _kill_midckpt(workdir, "kill_midckpt")


def scenario_kill_midckpt_rd4(workdir: str) -> None:
    """kill_midckpt under ``--rounds-per-dispatch 4``: the kill (and the
    torn checkpoint) land against a run whose rounds are dispatched as
    4-round dispatches with R-boundary checkpoints — the recovered
    record must still be bit-identical to an uninterrupted multi-round
    baseline, proving the dispatch rim added no new torn-state window."""
    _kill_midckpt(workdir, "kill_midckpt_rd4", rounds_per_dispatch=4)


def scenario_poisoned(workdir: str) -> None:
    root = os.path.join(workdir, "root")
    srv = Server(root, os.path.join(workdir, "serve.log"))
    try:
        healthy = [srv.submit(seed=s) for s in (1, 2)]
        poisoned = srv.submit(seed=3, gamma=1e30)
        runs = {r["run_id"]: r for r in srv.wait_all_terminal()}
        assert runs[poisoned]["status"] == "failed", runs[poisoned]
        assert "quarantined" in runs[poisoned].get("error", ""), runs[poisoned]
        for rid in healthy:
            assert runs[rid]["status"] == "completed", runs[rid]
            assert runs[rid].get("lowerings") == 1, runs[rid]
    finally:
        srv.close()
    print("poisoned: OK (quarantined, cotenants completed, one lowering)")


def scenario_slow_tenant(workdir: str) -> None:
    root = os.path.join(workdir, "root")
    srv = Server(root, os.path.join(workdir, "serve.log"))
    try:
        rid = srv.submit(seed=1, rounds=500)
        srv.wait_round(rid, 1)
        for _ in range(5):  # control plane stays live under a long run
            assert srv.healthz() == 200, "healthz degraded under load"
            assert isinstance(srv.runs(), list)
            time.sleep(0.2)
        srv.request("POST", f"/runs/{rid}/cancel")
        end = time.time() + 60
        while time.time() < end:
            if srv.request("GET", f"/runs/{rid}")["status"] == "cancelled":
                break
            time.sleep(0.2)
        else:
            raise AssertionError("cancel of the slow tenant never landed")
    finally:
        srv.close()
    print("slow_tenant: OK (healthz 200 throughout, cancel landed)")


def scenario_smoke(workdir: str) -> None:
    """The CI composite: poisoned tenant + kill -9 + restart."""
    root = os.path.join(workdir, "root")
    seeds, rounds = (1, 2), BASE_CFG["rounds"]
    srv = Server(root, os.path.join(workdir, "serve.log"))
    healthy = [srv.submit(seed=s) for s in seeds]
    srv.submit(seed=3, gamma=1e30)  # poisoned cotenant
    srv.wait_round(healthy[0], 2)
    srv.kill9()
    print("killed -9 mid-run; restarting on the same obs root")
    srv2 = Server(root, os.path.join(workdir, "serve2.log"))
    try:
        runs = {r["run_id"]: r for r in srv2.wait_all_terminal()}
        for rid in healthy:
            assert runs[rid]["status"] == "completed", runs[rid]
            assert runs[rid].get("lowerings") == 1, (
                f"{rid}: lowered {runs[rid].get('lowerings')} times"
            )
        bad = [
            r for r in runs.values()
            if r["run_id"] not in healthy
        ]
        assert len(bad) == 1 and bad[0]["status"] == "failed", bad
        assert "quarantined" in bad[0].get("error", ""), bad[0]
        assert srv2.healthz() == 200
    finally:
        srv2.close()
    base = _baseline(workdir, seeds, rounds)
    _assert_records_match(
        [runs[rid] for rid in healthy], base, seeds
    )
    print("smoke: OK (recovered, quarantined, bit-identical)")


SCENARIOS = {
    "kill9": scenario_kill9,
    "torn_tail": scenario_torn_tail,
    "kill_midckpt": scenario_kill_midckpt,
    "kill_midckpt_rd4": scenario_kill_midckpt_rd4,
    "refill_kill": scenario_refill_kill,
    "poisoned": scenario_poisoned,
    "slow_tenant": scenario_slow_tenant,
    "smoke": scenario_smoke,
}


def main(argv=None) -> int:
    global DEVICE
    p = argparse.ArgumentParser(
        "byzantine_aircomp_tpu_torch.analysis.chaos",
        description="kill the experiment server and assert it heals",
    )
    p.add_argument(
        "--scenario", choices=sorted(SCENARIOS) + list(EDGE_SCENARIOS) + ["all"],
        default="smoke",
    )
    p.add_argument(
        "--workdir", default=None,
        help="scratch dir (default: a fresh temp dir, removed on success)",
    )
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="the servers' device: cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.scenario in EDGE_SCENARIOS:
        p.error(f"scenario {args.scenario}: {EDGE_REFUSAL}")
    DEVICE = args.device
    names = sorted(SCENARIOS) if args.scenario == "all" else [args.scenario]
    for name in names:
        if args.workdir is None:
            workdir = tempfile.mkdtemp(prefix=f"chaos-{name}-")
        else:
            # per-scenario subdir so --scenario all never cross-pollutes
            workdir = os.path.join(args.workdir, name)
            os.makedirs(workdir, exist_ok=True)
        print(f"=== chaos scenario {name} (workdir {workdir}) ===", flush=True)
        SCENARIOS[name](workdir)
        if args.workdir is None:
            shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
