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

The two-tier scenarios drive a real aggregation root (``serve/root.py``)
and edge subprocesses (``serve/edge.py``), N+1 processes on one machine:

* ``edge_kill``   — 4 edges, one SIGKILLed after round 0; the root
  quarantines it on its deadline, the survivors run the later rounds
  degraded and finish every round; a fresh topology that nobody kills is
  bitwise the flat single-process aggregate for every aggregator and the
  packed sign vote; each edge sets up its round program once per
  degraded-ness.
* ``trace_smoke`` — a healthy topology under ``--trace on``: every stream
  joins one trace with no orphan span, and every round's timeline covers
  at least 90% of its wall clock.
* ``edge_replay`` — zero-trust checks over raw HTTP: a captured
  submission replayed byte for byte is rejected (409) and journaled
  without evicting the edge it names; a forged MAC never reaches the fold
  and can not evict the claimed edge; the nonce high-water mark survives a
  root restart through the root journal; a Byzantine edge that races a
  bogus phase schema in first is out-voted and quarantined.
* ``edge_ledger`` — the bandwidth claim: at d=7850 with the one-bit sign
  channel, root ingress per round is at most 1/24 of the flat f32
  submission volume; writes a perf row for ``perf_gate --append``.

Usage::

    python -m byzantine_aircomp_tpu_torch.analysis.chaos --scenario smoke

Stdlib-only on the client side (urllib against the server's HTTP API);
the server runs as ``python -m byzantine_aircomp_tpu_torch serve``
(``root``, ``edge``) exactly as an operator would launch it, on the card
unless ``--device cpu``.
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


def _env() -> Dict[str, str]:
    """The subprocesses' environment: the repository on the import path."""
    return {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (_REPO, os.environ.get("PYTHONPATH")) if p)}


def _await_port(proc, log_path: str, marker: str, what: str) -> int:
    """The port a subprocess printed after ``marker`` in its log."""
    deadline = time.time() + _BOOT_DEADLINE
    while time.time() < deadline:
        if proc.poll() is not None:
            raise AssertionError(
                f"{what} exited rc={proc.returncode} before binding; see {log_path}")
        try:
            with open(log_path) as f:
                for line in f:
                    if marker in line:
                        return int(line.split(marker, 1)[1].split()[0].strip("()"))
        except OSError:
            pass
        time.sleep(0.2)
    raise AssertionError(f"{what} never bound a port; see {log_path}")


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
            env=_env(),
        )
        self.port = self._await_port()

    def _await_port(self) -> int:
        return _await_port(self.proc, self.log_path, "experiment server on 127.0.0.1:",
                           "server")

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


# ----------------------------------------------- two-tier edge topology

_EDGE_DEADLINE = 1200.0  # N+1 processes sharing one machine


def _topology(workdir: str, **over) -> str:
    """Write a topology JSON with fresh random per-edge HMAC keys."""
    cfg: Dict[str, Any] = {
        "edges": 4, "k": 32, "d": 64, "cohort": 4, "rounds": 3,
        "aggs": ["median", "trimmed_mean", "mean", "gm2"],
        "sign_bits": 1, "gm2_maxiter": 40, "seed": 7,
        "partial_timeout": 90.0,
    }
    cfg.update(over)
    cfg["keys"] = {str(e): os.urandom(32).hex() for e in range(cfg["edges"])}
    path = os.path.join(workdir, "topo.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path


class Root:
    """One aggregation-root subprocess on an ephemeral port."""

    def __init__(self, topo: str, obs_dir: str, log_path: str,
                 linger: float = 3.0, extra: Optional[List[str]] = None):
        self.log_path = log_path
        self._log_fh = open(log_path, "ab")
        self.proc = subprocess.Popen(
            [
                sys.executable, "-m", "byzantine_aircomp_tpu_torch", "root",
                "--config", topo, "--host", "127.0.0.1", "--port", "0",
                "--obs-dir", obs_dir, "--linger", str(linger),
                "--device", DEVICE, *(extra or []),
            ],
            stdout=self._log_fh,
            stderr=subprocess.STDOUT,
            env=_env(),
        )
        self.port = self._await_port()
        self.url = f"http://127.0.0.1:{self.port}"

    def _await_port(self) -> int:
        return _await_port(self.proc, self.log_path, "edge root on 127.0.0.1:", "root")

    def request(self, method: str, path: str, body: Optional[dict] = None) -> tuple:
        """(status, parsed JSON): 4xx/5xx return, they do not raise."""
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(f"{self.url}{path}", data=data, method=method)
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                return resp.status, json.loads(resp.read().decode())
        except urllib.error.HTTPError as exc:
            return exc.code, json.loads(exc.read().decode())

    def metrics_text(self) -> str:
        with urllib.request.urlopen(f"{self.url}/metrics", timeout=30) as resp:
            return resp.read().decode()

    def wait_round(self, rnd: int, deadline: float = _EDGE_DEADLINE) -> None:
        end = time.time() + deadline
        while time.time() < end:
            status, info = self.request("GET", f"/rounds/{rnd}")
            if status == 200 and info.get("completed"):
                return
            time.sleep(0.2)
        raise AssertionError(f"round {rnd} never completed")

    def wait_exit(self, deadline: float = _EDGE_DEADLINE) -> dict:
        """Wait for the root's own exit; parse its results line."""
        self.proc.wait(timeout=deadline)
        self._log_fh.close()
        marker = "edge root results: "
        with open(self.log_path) as f:
            for line in f:
                if marker in line:
                    return json.loads(line.split(marker, 1)[1])
        raise AssertionError(f"no results line in {self.log_path}")

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
        if not self._log_fh.closed:
            self._log_fh.close()


class EdgeProc:
    """One edge subprocess bound to a shard of the topology."""

    def __init__(self, topo: str, shard: int, root_url: str, obs_dir: str,
                 log_path: str, extra: Optional[List[str]] = None):
        self.shard = shard
        self.log_path = log_path
        self._log_fh = open(log_path, "ab")
        self.proc = subprocess.Popen(
            [
                sys.executable, "-m", "byzantine_aircomp_tpu_torch", "edge",
                "--config", topo, "--shard", str(shard),
                "--root-url", root_url, "--obs-dir", obs_dir,
                "--device", DEVICE, *(extra or []),
            ],
            stdout=self._log_fh,
            stderr=subprocess.STDOUT,
            env=_env(),
        )

    def kill9(self) -> None:
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=30)
        self._log_fh.close()

    def summary(self, deadline: float = _EDGE_DEADLINE) -> dict:
        self.proc.wait(timeout=deadline)
        if not self._log_fh.closed:
            self._log_fh.close()
        marker = f"edge {self.shard}: {{"
        with open(self.log_path) as f:
            for line in f:
                if marker in line:
                    return json.loads(line.split(":", 1)[1])
        raise AssertionError(f"edge {self.shard} printed no summary; see {self.log_path}")

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)
        if not self._log_fh.closed:
            self._log_fh.close()


def _flat_reference(cfg, device: Optional[str] = None) -> Dict[int, Dict[str, Any]]:
    """The flat single-process aggregate per round, on ``device`` (the
    harness's by default): ``SeqShardCtx`` over the same shard partition
    plus the whole-stack packed sign vote, which the tree's results must
    match bitwise."""
    import torch

    from ..device import resolve_device
    from ..ops import aggregators, shardctx
    from ..serve.edge import round_stack

    dev = resolve_device(device or DEVICE)
    out: Dict[int, Dict[str, Any]] = {}
    for rnd in range(cfg.rounds):
        stack = round_stack(cfg.seed, rnd, cfg.k, cfg.d, dev)
        ctx = shardctx.SeqShardCtx(cfg.edges)

        def rebuild(c, stack=stack):
            return stack[c * cfg.cohort:(c + 1) * cfg.cohort]

        ref: Dict[str, Any] = {}
        if cfg.aggs:
            sa, sf, nf = aggregators.stream_stats(rebuild, cfg.n_chunks, cfg.d, dev, ctx)
            for name in cfg.aggs:
                ref[name] = aggregators.stream_aggregate(
                    name, rebuild, k=cfg.k, d=cfg.d, n_chunks=cfg.n_chunks, device=dev,
                    degraded=False, sum_all=sa, sum_finite=sf, n_finite=nf,
                    quantile=cfg.quantile, sketch_bins=cfg.sketch_bins,
                    trim_ratio=cfg.trim_ratio, maxiter=cfg.gm2_maxiter, ctx=ctx,
                ).cpu().numpy()
        if cfg.sign_bits == 1:
            words, kv = aggregators.pack_signs(
                stack, torch.zeros(cfg.d, dtype=torch.float32, device=dev))
            ref["signvote"] = (2 * aggregators.packed_sign_votes(words, cfg.d) - kv).to(
                torch.int32).cpu().numpy()
        out[rnd] = ref
    return out


def _assert_matches_flat(cfg, results: dict, ref: dict, rounds=None) -> None:
    from ..ops import shardctx

    for rnd in range(cfg.rounds) if rounds is None else rounds:
        rr = results["rounds"][str(rnd)]
        assert rr["completed"] and not rr["degraded"], (rnd, rr)
        for name in cfg.result_names:
            got = shardctx.decode_leaf(rr["results"][name])
            assert got.dtype == ref[rnd][name].dtype and \
                got.tobytes() == ref[rnd][name].tobytes(), (
                    f"round {rnd} {name}: tree result differs from the flat "
                    "single-process aggregate")
        print(f"  round {rnd}: tree == flat bitwise ({', '.join(cfg.result_names)})")


def scenario_edge_kill(workdir: str) -> None:
    from ..serve.edge import TopologyConfig

    topo = _topology(workdir)
    cfg = TopologyConfig.load(topo)
    obs = os.path.join(workdir, "obs")
    root = Root(topo, obs, os.path.join(workdir, "root.log"))
    edges = [EdgeProc(topo, e, root.url, obs, os.path.join(workdir, f"edge{e}.log"))
             for e in range(cfg.edges)]
    try:
        # let round 0 close healthy, then SIGKILL edge 2: it lands in round
        # 1, every later phase of which needs all four edges, so only the
        # deadline can clear it
        root.wait_round(0)
        edges[2].kill9()
        print("killed -9 edge 2 after round 0; survivors must finish degraded")
        results = root.wait_exit()
        for e in (0, 1, 3):
            s = edges[e].summary()
            assert s["status"] == "completed", s
            assert s["rounds"] == cfg.rounds, s
            assert s["steady_state_ok"], s
            assert s["lowerings"] == {"edge_round_fn": 1, "edge_round_fn_degraded": 1}, (
                f"edge {e} set up a program more than once: {s}")
        assert edges[2].proc.returncode == -signal.SIGKILL
    finally:
        for e in edges:
            e.close()
        root.close()
    assert results["quarantined"] == {"2": "partial_timeout"}, results
    assert results["fold_lowerings"] == results["fold_signatures"], results
    assert results["rounds"]["0"]["completed"]
    assert not results["rounds"]["0"]["degraded"]
    for rnd in range(1, cfg.rounds):
        rr = results["rounds"][str(rnd)]
        assert rr["completed"] and rr["degraded"], (rnd, rr)
    print("degraded rounds completed over the 3 survivors; now a fresh no-kill "
          "topology against the flat single-process aggregate")
    obs2 = os.path.join(workdir, "obs_base")
    root2 = Root(topo, obs2, os.path.join(workdir, "root_base.log"))
    edges2 = [EdgeProc(topo, e, root2.url, obs2, os.path.join(workdir, f"edge_base{e}.log"))
              for e in range(cfg.edges)]
    try:
        base = root2.wait_exit()
        for e in edges2:
            s = e.summary()
            assert s["status"] == "completed" and s["steady_state_ok"], s
    finally:
        for e in edges2:
            e.close()
        root2.close()
    assert not base["quarantined"], base
    ref = _flat_reference(cfg)
    _assert_matches_flat(cfg, base, ref)
    # round 0 of the killed run closed healthy before the kill: it too must
    # be bitwise the flat aggregate
    _assert_matches_flat(cfg, results, ref, rounds=[0])
    print("edge_kill: OK (degraded survival + bitwise no-kill run)")


def scenario_trace_smoke(workdir: str) -> None:
    """A healthy 4-edge topology under ``--trace on``: every stream (root
    and 4 edges) joins one trace with no orphan span, every per-round
    timeline covers at least 90% of its wall clock, the Perfetto export is
    valid trace-event JSON, and tracing costs no set-up (the edges' audit
    still passes)."""
    from ..serve.edge import TopologyConfig
    from . import trace_view as tv

    topo = _topology(workdir)
    cfg = TopologyConfig.load(topo)
    obs = os.path.join(workdir, "obs")
    root = Root(topo, obs, os.path.join(workdir, "root.log"), extra=["--trace", "on"])
    edges = [EdgeProc(topo, e, root.url, obs, os.path.join(workdir, f"edge{e}.log"),
                      extra=["--trace", "on"])
             for e in range(cfg.edges)]
    try:
        results = root.wait_exit()
        for e in edges:
            s = e.summary()
            assert s["status"] == "completed", s
            assert s["steady_state_ok"], f"edge {s['edge']}: tracing cost a set-up: {s}"
    finally:
        for e in edges:
            e.close()
        root.close()
    assert not results["quarantined"], results

    events = tv.load_streams(tv.find_streams(obs), root=obs)
    traces = tv.assemble(events)
    assert len(traces) == 1, f"expected one topology-wide trace, got {sorted(traces)}"
    trace = next(iter(traces.values()))
    assert not trace["orphans"], trace["orphans"]
    assert len(trace["streams"]) == cfg.edges + 1, trace["streams"]
    rounds = tv.round_table(trace["spans"])
    assert len(rounds) == cfg.rounds, rounds
    for row in rounds:
        assert row["coverage"] >= 0.90, (
            f"round {row['round']} attributes only {row['coverage']:.0%} of wall-clock")

    report_md = os.path.join(workdir, "trace_report.md")
    report_json = os.path.join(workdir, "trace.json")
    rc = tv.main([obs, "--out", report_md, "--trace-out", report_json,
                  "--assert-no-orphans"])
    assert rc == 0, f"trace_view exited {rc}"
    with open(report_json) as f:
        perfetto = json.load(f)
    spans = [e for e in perfetto["traceEvents"] if e.get("ph") == "X"]
    assert spans and all("ts" in e and "dur" in e and "pid" in e for e in spans), (
        "malformed Perfetto events")
    print(f"trace_smoke: OK (1 trace, {len(trace['spans'])} spans over "
          f"{len(trace['streams'])} streams, 0 orphans, min coverage "
          f"{min(r['coverage'] for r in rounds):.0%})")


def scenario_edge_replay(workdir: str) -> None:
    import numpy as np

    from ..ops import shardctx
    from ..serve import edge as edge_mod
    from ..serve import journal as journal_lib
    from ..utils.io import iter_jsonl

    topo = _topology(workdir, edges=2, k=8, d=16, cohort=4, rounds=1, aggs=[],
                     partial_timeout=600.0)
    cfg = edge_mod.TopologyConfig.load(topo)
    obs = os.path.join(workdir, "obs")

    def envelope(edge: int, nonce: int, key: str = None, mac: str = None) -> dict:
        counts = np.zeros(cfg.d, np.int32)
        kv = np.asarray(cfg.rows_per_edge, np.int32)
        body = {
            "op": "partial", "round": 0, "epoch": 0, "seq": 0,
            "meta": {"label": "signvote"},
            **shardctx.partial_to_wire([counts, kv], ("sum", "sum")),
            "edge": edge, "nonce": nonce,
        }
        body["mac"] = mac or edge_mod.sign_envelope(key or cfg.keys[edge], body)
        return body

    root = Root(topo, obs, os.path.join(workdir, "root.log"))
    try:
        st, resp = root.request("POST", "/partials", envelope(1, 1))
        assert st == 200, (st, resp)
        # a byte-for-byte replay of a captured, correctly signed edge-0
        # submission: the mac verifies, the nonce does not; rejected and
        # journaled, but the edge it names stays live
        captured = envelope(0, 1)
        st, resp = root.request("POST", "/partials", captured)
        assert st == 200, (st, resp)
        st, resp = root.request("POST", "/partials", captured)
        assert st == 409 and resp["error"] == "replay", (st, resp)
        st, resp = root.request("POST", "/partials", envelope(0, 2))
        assert st == 200, (st, resp)  # the edge's fresh nonces still work
        # a forged mac is rejected before any state changes, and can not
        # quarantine the edge whose identity it claims
        st, resp = root.request("POST", "/partials", envelope(1, 99, mac="00" * 32))
        assert st == 401 and resp["error"] == "bad_mac", (st, resp)
        st, resp = root.request("POST", "/partials", envelope(7, 1, key="11" * 32))
        assert st == 401 and resp["error"] == "unknown edge", (st, resp)
        st, res = root.request("GET", "/results")
        assert st == 200
        assert res["quarantined"] == {}, res
        assert res["live"] == [0, 1], res
        assert res["replays"] == {"0": 1}, res
        assert res["forged"] == {"1": 1}, res
        text = root.metrics_text()
        for needle in ('aircomp_edge_rejects_total{reason="replay"} 1',
                       'aircomp_edge_rejects_total{reason="bad_mac"} 1'):
            assert needle in text, f"{needle!r} missing from /metrics"
        assert "aircomp_edge_quarantines_total" not in text, (
            "a replay or forgery must never quarantine")
    finally:
        root.close()
    journal = os.path.join(obs, journal_lib.ROOT_JOURNAL_NAME)
    ops = [r.get("op") for r in iter_jsonl(journal)]
    for op in ("replay_rejected", "forged_rejected"):
        assert op in ops, f"{op} not journaled: {ops}"
    assert "edge_quarantined" not in ops, ops
    # the journaled rejection carries the nonce, so the high-water mark,
    # and with it the replay protection, survives a root restart, while
    # the named edge stays live
    root2 = Root(topo, obs, os.path.join(workdir, "root2.log"))
    try:
        st, resp = root2.request("POST", "/partials", captured)
        assert st == 409 and resp["error"] == "replay", (st, resp)
        st, resp = root2.request("POST", "/partials", envelope(0, 3))
        assert st == 200, (st, resp)
    finally:
        root2.close()
    # ---- schema-race containment: the first submitter does not define
    # the phase schema; a Byzantine edge that races a bogus shape in first
    # is out-voted and quarantined once every live edge reports
    schema_dir = os.path.join(workdir, "schema")
    os.makedirs(schema_dir, exist_ok=True)
    topo4 = _topology(schema_dir, edges=4, k=16, d=16, cohort=4, rounds=1, aggs=[],
                      partial_timeout=600.0)
    cfg4 = edge_mod.TopologyConfig.load(topo4)
    obs4 = os.path.join(schema_dir, "obs")

    def envelope4(edge: int, nonce: int, leaves) -> dict:
        body = {
            "op": "partial", "round": 0, "epoch": 0, "seq": 0,
            "meta": {"label": "signvote"},
            **shardctx.partial_to_wire(leaves, ("sum", "sum")),
            "edge": edge, "nonce": nonce,
        }
        body["mac"] = edge_mod.sign_envelope(cfg4.keys[edge], body)
        return body

    honest = [np.zeros(cfg4.d, np.int32), np.asarray(4, np.int32)]
    bogus = [np.zeros(cfg4.d + 1, np.int32), np.asarray(4, np.int32)]
    root3 = Root(topo4, obs4, os.path.join(workdir, "root_schema.log"))
    try:
        st, resp = root3.request("POST", "/partials", envelope4(0, 1, bogus))
        assert st == 200, (st, resp)  # buffered, not yet trusted
        for e in (1, 2):
            st, resp = root3.request("POST", "/partials", envelope4(e, 1, honest))
            assert st == 200, (st, resp)
        st, res = root3.request("GET", "/results")
        assert res["quarantined"] == {}, res  # no eviction before the vote
        st, resp = root3.request("POST", "/partials", envelope4(3, 1, honest))
        assert st == 200, (st, resp)
        st, res = root3.request("GET", "/results")
        assert res["quarantined"] == {"0": "bad_payload"}, res
        assert res["live"] == [1, 2, 3], res
    finally:
        root3.close()
    print("edge_replay: OK (replay 409 without eviction, forgery contained, HWM "
          "survives restart, schema race out-voted)")


def scenario_edge_ledger(workdir: str) -> None:
    from ..serve.edge import TopologyConfig

    topo = _topology(workdir, edges=4, k=128, d=7850, cohort=32, rounds=2, aggs=[],
                     partial_timeout=300.0)
    cfg = TopologyConfig.load(topo)
    obs = os.path.join(workdir, "obs")
    root = Root(topo, obs, os.path.join(workdir, "root.log"))
    edges = [EdgeProc(topo, e, root.url, obs, os.path.join(workdir, f"edge{e}.log"))
             for e in range(cfg.edges)]
    try:
        results = root.wait_exit()
        for e in edges:
            s = e.summary()
            assert s["status"] == "completed" and s["steady_state_ok"], s
            assert s["lowerings"] == {"edge_round_fn": 1}, s
    finally:
        for e in edges:
            e.close()
        root.close()
    assert not results["quarantined"], results
    assert results["fold_lowerings"] == results["fold_signatures"], results
    flat_f32 = cfg.k * cfg.d * 4  # every client shipping f32 coordinates
    per_round = [results["rounds"][str(r)]["ingress_bytes"] for r in range(cfg.rounds)]
    worst = max(per_round)
    ratio = flat_f32 / worst
    assert ratio >= 24.0, (
        f"root ingress {worst}B/round vs flat f32 {flat_f32}B: only {ratio:.1f}x "
        "(need >= 24x)")
    row = {
        "metric": "edge_root_ingress_bytes_per_round_sb1",
        "value": float(worst), "unit": "bytes/round", "platform": DEVICE,
        "k": cfg.k, "d": cfg.d, "agg": "signmv", "sign_bits": 1,
        "bytes_moved": worst, "bytes_moved_f32": flat_f32,
        "note": "analysis/chaos.py edge_ledger (4 edges, packed one-bit sign wire)",
    }
    row_path = os.path.join(workdir, "edge_ledger_row.json")
    with open(row_path, "w") as f:
        json.dump(row, f, indent=1)
    print(f"edge_ledger: OK (ingress {worst}B/round = flat/{ratio:.1f}, row at {row_path})")


SCENARIOS = {
    "kill9": scenario_kill9,
    "edge_kill": scenario_edge_kill,
    "edge_replay": scenario_edge_replay,
    "trace_smoke": scenario_trace_smoke,
    "edge_ledger": scenario_edge_ledger,
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
        "--scenario", choices=sorted(SCENARIOS) + ["all"],
        default="smoke",
    )
    p.add_argument(
        "--workdir", default=None,
        help="scratch dir (default: a fresh temp dir, removed on success)",
    )
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="the servers', roots' and edges' device: cuda (default) or cpu")
    args = p.parse_args(argv)
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
