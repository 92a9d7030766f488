"""Crash safety of the port's experiment server on the CPU: the journal's
replay folds against the JAX package's on the same files, the checkpoint's
paths meta on the same atomic write, the watchdog's bounded retries and
``/healthz``, ``tail --run``, a kernel build killed mid-way, and the chaos
harness's ``smoke`` scenario against a real ``serve`` subprocess (SIGKILL
mid-run, restart, records bitwise an unkilled baseline; its other
one-server scenarios run on the card in ``chip_smoke.py``)."""

import io
import json
import os
import signal
import subprocess
import sys
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from byzantine_aircomp_tpu.serve import journal as jjournal
from byzantine_aircomp_tpu_torch.analysis import chaos, tail
from byzantine_aircomp_tpu_torch.data import datasets as tdata
from byzantine_aircomp_tpu_torch.fed import checkpoint
from byzantine_aircomp_tpu_torch.fed.config import FedConfig, config_to_mapping
from byzantine_aircomp_tpu_torch.serve import journal as tjournal
from byzantine_aircomp_tpu_torch.serve.runs import RunManager
from byzantine_aircomp_tpu_torch.serve.server import ExperimentServer
from byzantine_aircomp_tpu_torch.utils.io import iter_jsonl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: many small ops (tests/test_torch_dispatch.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    return FedConfig(**dict(dict(dataset="mnist", honest_size=6, byz_size=0, rounds=2,
                                 display_interval=2, batch_size=16, agg="mean",
                                 eval_train=False, use_gpu=False), **kw))


def _both_replays(path):
    tw, jw = [], []
    return (tjournal.replay(path, warn=tw.append), tw,
            jjournal.replay(path, warn=jw.append), jw)


def test_the_journal_folds_as_jax_s_does(tmp_path):
    path = str(tmp_path / "journal.jsonl")
    j = tjournal.RunJournal(path)
    cfg_map = config_to_mapping(_cfg(seed=1))
    j.append("submitted", "run-0001", config=cfg_map, signature="sig", title="t1",
             solo=False, idempotency_key="key-1")
    j.append("running", "run-0001")
    j.append("checkpoint", "run-0001", round=1)
    j.append("checkpoint", "run-0001", round=2)
    j.append("completed", "run-0001", round=2, lowerings=1, final_val_acc=0.9,
             final_val_loss=0.3)
    j.append("submitted", "run-0002", config=cfg_map, signature="sig", title="t2",
             solo=False, idempotency_key=None)
    j.append("running", "run-0002")
    j.append("checkpoint", "run-0002", round=1)
    j.append("requeued", "run-0002", retries=1, reason="wedged")
    j.append("submitted", "run-0003", config=cfg_map, signature="sig", title="t3",
             solo=True)
    j.append("failed", "run-0003", round=1, reason="quarantined: non-finite parameters")
    j.append("submitted", "run-0004", config=cfg_map, signature="sig", title="t4",
             solo=False)
    j.append("refill", "run-0004", lane=2, round=0, group_round=3, signature="sig")
    j.append("running", "run-0009")  # no submitted line: dropped
    j.close()
    with open(path, "ab") as f:  # interior garbage, then a torn tail
        f.write(b"not json\n")
        f.write(b'{"op": "checkpoint", "run_id": "run-0002", "rou')
    got, tw, want, jw = _both_replays(path)
    assert got == want and tw == jw
    assert sorted(got) == ["run-0001", "run-0002", "run-0003", "run-0004"]
    assert got["run-0001"]["status"] == "completed" and got["run-0001"]["lowerings"] == 1
    assert got["run-0002"]["status"] == "queued" and got["run-0002"]["retries"] == 1
    assert got["run-0004"]["lane"] == 2
    assert any("run-0009" in w for w in tw)
    assert tjournal.replay(str(tmp_path / "absent")) == {}


def test_the_root_journal_folds_as_jax_s_does(tmp_path):
    path = str(tmp_path / "root_journal.jsonl")
    j = tjournal.RunJournal(path)
    j.append("partial", "edge-0", nonce=3)
    j.append("partial", "edge-1", nonce=7)
    j.close()
    with open(path, "a") as f:
        f.write("{garbage\n")
    j = tjournal.RunJournal(path)
    j.append("replay_rejected", "edge-1", nonce=9)
    j.append("edge_quarantined", "edge-0", reason="bad_payload")
    j.append("partial", "run-0001", nonce=99)  # not an edge
    j.close()
    tw, jw = [], []
    got = tjournal.replay_edges(path, warn=tw.append)
    assert got == jjournal.replay_edges(path, warn=jw.append) and tw == jw
    assert got == {0: {"nonce": 3, "quarantined": "bad_payload"},
                   1: {"nonce": 9, "quarantined": None}}


def test_the_checkpoint_meta_rides_the_same_atomic_write(tmp_path):
    paths = {"valLossPath": [1.25, 0.5], "variencePath": [0.125]}
    checkpoint.save(str(tmp_path), "t", 2, np.zeros(3, np.float32),
                    [np.ones(2, np.float32)], meta=json.dumps(paths))
    assert json.loads(checkpoint.load_meta(str(tmp_path), "t")) == paths
    rnd, flat, extras = checkpoint.load(str(tmp_path), "t")
    assert rnd == 2 and flat.shape == (3,) and len(extras) == 1
    # one file, no temp left beside it
    assert os.listdir(tmp_path) == ["t.ckpt.npz"]
    checkpoint.save(str(tmp_path), "bare", 1, np.zeros(1, np.float32), [])
    assert checkpoint.load_meta(str(tmp_path), "bare") is None
    assert checkpoint.load_meta(str(tmp_path), "absent") is None


@pytest.fixture(scope="module")
def ds():
    return tdata.load("mnist", synthetic_train=600, synthetic_val=200)


def test_the_watchdog_retries_a_bounded_number_of_times(tmp_path, ds):
    root = str(tmp_path / "root")
    mgr = RunManager(root, dataset=ds, device="cpu", wedge_secs=10.0, run_retries=2,
                     run_backoff=5.0)
    rid = mgr.submit(_cfg(seed=1))
    run = mgr._runs[rid]

    def wedge_at(t0):
        run.status, run.wedged, run.last_progress = "running", False, t0

    wedge_at(0.0)
    mgr._watchdog_sweep(5.0)
    assert run.status == "running" and mgr.degraded() is None
    mgr._watchdog_sweep(100.0)
    assert run.wedged and run.retries == 1 and "wedged" in mgr.degraded()
    mgr._watchdog_sweep(101.0)
    assert run.retries == 1
    mgr._watchdog_sweep(105.1)
    assert run.status == "queued" and rid in mgr._pending
    wedge_at(200.0)
    mgr._watchdog_sweep(300.0)
    mgr._watchdog_sweep(305.0)
    assert run.retries == 2 and run.status == "running"
    mgr._watchdog_sweep(310.1)
    assert run.status == "queued"
    wedge_at(400.0)
    mgr._watchdog_sweep(500.0)
    assert run.status == "failed" and "retries exhausted" in run.error
    assert mgr.degraded() is None
    mgr.journal.close()
    ops = [(r["op"], r.get("retries")) for r in iter_jsonl(tjournal.journal_path(root))
           if r["run_id"] == rid]
    assert ops.count(("requeued", 1)) == ops.count(("requeued", 2)) == 1
    assert [o for o, _ in ops].count("failed") == 1


def test_healthz_degrades_while_a_run_is_wedged(tmp_path, ds):
    srv = ExperimentServer(str(tmp_path / "root"), port=0, host="127.0.0.1", wedge_secs=10.0,
                           run_retries=0, dataset=ds, device="cpu")
    try:
        assert srv._health() == {"ok": True, "runs": {}}
        run = srv.manager._runs[srv.manager.submit(_cfg(seed=1))]
        run.status, run.last_progress = "running", 0.0
        srv.manager._watchdog_sweep(100.0)
        assert run.status == "failed"
        run2 = srv.manager._runs[srv.manager.submit(_cfg(seed=2))]
        run2.status, run2.last_progress = "running", 0.0
        srv.manager.run_retries = 1
        srv.manager._watchdog_sweep(100.0)
        body = srv._health()
        assert body["ok"] is False and "wedged" in body["reason"]
    finally:
        srv.manager.close()


def test_tail_run_prints_the_tenant_s_subtree(tmp_path, ds):
    root = str(tmp_path / "root")
    mgr = RunManager(root, dataset=ds, device="cpu")
    ids = [mgr.submit(_cfg(seed=s)) for s in (1, 2)]
    mgr.drain()
    mgr.close()
    out = io.StringIO()
    with redirect_stdout(out):
        assert tail.main([root, "--run", ids[1], "--once"]) == 0
    lines = out.getvalue().splitlines()
    assert len(lines) == 2 and all("| loss " in ln for ln in lines)
    # only that tenant's stream: the other run's file is never opened
    assert tail.discover_stream(os.path.join(root, ids[1])).startswith(
        os.path.join(root, ids[1]))
    assert tail.main([os.path.join(root, "absent.jsonl"), "--run", ids[0], "--once"]) == 1


_KILLED_BUILD = r"""
import os, sys, time
from byzantine_aircomp_tpu_torch.ops import kernels
kernels._nvcc = lambda: sys.argv[1]
kernels.build(["packed_vote_counts"])
"""


def test_a_kernel_build_killed_midway_leaves_no_library_to_load(tmp_path):
    """The build writes each library to a per-process temp file and
    renames it only when nvcc succeeded, so a SIGKILL during the first
    build (a chaos kill of a starting server) leaves no torn library at
    the path a later process loads."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nfor a; do case $p in -o) out=$a;; esac; p=$a; done\n"
                    "printf 'half a library' > \"$out\"\nsleep 60\n")
    fake.chmod(0o755)
    build_dir = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=REPO)
    code = _KILLED_BUILD.replace(
        "from byzantine_aircomp_tpu_torch.ops import kernels",
        "from byzantine_aircomp_tpu_torch.ops import kernels\n"
        f"kernels.BUILD_DIR = kernels.Path({str(build_dir)!r})")
    proc = subprocess.Popen([sys.executable, "-c", code, str(fake)], env=env)
    from byzantine_aircomp_tpu_torch.ops import kernels

    deadline = time.time() + 60
    while time.time() < deadline and not list(build_dir.glob("*.tmp")):
        time.sleep(0.05)
    proc.send_signal(signal.SIGKILL)
    proc.wait(timeout=30)
    temps = list(build_dir.glob("*.tmp"))
    assert temps and temps[0].read_text() == "half a library"
    final = build_dir / kernels._lib_path("packed_vote_counts").name
    assert not final.exists()
    assert not list(build_dir.glob("*.so"))


def test_the_scenarios_are_jax_s_edge_scenarios_included():
    assert set(chaos.SCENARIOS) == {"kill9", "torn_tail", "kill_midckpt",
                                    "kill_midckpt_rd4", "refill_kill", "poisoned",
                                    "slow_tenant", "smoke", "edge_kill", "edge_replay",
                                    "edge_ledger", "trace_smoke"}


def _edge_scenario(name, tmp_path, timeout):
    """One two-tier chaos scenario as a subprocess on the CPU: its root and
    edges are ``python -m byzantine_aircomp_tpu_torch root|edge --device cpu``."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "byzantine_aircomp_tpu_torch.analysis.chaos", "--scenario",
         name, "--device", "cpu", "--workdir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert f"{name}: OK" in proc.stdout
    return proc.stdout


def test_edge_replay_rejects_replays_and_forgeries_without_eviction(tmp_path):
    """A replayed capture answers 409 and a forged MAC 401, both journaled,
    neither evicting the edge it names; the nonce high-water mark survives a
    root restart; a bogus schema raced in first is out-voted."""
    _edge_scenario("edge_replay", tmp_path, 240)
    obs = tmp_path / "edge_replay" / "obs"
    ops = [r["op"] for r in iter_jsonl(str(obs / tjournal.ROOT_JOURNAL_NAME))]
    assert "replay_rejected" in ops and "forged_rejected" in ops
    assert "edge_quarantined" not in ops


def test_trace_smoke_joins_the_topology_in_one_trace(tmp_path):
    """A healthy 4-edge topology under ``--trace on``: one trace over the
    root's and the four edges' streams, no orphan span, every round's
    coverage at least 90%."""
    out = _edge_scenario("trace_smoke", tmp_path, 300)
    assert "over 5 streams, 0 orphans" in out


@pytest.mark.slow
def test_edge_kill_finishes_degraded_after_a_sigkill(tmp_path):
    """JAX's own topology, whose 90 s ``partial_timeout`` the kill has to
    wait out (tests/test_torch_edge.py holds the same claims in-process with
    a 2 s timeout)."""
    out = _edge_scenario("edge_kill", tmp_path, 900)
    assert "round 0: tree == flat bitwise" in out


def test_chaos_smoke_heals_a_killed_server(tmp_path):
    """The composite: three tenants (one poisoned) on a real ``serve``
    subprocess, SIGKILL mid-run, a restart on the same obs root; the
    healthy runs complete with one build and records bitwise an unkilled
    baseline server's, and the poisoned one fails as quarantined."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "byzantine_aircomp_tpu_torch.analysis.chaos", "--scenario",
         "smoke", "--device", "cpu", "--workdir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "record bit-identical across kill -9" in proc.stdout
    assert "smoke: OK" in proc.stdout
