"""The port's traffic soak (``analysis/soak.py``) on the CPU: its SLO rules
and percentile arithmetic are the JAX tool's, and a small seeded soak
against an in-process server passes every gate, with the 429s of a full
queue counted as genuine and none misfired.  The latency thresholds here
are wide (5 s): a CPU test worker shares its cores, and the latencies
that count are the card's (``chip_smoke.py`` run z15 prints the
admission p99)."""

import argparse

import pytest
import torch

from byzantine_aircomp_tpu.analysis import soak as jsoak
from byzantine_aircomp_tpu_torch.analysis import soak as tsoak


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: many small ops (tests/test_torch_dispatch.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(**kw):
    args = dict(seed=7, tenants=6, rounds=2, interval=2, arrival_ms=10.0, cancel_frac=0.05,
                swap_frac=0.15, scrape_frac=0.2, queue_cap=0, synthetic_train=300,
                synthetic_val=100, slo_admission_ms=5000.0, slo_scrape_ms=5000.0,
                slo_occupancy=0.5, max_secs=120.0, workdir=None, out=None, device="cpu",
                batch_window=0.05)
    args.update(kw)
    return argparse.Namespace(**args)


def test_the_rules_and_percentiles_are_the_jax_tool_s():
    assert tsoak.SOAK_RULES == jsoak.SOAK_RULES
    args = _args(slo_admission_ms=30.0)
    t_rules = [(r.name, r.metric, r.op, r.value) for r in tsoak.build_rules(args)]
    j_rules = [(r.name, r.metric, r.op, r.value) for r in jsoak.build_rules(args)]
    assert t_rules == j_rules
    for samples in ([], [3.0], [5.0, 1.0, 9.0, 2.0], [float(i) for i in range(101)]):
        for q in (50, 95, 99):
            assert tsoak._percentile(samples, q) == jsoak._percentile(samples, q)
        assert tsoak._latency_summary(samples) == jsoak._latency_summary(samples)
    for ms in (30.0, 250.0, 1e6):
        assert tsoak._bucket_ceiling_ms(ms) == jsoak._bucket_ceiling_ms(ms)


def test_a_small_soak_passes_every_gate(tmp_path):
    # two timing dependences are gone from the program: a queue that takes
    # every tenant holds the scheduler until every arrival has landed, so the
    # seeded op sequence alone decides the group (the five tenants left after
    # run 0's cancel, where
    # the tenants that landed inside the first batch window used to form it),
    # and the alert pack is evaluated once per group boundary at which a round
    # runs, on the scheduler thread (where a polling client caught the
    # group's closing, empty boundary or not: lane_occupancy_floor fired at
    # 0.8 under load).  The drain tail, 0.8 and 0.6, stays under the floor's
    # four samples
    report = tsoak.run_soak(_args(workdir=str(tmp_path)), log=lambda *a: None)
    failed = [s for s in report["slos"] if not s["ok"]]
    assert report["ok"], (failed, report["alert_events"])
    assert report["traffic"]["submit_2xx"] == 6 and not report["misfires"]
    assert report["scheduler"]["lane_group_samples"] > 0
    assert sum(report["outcomes"].values()) == 6
    assert report["soak"]["device"] == "cpu"


def test_a_full_queue_answers_429_and_every_tenant_lands(tmp_path):
    """A queue cap of 2: every 429 is a genuine queue-full rejection and
    every accepted tenant ends terminal (the occupancy floor may fire: a
    cap this small starves the group by design)."""
    report = tsoak.run_soak(_args(queue_cap=2, workdir=str(tmp_path)), log=lambda *a: None)
    slos = {s["name"]: s for s in report["slos"]}
    assert report["traffic"]["submit_429"] > 0 and not report["misfires"]
    assert slos["429_misfires"]["ok"] and slos["all_terminal"]["ok"], slos
    assert slos["one_lowering_per_tenant"]["ok"], slos
