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
    # the group forms once every arrival has landed, so its make-up does
    # not hang on a loaded worker's timing: under JAX's 0.05 s window the
    # first tenants may be seated alone, and six tenants are too few for
    # the later ones' refills to keep a lane group full; here one group
    # holds them all, and its drain tail (horizons of 2 to 4 rounds) is two
    # samples under the occupancy floor, which fires at four
    report = tsoak.run_soak(_args(workdir=str(tmp_path), batch_window=3.0),
                            log=lambda *a: None)
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
