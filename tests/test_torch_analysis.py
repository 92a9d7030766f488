"""The port's stream readers (``byzantine_aircomp_tpu_torch/analysis/``)
against their JAX twins on the CPU, on the same port streams and the same
ledger rows.

The streams come from short port runs (the MLP on a 600 / 100 synthetic
set made from a numpy seed, K = 10, gm2 under signflip, ``--defense
monitor``): one traced run with ``--forensics full`` and ``--alerts``, and
one rotated into 1 KiB segments and resumed (1 round, then ``--inherit``
to 3), and JAX ``test_forensics.py``'s audit configuration (service
rounds, K = 16 of 48, the adaptive defense, ``--forensics top``).  Each
reader's CLI prints for a stream what its JAX twin prints,
exactly, on standard output and standard error; where a reader names a
command, the port's names the port's package.  The perf gate reads one
ledger of ``cuda``, ``cpu`` and ``tpu`` rows and gives the JAX gate's
verdicts and lines, and never scores a CUDA row against another platform.
"""

import json
import os

import pytest
import torch

from byzantine_aircomp_tpu.analysis import audit as jaudit
from byzantine_aircomp_tpu.analysis import defense_trace as jdefense_trace
from byzantine_aircomp_tpu.analysis import obs_report as jobs_report
from byzantine_aircomp_tpu.analysis import perf_gate as jperf_gate
from byzantine_aircomp_tpu.analysis import tail as jtail
from byzantine_aircomp_tpu.analysis import trace_view as jtrace_view
from byzantine_aircomp_tpu.obs import ledger as jledger
from byzantine_aircomp_tpu_torch import analysis as tanalysis
from byzantine_aircomp_tpu_torch.analysis import audit as taudit
from byzantine_aircomp_tpu_torch.analysis import defense_trace as tdefense_trace
from byzantine_aircomp_tpu_torch.analysis import obs_report as tobs_report
from byzantine_aircomp_tpu_torch.analysis import perf_gate as tperf_gate
from byzantine_aircomp_tpu_torch.analysis import tail as ttail
from byzantine_aircomp_tpu_torch.analysis import trace_view as ttrace_view
from byzantine_aircomp_tpu_torch.data import datasets as tdata
from byzantine_aircomp_tpu_torch.fed import harness as tharness
from byzantine_aircomp_tpu_torch.fed.config import FedConfig
from byzantine_aircomp_tpu_torch.obs import ledger as tledger

READERS = {
    "obs_report": (jobs_report, tobs_report),
    "defense_trace": (jdefense_trace, tdefense_trace),
    "trace_view": (jtrace_view, ttrace_view),
    "tail": (jtail, ttail),
    "audit": (jaudit, taudit),
}
RULES = os.path.join(os.path.dirname(tanalysis.__file__), os.pardir, "tools",
                     "alert_rules.json")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(**kw):
    base = dict(honest_size=8, byz_size=2, attack="signflip", agg="gm2", rounds=3,
                display_interval=2, batch_size=16, eval_train=False, agg_maxiter=20,
                defense="monitor", defense_warmup=1)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """{name: the run's obs dir}: ``traced``, ``rotated_resumed`` and
    ``service_audit``."""
    ds = tdata.load("mnist", synthetic_train=600, synthetic_val=100)
    root = tmp_path_factory.mktemp("streams")
    out = {}
    d = root / "traced"
    tharness.run_with_trainer(FedConfig(**_kw(
        obs_dir=str(d), trace="on", forensics="full", forensics_top=4, alerts=RULES,
        cache_dir=str(root / "rec1"))), device="cpu", dataset=ds)
    out["traced"] = d
    d = root / "rotated_resumed"
    kw = _kw(obs_dir=str(d), obs_rotate_mb=1 / 1024, checkpoint_dir=str(root / "ck"),
             cache_dir=str(root / "rec2"))
    tharness.run_with_trainer(FedConfig(**dict(kw, rounds=1)), device="cpu", dataset=ds)
    tharness.run_with_trainer(FedConfig(**dict(kw, inherit=True)), device="cpu", dataset=ds)
    out["rotated_resumed"] = d
    # JAX test_forensics.py's audit configuration (service rounds, the
    # adaptive defense, signflip), whose precision JAX's own run misses
    d = root / "service_audit"
    tharness.run_with_trainer(FedConfig(
        rounds=3, honest_size=12, byz_size=4, population=48, service="on",
        attack="signflip", agg="mean", defense="adaptive",
        defense_ladder="mean,trimmed_mean,median", seed=0, forensics="top",
        forensics_top=8, display_interval=2, batch_size=16, eval_train=False,
        obs_dir=str(d), cache_dir=str(root / "rec3")), device="cpu", dataset=ds)
    out["service_audit"] = d
    return out


def _live(d):
    (name,) = [n for n in os.listdir(d) if n.endswith(".events.jsonl")]
    return str(d / name)


def _outputs(capsys, main, argv):
    try:
        code = main(argv)
    except SystemExit as e:
        code = e.code
    out, err = capsys.readouterr()
    return code, out.replace("byzantine_aircomp_tpu_torch", "byzantine_aircomp_tpu"), err


_ARGVS = {
    "obs_report": lambda d, f: [[f], [f, "--json"], [str(d)], [str(d), "--json"]],
    "defense_trace": lambda d, f: [[f], [f, "--json"]],
    "trace_view": lambda d, f: [[str(d)], [f]],
    "tail": lambda d, f: [[str(d), "--once"], [f, "--once"]],
    "audit": lambda d, f: [[f], [f, "--json"]],
}


@pytest.mark.parametrize("stream", ["traced", "rotated_resumed", "service_audit"])
@pytest.mark.parametrize("reader", list(READERS))
def test_each_reader_prints_what_its_jax_twin_prints(streams, capsys, reader, stream):
    d = streams[stream]
    jmod, tmod = READERS[reader]
    for argv in _ARGVS[reader](d, _live(d)):
        want = _outputs(capsys, jmod.main, argv)
        got = _outputs(capsys, tmod.main, argv)
        assert got == want, argv
        assert (want[1] + want[2]).strip(), argv


def test_trace_view_writes_jax_s_perfetto_trace(streams, tmp_path, capsys):
    d = streams["traced"]
    for name, mod in (("jax", jtrace_view), ("port", ttrace_view)):
        assert mod.main([str(d), "--trace-out", str(tmp_path / f"{name}.json"),
                         "--out", str(tmp_path / f"{name}.md"),
                         "--assert-no-orphans"]) == 0
    capsys.readouterr()
    assert (json.load(open(tmp_path / "port.json"))
            == json.load(open(tmp_path / "jax.json")))
    assert (tmp_path / "port.md").read_text() == (tmp_path / "jax.md").read_text()
    events = tdefense_trace.load_events(_live(d))
    spans = [e for e in events if e["kind"] == "span"]
    traces = ttrace_view.assemble(spans)
    assert len(traces) == 1
    assert ttrace_view.round_table(spans) == jtrace_view.round_table(spans)
    assert [r["round"] for r in ttrace_view.round_table(spans)] == [0, 1, 2, 3]
    assert ttrace_view.stage_table(spans) == jtrace_view.stage_table(spans)


def test_rotated_resumed_stream_loads_in_order_and_counts_each_round_once(streams):
    path = _live(streams["rotated_resumed"])
    segments = [n for n in os.listdir(streams["rotated_resumed"]) if ".jsonl." in n]
    assert len(segments) >= 2
    events = tdefense_trace.load_events(path)
    assert events == jdefense_trace.load_events(path)
    assert [e["seq"] for e in events] == list(range(len(events)))
    assert [e["start_round"] for e in events if e["kind"] == "run_start"] == [0, 1]
    summary = tobs_report.summarize(tobs_report.order_events(events))
    assert summary == jobs_report.summarize(jobs_report.order_events(events))
    phases = summary["phases"]
    assert phases["round[compile]"]["count"] + phases["round[steady]"]["count"] == 3
    assert [r["round"] for r in tdefense_trace.trace(events)["rows"]] == [0, 1, 2]
    assert [e["round"] for e in events if e["kind"] == "round"] == [0, 1, 2]


@pytest.mark.parametrize("stream", ["traced", "service_audit"])
def test_audit_scores_what_jax_scores(streams, stream):
    events = tdefense_trace.load_events(_live(streams[stream]))
    got, want = taudit.audit(events), jaudit.audit(events)
    assert got == want
    assert got["summary"]["flag_events"] == sum(
        1 for e in events if e["kind"] == "client_flag" and e["flagged"])
    if stream == "service_audit":
        # the last byz_size population shards; the precision is what the
        # run gives (JAX's own run of this config misses its 0.9 bar)
        assert got["summary"]["ground_truth"]["byz_ids"] == list(range(36, 48))


def test_analysis_entry_runs_each_reader(streams, capsys, monkeypatch):
    import runpy

    path = _live(streams["traced"])
    for reader, code in (("audit", 0), ("plots", 2)):
        monkeypatch.setattr("sys.argv", ["analysis", reader, path, "--json"])
        with pytest.raises(SystemExit) as e:
            runpy.run_module("byzantine_aircomp_tpu_torch.analysis", run_name="__main__")
        assert e.value.code == code
    got = capsys.readouterr().out
    assert got == _outputs(capsys, jaudit.main, [path, "--json"])[1]


# ---------------------------------------------------------------------------
# the perf gate over one ledger


def _ledger(mod, path):
    led = mod.PerfLedger(path)
    for v in (100.0, 92.0, 107.0, 98.0, 103.0, 95.0, 109.0, 101.0):
        led.append("rounds_per_sec_z9", v, unit="rounds/sec", platform="cuda",
                   card="NVIDIA H100 80GB HBM3", power_limit="700.00 W")
    led.append("rounds_per_sec_z9", 5.0, unit="rounds/sec", platform="cpu")
    led.append("host_only", 3.0, unit="ms", platform="tpu")
    return led


_ROWS = [
    dict(metric="rounds_per_sec_z9", value=50.0, platform="cuda"),
    dict(metric="rounds_per_sec_z9", value=104.0, platform="cuda"),
    dict(metric="rounds_per_sec_z9", value=250.0, platform="cuda"),
    dict(metric="rounds_per_sec_z9", value=5.1, platform="cpu"),
    dict(metric="rounds_per_sec_z9", value=100.0, platform="tpu"),
    dict(metric="host_only", value=3.0, platform="cuda"),
    dict(metric="never_seen", value=1.0, platform="cuda"),
]


@pytest.mark.parametrize("row", _ROWS, ids=lambda r: f"{r['platform']}_{r['value']}")
def test_perf_gate_gives_jax_s_verdicts_on_one_ledger(tmp_path, capsys, row):
    path = str(tmp_path / "perf_ledger_cuda.jsonl")
    _ledger(tledger, path)
    led = tledger.PerfLedger(path)
    want = jperf_gate.gate(row, jledger.PerfLedger(path))
    got = tperf_gate.gate(row, led)
    assert got == want
    if row["platform"] == "cuda" and row["metric"] == "host_only":
        # cuda has no history of it; the tpu row is never its baseline
        assert got["verdict"] == "platform_mismatch"
    for extra in ([], ["--json"], ["--expect-platform", "cuda", "--strict-platform"]):
        argv = ["--ledger", path, "--metric", row["metric"], "--value", str(row["value"]),
                "--platform", row["platform"]] + extra
        assert _outputs(capsys, tperf_gate.main, argv) == _outputs(capsys, jperf_gate.main,
                                                                   argv), extra


def test_perf_gate_reads_the_port_s_ledger_by_default(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert tperf_gate.DEFAULT_LEDGER_PATH == "chiprun_out/perf_ledger_cuda.jsonl"
    _ledger(tledger, tperf_gate.DEFAULT_LEDGER_PATH)
    row = tmp_path / "row.json"
    row.write_text(json.dumps({"parsed": dict(_ROWS[1], unit="rounds/sec")}))
    assert tperf_gate.main(["--row", str(row), "--append"]) == 0
    assert tperf_gate.main(["--metric", "rounds_per_sec_z9", "--value", "50",
                            "--platform", "cuda"]) == 1
    out = capsys.readouterr().out
    assert "[perf_gate] ok" in out and "[perf_gate] regression" in out
    rows = tledger.PerfLedger(tperf_gate.DEFAULT_LEDGER_PATH).rows()
    assert rows[-1]["value"] == 104.0 and rows[-1]["note"] == "perf_gate --append"
    assert tperf_gate.self_check() == 0
