"""The port's live telemetry (``obs/metrics.py``, ``obs/exporter.py``,
``obs/alerts.py``) against the JAX package's on the CPU.

One event stream per configuration comes from a short port run (the MLP on
a 600 / 100 synthetic set made from a numpy seed, K = 10, 3 rounds, gm2
and median ``--var``, ``--defense monitor --forensics full``, ``--alerts``
with the repo's rules file).  It is fed through the JAX package's
``MetricsSink``/``AlertEngine`` and through the port's, the way the
harness feeds them (fold each event, evaluate after each round event,
finalize after ``run_end``): the registries' ``snapshot()`` and
``render()``, the alert events and the ``finalize`` summary must be equal,
exactly, and equal to what the port's run wrote live.  Then the exporter
on a free port, the flags and their validation, the metrics sink's place
outside the writer thread, and records bitwise with telemetry on and off.
"""

import dataclasses
import json
import os
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from byzantine_aircomp_tpu import cli as jcli
from byzantine_aircomp_tpu import obs as jobs
from byzantine_aircomp_tpu.fed.config import FedConfig as JaxFedConfig
from byzantine_aircomp_tpu.obs import alerts as jalerts
from byzantine_aircomp_tpu.obs import metrics as jmetrics
from byzantine_aircomp_tpu_torch import cli as tcli
from byzantine_aircomp_tpu_torch import obs as tobs
from byzantine_aircomp_tpu_torch.data import datasets as tdata
from byzantine_aircomp_tpu_torch.fed import harness as tharness
from byzantine_aircomp_tpu_torch.fed.config import FedConfig
from byzantine_aircomp_tpu_torch.obs import alerts as talerts
from byzantine_aircomp_tpu_torch.obs import metrics as tmetrics
from byzantine_aircomp_tpu_torch.obs import writer as twriter

RULES = os.path.join(os.path.dirname(tobs.__file__), os.pardir, "tools", "alert_rules.json")
PKGS = {"jax": (jmetrics, jalerts), "port": (tmetrics, talerts)}


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: many small ops, and the test workers share cores
    (the bitwise checks compare runs of one process, with one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ds():
    return tdata.load("mnist", synthetic_train=600, synthetic_val=100)


def _kw(**kw):
    base = dict(honest_size=8, byz_size=2, attack="signflip", agg="gm2", rounds=3,
                display_interval=2, batch_size=16, eval_train=False, agg_maxiter=20,
                defense="monitor", defense_warmup=1, forensics="full", forensics_top=4)
    base.update(kw)
    return base


def _stream(obs_dir):
    (name,) = [n for n in os.listdir(obs_dir) if n.endswith(".events.jsonl")]
    with open(os.path.join(obs_dir, name)) as f:
        return [json.loads(line) for line in f]


def _run(ds, tmp_path, tag, **kw):
    cfg = FedConfig(cache_dir=str(tmp_path / f"{tag}_rec"), **kw)
    trainer, record = tharness.run_with_trainer(cfg, device="cpu", dataset=ds)
    return trainer, record


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _replay(pkg, events, rules):
    """Fold ``events`` (a stream, without its live alert and snapshot
    events) as the harness does: each event into the sink, the engine after
    each round event and once more after run_end (finalize), its alert
    events into the same sink.  Returns the registry, the alert events and
    the finalize summary."""
    metrics, alerts = PKGS[pkg]
    sinks = {"jax": jobs, "port": tobs}[pkg]
    registry = metrics.MetricsRegistry()
    sink = metrics.MetricsSink(registry)
    fired = sinks.MemorySink()
    engine_out = sinks.MultiSink([sink, fired])
    engine = alerts.AlertEngine(alerts.load_rules(rules), registry)
    last_round = max(next(e for e in events if e["kind"] == "run_start")["rounds"] - 1, 0)
    summary = None
    for e in events:
        if e["kind"] in ("alert", "metrics_snapshot"):
            continue
        sink.emit(e)
        if e["kind"] == "round":
            engine.evaluate(e["round"], engine_out)
        if e["kind"] == "run_end":
            summary = engine.finalize(last_round, engine_out)
    return registry, fired.events, summary


def _alert_fields(e):
    return {k: e[k] for k in ("round", "rule", "severity", "metric", "value", "threshold",
                              "firing")}


# ---------------------------------------------------------------------------
# the registry and the alerts on a port stream


_STREAMS = {
    "gm2": dict(),
    "median_var": dict(agg="median", noise_var=1e-2),
    # the dispatch loop, each round's events folded from its host rows,
    # with the writer thread on
    "gm2_r2_async": dict(rounds=4, rounds_per_dispatch=2, async_writer="on"),
}


@pytest.fixture(scope="module", params=list(_STREAMS))
def stream(request, ds, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(request.param)
    _run(ds, tmp, "on", **_kw(obs_dir=str(tmp / "obs"), alerts=RULES,
                              **_STREAMS[request.param]))
    return _stream(str(tmp / "obs"))


def test_registry_snapshot_and_render_equal_jax_on_a_port_stream(stream):
    assert stream[-1]["kind"] == "metrics_snapshot"
    jreg, jfired, jsummary = _replay("jax", stream, RULES)
    treg, tfired, tsummary = _replay("port", stream, RULES)
    assert treg.snapshot() == jreg.snapshot()
    assert treg.render() == jreg.render()
    assert [_alert_fields(e) for e in tfired] == [_alert_fields(e) for e in jfired]
    assert tsummary == jsummary
    # the port's live registry and engine wrote the same into the stream
    live = stream[-1]
    assert live["metrics"] == json.loads(json.dumps(treg.snapshot()))
    assert live["alerts"] == tsummary
    assert [_alert_fields(e) for e in stream if e["kind"] == "alert"] == [
        _alert_fields(e) for e in tfired]
    rounds = live["metrics"]["aircomp_rounds_total"]["series"][0]["value"]
    assert rounds == stream[1]["rounds"]
    assert tsummary["total_fired"] >= 1  # the rules file's progress rule fires


# each handler of the JAX sink, with values that reach each branch
_EVENTS = [
    ("run_start", dict(title="t", backend="cpu", rounds=8, start_round=0, k=8, byz=0)),
    ("span", dict(name="round", ms=12.5, compiled=True)),
    ("span", dict(name="queue_wait", ms=90_000.0)),
    ("span", dict(name="eval", ms=float("nan"))),
    ("round", dict(round=0, train_loss=0.5, train_acc=0.8, val_loss=float("nan"),
                   val_acc=0.8, variance=1.0, round_secs=0.02, rounds_per_sec=50.0,
                   dropped=1, erased=0, corrupt=2, effective_k=6, bytes_in_use=10,
                   peak_bytes_in_use=20, mem_source="device:cuda")),
    ("participation", dict(round=0, available=7, absent=1, late=2, effective_k=5)),
    ("rollback", dict(round=1, restored_round=0, reason="non_finite", epoch=1)),
    ("defense", dict(round=1, rung=1, flagged=2)),
    ("client_flag", dict(round=1, client=3, flagged=True)),
    ("client_flag", dict(round=1, client=4, flagged=False)),
    ("retrace", dict(counts={"round_fn": 2}, steady_state_ok=False)),
    ("alert", dict(round=1, rule="r", severity="page", firing=True)),
    ("alert", dict(round=2, rule="r", severity="page", firing=False)),
    ("run_failed", dict(reason="quarantined lane")),
    ("run_failed", dict(reason="wedged run")),
    ("run_failed", dict(reason="boom")),
    ("run_requeued", dict()),
    ("journal_replay", dict(status="running")),
    ("lane_group", dict(occupancy=0.5, live=4, lanes=8, queue_depth=3)),
    ("lane_refill", dict()),
    ("edge_partial", dict(bytes=1024)),
    ("edge_reject", dict(reason="hmac")),
    ("edge_quarantine", dict(edge=2, reason="timeout")),
    ("edge_round", dict(degraded=True, edges=3, ingress_bytes=4096)),
    ("run_end", dict(rounds_per_sec=40.0, memory={"modeled_peak_bytes": 100,
                                                   "peak_bytes_in_use": 150,
                                                   "source": "device:cuda"})),
    ("unknown_kind", dict()),
]


def test_every_event_kind_folds_as_in_jax():
    out = {}
    for pkg, (metrics, _) in PKGS.items():
        registry = metrics.MetricsRegistry()
        sink = metrics.MetricsSink(registry)
        sink.wedge_secs = 5.0
        health = []
        for kind, fields in _EVENTS:
            if kind == "run_end":
                # running: wedged 10 s after the last round, healthy at 0.5 s
                health += [sink.health(now=110.0), sink.health(now=100.5)]
            sink.emit(dict(v=10, kind=kind, ts=100.0, **fields))
        # one family past MAX_SERIES label sets folds into __overflow__
        for i in range(metrics.MAX_SERIES + 3):
            registry.inc("aircomp_many_total", client=str(i))
        labeled = metrics.LabeledRegistry(registry, run_id="r1")
        labeled.observe("aircomp_lane_seconds", 0.3)
        labeled.set("aircomp_lane_gauge", 2.0, lane="0")
        health.append(sink.health(now=110.0))
        out[pkg] = (registry.snapshot(), registry.render(),
                    registry.quantile("aircomp_stage_seconds", 0.5, stage="round"),
                    registry.quantile("aircomp_queue_wait_seconds", 0.99),
                    labeled.value("aircomp_lane_gauge", lane="0"),
                    labeled.quantile("aircomp_lane_seconds", 0.9),
                    health)
    assert out["port"] == out["jax"]
    assert [h["ok"] for h in out["port"][6]] == [False, True, True]
    assert out["port"][6][2]["phase"] == "done"
    reg = tmetrics.MetricsRegistry()
    reg.inc("aircomp_x")
    with pytest.raises(ValueError, match="registered as counter"):
        reg.set("aircomp_x", 1.0)


def test_watermark_ratio_reads_the_run_s_own_peak():
    """A card run's memory block carries the run's own peak beside the
    device's (which holds what the caller allocated before the run): the
    port's ratio reads the run's, the JAX sink's the device's; a block
    without the run's peak gives both the same ratio."""
    mem = {"source": "device:cuda", "peak_bytes_in_use": 300, "baseline_bytes": 200,
           "run_peak_bytes": 100, "modeled_peak_bytes": 100}
    ratios = {}
    for pkg, (metrics, _) in PKGS.items():
        for name, block in (("run", mem), ("device", {k: v for k, v in mem.items()
                                                      if k != "run_peak_bytes"})):
            registry = metrics.MetricsRegistry()
            metrics.MetricsSink(registry).emit(dict(v=10, kind="run_end", ts=1.0,
                                                    memory=block))
            ratios[pkg, name] = registry.value("aircomp_hbm_watermark_ratio")
    assert ratios == {("port", "run"): 1.0, ("port", "device"): 3.0,
                      ("jax", "run"): 3.0, ("jax", "device"): 3.0}


def test_default_rules_and_scenarios_are_jax_s():
    assert talerts.DEFAULT_RULES == jalerts.DEFAULT_RULES
    scen_t, scen_j = talerts._scenarios(), jalerts._scenarios()
    assert set(scen_t) == set(scen_j) == {r["name"] for r in talerts.DEFAULT_RULES}
    for name in scen_t:
        for case in ("breach", "healthy"):
            got = talerts._run_scenario(scen_t[name][case])
            assert got == jalerts._run_scenario(scen_j[name][case]), (name, case)
    assert talerts.self_check() == 0


@pytest.mark.parametrize("spec", [
    dict(name="a", metric="m", op="gt"),
    dict(name="a", metric="m", op="eq", value=1),
    dict(name="a", metric="m", op="gt", value=1, reduce="median"),
    dict(name="a", metric="m", op="gt", value=1, severity="fatal"),
    dict(name="a", metric="m", op="gt", value=1, window=0),
    dict(name="a", metric="m", op="gt", value=1, quantile=1.5),
    dict(name="a", metric="m", op="gt", value=1, colour="red"),
])
def test_rules_refuse_what_jax_refuses(tmp_path, spec):
    path = tmp_path / "rules.json"
    path.write_text(json.dumps([spec]))
    with pytest.raises((ValueError, TypeError)) as j:
        jalerts.load_rules(str(path))
    with pytest.raises(type(j.value)):
        talerts.load_rules(str(path))


def test_gate_reads_a_stream_as_jax_does(stream, tmp_path, capsys):
    path = tmp_path / "s.events.jsonl"
    path.write_text("".join(json.dumps(e) + "\n" for e in stream))
    for fail_on in ("info", "warn", "page"):
        codes = []
        for mod in (jalerts, talerts):
            codes.append(mod.main(["--gate", str(path), "--fail-on", fail_on]))
            codes.append(capsys.readouterr().out)
        assert codes[:2] == codes[2:]


# ---------------------------------------------------------------------------
# the exporter


def test_exporter_serves_metrics_and_healthz_on_a_free_port():
    registry = tmetrics.MetricsRegistry()
    sink = tmetrics.MetricsSink(registry)
    sink.emit(dict(v=10, kind="run_start", ts=1.0, k=8, byz=2, rounds=3))
    sink.emit(dict(v=10, kind="round", ts=2.0, round=0, train_loss=1.0, val_loss=1.0,
                   val_acc=0.5, variance=0.1, round_secs=0.2))
    health = {"now": 3.0}
    exporter = tobs.MetricsExporter(registry, port=0, host="127.0.0.1",
                                    health_fn=lambda: sink.health(now=health["now"]))
    with exporter:
        port = exporter.port
        status, body = _get(port, "/metrics")
        assert status == 200 and body == registry.render()
        assert 'aircomp_events_total{kind="round"} 1' in body
        status, body = _get(port, "/healthz?verbose=1")
        assert status == 200 and json.loads(body) == sink.health(now=3.0)
        assert json.loads(body)["phase"] == "running"
        sink.wedge_secs, health["now"] = 5.0, 60.0
        status, body = _get(port, "/healthz")
        assert status == 503 and json.loads(body)["reason"].startswith("wedged")
        assert _get(port, "/nothing")[0] == 404
        # a second server on the bound port fails loudly
        with pytest.raises(OSError):
            tobs.MetricsExporter(registry, port=port, host="127.0.0.1").start()
    assert exporter.port is None
    assert not any(t.name == "aircomp-metrics-exporter" for t in threading.enumerate())
    with pytest.raises(OSError):
        _get(port, "/metrics")


def _exporter_threads():
    return [t for t in threading.enumerate() if t.name == "aircomp-metrics-exporter"]


def test_a_run_serves_metrics_live_and_closes_the_port(ds, tmp_path):
    port = _free_port()
    scrapes = []

    def scrape(r, _t):
        status, body = _get(port, "/metrics")
        total = [float(line.split()[-1]) for line in body.splitlines()
                 if line.startswith("aircomp_rounds_total ")]
        scrapes.append((r, status, total, json.loads(_get(port, "/healthz")[1])))

    cfg = FedConfig(cache_dir=str(tmp_path / "rec"), metrics_port=port,
                    **_kw(forensics="off", forensics_top=8))
    tharness.run_with_trainer(cfg, device="cpu", dataset=ds, on_round=scrape)
    assert [(r, s, t) for r, s, t, _ in scrapes] == [(1, 200, [1.0]), (2, 200, [2.0]),
                                                     (3, 200, [3.0])]
    assert [h["last_round"] for *_, h in scrapes] == [0, 1, 2]
    assert not _exporter_threads()
    with pytest.raises(OSError):
        _get(port, "/metrics")


def test_the_exporter_closes_when_the_run_raises(ds, tmp_path):
    def boom(r, _t):
        raise RuntimeError("stop")

    cfg = FedConfig(cache_dir=str(tmp_path / "rec"), metrics_port=_free_port(),
                    **_kw(forensics="off", forensics_top=8))
    with pytest.raises(RuntimeError, match="stop"):
        tharness.run_with_trainer(cfg, device="cpu", dataset=ds, on_round=boom)
    assert not _exporter_threads()


def test_a_taken_port_fails_the_run(ds, tmp_path):
    with socket.socket() as s:
        s.bind(("0.0.0.0", 0))
        s.listen(1)
        cfg = FedConfig(cache_dir=str(tmp_path / "rec"), metrics_port=s.getsockname()[1],
                        **_kw(forensics="off", forensics_top=8))
        with pytest.raises(OSError):
            tharness.run_with_trainer(cfg, device="cpu", dataset=ds)
    assert not _exporter_threads()


# ---------------------------------------------------------------------------
# the flags, their validation, and the sink outside the writer


@pytest.mark.parametrize("kw,on,engine", [
    (dict(), False, False),
    (dict(metrics="on"), True, False),
    (dict(metrics_port=9), True, False),
    (dict(alerts="default"), True, True),
    (dict(obs_stdout=True), False, False),
])
def test_port_and_alerts_imply_metrics_as_in_jax(kw, on, engine):
    for mod, cfg in ((jobs, JaxFedConfig(**kw)), (tobs, FedConfig(**kw))):
        o = mod.from_config(cfg, "t")
        assert (o.registry is not None, o.alert_engine is not None) == (on, engine)
        assert o.enabled == bool(kw)
        o.close()


def test_the_metrics_sink_stays_outside_the_writer(tmp_path):
    writer = twriter.WriterThread()
    try:
        o = tobs.from_config(FedConfig(obs_dir=str(tmp_path), metrics="on"), "t", writer=writer)
        assert isinstance(o.sink, tobs.MultiSink)
        jsonl, metrics = o.sink.sinks
        assert isinstance(jsonl, tobs.AsyncSink) and metrics is o.metrics_sink
        o.close()
    finally:
        writer.close()


def test_async_writer_alerts_see_their_own_round(ds, tmp_path):
    """With the writer thread on, each rule at round r samples the registry
    through round r: the progress rule fires at round 1 (the first round
    with two samples) and a rule on the round index fires at round 2."""
    rules = tmp_path / "rules.json"
    rules.write_text(json.dumps([
        {"name": "progress", "metric": "aircomp_rounds_total", "window": 2,
         "reduce": "delta", "op": "ge", "value": 1, "severity": "info"},
        {"name": "late_round", "metric": "aircomp_round", "op": "ge", "value": 2,
         "severity": "warn"},
    ]))
    cfg = _kw(forensics="off", forensics_top=8, rounds=4, rounds_per_dispatch=2,
              async_writer="on", obs_dir=str(tmp_path / "obs"), alerts=str(rules))
    _run(ds, tmp_path, "async", **cfg)
    events = _stream(str(tmp_path / "obs"))
    fired = [(e["rule"], e["round"], e["value"]) for e in events
             if e["kind"] == "alert" and e["firing"]]
    assert fired == [("progress", 1, 1.0), ("late_round", 2, 2.0)]
    assert [e["round"] for e in events if e["kind"] == "round"] == [0, 1, 2, 3]


@pytest.mark.parametrize("kw", [
    dict(metrics="yes"), dict(metrics_port=-1), dict(metrics_port=70000), dict(alerts=""),
    dict(alerts="/nonexistent/rules.json"),
])
def test_validation_refuses_what_jax_refuses(kw):
    with pytest.raises((ValueError, AssertionError, OSError)):
        JaxFedConfig(**kw).validate()
    with pytest.raises((ValueError, OSError)):
        FedConfig(**kw).validate()


@pytest.mark.parametrize("kw", [dict(metrics="on"), dict(metrics_port=9100),
                                dict(alerts="default"), dict(alerts=RULES)])
def test_validation_accepts_what_jax_accepts_and_the_hash_holds(kw):
    JaxFedConfig(**kw).validate()
    cfg = FedConfig(**kw).validate()
    assert tharness.config_hash(cfg) == tharness.config_hash(FedConfig())
    assert tharness.run_title(cfg) == tharness.run_title(FedConfig())


@pytest.mark.parametrize("argv", [
    [], ["--metrics", "on"], ["--metrics-port", "9100"], ["--alerts", "default"],
    ["--metrics", "on", "--metrics-port", "0", "--alerts", RULES],
])
def test_cli_flags_parse_like_the_jax_cli(argv):
    tcfg = tcli.config_from_args(tcli.build_parser().parse_args(argv + ["--device", "cpu"]))
    jcfg = jcli.config_from_args(jcli.build_parser().parse_args(argv))
    for name in ("metrics", "metrics_port", "alerts"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name


# ---------------------------------------------------------------------------
# records


def _records_bitwise(a, b):
    assert set(a) == set(b)
    for key in a:
        if key == "roundsPerSec":
            continue
        x, y = a[key], b[key]
        if isinstance(x, list) and x and all(isinstance(v, float) for v in x + y):
            assert np.array_equal(np.asarray(x), np.asarray(y), equal_nan=True), key
        else:
            assert x == y, key


@pytest.mark.parametrize("kw", [dict(), dict(rounds=4, rounds_per_dispatch=2)],
                         ids=["r1", "r2"])
def test_records_are_bitwise_with_telemetry_on_and_off(ds, tmp_path, kw, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the flight recorder's run-end dump lands here
    t_off, r_off = _run(ds, tmp_path, "off", **_kw(**kw))
    on = _kw(metrics="on", metrics_port=_free_port(), alerts="default", **kw)
    t_on, r_on = _run(ds, tmp_path, "on", **on)
    _records_bitwise(r_on, r_off)
    assert torch.equal(t_on.flat_params, t_off.flat_params)
    cfg = FedConfig(**on)
    assert tharness.ckpt_title(cfg) == tharness.ckpt_title(dataclasses.replace(
        cfg, metrics="off", metrics_port=0, alerts="off"))
