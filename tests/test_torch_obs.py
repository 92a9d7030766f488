"""The port's observability (``byzantine_aircomp_tpu_torch/obs/``) against
the JAX package's on the CPU: the sinks (``seq``, append on resume,
rotation, atomic mode, a full disk), ``AsyncSink`` ordering under
concurrent emits, spans, the profiler's window and memory watermarks, the
memory model's integers, the retrace counter, the perf ledger, the twelve
config knobs (validation, CLI flags, the config hash), the log's tee and
quiet mode; then whole runs of the MLP on a 1,500 / 300 synthetic set
(K = 10, 3 rounds): the stream's sequence of event kinds equals the JAX
run's of the same config (resident gm2 with the monitor defense and
forensics top, service rounds, an R = 2 dispatch), the JAX package's own
readers read the port's stream, the records are bitwise the same with
every knob on and off, a resume appends to the same stream, and a
prefetched dispatch with the stream on still defers its folds.

Comparisons are exact (the same integers, the same verdicts, the same
kinds in the same order); records are compared bitwise but for
``roundsPerSec`` (a host-clock reading).
"""

import dataclasses
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from byzantine_aircomp_tpu import cli as jcli
from byzantine_aircomp_tpu.analysis import defense_trace as jdefense_trace
from byzantine_aircomp_tpu.analysis import obs_report as jobs_report
from byzantine_aircomp_tpu.data import datasets as jdata
from byzantine_aircomp_tpu.fed import harness as jharness
from byzantine_aircomp_tpu.fed.config import FedConfig as JaxFedConfig
from byzantine_aircomp_tpu.obs import hbm as jhbm
from byzantine_aircomp_tpu.obs import ledger as jledger
from byzantine_aircomp_tpu.obs import profile as jprofile
from byzantine_aircomp_tpu.obs import sinks as jsinks
from byzantine_aircomp_tpu_torch import cli as tcli
from byzantine_aircomp_tpu_torch import obs as tobs
from byzantine_aircomp_tpu_torch.data import datasets as tdata
from byzantine_aircomp_tpu_torch.fed import harness as tharness
from byzantine_aircomp_tpu_torch.fed import train as ttrain
from byzantine_aircomp_tpu_torch.fed.config import FedConfig
from byzantine_aircomp_tpu_torch.obs import hbm as thbm
from byzantine_aircomp_tpu_torch.obs import ledger as tledger
from byzantine_aircomp_tpu_torch.obs import profile as tprofile
from byzantine_aircomp_tpu_torch.obs import sinks as tsinks
from byzantine_aircomp_tpu_torch.obs.writer import AsyncSink, WriterThread


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: many small ops, and the test workers share cores
    (the bitwise checks compare runs of one process, with one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SINKS = {"jax": jsinks, "port": tsinks}


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


# ---------------------------------------------------------------------------
# sinks


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_jsonl_appends_resumes_and_counts_seq(tmp_path, pkg):
    mod = SINKS[pkg]
    p = str(tmp_path / "ev.jsonl")
    s1 = mod.JsonlSink(p)
    assert s1.fresh
    event = {"kind": "a", "x": 1}
    s1.emit(event)
    assert "seq" not in event  # stamped on a copy
    assert _lines(p)[0]["x"] == 1  # flushed per line, before close
    s1.emit({"kind": "a", "x": 2})
    s1.close()
    s2 = mod.JsonlSink(p)
    assert not s2.fresh
    s2.emit({"kind": "a", "x": 3})
    s2.close()
    assert [(e["x"], e["seq"]) for e in _lines(p)] == [(1, 0), (2, 1), (3, 2)]


def test_sinks_write_what_the_jax_sinks_write(tmp_path, capsys):
    """Memory, JSONL (append and atomic), stdout and a fan-out, fed the
    same events: the same bytes and the same per-sink ``seq``."""
    events = [{"v": 10, "kind": k, "ts": 1.5, "x": i} for i, k in enumerate("abab")]
    out = {}
    for pkg, mod in SINKS.items():
        mem, mem2 = mod.MemorySink(), mod.MemorySink()
        live, atomic = str(tmp_path / f"{pkg}.jsonl"), str(tmp_path / f"{pkg}_at.jsonl")
        multi = mod.MultiSink([mem2, mod.JsonlSink(live)])
        at = mod.JsonlSink(atomic, atomic=True)
        for e in events:
            mem.emit(e)
            multi.emit(e)
            at.emit(e)
            mod.StdoutSink().emit(e)
        assert not os.path.exists(atomic)  # nothing until close
        multi.close()
        at.close()
        out[pkg] = (mem.events, mem2.events, mem.by_kind("b"), open(live).read(),
                    open(atomic).read(), capsys.readouterr().out)
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_rotation_keeps_one_seq_across_segments_and_resume(tmp_path, pkg):
    mod = SINKS[pkg]
    p = str(tmp_path / "run.events.jsonl")
    pad = "x" * 400
    sink = mod.JsonlSink(p, rotate_mb=1024 / 2**20)  # rotate past 1 KiB
    for i in range(10):
        sink.emit({"kind": "a", "i": i, "pad": pad})
    sink.close()
    segments = mod.rotated_segments(p)
    assert len(segments) >= 3
    sink = mod.JsonlSink(p, rotate_mb=1024 / 2**20)  # a resume counts every segment
    assert not sink.fresh
    sink.emit({"kind": "a", "i": 10, "pad": pad})
    sink.close()
    rows = [e for s in mod.rotated_segments(p) + [p] for e in _lines(s)]
    assert [e["seq"] for e in rows] == list(range(11))
    assert [e["i"] for e in rows] == list(range(11))


def test_rotation_names_the_jax_segments(tmp_path):
    names = {}
    for pkg, mod in SINKS.items():
        p = str(tmp_path / pkg / "run.events.jsonl")
        sink = mod.JsonlSink(p, rotate_mb=512 / 2**20)
        for i in range(6):
            sink.emit({"kind": "a", "i": i, "pad": "y" * 300})
        sink.close()
        names[pkg] = [os.path.basename(s) for s in mod.rotated_segments(p)]
    assert names["port"] == names["jax"] and names["port"]


def test_full_disk_degrades_with_one_warning(tmp_path, capsys):
    class _Full:
        def write(self, s):
            raise OSError(28, "No space left on device")

        def flush(self):
            pass

        def close(self):
            pass

    sink = tsinks.JsonlSink(str(tmp_path / "full.jsonl"))
    sink._fh.close()
    sink._fh = _Full()
    sink.emit({"kind": "a"})
    sink.emit({"kind": "a"})
    assert capsys.readouterr().err.count("further events dropped") == 1
    sink.flush()
    sink.close()


def test_async_sink_orders_concurrent_emits():
    """Racing producers through AsyncSink: one gapless ``seq`` order, each
    producer's events in its own order, nothing lost at close."""
    mem, writer = tsinks.MemorySink(), WriterThread()
    sink = AsyncSink(mem, writer)
    n_threads, per = 4, 50

    def produce(tid):
        for i in range(per):
            sink.emit({"kind": "x", "tid": tid, "i": i})

    threads = [threading.Thread(target=produce, args=(t,)) for t in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # interleave the producers as much as possible
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    sink.close()
    writer.close()
    assert [e["seq"] for e in mem.events] == list(range(n_threads * per))
    for tid in range(n_threads):
        assert [e["i"] for e in mem.events if e["tid"] == tid] == list(range(per))
    assert writer.error is None


def test_async_sink_rides_in_submission_order_with_other_tasks(capsys):
    """Event appends and other writer tasks (checkpoints, the record) run
    in the order submitted; a failing task degrades with one warning."""
    mem, writer, order = tsinks.MemorySink(), WriterThread(maxsize=2), []
    sink = AsyncSink(mem, writer)
    sink.emit({"kind": "a"})
    writer.submit(lambda: order.append(len(mem.events)))
    writer.submit(lambda: 1 / 0)
    sink.emit({"kind": "b"})
    sink.flush()
    assert order == [1] and [e["kind"] for e in mem.events] == ["a", "b"]
    assert isinstance(writer.error, ZeroDivisionError)
    assert capsys.readouterr().err.count("async writer task failed") == 1
    writer.close()


# ---------------------------------------------------------------------------
# spans, trace ids, retrace


def test_span_reports_fields_errors_and_nesting():
    sink = tsinks.MemorySink()
    obs = tobs.Observability(sink)
    with obs.span("round", round=2, sync=torch.device("cpu")) as sp:
        sp["compiled"] = True
    with pytest.raises(RuntimeError):
        with obs.span("eval", round=3):
            raise RuntimeError("boom")
    r, e = sink.events
    assert (r["name"], r["round"], r["compiled"], r["ms"] >= 0) == ("round", 2, True, True)
    assert e["error"] is True and "trace_id" not in r
    obs.traced = True
    with obs.span("run"):
        with obs.span("round", round=0):
            obs.emit("round", round=0, val_loss=1.0, val_acc=0.5, variance=0.0)
    inner_ev, inner, outer = sink.events[2:]
    assert inner["parent_span_id"] == outer["span_id"] == inner["parent_span_id"]
    assert inner_ev["span_id"] == inner["span_id"]
    assert len({inner_ev["trace_id"], inner["trace_id"], outer["trace_id"]}) == 1
    assert "parent_span_id" not in outer


def test_retrace_counts_builds_and_checks():
    det, warned = tobs.RetraceDetector(), []
    assert det.snapshot() == {"round_fn": 0, "multi_round_fn": 0, "eval_fn": 0}
    det.build("multi_round_fn")
    assert det.check("multi_round_fn", warn_fn=warned.append) and not warned
    det.build("multi_round_fn")
    assert not det.check("multi_round_fn", warn_fn=warned.append) and len(warned) == 1
    with pytest.raises(tobs.RetraceError):
        det.check("multi_round_fn", error=True)


# ---------------------------------------------------------------------------
# profiler, memory


@pytest.mark.parametrize("spec", ["0:1", "2:5", "1:1", "3:2", "-1:2", "a:b", "1", "1:2:3"])
def test_parse_rounds_agrees_with_jax(spec):
    def outcome(fn):
        try:
            return fn(spec)
        except ValueError:
            return "refused"

    assert outcome(tprofile.parse_rounds) == outcome(jprofile.parse_rounds)


def test_profiler_window_traces_its_rounds_only(tmp_path):
    prof = tprofile.Profiler(str(tmp_path), (1, 2), device=torch.device("cpu"))
    for r in range(3):
        prof.round_start(r)
        with prof.step(r):
            torch.ones(4).sum()
        with prof.phase("eval"):
            torch.ones(2).sum()
        prof.round_end(r)
    prof.close()
    assert prof.captured and prof.trace_paths == [str(tmp_path / "trace.json")]
    names = [ev.get("name") for ev in json.load(open(prof.trace_paths[0]))["traceEvents"]]
    assert names.count("round") == 1 and names.count("eval") == 1
    assert tprofile.from_config(FedConfig()) is tprofile.NULL_PROFILER
    assert tprofile.NULL_PROFILER.step(0) is tprofile.NULL_PROFILER.phase("eval")


def test_profiler_suspends_into_a_new_segment(tmp_path):
    """A suspended stretch (a CUDA-graph capture) stays out of the trace:
    the trace so far is written, and a new segment holds what follows."""
    prof = tprofile.Profiler(str(tmp_path), device=torch.device("cpu"))
    prof.start()
    for r in range(2):
        with prof.step(r):
            torch.ones(4).sum()
        if r == 0:
            with prof.suspended():
                with torch.profiler.record_function("captured"):
                    torch.ones(3).sum()
    prof.close()
    assert [os.path.basename(p) for p in prof.trace_paths] == ["trace.json", "trace_1.json"]
    for path in prof.trace_paths:
        names = [ev.get("name") for ev in json.load(open(path))["traceEvents"]]
        assert names.count("round") == 1 and "captured" not in names
    with tprofile.NULL_PROFILER.suspended():
        pass


def test_device_memory_on_the_cpu_is_host_rss():
    row = tprofile.device_memory(torch.device("cpu"))
    assert row["source"] == "host_rss" and row["peak_bytes_in_use"] >= row["bytes_in_use"] > 0
    assert tprofile.per_device_memory([torch.device("cpu")])[0]["source"] == "host_rss"


@pytest.mark.parametrize("k", [1, 10, 50, 1000])
@pytest.mark.parametrize("d", [1, 7850, 48670, 3274634])
def test_memory_models_give_jax_integers(k, d):
    assert thbm.stack_bytes(k, d) == jhbm.stack_bytes(k, d)
    for bits in (1, 8, 16, 32):
        assert thbm.packed_stack_bytes(k, d, bits) == jhbm.packed_stack_bytes(k, d, bits)
    for impl in ("pallas", "xla"):
        assert thbm.packed_vote_hbm_bytes(k, d, impl) == jhbm.packed_vote_hbm_bytes(k, d, impl)
    for impl in ("pallas", "select", "sort"):
        for ch in (False, True):
            assert (thbm.epilogue_hbm_bytes(impl, k, d, k // 5, ch)
                    == jhbm.epilogue_hbm_bytes(impl, k, d, k // 5, ch))
    for agg in ("gm2", "median", "trimmed_mean", "mean"):
        for impl in ("pallas", "xla"):
            for fused in (False, True):
                kw = dict(impl=impl, fused=fused, channel=True, trim=k // 5)
                assert (thbm.aggregator_hbm_model(agg, k, d, **kw)
                        == jhbm.aggregator_hbm_model(agg, k, d, **kw))
    assert thbm.modeled_peak_bytes(k, d, data_bytes=99) == jhbm.modeled_peak_bytes(
        k, d, data_bytes=99)
    for cohort in (1, 10, 50):
        for shards in (1, 4):
            kw = dict(data_bytes=7, state_bytes_per_client=12, pop_shards=shards)
            assert (thbm.streamed_peak_bytes(k, d, cohort, **kw)
                    == jhbm.streamed_peak_bytes(k, d, cohort, **kw))


def test_port_model_counts_its_terms():
    client = thbm.client_step_bytes(100, 3136, 40, input_copies=2)
    assert client == 100 * (2 * 3136 + 2 * 40)
    got = thbm.cuda_peak_bytes(10, 7850, client_bytes=client, data_bytes=5, channel_copies=2)
    assert got == 5 + 4 * 7850 * 4 + 5 * 10 * 7850 * 4 + client
    streamed = thbm.cuda_peak_bytes(4, 7850, client_bytes=0, param_copies=6,
                                    state_bytes=1200)
    assert streamed == 6 * 7850 * 4 + 3 * 4 * 7850 * 4 + 1200


def test_per_sample_bytes_from_layer_shapes():
    from byzantine_aircomp_tpu_torch.registry import MODELS

    gen = torch.Generator().manual_seed(0)
    mlp = MODELS.get("MLP")(input_shape=(28, 28), num_classes=10, generator=gen)
    assert thbm.per_sample_bytes(mlp, (784,)) == (3136, 40)
    net = MODELS.get("ResNet18")(input_shape=(8, 8, 3), num_classes=10, width=8,
                                 generator=gen)
    full = thbm.per_sample_bytes(net, (8, 8, 3))
    remat = thbm.per_sample_bytes(net, (8, 8, 3), remat=True)
    assert full[0] == remat[0] == 8 * 8 * 3 * 4
    assert 0 < remat[1] < full[1]


# ---------------------------------------------------------------------------
# ledger


def test_ledger_appends_and_judges_as_jax_does(tmp_path):
    verdicts = {}
    for pkg, mod in (("jax", jledger), ("port", tledger)):
        led = mod.PerfLedger(str(tmp_path / f"{pkg}.jsonl"))
        key = mod.config_key({"k": 1000, "agg": "gm2", "b": 100, "x": 1})
        for v in (10.0, 10.5, 9.8, 10.1):
            led.append("rps", v, unit="1/s", platform="cuda", key=key, card="H100")
        verdicts[pkg] = (key, led.history("rps", "cuda", key), [
            {k: v for k, v in led.compare("rps", x, platform=p, key=key).items()}
            for x, p in ((10.0, "cuda"), (7.0, "cuda"), (14.0, "cuda"), (10.0, "tpu"))
        ] + [led.compare("other", 1.0, platform="cuda")],
            mod.robust_stats([1.0, 2.0, 9.0]))
    assert verdicts["port"] == verdicts["jax"]
    assert [v["verdict"] for v in verdicts["port"][2]] == [
        "ok", "regression", "improvement", "platform_mismatch", "new_metric"]
    assert tledger.DEFAULT_LEDGER_PATH == "chiprun_out/perf_ledger_cuda.jsonl"


# ---------------------------------------------------------------------------
# the twelve knobs: validation, flags, hash, log routing


_BASE = dict(honest_size=8, byz_size=2, attack="classflip", agg="gm2")


@pytest.mark.parametrize("kw", [
    dict(profile_rounds="1:2"),
    dict(profile_dir="p", profile_rounds="2:1"),
    dict(hbm_warn_factor=0.0),
    dict(obs_rotate_mb=-1.0),
    dict(obs_rotate_mb=1.0),
    dict(forensics="some"),
    dict(forensics_top=4),
    dict(flight_window=3),
    dict(forensics="top"),
    dict(forensics="full", defense="monitor", forensics_top=11),
    dict(forensics="top", defense="monitor", forensics_top=0),
    dict(forensics="full", defense="monitor", flight_window=0),
])
def test_validation_refuses_what_jax_refuses(kw):
    with pytest.raises((ValueError, AssertionError)):
        JaxFedConfig(**_BASE, **kw).validate()
    with pytest.raises(ValueError):
        FedConfig(**_BASE, **kw).validate()


@pytest.mark.parametrize("kw", [
    dict(profile_dir="p", profile_rounds="1:2", hbm_warn_factor=3.0),
    dict(obs_dir="o", obs_rotate_mb=0.5, obs_stdout=True, trace="on"),
    dict(forensics="full", defense="monitor", forensics_top=10, flight_window=2),
    dict(forensics="top", defense="adaptive", defense_ladder="gm2,median"),
    dict(log_file="l.txt", quiet=True),
])
def test_validation_accepts_what_jax_accepts_and_the_hash_holds(kw):
    JaxFedConfig(**_BASE, **kw).validate()
    cfg = FedConfig(**_BASE, **kw).validate()
    base = FedConfig(**_BASE, **{k: v for k, v in kw.items()
                                 if k.startswith("defense")})
    assert tharness.config_hash(cfg) == tharness.config_hash(base)
    assert tharness.run_title(cfg) == tharness.run_title(base)


def test_obs_fields_are_the_jax_fields_with_jax_defaults():
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxFedConfig)}
    port = {f.name: f.default for f in dataclasses.fields(FedConfig)}
    assert len(FedConfig._OBS_FIELDS) == 15
    for name in FedConfig._OBS_FIELDS:
        assert port[name] == jax_fields[name], name
    assert len(set(jax_fields) & set(port)) == 109


ARGV = ["--profile-dir", "pd", "--profile-rounds", "2:5", "--hbm-warn-factor", "3.5",
        "--obs-dir", "od", "--obs-stdout", "--log-file", "lf", "--obs-rotate-mb", "2",
        "--trace", "on", "--quiet", "--forensics", "full", "--forensics-top", "4",
        "--flight-window", "3", "--defense", "monitor", "--agg", "gm2"]


@pytest.mark.parametrize("argv", [[], ARGV])
def test_cli_flags_parse_like_the_jax_cli(argv):
    tcfg = tcli.config_from_args(tcli.build_parser().parse_args(argv + ["--device", "cpu"]))
    jcfg = jcli.config_from_args(jcli.build_parser().parse_args(argv))
    for name in FedConfig._OBS_FIELDS:
        assert getattr(tcfg, name) == getattr(jcfg, name), name


def test_log_file_tees_and_quiet_silences(tmp_path, capsys):
    path = str(tmp_path / "run.log")
    restore = tharness.configure_log(path, quiet=True)
    tharness.log("hello", 3)
    restore()
    tharness.log("after")
    out = capsys.readouterr().out
    assert "hello" not in out and "after" in out
    assert open(path).read().rstrip().endswith("hello 3")


# ---------------------------------------------------------------------------
# whole runs


@pytest.fixture(scope="module")
def ds():
    return tdata.load("mnist", synthetic_train=1500, synthetic_val=300)


@pytest.fixture(scope="module")
def jds():
    return jdata.load("mnist", synthetic_train=1500, synthetic_val=300)


def _kw(**kw):
    base = dict(honest_size=8, byz_size=2, attack="signflip", agg="gm2", rounds=3,
                display_interval=2, batch_size=16, eval_train=False, agg_maxiter=20,
                defense="monitor", defense_warmup=1)
    base.update(kw)
    return base


def _stream(obs_dir):
    (name,) = [n for n in os.listdir(obs_dir) if n.endswith(".events.jsonl")]
    return _lines(os.path.join(obs_dir, name))


def _kinds(events):
    """The stream as (kind, span name) tokens, a run of client_flag events
    as one token (how many clients a round flags depends on the draws,
    which differ between the packages by construction)."""
    out = []
    for e in events:
        tok = (e["kind"], e.get("name"))
        if tok == ("client_flag", None) and out and out[-1] == tok:
            continue
        out.append(tok)
    return out


def _jax_run(monkeypatch, jds, tmp_path, **kw):
    monkeypatch.setattr(jdata, "load", lambda name, **_: jds)
    cfg = JaxFedConfig(agg_impl="xla", cache_dir=str(tmp_path / "jrec"),
                       obs_dir=str(tmp_path / "jobs"), **kw)
    jharness.run(cfg)
    return _stream(cfg.obs_dir)


def _port_run(ds, tmp_path, tag="obs", **kw):
    cfg = FedConfig(cache_dir=str(tmp_path / f"{tag}_rec"), **kw)
    trainer, record = tharness.run_with_trainer(cfg, device="cpu", dataset=ds)
    events = _stream(cfg.obs_dir) if cfg.obs_dir else None
    return trainer, record, events


@pytest.mark.parametrize("kw", [
    dict(forensics="top", forensics_top=4),
    dict(service="on", population=20, straggler_prob=0.2, rollback="off"),
    dict(rounds=4, rounds_per_dispatch=2, forensics="top", forensics_top=4),
], ids=["resident_forensics", "service", "dispatch_r2"])
def test_stream_has_the_jax_sequence_of_kinds(monkeypatch, tmp_path, ds, jds, kw):
    jevents = _jax_run(monkeypatch, jds, tmp_path, **_kw(**kw))
    _, _, events = _port_run(ds, tmp_path, obs_dir=str(tmp_path / "obs"), **_kw(**kw))
    assert _kinds(events) == _kinds(jevents)
    for e in events:
        tobs.validate_event(e)
    assert [e["seq"] for e in events] == list(range(len(events)))
    # the JAX package's own readers read the port's stream
    digest = jobs_report.summarize(events)
    assert digest["run"]["rounds"] == kw.get("rounds", 3)
    story = jdefense_trace.trace(events)
    assert len(story["rows"]) == kw.get("rounds", 3)
    rounds = [e for e in events if e["kind"] == "round"]
    assert [e["round"] for e in rounds] == list(range(kw.get("rounds", 3)))
    assert all(e["mem_source"] == "host_rss" for e in rounds)


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
def test_records_are_bitwise_with_every_knob_on_and_off(tmp_path, ds, kw):
    t_off, r_off, _ = _port_run(ds, tmp_path, tag="off", **_kw(**kw))
    t_on, r_on, events = _port_run(
        ds, tmp_path, tag="on", **_kw(
            obs_dir=str(tmp_path / "obs"), forensics="full", forensics_top=5,
            flight_window=2, profile_dir=str(tmp_path / "prof"),
            # a window opens at a dispatch's first round
            profile_rounds="2:4" if kw else "1:2",
            trace="on", log_file=str(tmp_path / "log.txt"), **kw))
    _records_bitwise(r_on, r_off)
    assert torch.equal(t_on.flat_params, t_off.flat_params)
    assert os.path.exists(tmp_path / "obs" / "flight_run_end.json")
    assert os.path.exists(tmp_path / "prof" / "trace.json")
    kinds = [e["kind"] for e in events if e["kind"] != "span"]
    assert kinds[-4:] == ["profile", "retrace", "forensic_dump", "run_end"]
    assert (events[-1]["kind"], events[-1]["name"]) == ("span", "run")  # the trace root
    end = [e for e in events if e["kind"] == "run_end"][0]["memory"]
    assert end["source"] == "host_rss" and end["exceeds_model"] is False
    assert end["modeled_peak_bytes"] > 0 and "model_terms" in end
    assert all("trace_id" in e for e in events)


@pytest.mark.parametrize("kw", [dict(), dict(rounds=4, rounds_per_dispatch=2)],
                         ids=["r1", "r2"])
def test_retrace_event_counts_the_runs_builds(tmp_path, ds, kw):
    """On the CPU every round runs eagerly: one eager set-up, no capture,
    and only the run's first round (or dispatch) is marked as paying."""
    t, _, events = _port_run(ds, tmp_path, **_kw(obs_dir=str(tmp_path / "obs"), **kw))
    assert t.round_graph is None
    (retrace,) = [e for e in events if e["kind"] == "retrace"]
    assert retrace["counts"] == {"round_fn": 1, "multi_round_fn": 0, "eval_fn": 0}
    assert retrace["steady_state_ok"] is True
    name = "dispatch" if kw else "round"
    spans = [e for e in events if e["kind"] == "span" and e["name"] == name]
    assert [e["compiled"] for e in spans] == [True] + [False] * (len(spans) - 1)
    assert len(spans) == kw.get("rounds", 3) // kw.get("rounds_per_dispatch", 1)


def test_resume_appends_to_the_stream_and_continues_rounds(tmp_path, ds):
    kw = _kw(obs_dir=str(tmp_path / "obs"), checkpoint_dir=str(tmp_path / "ck"))
    _port_run(ds, tmp_path, **dict(kw, rounds=1))
    _port_run(ds, tmp_path, **dict(kw, rounds=3, inherit=True))
    events = _stream(kw["obs_dir"])
    assert [e["seq"] for e in events] == list(range(len(events)))
    assert [e["round"] for e in events if e["kind"] == "round"] == [0, 1, 2]
    starts = [e["start_round"] for e in events if e["kind"] == "run_start"]
    assert starts == [0, 1]


def test_prefetched_run_with_the_stream_on_defers_its_folds(tmp_path, ds, monkeypatch):
    """Dispatch i+1 is queued before dispatch i's rows are read and folded
    into the paths and the stream (on the card the same order is what lets
    the host fold overlap the device)."""
    order = []
    stacked, get = ttrain.Trainer.run_rounds_stacked, ttrain._HostRows.get

    def run_stacked(self, r, n):
        order.append(("dispatch", r))
        return stacked(self, r, n)

    def host_get(self):
        order.append(("fold",))
        return get(self)

    monkeypatch.setattr(ttrain.Trainer, "run_rounds_stacked", run_stacked)
    monkeypatch.setattr(ttrain._HostRows, "get", host_get)
    cfg = _kw(rounds=8, rounds_per_dispatch=2, eval_interval=8, dispatch_prefetch="on",
              obs_dir=str(tmp_path / "obs"))
    _, record, events = _port_run(ds, tmp_path, **cfg)
    assert order[:4] == [("dispatch", 0), ("dispatch", 2), ("fold",), ("dispatch", 4)]
    assert [e["round"] for e in events if e["kind"] == "round"] == list(range(8))
    _, r_off, _ = _port_run(ds, tmp_path, tag="plain",
                            **dict(cfg, obs_dir="", dispatch_prefetch="off"))
    _records_bitwise(record, r_off)
