"""The port's experiment server (``byzantine_aircomp_tpu_torch/serve/``)
against the JAX package's on the CPU, and its lanes against the port's own
solo runs.

* The batch contract: ``validate_batch``'s verdicts and error texts,
  ``validate_stream_batch``'s, ``applicable_knobs`` and the
  ``static_signature`` digest equal JAX's on the same configs (a JAX
  config's mapping parsed by the port's ``config_from_mapping``).
* The HTTP surface: one scripted session (submit, get, list, swap, cancel,
  the 429 of a full queue, ``idempotency_key``, the 401 of
  ``--auth-token``, 404, 400) gets JAX's status codes and JSON keys from
  both servers, exporter-only (no scheduler), so the runs stay queued.
* The lanes: seed lanes bitwise their solo ``Trainer.train`` under
  ``vmap`` and ``map``; a knob swap that changes a lane from round r on
  with one build; a refill bitwise its solo run; a quarantine that leaves
  the cotenants bitwise; resume through checkpoints bitwise; population-
  shard tenants bitwise their solo harness runs.  All bitwise (the same
  trainer code on one thread), ``roundsPerSec`` aside.
"""

import dataclasses
import json
import os
import pickle
import threading
import urllib.error
import urllib.request

import pytest
import torch

from byzantine_aircomp_tpu.fed.config import FedConfig as JaxFedConfig
from byzantine_aircomp_tpu.fed.config import config_to_mapping as jax_to_mapping
from byzantine_aircomp_tpu.serve import batch as jbatch
from byzantine_aircomp_tpu.serve import elastic as jelastic
from byzantine_aircomp_tpu_torch.data import datasets as tdata
from byzantine_aircomp_tpu_torch.fed import harness as tharness
from byzantine_aircomp_tpu_torch.fed.config import (
    FedConfig,
    config_from_mapping,
    config_to_mapping,
)
from byzantine_aircomp_tpu_torch.fed.train import Trainer
from byzantine_aircomp_tpu_torch.serve import batch as tbatch
from byzantine_aircomp_tpu_torch.serve import elastic as telastic
from byzantine_aircomp_tpu_torch.serve.batch import BatchRunner
from byzantine_aircomp_tpu_torch.serve.runs import QueueFull, RunManager
from byzantine_aircomp_tpu_torch.serve.server import ExperimentServer


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: many small ops (tests/test_torch_dispatch.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ds():
    return tdata.load("mnist", synthetic_train=600, synthetic_val=200)


BASE = dict(dataset="mnist", honest_size=6, byz_size=0, rounds=2, display_interval=2,
            batch_size=16, agg="mean", eval_train=False)


def _kw(**kw):
    return dict(BASE, **kw)


def _cfg(**kw):
    return FedConfig(use_gpu=False, **_kw(**kw))


def _pair(**kw):
    """The same config in both packages: JAX's, and the port's parsed from
    its mapping."""
    j = JaxFedConfig(**_kw(**kw))
    return j, config_from_mapping(json.loads(json.dumps(jax_to_mapping(j))), use_gpu=False)


def _stream_kw(**kw):
    return dict(dict(honest_size=12, byz_size=4, rounds=2, agg="median", attack="gaussian",
                     noise_var=0.1, service="on", population=48, churn_arrival=0.05,
                     churn_departure=0.02, straggler_prob=0.2, cohort_size=2,
                     rollback="off", sharded=False), **kw)


def _verdict(fn, cfgs):
    try:
        return ("ok", sorted(fn(cfgs)))
    except ValueError as exc:
        return ("error", str(exc))


# ------------------------------------------------------------ the contract

CONTRACT_CASES = {
    "seeds": [dict(seed=1), dict(seed=2)],
    "knobs_and_horizons": [dict(seed=1, gamma=0.5, rounds=3), dict(seed=2, weight_decay=1e-4)],
    "honest_size": [dict(seed=1), dict(seed=2, honest_size=8)],
    "agg": [dict(), dict(agg="trimmed_mean")],
    "cohort": [dict(cohort_size=3, cohort_quantile="exact")],
    "dirichlet_seeds": [dict(partition="dirichlet", dirichlet_alpha=0.5, seed=1),
                        dict(partition="dirichlet", dirichlet_alpha=0.5, seed=2)],
    "dirichlet_same_seed": [dict(partition="dirichlet", dirichlet_alpha=0.5, seed=1)] * 2,
    "attack_param_presence": [dict(byz_size=2, attack="gaussian", attack_param=1.0),
                              dict(byz_size=2, attack="gaussian")],
    "noise_var_presence": [dict(noise_var=1e-2), dict()],
    "service_rollback": [dict(byz_size=2, attack="signflip", service="on", population=24,
                              rollback="on")],
    "defended": [dict(byz_size=2, attack="signflip", defense="adaptive",
                      defense_ladder="mean,trimmed_mean,median", defense_z=3.0),
                 dict(byz_size=2, attack="signflip", defense="adaptive",
                      defense_ladder="mean,trimmed_mean,median", defense_up=4)],
    "output_only": [dict(obs_dir="a", trace="on"), dict(obs_dir="b", metrics="on")],
}


@pytest.mark.parametrize("case", sorted(CONTRACT_CASES))
def test_validate_batch_verdicts_and_texts_are_jax_s(case):
    pairs = [_pair(**kw) for kw in CONTRACT_CASES[case]]
    jcfgs, tcfgs = [p[0] for p in pairs], [p[1] for p in pairs]
    assert _verdict(tbatch.validate_batch, tcfgs) == _verdict(jbatch.validate_batch, jcfgs)
    assert (_verdict(telastic.validate_stream_batch, tcfgs)
            == _verdict(jelastic.validate_stream_batch, jcfgs))
    assert tbatch.applicable_knobs(tcfgs[0]) == jbatch.applicable_knobs(jcfgs[0])
    # the grouping key: the same digest, so the same groups
    assert [tbatch.static_signature(c) for c in tcfgs] == \
        [jbatch.static_signature(c) for c in jcfgs]


def test_stream_contract_pins_gating_knobs_as_jax_does():
    a, ta = _pair(**_stream_kw(seed=1))
    b, tb = _pair(**_stream_kw(seed=2, straggler_prob=0.4))
    c, tc = _pair(**_stream_kw(seed=2))
    assert tbatch.static_signature(ta) == jbatch.static_signature(a)
    assert tbatch.static_signature(ta) != tbatch.static_signature(tb)
    assert (_verdict(telastic.validate_stream_batch, [ta, tb])
            == _verdict(jelastic.validate_stream_batch, [a, b]))
    assert "straggler_prob" in _verdict(telastic.validate_stream_batch, [ta, tb])[1]
    assert (telastic.validate_stream_batch([ta, tc])
            == jelastic.validate_stream_batch([a, c]))
    assert telastic.pinned_knobs(ta) == jelastic.pinned_knobs(a) == ("straggler_prob",)
    assert tbatch.BATCHABLE_KNOBS == jbatch.BATCHABLE_KNOBS
    assert tbatch._OUTPUT_ONLY == jbatch._OUTPUT_ONLY
    assert tbatch.PINNED_STREAM_KNOBS == jbatch.PINNED_STREAM_KNOBS


def test_config_mapping_round_trips_and_refuses_as_jax_does():
    from byzantine_aircomp_tpu.fed.config import config_from_mapping as jax_from_mapping

    for kw in (dict(), dict(seed=7, gamma=0.5, rounds=9),
               dict(byz_size=2, attack="signflip", defense="adaptive",
                    defense_ladder="mean,trimmed_mean,median"),
               _stream_kw(pop_shards=8)):
        j, t = _pair(**kw)
        assert config_to_mapping(t) == jax_to_mapping(j)
        assert config_from_mapping(config_to_mapping(t), use_gpu=False) == t
    body = {"dataset": "mnist", "honest_size": 6, "rounds": "3", "gamma": 1}
    t, j = config_from_mapping(dict(body)), jax_from_mapping(dict(body))
    assert (t.honest_size, t.rounds, t.gamma) == (j.honest_size, j.rounds, j.gamma) == (6, 3, 1.0)
    assert isinstance(t.gamma, float) and t.use_gpu is True
    for bad in ({"bogus": 1}, {"gama": 0.1}):
        with pytest.raises(ValueError) as te:
            config_from_mapping(dict(bad))
        with pytest.raises(ValueError) as je:
            jax_from_mapping(dict(bad))
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="server's"):
        config_from_mapping({"use_gpu": False})


# ------------------------------------------------------------ the lanes


def _solo(cfg, ds):
    paths = Trainer(dataclasses.replace(cfg), dataset=ds, device="cpu").train()
    paths.pop("roundsPerSec")
    return paths


def _bits(paths):
    paths = dict(paths)
    paths.pop("roundsPerSec", None)
    return pickle.dumps(paths)


LANE_FAMILIES = {
    "mean": dict(),
    "gm2_classflip": dict(agg="gm2", byz_size=2, attack="classflip", agg_maxiter=30),
    "gm_var_defended": dict(agg="gm", byz_size=2, attack="signflip", noise_var=1e-3,
                            agg_maxiter=30, defense="monitor", forensics="top",
                            forensics_top=4),
}


@pytest.mark.parametrize("backend", ["vmap", "map"])
@pytest.mark.parametrize("family", sorted(LANE_FAMILIES))
def test_seed_lanes_are_bitwise_their_solo_runs(ds, backend, family):
    cfgs = [_cfg(rounds=3, seed=s, **LANE_FAMILIES[family]) for s in (11, 12, 13)]
    batch = BatchRunner(cfgs, dataset=ds, backend=backend)
    paths = batch.train()
    assert batch.retrace.count("batch_round_fn") == 1
    for cfg, got in zip(cfgs, paths):
        assert _bits(got) == pickle.dumps(_solo(cfg, ds))
    # the lanes read one dataset on the device
    assert all(t.x_train is batch.template.x_train for t in batch.trainers)


def test_a_group_uploads_its_dataset_once(ds, monkeypatch):
    """The build count is the count of the group's dataset uploads: one,
    its lanes, a swap and a refill included."""
    uploads = []
    stage = Trainer._stage_data

    def counted(self, cfg, data):
        uploads.append(cfg.seed)
        stage(self, cfg, data)

    monkeypatch.setattr(Trainer, "_stage_data", counted)
    batch = BatchRunner([_cfg(rounds=2, seed=s) for s in (1, 2, 3)], dataset=ds)
    batch.run_round(0)
    batch.set_knob(1, "gamma", 0.05)
    batch.release_lane(2)
    batch.install_lane(2, _cfg(rounds=2, seed=4), own_round=1)
    batch.run_round([1, 1, 1])
    assert uploads == [1] and batch.retrace.count("batch_round_fn") == 1
    first = batch.trainers[0]
    assert [t.staged_data for t in batch.trainers] == [True, False, False]
    assert all(t.x_train is first.x_train and t._eval_cache is first._eval_cache
               for t in batch.trainers)
    # a second group is a second set-up
    BatchRunner([_cfg(seed=5)], dataset=ds, retrace=batch.retrace)
    assert uploads == [1, 5] and batch.retrace.count("batch_round_fn") == 2


def test_a_swap_changes_a_lane_from_its_round_on_with_no_build(ds):
    cfgs = [_cfg(rounds=3, seed=1), _cfg(rounds=3, seed=2)]
    batch = BatchRunner(cfgs, dataset=ds)
    swapped = []

    def before(step):
        if step == 1:
            batch.set_knob(1, "gamma", 0.05)
            swapped.append(step)

    paths = batch.train(before_round=before)
    assert swapped == [1] and batch.retrace.count("batch_round_fn") == 1
    assert cfgs[1].gamma == 1e-2  # the caller's config is untouched
    assert _bits(paths[0]) == pickle.dumps(_solo(cfgs[0], ds))
    # the lane is its solo run with the knob written before round 1
    solo = Trainer(dataclasses.replace(cfgs[1]), dataset=ds, device="cpu")
    solo.run_round(0)
    solo.cfg.gamma = 0.05
    solo.run_round(1)
    solo.run_round(2)
    assert torch.equal(batch.lane_params(1), solo.flat_params)
    unswapped = Trainer(dataclasses.replace(cfgs[1]), dataset=ds, device="cpu")
    for r in range(3):
        unswapped.run_round(r)
    assert not torch.equal(batch.lane_params(1), unswapped.flat_params)
    with pytest.raises(KeyError, match="attack_param"):
        batch.set_knob(0, "attack_param", 2.0)


def test_a_detector_knob_swap_reaches_the_lane_s_defense(ds):
    cfg = _cfg(byz_size=2, attack="signflip", defense="adaptive",
               defense_ladder="mean,trimmed_mean,median")
    batch = BatchRunner([cfg, dataclasses.replace(cfg, seed=3)], dataset=ds)
    batch.set_knob(1, "defense_z", 7.5)
    batch.set_knob(1, "defense_up", 5.0)
    t0, t1 = batch.trainers
    assert (t1.defense.detector.z_thresh, t1.defense.policy.up_n) == (7.5, 5)
    assert isinstance(t1.defense.policy.up_n, int)
    assert (t0.defense.detector.z_thresh, t0.defense.policy.up_n) == (cfg.defense_z,
                                                                      cfg.defense_up)


def test_release_and_install_clear_the_lane_s_state(ds):
    batch = BatchRunner([_cfg(rounds=4, seed=1), _cfg(rounds=4, seed=2)], dataset=ds)
    batch.run_round(0)
    batch._quarantine(1, 0, "poisoned", None, lambda s: None)
    assert batch.failed == {1: "poisoned"} and not batch.active[1]
    batch.release_lane(1)
    assert 1 not in batch.failed
    batch.install_lane(1, _cfg(rounds=4, seed=3), own_round=1)
    assert batch.active[1] and batch.refills == 1 and batch.lane_rounds[1] == 1
    batch.run_round([1, 1])
    assert batch.retrace.count("batch_round_fn") == 1


def test_the_device_has_one_driving_thread(ds, tmp_path):
    batch = BatchRunner([_cfg(seed=1)], dataset=ds)
    errors = []

    def other():
        try:
            batch.run_round(0)
        except RuntimeError as exc:
            errors.append(str(exc))

    th = threading.Thread(target=other)
    th.start()
    th.join()
    assert errors and "one device thread" in errors[0]
    mgr = RunManager(str(tmp_path / "root"), dataset=ds, device="cpu",
                     batch_window=0.01).start()
    try:
        with pytest.raises(RuntimeError, match="scheduler thread"):
            mgr.drain()
    finally:
        mgr.close()


# ------------------------------------------------------------ the manager


def _record(info):
    with open(info["record"], "rb") as f:
        record = pickle.load(f)
    record.pop("roundsPerSec")
    return pickle.dumps(record)


def _events(root, rid):
    run_dir = os.path.join(root, rid)
    name = next(f for f in os.listdir(run_dir) if f.endswith(".events.jsonl"))
    with open(os.path.join(run_dir, name)) as f:
        return [json.loads(line) for line in f]


def test_one_group_per_signature_and_the_solo_routes(ds, tmp_path):
    mgr = RunManager(str(tmp_path / "root"), dataset=ds, device="cpu")
    ids = [mgr.submit(_cfg(seed=s)) for s in range(6)]
    solo_r = mgr.submit(_cfg(seed=1, rounds=2, rounds_per_dispatch=2))
    solo_rb = mgr.submit(FedConfig(use_gpu=False, **dict(_kw(), **_stream_kw(
        rollback="on", seed=1))))
    assert mgr.get(solo_r)["solo"] is True and mgr.get(solo_rb)["solo"] is True
    mgr.cancel(solo_rb)
    mgr.drain()
    infos = [mgr.get(rid) for rid in ids]
    assert {i["status"] for i in infos} == {"completed"}
    assert {i["lowerings"] for i in infos} == {1} and len({i["signature"] for i in infos}) == 1
    r = mgr.get(solo_r)
    assert r["status"] == "completed" and r["lowerings"] == 1
    # the solo R = 2 run is the harness's run of its config
    cfg = tharness.run_namespace(_cfg(seed=1, rounds=2, rounds_per_dispatch=2),
                                 "solo", str(tmp_path / "solo"))
    want = tharness.run_with_trainer(cfg, device="cpu", dataset=ds)[1]
    want.pop("roundsPerSec")
    assert _record(r) == pickle.dumps(want)
    events = _events(str(tmp_path / "root"), ids[0])
    assert events[0]["kind"] == "run_submitted" and events[0]["run_id"] == ids[0]
    assert sum(e["kind"] == "round" for e in events) == 2
    mgr.close()


def test_queued_cancel_swap_cap_and_idempotency(ds, tmp_path):
    mgr = RunManager(str(tmp_path / "root"), dataset=ds, device="cpu", queue_cap=3)
    keep, created = mgr.submit_idempotent(_cfg(seed=1), key="k")
    gone = mgr.submit(_cfg(seed=2))
    assert created and mgr.submit_idempotent(_cfg(seed=1), key="k") == (keep, False)
    mgr.submit(_cfg(seed=3))
    with pytest.raises(QueueFull, match="cap 3"):
        mgr.submit(_cfg(seed=4))
    mgr.swap(keep, "gamma", 0.25)
    assert mgr.cancel(gone)["status"] == "cancelled"
    with pytest.raises(ValueError, match="not hot-swappable"):
        mgr.swap(keep, "honest_size", 3)
    mgr.drain()
    assert mgr.get(keep)["status"] == "completed" and mgr.get(keep)["knobs"]["gamma"] == 0.25
    assert mgr.get(gone)["status"] == "cancelled"
    with pytest.raises(ValueError):
        mgr.swap(keep, "gamma", 0.1)
    with pytest.raises(KeyError):
        mgr.get("run-9999")
    mgr.close()


def test_a_refill_is_bitwise_its_solo_run_in_one_group(ds, tmp_path):
    mgr = RunManager(str(tmp_path / "root"), dataset=ds, device="cpu")
    a = mgr.submit(_cfg(rounds=1, seed=31))
    b = mgr.submit(_cfg(rounds=3, seed=32))
    late = []
    orig = BatchRunner.run_round

    def submitting(self, round_idx):
        if not late:
            late.append(mgr.submit(_cfg(rounds=2, seed=33)))
        return orig(self, round_idx)

    BatchRunner.run_round = submitting
    try:
        mgr.drain()
    finally:
        BatchRunner.run_round = orig
    c = late[0]
    for rid in (a, b, c):
        assert mgr.get(rid)["status"] == "completed" and mgr.get(rid)["lowerings"] == 1
    assert mgr.get(c)["lane"] == 0  # a's drained lane
    refills = [e for e in _events(str(tmp_path / "root"), c) if e["kind"] == "lane_refill"]
    assert len(refills) == 1 and refills[0]["round"] == 0
    control = RunManager(str(tmp_path / "control"), dataset=ds, device="cpu")
    cc = control.submit(_cfg(rounds=2, seed=33))
    control.drain()
    assert _record(mgr.get(c)) == _record(control.get(cc))
    mgr.close()
    control.close()


def test_a_quarantine_leaves_the_cotenants_bitwise(ds, tmp_path):
    healthy = [0, 1, 3]
    mgr = RunManager(str(tmp_path / "root"), dataset=ds, device="cpu")
    ids = {s: mgr.submit(_cfg(rounds=3, seed=s, gamma=1e38 if s == 2 else 1e-2))
           for s in range(4)}
    mgr.drain()
    bad = mgr.get(ids[2])
    assert bad["status"] == "failed" and bad["error"].startswith("quarantined:")
    kinds = [e["kind"] for e in _events(str(tmp_path / "root"), ids[2])]
    assert kinds.count("run_failed") == 1
    clean = RunManager(str(tmp_path / "clean"), dataset=ds, device="cpu")
    clean_ids = {s: clean.submit(_cfg(rounds=3, seed=s)) for s in healthy}
    clean.drain()
    for s in healthy:
        assert mgr.get(ids[s])["lowerings"] == 1
        assert _record(mgr.get(ids[s])) == _record(clean.get(clean_ids[s])), s
    mgr.close()
    clean.close()


def test_resume_through_checkpoints_is_bitwise(ds, tmp_path):
    root = str(tmp_path / "root")
    crashed = RunManager(root, dataset=ds, device="cpu")
    ids = [crashed.submit(_cfg(rounds=3, seed=s)) for s in (21, 22)]
    orig = BatchRunner.run_round

    def dying(self, round_idx):
        if round_idx == 2 or round_idx == [2, 2]:
            raise KeyboardInterrupt  # a SIGKILL stand-in: not an Exception
        return orig(self, round_idx)

    BatchRunner.run_round = dying
    try:
        with pytest.raises(KeyboardInterrupt):
            crashed.drain()
    finally:
        BatchRunner.run_round = orig
    healed = RunManager(root, dataset=ds, device="cpu")
    assert sorted(healed.recover()) == sorted(ids)
    assert [healed.get(r)["resume_round"] for r in ids] == [2, 2]
    healed.drain()
    control = RunManager(str(tmp_path / "control"), dataset=ds, device="cpu")
    cids = [control.submit(_cfg(rounds=3, seed=s)) for s in (21, 22)]
    control.drain()
    for rid, cid in zip(ids, cids):
        assert healed.get(rid)["status"] == "completed" and healed.get(rid)["lowerings"] == 1
        assert _record(healed.get(rid)) == _record(control.get(cid))
    events = _events(root, ids[0])
    replays = [e for e in events if e["kind"] == "journal_replay"]
    assert len(replays) == 1 and replays[0]["round"] == 2
    assert replays[0]["status"] == "resumed"
    seqs = [e["seq"] for e in events]
    assert seqs == sorted(seqs)
    healed.close()
    control.close()


def test_a_mid_refill_kill_replays_the_same_seat(ds, tmp_path):
    root = str(tmp_path / "root")
    crashed = RunManager(root, dataset=ds, device="cpu")
    a = crashed.submit(_cfg(rounds=1, seed=31))
    b = crashed.submit(_cfg(rounds=3, seed=32))
    late = []
    orig_run, orig_install = BatchRunner.run_round, BatchRunner.install_lane

    def submitting(self, round_idx):
        if not late:
            late.append(crashed.submit(_cfg(rounds=2, seed=33)))
        return orig_run(self, round_idx)

    def dying(self, lane, cfg, **kw):
        raise KeyboardInterrupt  # after the refill record, before the splice

    BatchRunner.run_round, BatchRunner.install_lane = submitting, dying
    try:
        with pytest.raises(KeyboardInterrupt):
            crashed.drain()
    finally:
        BatchRunner.run_round, BatchRunner.install_lane = orig_run, orig_install
    c = late[0]
    assert crashed.get(a)["status"] == "completed"
    healed = RunManager(root, dataset=ds, device="cpu")
    assert sorted(healed.recover()) == sorted([b, c])
    healed.drain()
    assert healed.get(c)["lane"] == 0 and healed.get(c)["lowerings"] == 1
    control = RunManager(str(tmp_path / "control"), dataset=ds, device="cpu")
    cids = [control.submit(_cfg(rounds=r, seed=s)) for r, s in ((1, 31), (3, 32), (2, 33))]
    control.drain()
    for rid, cid, mgr in ((a, cids[0], crashed), (b, cids[1], healed), (c, cids[2], healed)):
        assert _record(mgr.get(rid)) == _record(control.get(cid)), rid
    healed.close()
    control.close()


def test_population_shard_lanes_are_bitwise_their_solo_runs(ds, tmp_path):
    kw = dict(_kw(), **_stream_kw(pop_shards=2, agg="mean"))
    mgr = RunManager(str(tmp_path / "root"), dataset=ds, device="cpu")
    ids = [mgr.submit(FedConfig(use_gpu=False, **dict(kw, seed=s))) for s in (1, 2)]
    assert len({mgr.get(r)["signature"] for r in ids}) == 1
    assert not any(mgr.get(r).get("solo") for r in ids)
    mgr.drain()
    for s, rid in zip((1, 2), ids):
        info = mgr.get(rid)
        assert info["status"] == "completed" and info["lowerings"] == 1
        cfg = tharness.run_namespace(FedConfig(use_gpu=False, **dict(kw, seed=s)), f"s{s}",
                                     str(tmp_path / "solo"))
        want = tharness.run_with_trainer(cfg, device="cpu", dataset=ds)[1]
        want.pop("roundsPerSec")
        assert _record(info) == pickle.dumps(want)
    mgr.close()


# ------------------------------------------------------------ HTTP


def _req(base, method, path, body=None, token=None):
    headers = {"Authorization": f"Bearer {token}"} if token else {}
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(base + path, data=data, method=method, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read() or b"{}")


def _session(srv):
    """The scripted session; returns [(status, sorted keys)] per request."""
    base = f"http://127.0.0.1:{srv.port}"
    tiny = dict(BASE, seed=1)
    steps = [
        ("POST", "/runs", tiny, None),  # 401: no token
        ("POST", "//runs", tiny, None),  # 401 after path normalisation
        ("POST", "/runs", dict(tiny, idempotency_key="k-1"), "tok"),  # 201
        ("POST", "/runs", dict(tiny, idempotency_key="k-1"), "tok"),  # 200, same run
        ("POST", "/runs", dict(tiny, seed=2), "tok"),  # 201
        ("POST", "/runs", dict(tiny, seed=3), "tok"),  # 429
        ("POST", "/runs", dict(tiny, idempotency_key=7), "tok"),  # 400
        ("POST", "/runs", {"bogus": 1}, "tok"),  # 400
        ("GET", "/runs", None, None),
        ("GET", "/runs/run-0001", None, None),
        ("GET", "/runs/absent", None, None),  # 404
        ("POST", "/runs/run-0001/knobs", {"gamma": 0.5}, "tok"),
        ("POST", "/runs/run-0001/knobs", {"honest_size": 3}, "tok"),  # 400
        ("POST", "/runs/run-0001/knobs", {}, "tok"),  # 400
        ("POST", "/runs/run-0002/cancel", None, None),  # 401
        ("POST", "/runs/run-0002/cancel", None, "tok"),
        ("POST", "/runs/run-0002/knobs", {"gamma": 0.5}, "tok"),  # 400: done
        ("GET", "/runs/run-0002", None, None),
    ]
    out = []
    for method, path, body, token in steps:
        status, payload = _req(base, method, path, body, token)
        keys = sorted(payload) if isinstance(payload, dict) else payload
        if path == "/runs" and method == "GET":
            keys = [sorted(r) for r in payload["runs"]]
        out.append((method, path, status, keys))
    return out


def test_an_http_session_gets_jax_s_codes_and_keys(ds, tmp_path):
    from byzantine_aircomp_tpu.serve.server import ExperimentServer as JaxServer

    results = []
    for label, make in (
        ("jax", lambda root: JaxServer(root, port=0, host="127.0.0.1", queue_cap=2,
                                       auth_token="tok")),
        ("port", lambda root: ExperimentServer(root, port=0, host="127.0.0.1", queue_cap=2,
                                               auth_token="tok", dataset=ds, device="cpu")),
    ):
        srv = make(str(tmp_path / label))
        srv.exporter.start()  # no scheduler: the runs stay queued
        try:
            results.append(_session(srv))
            metrics = urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics", timeout=30).read().decode()
            assert 'aircomp_http_request_seconds_count{route="POST /runs"}' in metrics
        finally:
            srv.exporter.close()
            srv.manager.close()
    jax_s, port_s = results
    assert [r[2] for r in port_s] == [401, 401, 201, 200, 201, 429, 400, 400, 200, 200, 404,
                                      200, 400, 400, 401, 200, 400, 200]
    assert port_s == jax_s


def test_the_server_runs_its_tenants_and_serves_their_metrics(ds, tmp_path):
    import time

    with ExperimentServer(str(tmp_path / "root"), port=0, host="127.0.0.1",
                          batch_window=0.05, dataset=ds, device="cpu").start() as srv:
        base = f"http://127.0.0.1:{srv.port}"
        r1 = _req(base, "POST", "/runs", dict(BASE, seed=1))[1]
        r2 = _req(base, "POST", "/runs", dict(BASE, seed=2))[1]
        deadline = time.time() + 120
        while time.time() < deadline:
            statuses = [r["status"] for r in _req(base, "GET", "/runs")[1]["runs"]]
            if all(s in ("completed", "failed") for s in statuses):
                break
            time.sleep(0.1)
        assert statuses == ["completed", "completed"]
        info = _req(base, "GET", f"/runs/{r1['run_id']}")[1]
        assert info["lowerings"] == 1 and info["val_acc"] is not None
        metrics = urllib.request.urlopen(base + "/metrics", timeout=30).read().decode()
        for rid in (r1["run_id"], r2["run_id"]):
            assert f'aircomp_events_total{{kind="round",run_id="{rid}"}}' in metrics
        health = json.loads(urllib.request.urlopen(base + "/healthz", timeout=30).read())
        assert health == {"ok": True, "runs": {"completed": 2}}


def test_a_server_without_a_gpu_fails_at_start_up(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        ExperimentServer(str(tmp_path / "root"), port=0, host="127.0.0.1")


def test_root_and_edge_without_a_gpu_fail_at_start_up_unless_told_cpu(tmp_path, monkeypatch):
    """``root`` and ``edge`` run on the card unless ``--device cpu``: without
    a GPU they fail at start-up, naming the flag, never falling back."""
    import urllib.error

    from byzantine_aircomp_tpu_torch import cli
    from byzantine_aircomp_tpu_torch.serve.root import RootServer

    topo = tmp_path / "topo.json"
    topo.write_text(json.dumps({"edges": 2, "k": 8, "d": 4, "cohort": 4, "rounds": 1,
                                "sign_bits": 1, "keys": {"0": "aa" * 32, "1": "bb" * 32}}))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    edge = ["edge", "--config", str(topo), "--shard", "0", "--root-url", "http://127.0.0.1:9"]
    for argv in (["root", "--config", str(topo), "--port", "0"], edge):
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(argv)
    # told the CPU, the edge gets past its device and fails on the dead URL
    with pytest.raises(urllib.error.URLError):
        cli.main(edge + ["--device", "cpu"])
    from byzantine_aircomp_tpu_torch.serve.edge import TopologyConfig

    with RootServer(TopologyConfig.load(str(topo)), host="127.0.0.1", device="cpu") as srv:
        assert srv.state.device.type == "cpu" and srv.port
