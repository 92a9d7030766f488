"""The port's two-tier aggregation (``serve/edge.py``, ``serve/root.py``)
against the JAX package's, on the CPU.

The protocol helpers and the topology config equal JAX's; the root's
state machine answers every scenario of JAX's ``tests/test_edge.py`` as
JAX's root does, fed the same envelope bytes (statuses, payloads, the
live and quarantined sets, nonces, strikes, the epoch and the folded
arrays); the two roots' journals restore each other; and a tree of port
edge threads over HTTP against the port's root is bitwise the port's flat
``SeqShardCtx`` aggregate, healthy and with one edge dead, while that flat
aggregate agrees with JAX's streamed rules on the same stack.  One torch
thread, as ``tests/test_torch_soak.py`` pins it: the many small ops of a
streamed pass run faster so, and the float sums keep one order."""

import json
import threading

import numpy as np
import pytest
import torch

from byzantine_aircomp_tpu.ops import aggregators as jagg
from byzantine_aircomp_tpu.ops import shardctx as jshardctx
from byzantine_aircomp_tpu.serve import edge as jedge
from byzantine_aircomp_tpu.serve import journal as jjournal
from byzantine_aircomp_tpu.serve import root as jroot
from byzantine_aircomp_tpu_torch.analysis import chaos
from byzantine_aircomp_tpu_torch.ops import shardctx
from byzantine_aircomp_tpu_torch.serve import edge as tedge
from byzantine_aircomp_tpu_torch.serve import journal as tjournal
from byzantine_aircomp_tpu_torch.serve import root as troot


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PKGS = {"jax": (jedge, jroot, jjournal), "torch": (tedge, troot, tjournal)}


# ------------------------------------------------------ protocol helpers


def test_the_signing_helpers_are_jax_s():
    bodies = [
        {"op": "partial", "round": 0, "epoch": 0, "seq": 3, "meta": {},
         "edge": 1, "nonce": 9, "wire": 1, "tags": ["sum"], "leaves": []},
        {"op": "done", "round": 2, "epoch": 1, "edge": 0, "nonce": 41,
         "mac": "ab" * 32},
        {"z": [1.5, -0.0, 1e-30], "a": {"b": None, "é": "x"}},
    ]
    for body in bodies:
        assert tedge.canonical_bytes(body) == jedge.canonical_bytes(body)
        for key in ("aa" * 32, "0123456789abcdef" * 4):
            assert tedge.sign_envelope(key, body) == jedge.sign_envelope(key, body)


@pytest.mark.parametrize("kw, match", [
    (dict(k=9), "cohort"),
    (dict(edges=3, keys={e: "aa" * 32 for e in range(3)}), "edges"),
    (dict(keys={0: "aa" * 32}), "key"),
])
def test_the_topology_checks_are_jax_s(kw, match):
    base = dict(edges=2, k=8, d=4, cohort=4, rounds=1, keys={0: "aa" * 32, 1: "bb" * 32})
    base.update(kw)
    with pytest.raises(ValueError, match=match) as jerr:
        jedge.TopologyConfig(**base)
    with pytest.raises(ValueError, match=match) as terr:
        tedge.TopologyConfig(**base)
    assert str(terr.value) == str(jerr.value)


def test_one_topology_file_loads_in_both_packages(tmp_path):
    path = tmp_path / "topo.json"
    path.write_text(json.dumps({
        "edges": 4, "k": 1000, "d": 7850, "cohort": 50, "rounds": 3,
        "aggs": ["median", "trimmed_mean", "mean", "gm2"], "sign_bits": 1,
        "partial_timeout": 10.0, "strike_limit": 2,
        "keys": {str(e): f"{e:02d}" * 32 for e in range(4)},
    }))
    j = jedge.TopologyConfig.load(str(path))
    t = tedge.TopologyConfig.load(str(path))
    assert vars(t) == vars(j)
    for prop in ("n_chunks", "chunks_per_edge", "rows_per_edge", "result_names"):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert (t.n_chunks, t.chunks_per_edge, t.rows_per_edge) == (20, 5, 250)


@pytest.mark.parametrize("status, resp", [
    (409, {"error": "stale_epoch", "epoch": 3}),
    (409, {"error": "stale_epoch"}),
    (410, {"error": "bad_payload"}),
    (409, {"error": "replay"}),
    (500, {"error": "boom"}),
])
def test_the_client_classifies_the_root_s_answers_as_jax_s_does(status, resp):
    outcomes = []
    for mod in (jedge, tedge):
        client = mod.EdgeClient("http://127.0.0.1:1", 0, "aa" * 32)
        with pytest.raises(Exception) as exc:
            client._raise_for(status, resp)
        outcomes.append((type(exc.value).__name__, getattr(exc.value, "epoch", None),
                         str(exc.value) if type(exc.value) is RuntimeError else None))
    assert outcomes[0] == outcomes[1]


def test_round_stack_is_seeded_and_the_same_on_every_call():
    a = tedge.round_stack(7, 1, 12, 10)
    assert a.dtype == torch.float32 and a.shape == (12, 10)
    assert torch.equal(a, tedge.round_stack(7, 1, 12, 10))
    assert not torch.equal(a, tedge.round_stack(7, 2, 12, 10))
    assert not torch.equal(a, tedge.round_stack(8, 1, 12, 10))


# ------------------------------------------- the root's state machine


def _topo(mod, **over):
    base = dict(edges=2, k=8, d=4, cohort=4, rounds=2, aggs=[], sign_bits=1,
                partial_timeout=5.0, keys={0: "aa" * 32, 1: "bb" * 32})
    base.update(over)
    return mod.TopologyConfig(**base)


THREE = dict(edges=3, k=12, keys={e: f"{e:02d}" * 32 for e in range(3)})


def _envelope(cfg, edge, nonce, seq=0, rnd=0, epoch=0, leaves=None, tags=None, meta=None,
              key=None, mac=None) -> bytes:
    if leaves is None:
        leaves = [np.zeros(cfg.d, np.int32), np.asarray(4, np.int32)]
    body = {
        "op": "partial", "round": rnd, "epoch": epoch, "seq": seq, "meta": meta or {},
        **jshardctx.partial_to_wire(leaves, tags or ("sum",) * len(leaves)),
        "edge": edge, "nonce": nonce,
    }
    body["mac"] = mac or jedge.sign_envelope(key or cfg.keys[edge], body)
    return json.dumps(body).encode()


def _resign(cfg, raw, edge, **changes) -> bytes:
    body = json.loads(raw.decode())
    body.update(changes)
    body.pop("mac", None)
    body["mac"] = jedge.sign_envelope(cfg.keys[edge], body)
    return json.dumps(body).encode()


def _state(st):
    return dict(live=sorted(st.live), quarantined=dict(st.quarantined), nonces=dict(st.nonces),
                strikes=dict(st.strikes), forged=dict(st.forged), replays=dict(st.replays),
                epoch=st.epoch, phases=sorted(st.phases))


def _results(st):
    """``/results`` without the port's extra per-round keys (folds,
    fold_ms), which JAX's readers ignore."""
    res = st.results()
    for rr in res["rounds"].values():
        rr.pop("folds", None)
        rr.pop("fold_ms", None)
    return res


class _Case:
    """One scenario against one package's root: ``step`` records what a
    call answered and the root's state after it."""

    def __init__(self, pkg, tmp_path):
        self.edge_mod, self.root_mod, self.journal_mod = PKGS[pkg]
        self.pkg = pkg
        self.dir = tmp_path / pkg
        self.dir.mkdir(parents=True, exist_ok=True)
        self.trace = []
        self.clock = [0.0]

    def cfg(self, **over):
        return _topo(self.edge_mod, **over)

    def root(self, cfg, journal=False):
        kw = dict(obs_dir=str(self.dir) if journal else None, now_fn=lambda: self.clock[0])
        if self.pkg == "torch":
            kw["device"] = "cpu"
        return self.root_mod.RootState(cfg, **kw)

    def step(self, st, answer):
        self.trace.append((answer, _state(st)))
        return answer


def _forged_mac(c):
    cfg = c.cfg()
    st = c.root(cfg)
    c.step(st, st.submit_partial(_envelope(cfg, 0, 1, mac="00" * 32)))
    c.step(st, st.submit_partial(_envelope(cfg, 0, 2, key="cc" * 32)))
    c.step(st, st.submit_partial(_envelope(cfg, 7, 1, key="cc" * 32)))
    c.step(st, st.submit_partial(b"{not json"))
    c.step(st, st.submit_partial(json.dumps({"op": "done"}).encode()))
    st.close()


def _replay_journaled_not_quarantined(c):
    cfg = c.cfg()
    st = c.root(cfg, journal=True)
    captured = _envelope(cfg, 0, 1)
    c.step(st, st.submit_partial(captured))
    c.step(st, st.submit_partial(captured))
    c.step(st, st.submit_partial(_envelope(cfg, 0, 2, seq=1)))
    st.close()
    ops = [r["op"] for r in c.journal_mod.io_lib.iter_jsonl(
        str(c.dir / c.journal_mod.ROOT_JOURNAL_NAME))]
    c.trace.append(ops)
    st2 = c.root(cfg, journal=True)
    c.step(st2, st2.submit_partial(captured))
    st2.close()


def _nonce_hwm_across_a_restart(c):
    jr = c.journal_mod.RunJournal(str(c.dir / c.journal_mod.ROOT_JOURNAL_NAME))
    jr.append("partial", "edge-1", round=0, nonce=7)
    jr.append("edge_quarantined", "edge-0", reason="bad_payload")
    jr.close()
    cfg = c.cfg()
    st = c.root(cfg, journal=True)
    c.step(st, None)
    c.step(st, st.submit_partial(_envelope(cfg, 1, 7)))
    c.step(st, st.submit_partial(_envelope(cfg, 0, 9)))
    c.step(st, st.submit_partial(_envelope(cfg, 1, 8)))
    st.close()


def _partial_timeout(c):
    cfg = c.cfg(partial_timeout=5.0)
    st = c.root(cfg)
    c.step(st, st.submit_partial(_envelope(cfg, 0, 1)))
    c.step(st, st.get_fold(0, 0, 0, 0))
    c.clock[0] = 6.0
    st.deadline_check()
    c.step(st, None)
    c.step(st, st.get_fold(0, 0, 0, 0))
    c.step(st, st.get_fold(0, 0, 1, 1))
    leaves = [np.arange(cfg.d, dtype=np.int32), np.asarray(4, np.int32)]
    c.step(st, st.submit_partial(_envelope(cfg, 0, 2, epoch=1, leaves=leaves)))
    c.step(st, st.get_fold(0, 0, 1, 0))
    done = json.dumps(dict(op="done", round=0, epoch=1, edge=0, nonce=3)).encode()
    c.step(st, st.submit_done(_resign(cfg, done, 0)))
    c.step(st, st.round_info(0))
    c.trace.append(_results(st))
    st.close()


def _bad_payloads(c):
    cfg = c.cfg(**THREE)
    st = c.root(cfg)
    c.step(st, st.submit_partial(_resign(cfg, _envelope(cfg, 0, 1), 0, wire=99)))
    c.step(st, st.submit_partial(_envelope(
        cfg, 1, 1, epoch=st.epoch, leaves=[np.array([np.nan], np.float32)], tags=("sum",))))
    body = json.loads(_envelope(cfg, 2, 1).decode())
    del body["leaves"][0]["wdtype"]
    c.step(st, st.submit_partial(_resign(cfg, json.dumps(body).encode(), 2, epoch=st.epoch)))
    st.close()


def _consensus_dissent(c):
    cfg = c.cfg(**THREE)
    st = c.root(cfg)
    honest = [np.arange(cfg.d, dtype=np.int32), np.linspace(-1, 1, cfg.d, dtype=np.float32)]
    lying = [honest[0] + 1, honest[1]]
    meta = {"label": "results", "names": ["signvote", "mean"]}
    for edge, leaves in ((0, honest), (1, lying), (2, honest)):
        c.step(st, st.submit_partial(_envelope(cfg, edge, 1, leaves=leaves, tags=("same",) * 2,
                                               meta=meta)))
    c.step(st, st.get_fold(0, 0, 0, 0))
    c.trace.append(_results(st))
    st.close()


def _schema_majority(c):
    cfg = c.cfg(**THREE)
    st = c.root(cfg)
    bogus = [np.zeros(cfg.d + 1, np.int32), np.asarray(4, np.int32)]
    c.step(st, st.submit_partial(_envelope(cfg, 0, 1, leaves=bogus)))
    c.step(st, st.submit_partial(_envelope(cfg, 1, 1)))
    c.step(st, st.get_fold(0, 0, 0, None))
    c.step(st, st.submit_partial(_envelope(cfg, 2, 1)))
    leaves = [np.arange(cfg.d, dtype=np.int32), np.asarray(4, np.int32)]
    for edge in (1, 2):
        c.step(st, st.submit_partial(_envelope(cfg, edge, 2, epoch=1, leaves=leaves)))
    c.step(st, st.get_fold(0, 0, 1, 1))
    st.close()


def _schema_minority(c):
    cfg = c.cfg()
    st = c.root(cfg)
    c.step(st, st.submit_partial(_envelope(cfg, 0, 1)))
    c.step(st, st.submit_partial(_envelope(
        cfg, 1, 1, leaves=[np.zeros(cfg.d + 1, np.int32), np.asarray(4, np.int32)])))
    st.close()


def _strike_limit(c):
    cfg = c.cfg(strike_limit=3)
    st = c.root(cfg)
    for n in (1, 2):
        c.step(st, st.submit_partial(_envelope(cfg, 0, n, rnd=99)))
    c.step(st, st.submit_partial(_envelope(cfg, 0, 2, rnd=99)))
    c.step(st, st.submit_partial(_resign(cfg, _envelope(cfg, 1, 1), 1, seq=-1)))
    c.step(st, st.submit_partial(_envelope(cfg, 0, 3, rnd=99)))
    c.step(st, st.submit_partial(_envelope(cfg, 0, 4)))
    st.close()


def _late_resubmission(c):
    cfg = c.cfg()
    st = c.root(cfg)
    a = [np.arange(cfg.d, dtype=np.float32) / 3, np.asarray(4, np.int32)]
    b = [np.arange(cfg.d, dtype=np.float32) * 7.25, np.asarray(2, np.int32)]
    c.step(st, st.submit_partial(_envelope(cfg, 0, 1, leaves=a)))
    c.step(st, st.submit_partial(_envelope(cfg, 1, 1, leaves=b)))
    c.step(st, st.get_fold(0, 0, 0, None))
    poison = [np.full(cfg.d, 9, np.float32), np.asarray(4, np.int32)]
    c.step(st, st.submit_partial(_envelope(cfg, 0, 2, leaves=poison)))
    c.step(st, st.get_fold(0, 0, 0, None))
    st.close()


ROOT_CASES = {
    "forged_mac": _forged_mac,
    "replay_journaled_not_quarantined": _replay_journaled_not_quarantined,
    "nonce_hwm_across_a_restart": _nonce_hwm_across_a_restart,
    "partial_timeout": _partial_timeout,
    "bad_payloads": _bad_payloads,
    "consensus_dissent": _consensus_dissent,
    "schema_majority": _schema_majority,
    "schema_minority": _schema_minority,
    "strike_limit": _strike_limit,
    "late_resubmission": _late_resubmission,
}


@pytest.mark.parametrize("case", sorted(ROOT_CASES))
def test_the_root_answers_every_scenario_as_jax_s_does(case, tmp_path):
    traces = {}
    for pkg in PKGS:
        c = _Case(pkg, tmp_path)
        ROOT_CASES[case](c)
        traces[pkg] = c.trace
    assert traces["torch"] == traces["jax"]
    assert len(traces["jax"]) >= 2


def test_a_leaf_torch_cannot_fold_is_a_bad_payload():
    """A signed leaf of a dtype torch does not hold (here unicode) is
    refused at submission, before it can reach the fold on the device."""
    cfg = _topo(tedge)
    st = troot.RootState(cfg, device="cpu")
    status, payload = st.submit_partial(_envelope(cfg, 0, 1, leaves=[np.array(["ab"] * 4)]))
    assert status == 422 and "bad payload" in payload["error"], payload
    assert st.quarantined == {0: "bad_payload"} and not st.phases


def test_the_two_roots_journals_restore_each_other(tmp_path):
    """A root journal one package wrote restores the other package's root:
    the nonce high-water marks, the quarantines and the replay protection."""
    restored = {}
    for writer, reader in (("jax", "torch"), ("torch", "jax")):
        c = _Case(writer, tmp_path / writer)
        cfg = c.cfg(**THREE)
        st = c.root(cfg, journal=True)
        captured = _envelope(cfg, 0, 5)
        st.submit_partial(captured)
        st.submit_partial(captured)
        st.submit_partial(_envelope(cfg, 1, 3, rnd=99))
        st.submit_partial(_resign(cfg, _envelope(cfg, 2, 1), 2, wire=99))
        for edge in (0, 1):
            st.submit_partial(_envelope(cfg, edge, 10 + edge, epoch=st.epoch))
        done = [_resign(cfg, json.dumps(dict(op="done", round=0, epoch=st.epoch, edge=e,
                                             nonce=20 + e)).encode(), e) for e in (0, 1)]
        for raw in done:
            st.submit_done(raw)
        assert st.quarantined == {2: "bad_payload"} and st.rounds[0]["completed"]
        st.close()
        r = _Case(reader, tmp_path / writer)
        r.dir = c.dir
        st2 = r.root(_topo(r.edge_mod, **THREE), journal=True)
        # the journal keeps each round's closing nonces and every rejection's;
        # edge 2's one nonce burned before its quarantine is not journaled
        restored[reader] = _state(st2)
        assert st2.nonces == {0: 20, 1: 21, 2: 0}
        assert st2.quarantined == {2: "bad_payload"} and st2.live == {0, 1}
        assert st2.submit_partial(captured)[0] == 409
        assert st2.submit_partial(_envelope(cfg, 1, 22, rnd=1))[0] == 200
        st2.close()
    assert restored["torch"] == restored["jax"]


# ---------------------------------------------------- the tree over HTTP


def _np_stack(seed, rnd, k, d, device="cpu"):
    rng = np.random.default_rng([seed, rnd])
    return torch.from_numpy(rng.standard_normal((k, d), dtype=np.float32)).to(device)


TREE = dict(edges=4, k=32, d=64, cohort=4, rounds=2,
            aggs=["median", "trimmed_mean", "mean", "gm2"], sign_bits=1, gm2_maxiter=40,
            seed=7, partial_timeout=120.0, keys={e: f"{e:02d}" * 32 for e in range(4)})


def _run_tree(cfg, shards, tmp_path):
    with troot.RootServer(cfg, obs_dir=str(tmp_path / "obs"), host="127.0.0.1",
                          device="cpu") as srv:
        url = f"http://127.0.0.1:{srv.port}"
        summaries = {}
        threads = [threading.Thread(target=lambda e=e: summaries.__setitem__(
            e, tedge.run_edge(cfg, e, url, device="cpu"))) for e in shards]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return summaries, srv.state.results()


def _decoded(res, rnd):
    return {n: shardctx.decode_leaf(v) for n, v in res["rounds"][str(rnd)]["results"].items()}


def _jax_flat(stack, cfg):
    """JAX's streamed rules under JAX's ``SeqShardCtx`` and its whole-stack
    packed vote, on ``stack`` (numpy)."""
    import jax
    import jax.numpy as jnp

    w = jnp.asarray(stack)
    ctx = jshardctx.SeqShardCtx(cfg.edges)

    def rebuild(c):
        return jax.lax.dynamic_slice(w, (c * cfg.cohort, 0), (cfg.cohort, cfg.d))

    sa, sf, nf = jagg.stream_stats(rebuild, cfg.n_chunks, cfg.d, ctx)
    out = {name: np.asarray(jagg.stream_aggregate(
        name, rebuild, k=cfg.k, d=cfg.d, n_chunks=cfg.n_chunks, degraded=False, sum_all=sa,
        sum_finite=sf, n_finite=nf, trim_ratio=cfg.trim_ratio, maxiter=cfg.gm2_maxiter,
        ctx=ctx)) for name in cfg.aggs}
    words, kv = jagg.pack_signs(w, jnp.zeros(cfg.d, jnp.float32))
    out["signvote"] = np.asarray((2 * jagg.packed_sign_votes(words, cfg.d) - kv).astype(jnp.int32))
    return out


TOLERANCE = {"median": 0.0, "signvote": 0.0, "mean": 1e-6, "trimmed_mean": 1e-6, "gm2": 1e-5}


def test_a_healthy_tree_is_bitwise_the_flat_aggregate(tmp_path, monkeypatch):
    monkeypatch.setattr(tedge, "round_stack", _np_stack)
    cfg = tedge.TopologyConfig(**TREE)
    summaries, res = _run_tree(cfg, range(cfg.edges), tmp_path)
    for e, s in summaries.items():
        assert s["status"] == "completed" and s["rounds"] == cfg.rounds, s
        assert s["lowerings"] == {"edge_round_fn": 1} and s["steady_state_ok"], s
        assert s["setups"] == {"edge_round_fn": {}}, s  # no kernel on the CPU
        assert [r["exchanges"] for r in s["per_round"]] == [
            r["folds"] for r in res["rounds"].values()], (s, res)
    assert not res["quarantined"] and res["fold_lowerings"] == res["fold_signatures"]
    flat = chaos._flat_reference(cfg, device="cpu")
    chaos._assert_matches_flat(cfg, res, flat)
    # the port's flat aggregate against JAX's streamed rules on the stack
    for rnd in range(cfg.rounds):
        jax_flat = _jax_flat(_np_stack(cfg.seed, rnd, cfg.k, cfg.d).numpy(), cfg)
        for name, tol in TOLERANCE.items():
            got, want = flat[rnd][name], jax_flat[name]
            assert got.dtype == want.dtype and got.shape == want.shape, name
            if tol == 0.0:
                assert got.tobytes() == want.tobytes(), (rnd, name)
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)


def test_a_tree_with_a_dead_edge_finishes_degraded_and_bitwise(tmp_path, monkeypatch):
    """Edge 3 never starts: the root quarantines it when the first phase
    times out, and the survivors run every round degraded, one set-up per
    program, their results bitwise the flat degraded aggregate of their
    rows (shards 0-2 hold the first 24 rows, in the same shard order)."""
    monkeypatch.setattr(tedge, "round_stack", _np_stack)
    cfg = tedge.TopologyConfig(**dict(TREE, partial_timeout=2.0))
    summaries, res = _run_tree(cfg, range(cfg.edges - 1), tmp_path)
    for e, s in summaries.items():
        assert s["status"] == "completed" and s["rounds"] == cfg.rounds, s
        assert s["lowerings"] == {"edge_round_fn": 1, "edge_round_fn_degraded": 1}, s
        assert s["setups"] == {"edge_round_fn": {}, "edge_round_fn_degraded": {}}, s
        assert s["steady_state_ok"] and all(r["degraded"] for r in s["per_round"]), s
    assert res["quarantined"] == {3: "partial_timeout"} and res["epoch"] == 1
    survivors = tedge.TopologyConfig(**dict(
        TREE, edges=3, k=24, keys={e: TREE["keys"][e] for e in range(3)}))
    for rnd in range(cfg.rounds):
        rr = res["rounds"][str(rnd)]
        assert rr["completed"] and rr["degraded"], rr
        stack = _np_stack(cfg.seed, rnd, cfg.k, cfg.d)[:survivors.k]
        want = _flat_degraded(stack, survivors)
        got = _decoded(res, rnd)
        for name in cfg.result_names:
            assert got[name].tobytes() == want[name].tobytes(), (rnd, name)


def test_a_set_up_is_counted_for_the_program_whose_round_made_it(monkeypatch):
    """JAX's build count is one per program by construction; the set-ups
    (``ops/kernels.py::SETUPS``: on the card a kernel's load, a Weiszfeld
    workspace) go to the program whose round made them, and a second set-up
    of one kind counts 2."""
    from byzantine_aircomp_tpu_torch.ops import kernels

    monkeypatch.setattr(kernels, "SETUPS", {})
    made = iter([["load:weiszfeld_step", "workspace:4x64"], [], ["workspace:4x64"]])
    compute = tedge.EdgeCompute(tedge.TopologyConfig(**TREE), 0, None, "cpu")
    monkeypatch.setattr(compute, "_round", lambda degraded, stack: [
        kernels._count_setup(key) for key in next(made)])
    for degraded in (False, True, True):
        compute.round_fn(degraded)(None)
    assert compute.detector.snapshot() == {"edge_round_fn": 1, "edge_round_fn_degraded": 1}
    assert compute.setups == {
        "edge_round_fn": {"load:weiszfeld_step": 1, "workspace:4x64": 1},
        "edge_round_fn_degraded": {"workspace:4x64": 1}}
    assert kernels.SETUPS == {"load:weiszfeld_step": 1, "workspace:4x64": 2}


def _flat_degraded(stack, cfg):
    from byzantine_aircomp_tpu_torch.ops import aggregators

    ctx = shardctx.SeqShardCtx(cfg.edges)

    def rebuild(c):
        return stack[c * cfg.cohort:(c + 1) * cfg.cohort]

    sa, sf, nf = aggregators.stream_stats(rebuild, cfg.n_chunks, cfg.d, "cpu", ctx)
    out = {name: aggregators.stream_aggregate(
        name, rebuild, k=cfg.k, d=cfg.d, n_chunks=cfg.n_chunks, device="cpu", degraded=True,
        sum_all=sa, sum_finite=sf, n_finite=nf, trim_ratio=cfg.trim_ratio,
        maxiter=cfg.gm2_maxiter, ctx=ctx).numpy() for name in cfg.aggs}
    words, kv = aggregators.pack_signs(stack, torch.zeros(cfg.d))
    out["signvote"] = (2 * aggregators.packed_sign_votes(words, cfg.d) - kv).to(
        torch.int32).numpy()
    return out
