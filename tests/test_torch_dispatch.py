"""Multi-round dispatch of the port (``--rounds-per-dispatch`` and its
knobs) against the JAX package on the CPU: validation, titles, hashes and
CLI flags; the R>1 driver's path lengths, eval replication and per-dispatch
rate; prefetch and the writer thread; a resume through an alignment
dispatch; a degraded-mode rollback at a boundary; the R>1 run bitwise the
R=1 run; the Weiszfeld loop's graph-safe modes (gm's unrolled loop
bitwise the chunked loop, gm2's loop nodes); and the graph predicate's
reasons.

On the CPU every dispatch runs eagerly (CUDA graphs need the card;
``tests/test_torch_cuda.py`` holds the graphed rounds against the eager
ones there).  Tolerances: the port's R>1 run against its own R=1 run, the
unrolled loop against the chunked one, prefetch on against off and the
writer on against off are bitwise (the same ops in the same order); the
unrolled Weiszfeld solves against the JAX package's within rtol 1e-4 (f32
sums in another order, compounded over the steps); the two packages' runs
are compared in structure only (lengths, the eval-replication pattern, the
rate's repetition, rollback counts), since their random streams differ.
"""

import dataclasses
import math
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantine_aircomp_tpu import cli as jcli
from byzantine_aircomp_tpu.data import datasets as jdata
from byzantine_aircomp_tpu.fed import harness as jharness
from byzantine_aircomp_tpu.fed.config import FedConfig as JaxFedConfig
from byzantine_aircomp_tpu.fed.train import FedTrainer
from byzantine_aircomp_tpu.ops import aggregators as jagg
from byzantine_aircomp_tpu.ops import channel as jchannel
from byzantine_aircomp_tpu_torch import cli as tcli
from byzantine_aircomp_tpu_torch import obs as tobs
from byzantine_aircomp_tpu_torch.data import datasets as tdata
from byzantine_aircomp_tpu_torch.fed import checkpoint as tcheckpoint
from byzantine_aircomp_tpu_torch.fed import graphs as tgraphs
from byzantine_aircomp_tpu_torch.fed import harness as tharness
from byzantine_aircomp_tpu_torch.fed.config import FedConfig
from byzantine_aircomp_tpu_torch.fed.train import Trainer
from byzantine_aircomp_tpu_torch.ops import aggregators as tagg
from byzantine_aircomp_tpu_torch.ops import kernels as tkernels

RTOL = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: these runs are many small ops, which a multithreaded
    pool only slows down when the test workers share the machine's cores
    (the bitwise checks compare runs of one process, with one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ds():
    return tdata.load("mnist", synthetic_train=600, synthetic_val=200)


@pytest.fixture(scope="module")
def jds():
    return jdata.load("mnist", synthetic_train=600, synthetic_val=200)


def _kw(**kw):
    base = dict(honest_size=8, byz_size=2, attack="classflip", agg="gm2", rounds=4,
                display_interval=2, batch_size=16, eval_train=False, agg_maxiter=50)
    base.update(kw)
    return base


def _train(cfg, ds, **train_kw):
    t = Trainer(cfg, dataset=ds, device="cpu")
    lines = []
    paths = t.train(log_fn=lines.append, **train_kw)
    return t, paths, lines


def _pattern(values):
    """Each entry's index among the distinct values, in order of first
    appearance: the eval-replication pattern of a path."""
    seen = {}
    return [seen.setdefault(v, len(seen)) for v in values]


def _same_paths(a, b, skip=("roundsPerSec",)):
    """Equal entries but ``skip``'s; float lists bitwise, NaN included."""
    assert set(a) == set(b)
    for key in a:
        if key in skip:
            continue
        x, y = a[key], b[key]
        if isinstance(x, list) and all(isinstance(v, float) for v in x + y):
            assert np.array_equal(np.asarray(x), np.asarray(y), equal_nan=True), key
        else:
            assert x == y, key


# ---------------------------------------------------------------------------
# validation, titles, hashes, flags


@pytest.mark.parametrize("match,kw", [
    ("must be >= 1", dict(rounds_per_dispatch=0)),
    ("require --rounds-per-dispatch > 1", dict(eval_interval=4)),
    ("require --rounds-per-dispatch > 1", dict(dispatch_mode="degraded")),
    ("require --rounds-per-dispatch > 1", dict(dispatch_prefetch="on")),
    ("divide the round budget", dict(rounds=5, rounds_per_dispatch=2)),
    ("multiple of", dict(rounds=8, rounds_per_dispatch=4, eval_interval=2)),
    ("eval_interval must be >= 0", dict(rounds=8, rounds_per_dispatch=4, eval_interval=-4)),
    ("async_writer must be", dict(async_writer="yes")),
    ("dispatch_prefetch must be", dict(rounds=4, rounds_per_dispatch=2,
                                       dispatch_prefetch="maybe")),
    ("dispatch_mode must be", dict(rounds=4, rounds_per_dispatch=2, dispatch_mode="fast")),
    ("--dispatch-mode degraded", dict(agg="trimmed_mean", attack=None, byz_size=0,
                                      service="on", population=24, rounds=8,
                                      rounds_per_dispatch=4)),
])
def test_validation_refuses_what_the_jax_package_refuses(match, kw):
    for cls in (JaxFedConfig, FedConfig):
        with pytest.raises(ValueError, match=match):
            cls(**_kw(**kw)).validate()


@pytest.mark.parametrize("kw", [
    dict(rounds=8, rounds_per_dispatch=4, eval_interval=8),
    dict(rounds=8, rounds_per_dispatch=4, dispatch_prefetch="on"),
    dict(async_writer="on"),
    dict(async_writer="off", rounds_per_dispatch=2),
    dict(agg="trimmed_mean", attack=None, byz_size=0, service="on", population=24, rounds=8,
         rounds_per_dispatch=4, dispatch_mode="degraded"),
    dict(agg="trimmed_mean", attack=None, byz_size=0, service="on", population=24, rounds=8,
         rounds_per_dispatch=4, rollback="off"),
])
def test_validation_accepts_what_the_jax_package_accepts(kw):
    JaxFedConfig(**_kw(**kw)).validate()
    assert FedConfig(**_kw(**kw)).validate().rounds_per_dispatch == kw.get(
        "rounds_per_dispatch", 1)


@pytest.mark.parametrize("kw", [
    dict(rounds=8, rounds_per_dispatch=4),
    dict(rounds=8, rounds_per_dispatch=2, eval_interval=4),
    dict(rounds=8, rounds_per_dispatch=2, eval_interval=4, dispatch_mode="degraded"),
    dict(rounds=8, rounds_per_dispatch=2, dispatch_prefetch="on", async_writer="off"),
    dict(agg="trimmed_mean", attack=None, byz_size=0, service="on", population=24, rounds=8,
         rounds_per_dispatch=4, dispatch_mode="degraded", cohort_size=2),
])
def test_titles_match_jax(kw):
    title = tharness.run_title(FedConfig(**_kw(**kw)))
    assert title == jharness.run_title(JaxFedConfig(**_kw(**kw)))
    assert f"_rd{kw['rounds_per_dispatch']}" in title


# the port's digests of these configs on the tree before the dispatch
# fields were ported (the JAX package's digest of a run differs: the two
# FedConfigs hold different fields)
@pytest.mark.parametrize("kw,digest", [
    (dict(), "fb10ef9d"),
    (dict(agg="median", attack="signflip", byz_size=2, noise_var=1e-2), "67b1a9e8"),
])
def test_r1_keeps_its_hash_and_output_knobs_never_fork_it(kw, digest):
    cfg = FedConfig(**kw)
    assert tharness.config_hash(cfg) == digest
    for knob in (dict(async_writer="on"), dict(async_writer="off")):
        assert tharness.config_hash(dataclasses.replace(cfg, **knob)) == digest
    assert "_rd" not in tharness.run_title(cfg)
    r2 = dataclasses.replace(cfg, rounds_per_dispatch=2)
    assert tharness.config_hash(r2) != digest
    # prefetch and the writer leave the R > 1 hash too; eval_interval and
    # the mode fork it
    assert tharness.config_hash(dataclasses.replace(
        r2, dispatch_prefetch="on", async_writer="off")) == tharness.config_hash(r2)
    for knob in (dict(eval_interval=2), dict(dispatch_mode="degraded")):
        assert tharness.config_hash(dataclasses.replace(r2, **knob)) != tharness.config_hash(r2)


def test_jax_hash_rules_agree_on_which_knobs_fork():
    """The JAX package's digests fork and stay under the same knob changes
    as the port's (the digests themselves differ)."""
    base = dict(rounds=8)
    for kw, forks in ((dict(async_writer="on"), False),
                      (dict(rounds_per_dispatch=2), True),
                      (dict(rounds_per_dispatch=2, dispatch_prefetch="on"), True)):
        for cls, hash_fn in ((JaxFedConfig, jharness.config_hash),
                             (FedConfig, tharness.config_hash)):
            assert (hash_fn(cls(**base, **kw)) != hash_fn(cls(**base))) == forks, (cls, kw)
    r2 = dict(base, rounds_per_dispatch=2)
    for cls, hash_fn in ((JaxFedConfig, jharness.config_hash),
                         (FedConfig, tharness.config_hash)):
        assert hash_fn(cls(**r2, dispatch_prefetch="on")) == hash_fn(cls(**r2))


_CLI_ARGV = ["--K", "10", "--B", "2", "--attack", "classflip", "--agg", "gm2",
             "--rounds-per-dispatch", "5", "--eval-interval", "10", "--dispatch-mode",
             "degraded", "--dispatch-prefetch", "on", "--async-writer", "off"]


def test_cli_flags_parse_like_the_jax_cli():
    port = tcli.config_from_args(tcli.build_parser().parse_args(_CLI_ARGV))
    want = jcli.config_from_args(jcli.build_parser().parse_args(_CLI_ARGV), _CLI_ARGV)
    for field in ("rounds_per_dispatch", "eval_interval", "dispatch_mode",
                  "dispatch_prefetch", "async_writer"):
        assert getattr(port, field) == getattr(want, field), field
    assert port.validate() is port
    default = tcli.config_from_args(tcli.build_parser().parse_args([]))
    assert (default.rounds_per_dispatch, default.eval_interval, default.dispatch_mode,
            default.dispatch_prefetch, default.async_writer) == (1, 0, "exact", "off", "auto")


# ---------------------------------------------------------------------------
# the R>1 driver against the JAX package's


@pytest.mark.parametrize("eval_interval", [0, 4])
def test_driver_structure_matches_jax(ds, jds, eval_interval):
    """gm2, K=10, 4 rounds, R=2: the same path lengths, the same pattern of
    repeated evals and the same rate inside each dispatch as JAX's
    ``_train_multi``."""
    kw = _kw(rounds_per_dispatch=2, eval_interval=eval_interval)
    jpaths = FedTrainer(JaxFedConfig(agg_impl="xla", **kw), dataset=jds).train()
    _, paths, lines = _train(FedConfig(**kw), ds)
    assert {k: len(v) for k, v in paths.items()} == {k: len(jpaths[k]) for k in paths}
    for key in ("valLossPath", "valAccPath"):
        assert _pattern(paths[key]) == _pattern(jpaths[key]), key
    want = [[0, 1, 1, 2, 2], [0, 0, 0, 1, 1]][eval_interval == 4]
    assert _pattern(paths["valLossPath"]) == want
    for rps in (paths["roundsPerSec"], jpaths["roundsPerSec"]):
        assert rps[0] == rps[1] and rps[2] == rps[3] and min(rps) > 0
    assert [line.split("]")[0] for line in lines] == ["[0/4", "[2/4", "[4/4"]
    assert all("dispatch: 2" in line for line in lines[1:])


@pytest.mark.parametrize("kw", [
    dict(agg="gm2"),
    dict(agg="gm", noise_var=1e-6, agg_maxiter=20),
    dict(agg="median", noise_var=1e-2),
    dict(agg="trimmed_mean", noise_var=1e-2),
    dict(agg="mean", attack="gradascent@1", noise_var=1e-2),
    dict(agg="gm2", fault="chaos"),
    dict(agg="mean", attack="signflip", defense="monitor"),
])
def test_r2_run_is_bitwise_the_r1_run(ds, kw):
    """Every round's variance and fault and defense rows, the final params
    and the boundary evals: the eager dispatch is the per-round loop."""
    t1, p1, _ = _train(FedConfig(**_kw(**kw)), ds)
    t2, p2, _ = _train(FedConfig(**_kw(rounds_per_dispatch=2, **kw)), ds)
    assert torch.isfinite(t1.flat_params).all()
    assert torch.equal(t1.flat_params, t2.flat_params)
    _same_paths(p1, p2, skip=("roundsPerSec",) + tharness._EVAL_PATH_KEYS)
    for key in tharness._EVAL_PATH_KEYS:
        assert [p1[key][i] for i in (0, 2, 4)] == [p2[key][i] for i in (0, 2, 4)], key
        assert p2[key][1] == p2[key][2] and p2[key][3] == p2[key][4], key


def test_run_rounds_is_the_per_round_variances(ds):
    """``run_rounds`` (JAX :1979) without eval: the stacked variances are
    those ``run_round`` returns one round at a time."""
    cfg = FedConfig(**_kw(rounds_per_dispatch=2, agg="median", noise_var=1e-2))
    a, b = Trainer(cfg, dataset=ds, device="cpu"), Trainer(cfg, dataset=ds, device="cpu")
    stacked = a.run_rounds(1, 3)
    assert stacked.shape == (3,)
    assert stacked.tolist() == [float(b.run_round(r)) for r in (1, 2, 3)]
    assert torch.equal(a.flat_params, b.flat_params)


@pytest.mark.parametrize("kw", [
    dict(eval_interval=8),
    dict(eval_interval=4, fault="chaos", agg="median", noise_var=1e-2),
])
def test_prefetch_on_is_bitwise_prefetch_off(ds, kw):
    cfg = FedConfig(**_kw(rounds=8, rounds_per_dispatch=2, **kw))
    ta, pa, la = _train(cfg, ds)
    tb, pb, lb = _train(dataclasses.replace(cfg, dispatch_prefetch="on"), ds)
    assert torch.equal(ta.flat_params, tb.flat_params)
    _same_paths(pa, pb)
    assert [line.split(" train:")[1] for line in la] == [line.split(" train:")[1] for line in lb]


def test_writer_on_writes_what_writer_off_writes(tmp_path, ds):
    """The same checkpoint file (the last boundary's, the paths in its meta
    but for the rate) and the same pickled record."""
    out = {}
    for mode in ("on", "off"):
        cfg = FedConfig(**_kw(rounds_per_dispatch=2, async_writer=mode,
                              checkpoint_dir=str(tmp_path / mode / "ck"),
                              cache_dir=str(tmp_path / mode / "rec")))
        t, record = tharness.run_with_trainer(cfg, device="cpu", dataset=ds)
        title = tharness.ckpt_title(cfg)
        rnd, flat, leaves = tcheckpoint.load(cfg.checkpoint_dir, title)
        meta = tcheckpoint.load_meta(cfg.checkpoint_dir, title)
        with open(tharness.cache_path(cfg, "mnist"), "rb") as f:
            pickled = pickle.load(f)
        out[mode] = (t, record, rnd, flat, leaves, meta, pickled)
        assert not [n for n in os.listdir(cfg.checkpoint_dir) if n.endswith(".tmp")]
    (ta, ra, rnd_a, fa, la, ma, pa), (tb, rb, rnd_b, fb, lb, mb, pb) = out["on"], out["off"]
    assert rnd_a == rnd_b == 4 and np.array_equal(fa, fb) and len(la) == len(lb)
    assert np.array_equal(fa, ta.flat_params.numpy())
    import json

    ja, jb = json.loads(ma), json.loads(mb)
    _same_paths(ja, jb)
    _same_paths(ra, rb)
    _same_paths(pa, ra)
    _same_paths(pb, rb)


def test_writer_runs_tasks_in_order_and_drains():
    w = tobs.WriterThread(maxsize=2)
    seen = []
    for i in range(20):
        w.submit(lambda i=i: seen.append(i))
    w.drain()
    assert seen == list(range(20))
    w.submit(lambda: 1 / 0)
    w.submit(lambda: seen.append("after"))
    w.close()
    assert isinstance(w.error, ZeroDivisionError) and seen[-1] == "after"
    w.submit(lambda: seen.append("inline"))  # after close: runs inline
    assert seen[-1] == "inline"
    w.close()  # idempotent


def test_writer_keeps_each_producers_order_under_contention():
    """Eight producer threads against a bound of 4, with a short switch
    interval: every task runs once, each producer's in its own order."""
    import sys
    import threading

    w = tobs.WriterThread(maxsize=4)
    seen = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def produce(p):
            for i in range(200):
                w.submit(lambda p=p, i=i: seen.append((p, i)))

        threads = [threading.Thread(target=produce, args=(p,)) for p in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
        w.close()
    finally:
        sys.setswitchinterval(old)
    assert len(seen) == 1600 and w.error is None
    for p in range(8):
        assert [i for q, i in seen if q == p] == list(range(200))


@pytest.mark.parametrize("mode,r,want", [
    ("auto", 1, False), ("auto", 2, True), ("on", 1, True), ("off", 4, False),
])
def test_resolve_async_matches_jax(mode, r, want):
    from byzantine_aircomp_tpu.obs import writer as jwriter

    cfg = FedConfig(async_writer=mode, rounds_per_dispatch=r)
    assert tobs.resolve_async(cfg) == jwriter.resolve_async(cfg) == want


@pytest.mark.parametrize("R,rounds,start,dispatches", [
    (2, 6, 3, [1, 2]),   # an alignment dispatch, then a full one
    (4, 8, 5, [3]),      # the alignment dispatch is the tail
])
def test_resume_through_an_alignment_and_a_tail_dispatch(tmp_path, ds, R, rounds, start,
                                                          dispatches):
    """A checkpoint at an unaligned round, restored into an R>1 trainer:
    the dispatches it runs, and the params and variances of the straight
    per-round run."""
    base = FedConfig(**_kw(rounds=rounds, agg="gm", noise_var=1e-6, agg_maxiter=20))
    straight, sp, _ = _train(base, ds)
    cut = dataclasses.replace(base, rounds=start, checkpoint_dir=str(tmp_path))
    tharness.run_with_trainer(cut, device="cpu", record_in_file=False, dataset=ds)
    restored = tcheckpoint.load(str(tmp_path), tharness.ckpt_title(cut))
    t = Trainer(dataclasses.replace(base, rounds_per_dispatch=R), dataset=ds, device="cpu")
    assert tharness.restore_trainer(t, restored) == start
    lines = []
    paths = t.train(log_fn=lines.append, start_round=start)
    assert [int(line.split("dispatch: ")[1].split(")")[0]) for line in lines[1:]] == dispatches
    assert torch.equal(t.flat_params, straight.flat_params)
    assert paths["variencePath"] == sp["variencePath"][start:]
    assert paths["valLossPath"][-1] == sp["valLossPath"][-1]


def test_degraded_rollback_at_a_boundary_matches_jax(ds, jds):
    """Service rounds, R=2, the guard armed under --dispatch-mode degraded:
    params poisoned at the boundary after round 2 make the next dispatch
    diverge; exactly one rollback restores round 2 and runs the dispatch
    again under salted draws, in both packages, with full finite paths."""
    kw = _kw(agg="trimmed_mean", attack=None, byz_size=0, service="on", population=24,
             straggler_prob=0.2, rounds_per_dispatch=2, dispatch_mode="degraded")

    def jpoison(r, t):
        if r == 2 and not t._rollbacks_done:
            t.flat_params = t.flat_params * jnp.nan

    def tpoison(r, t, _paths):
        if r == 2 and not t._rollbacks_done:
            t.flat_params.mul_(math.nan)

    jt = FedTrainer(JaxFedConfig(agg_impl="xla", **kw), dataset=jds)
    jpaths = jt.train(checkpoint_fn=jpoison)
    t, paths, lines = _train(FedConfig(**kw), ds, checkpoint_fn=tpoison)
    assert t._rollbacks_done == jt._rollbacks_done == 1
    assert t._rollback_epoch == 1 and float(t.service_state[1]) == 1.5
    assert any("dispatch ending round 4 diverged (non_finite); restored round 2" in line
               for line in lines)
    assert {k: len(v) for k, v in paths.items()} == {k: len(jpaths[k]) for k in paths}
    assert all(math.isfinite(v) for key in ("valLossPath", "variencePath")
               for v in paths[key])


# ---------------------------------------------------------------------------
# the Weiszfeld loop's unrolled mode


def _stack(k, d, seed, spread=1e-3):
    rng = np.random.default_rng(seed)
    base = 0.01 * rng.standard_normal((1, d))
    w = (base + spread * rng.standard_normal((k, d))).astype(np.float32)
    g = (w.mean(axis=0) + spread * rng.standard_normal(d)).astype(np.float32)
    return w, g


def _jax_gm_draws(key, k, d, steps):
    """The fades and receiver normals JAX's gm draws at each step (its key
    chain, as ``tests/test_torch_aggregators.py`` reproduces it)."""
    h_r, h_i, z = [], [], []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        key_h, key_n = jax.random.split(sub)
        hr, hi = jchannel.rayleigh_fade(key_h, k)
        h_r.append(np.asarray(hr))
        h_i.append(np.asarray(hi))
        z.append(np.asarray(jax.random.normal(key_n, (d + 1,), dtype=jnp.float32)))
    return (torch.from_numpy(np.stack(h_r)), torch.from_numpy(np.stack(h_i))), \
        torch.from_numpy(np.stack(z))


@pytest.mark.parametrize("rule,maxiter", [("gm", 120), ("gm_noiseless", 60)])
def test_unrolled_loop_is_bitwise_the_chunked_loop(rule, maxiter):
    """gm's loop unrolled to all ``maxiter`` steps with no host read gives
    the chunked loop's guess bit for bit (the steps after convergence copy
    it), and its steps as a device scalar; both within rtol 1e-4 of the JAX
    solve with its draws.  (gm2's captured loop is a loop node, below.)"""
    k, d = 13, 300
    w, g = _stack(k, d, seed=5)
    wt, gt = torch.from_numpy(w), torch.from_numpy(g)
    noise_var = 1e-2 if rule == "gm" else None
    tol = 2.5e-3 if rule == "gm" else 2e-3
    key = jax.random.PRNGKey(42)
    want = jagg.gm(jnp.asarray(w), key=key, noise_var=noise_var, guess=jnp.asarray(g),
                   maxiter=maxiter, tol=tol, impl="xla")
    fades, noise = _jax_gm_draws(key, k, d, maxiter)

    def solve(unrolled):
        return tagg.gm_solve(wt, noise_var=noise_var, guess=gt, maxiter=maxiter, tol=tol,
                             fades=fades, noise=noise, unrolled=unrolled)

    chunked, n_chunked = solve(False)
    unrolled, n_unrolled = solve(True)
    assert isinstance(n_chunked, int) and isinstance(n_unrolled, torch.Tensor)
    assert 1 < n_chunked < maxiter, "the case must stop on the tolerance"
    assert int(n_unrolled) == n_chunked
    assert torch.equal(unrolled, chunked)
    np.testing.assert_allclose(unrolled.numpy(), np.asarray(want), rtol=RTOL, atol=1e-7)


def test_unrolled_gm_with_a_generator_is_bitwise_the_chunked_gm():
    """Drawing from a generator, the unrolled loop draws for every step,
    the chunked one up to its chunk's end: the extra draws are discarded."""
    w, g = _stack(11, 200, seed=3)
    out = {}
    for unrolled in (False, True):
        gen = torch.Generator().manual_seed(7)
        out[unrolled] = tagg.gm_solve(torch.from_numpy(w), noise_var=1e-2,
                                      guess=torch.from_numpy(g), maxiter=120, tol=2.5e-3,
                                      generator=gen, unrolled=unrolled)
    assert torch.equal(out[True][0], out[False][0]) and int(out[True][1]) == out[False][1]


@pytest.mark.parametrize("launches", [True, False], ids=["kernel", "plain"])
def test_a_drawing_step_never_gets_a_loop_node(monkeypatch, launches):
    """Inside a capture gm2's solve takes the WHILE node where its step
    launches the fused kernel (one launch a step), and the unrolled loop
    where it runs the plain version (``--agg-impl xla``, or no card);
    gm's (a step that draws) always the unrolled loop.  Outside a capture
    every solve chunks, and an explicit ``unrolled`` overrides."""
    assert tagg.solve_mode(None, False, "weiszfeld_step") == "chunked"
    assert tagg.solve_mode(None, True, "weiszfeld_step") == "loop"
    assert tagg.solve_mode(None, True, None) == "unrolled"
    assert tagg.solve_mode(True, True, "weiszfeld_step") == "unrolled"
    assert tagg.solve_mode(False, True, "weiszfeld_step") == "chunked"
    assert tagg.solve_mode(None, False, None) == "chunked"
    seen = []

    def record(step, init, maxiter, chunk=tagg.WEISZFELD_CHUNK, unrolled=None,
               loop_kernel=None):
        seen.append(loop_kernel)
        return init, 0

    monkeypatch.setattr(tagg, "weiszfeld_solve", record)
    asked = []

    def use_kernel(w):
        asked.append(w)
        return launches

    # the wrappers' choice (``kernels._use_kernel``): on the card a CUDA
    # stack launches unless ``--agg-impl xla``; here a CPU stack stands in
    monkeypatch.setattr(tkernels, "_use_kernel", use_kernel)
    w, g = _stack(5, 20, seed=1)
    wt = torch.from_numpy(w)
    tagg.gm2_solve(wt)
    assert len(asked) == 1 and asked[0] is wt
    tagg.gm_solve(wt, noise_var=1e-2, generator=torch.Generator().manual_seed(1))
    tagg.gm_solve(wt)
    fades = (torch.ones(3, 5), torch.ones(3, 5))
    tagg.gm_solve(wt, maxiter=3, fades=fades, noise=torch.zeros(3, 21), noise_var=1e-2)
    assert seen == ["weiszfeld_step" if launches else None, None, None, None]


@pytest.mark.parametrize("maxiter", [1000, 50, 41, 16, 7])
def test_captured_loop_is_a_while_node_of_chunks_and_an_if_node_of_the_tail(
        monkeypatch, maxiter):
    """The captured gm2 loop's layout (``_loop_nodes``), with the graph calls
    recorded in place of libcuda's: a WHILE node over one 16-step chunk
    where ``maxiter >= 16``, and an IF node over the ``maxiter % 16`` left
    where any are; each body ends with the guess in the first buffer (an
    odd count copies it back) and with the stopping test, which sets the
    loop's and the tail's conditions from the WHILE body; and the bodies'
    capture-time launches leave ``LAUNCHES`` as it was."""
    events = []
    handles = iter(range(101, 110))

    def conditional_handle(default):
        h = next(handles)
        events.append(("handle", h, default))
        return h

    class Body:
        def __init__(self, handle, loop):
            events.append(("while" if loop else "if", handle))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            events.append(("end",))

    monkeypatch.setattr(tgraphs, "conditional_handle", conditional_handle)
    monkeypatch.setattr(tgraphs, "conditional_body", Body)
    monkeypatch.setattr(tgraphs, "copy_async",
                        lambda dst, src: events.append(("copy", dst is g, src is spare)))

    def condition(active, steps, launched, n, maxiter_, loop=None, tail=None):
        events.append(("condition", n, loop, tail))

    monkeypatch.setattr(tkernels, "weiszfeld_loop_condition", condition)
    g, spare = torch.zeros(4), torch.zeros(4)
    active = torch.ones((), dtype=torch.int32)
    steps = torch.zeros((), dtype=torch.int64)

    def step(a, b, active_, steps_, _i):
        # as the card's fused wrapper: the guess written into b, in place
        tkernels.LAUNCHES.add("weiszfeld_step", 1)
        b.copy_(a + 1)
        events.append(("step", a is g))
        return b, active_, steps_

    before = dict(tkernels.LAUNCHES)
    tagg._loop_nodes(step, g, spare, active, steps, maxiter, 16, "weiszfeld_step",
                     torch.zeros((), dtype=torch.int64))
    assert dict(tkernels.LAUNCHES) == before
    full, tail = divmod(maxiter, 16)
    want = []
    handle = iter(range(101, 110))
    tail_h = next(handle) if tail else None
    if tail:
        want.append(("handle", tail_h, 1))
    if full:
        loop_h = next(handle)
        want += [("handle", loop_h, 1), ("while", loop_h)]
        want += [("step", j % 2 == 0) for j in range(16)]
        want += [("condition", 16, loop_h, tail_h), ("end",)]
    if tail:
        want.append(("if", tail_h))
        want += [("step", j % 2 == 0) for j in range(tail)]
        want += [("copy", True, True)] if tail % 2 else []
        want += [("condition", tail, None, None), ("end",)]
    assert events == want


# ---------------------------------------------------------------------------
# the graph's predicate, the generators a replay draws from, launch counts


@pytest.mark.parametrize("kw,device,graphed,reason", [
    (dict(), "cuda", False, "one round per dispatch"),
    (dict(rounds_per_dispatch=2), "cpu", False, "CUDA graphs need the card"),
    # gm's steps draw, so its graph runs them all; gm2's loop stops on the
    # device at convergence, and its banner is the plain one (below)
    (dict(rounds_per_dispatch=2, agg="gm", noise_var=1e-2), "cuda", True,
     "runs all 50 Weiszfeld steps"),
    (dict(rounds_per_dispatch=2, agg="gm", agg_maxiter=1000), "cuda", True,
     "runs all 1000 Weiszfeld steps"),
    (dict(rounds_per_dispatch=2, agg="gm", noise_var=1e-2, model="CNN"), "cuda", True,
     "one CUDA graph"),
    (dict(rounds_per_dispatch=2, agg="median", noise_var=1e-2, attack="weightflip"), "cuda",
     True, "one CUDA graph"),
    (dict(rounds_per_dispatch=2, agg="trimmed_mean", noise_var=1e-2, attack="dataflip"),
     "cuda", True, "one CUDA graph"),
    (dict(rounds_per_dispatch=2, agg="trimmed_mean", attack=None, byz_size=0, service="on",
          population=20, rollback="off"), "cuda", False, "link_key"),
    (dict(rounds_per_dispatch=2, agg="mean", cohort_size=2), "cuda", False,
     "cohort-streamed"),
    (dict(rounds_per_dispatch=2, agg="mean", defense="adaptive"), "cuda", False,
     "reads its rung on the host"),
    (dict(rounds_per_dispatch=2, agg="mean", attack="signflip", defense="monitor"), "cuda",
     True, "one CUDA graph"),
    (dict(rounds_per_dispatch=2, attack="mimic", defense="monitor"), "cuda", False,
     "defense-aware attacks"),
    (dict(rounds_per_dispatch=2, fault="chaos"), "cuda", False, "fault rounds"),
    (dict(rounds_per_dispatch=2, agg="krum"), "cuda", False, "the rule krum is not captured"),
    (dict(rounds_per_dispatch=2, agg="Krum"), "cuda", False, "the rule Krum is not captured"),
    (dict(rounds_per_dispatch=2, model="ResNet18", dataset="cifar10"), "cuda", True,
     "one CUDA graph"),
    # an alias shares its entry's registration, so it is captured as well
    (dict(rounds_per_dispatch=2, model="cnn", agg="mean"), "cuda", True,
     "one CUDA graph of the round, replayed once per round"),
    (dict(rounds_per_dispatch=2, model="mlp", agg="median"), "cuda", True, "one CUDA graph"),
    (dict(rounds_per_dispatch=2, model="resnet18", dataset="cifar10", agg="gm",
          noise_var=1e-2), "cuda", True, "runs all 50 Weiszfeld steps"),
    (dict(rounds_per_dispatch=2, local_steps=2, fedprox_mu=0.01, server_opt="adam"), "cuda",
     True, "one CUDA graph"),
    (dict(rounds_per_dispatch=2, client_momentum=0.9, server_opt="momentum"), "cuda", True,
     "one CUDA graph"),
    (dict(rounds_per_dispatch=2, participation=0.5), "cuda", False, "torch.randperm"),
    (dict(rounds_per_dispatch=2, bucket_size=2, agg="median"), "cuda", False,
     "torch.randperm"),
])
def test_dispatch_graph_says_why(kw, device, graphed, reason):
    cfg = FedConfig(**_kw(**kw))
    got, why = tgraphs.dispatch_graph(cfg, device)
    assert got is graphed and reason in why
    # only gm's banner speaks of its unrolled steps (gm2's graphed loop
    # stops at convergence)
    assert ("Weiszfeld steps" in why) == (got and cfg.agg == "gm")


def test_banner_prints_the_dispatch_and_why(ds, capsys):
    cfg = FedConfig(**_kw(rounds=2, rounds_per_dispatch=2))
    tharness.run_with_trainer(cfg, device="cpu", record_in_file=False, dataset=ds)
    out = capsys.readouterr().out
    assert "[dispatch    ]   roundsPerDispatch=2" in out
    assert "cudaGraph=no (CUDA graphs need the card" in out
    cfg1 = FedConfig(**_kw(rounds=1))
    tharness.run_with_trainer(cfg1, device="cpu", record_in_file=False, dataset=ds)
    assert "[dispatch" not in capsys.readouterr().out


def test_kept_generators_draw_what_new_ones_draw(ds):
    """``run_round``'s kept generator of a slot draws what a new one of the
    same (round, iteration, stream) draws, after any reseed; a reseed
    reaches every kept one."""
    t = Trainer(FedConfig(**_kw(fault="chaos")), dataset=ds, device="cpu")
    kept = t.iteration_generators(3, 1, persistent=True)
    assert t.iteration_generators(3, 1, persistent=True).batch is kept.batch
    for g in kept[:5]:
        torch.rand(7, generator=g)  # used: a reseed must start it over
    t.reseed_slot_generators(5)
    new = t.iteration_generators(5, 1)
    assert new.batch is not kept.batch
    for a, b in zip(kept[:5], new[:5]):
        assert a.initial_seed() == b.initial_seed()
        assert torch.equal(torch.rand(7, generator=a), torch.rand(7, generator=b))
    assert len(t._slot_generators) == 5  # streams 0-3 and the fault's, one slot


def test_add_launches_counts_a_replay():
    before = dict(tkernels.LAUNCHES)
    try:
        tkernels.add_launches({"weiszfeld_step": 160, "select_columns": 0})
        assert tkernels.LAUNCHES["weiszfeld_step"] == before["weiszfeld_step"] + 160
        assert tkernels.LAUNCHES["select_columns"] == before["select_columns"]
    finally:
        tkernels.LAUNCHES.update(before)
