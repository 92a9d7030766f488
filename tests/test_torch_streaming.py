"""Cohort-streamed rounds of the port (``--cohort-size``) on the CPU: the
streamed rules against the JAX package's ``stream_*`` on the same numpy
chunk list, one whole streamed iteration against JAX's
``_iteration_streamed`` from the same params and draws, the port's
streamed trainer against its resident one (as the JAX package's
``tests/test_streaming.py`` holds its own), and the config's checks
against JAX's.

Tolerances: the exact median bitwise (also with ties, and with NaN rows
degraded), the sketch's keys bitwise (and its median within one bucket
of the exact one, JAX's own check), the exact trimmed mean 1e-6, gm2 1e-5 (its Weiszfeld sums add in
another order), the mean 1e-6; the streamed trainer against the resident
one bitwise for the median (one batch draw, integer counts) and within
1e-5 for mean, trimmed_mean and gm2 (chunk sums add in another order),
1e-4 under service with ``--var`` and under partial participation; one
whole iteration against JAX 1e-5, and its streamed variance, a difference
of moments (``sum ||w||^2 / n - ||mean||^2``), within 1e-6 of the squared
norm it cancels.  The trainer comparisons that are bitwise run the CPU on
one thread: a multithreaded batched matmul may add in another order for
a [cohort] batch of clients than for all K.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantine_aircomp_tpu.fed import harness as jharness
from byzantine_aircomp_tpu.fed.config import FedConfig as JaxFedConfig
from byzantine_aircomp_tpu.fed.train import FedTrainer
from byzantine_aircomp_tpu.ops import aggregators as jagg
from byzantine_aircomp_tpu_torch.data import datasets as tdata
from byzantine_aircomp_tpu_torch.fed import harness as tharness
from byzantine_aircomp_tpu_torch.fed.config import FedConfig
from byzantine_aircomp_tpu_torch.fed.train import Trainer
from byzantine_aircomp_tpu_torch.ops import aggregators as tagg
from byzantine_aircomp_tpu_torch.ops import kernels as tkernels
from test_torch_service import _service_draws


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def mnist():
    return tdata.load("mnist", synthetic_train=600, synthetic_val=200)


# ---------------------------------------------------------------------------
# the streamed rules against JAX's


def _chunks(seed, n_chunks=4, cohort=4, d=300, nan_rows=()):
    """A [n_chunks * cohort, d] stack with tied rows, tied columns, signed
    zeros and the given NaN rows, as (JAX rebuild, port rebuild, stack)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n_chunks * cohort, d)).astype(np.float32)
    w[3] = w[5]
    w[:, :10] = np.round(w[:, :10])  # ties, and -0.0 beside +0.0
    w[list(nan_rows)] = np.nan
    jw = jnp.asarray(w).reshape(n_chunks, cohort, d)
    tw = _t(w).reshape(n_chunks, cohort, d)
    return (lambda c: jw[c]), (lambda c: tw[c]), w


_CASES = [(False, ()), (True, (2, 9)), (True, (0, 1, 2, 3, 15))]


def _kw(w, degraded):
    kw = dict(k=w.shape[0], d=w.shape[1], n_chunks=4, degraded=degraded)
    n = int(np.isfinite(w).all(axis=1).sum())
    return kw, (jnp.int32(n) if degraded else None), (torch.tensor(n) if degraded else None)


@pytest.mark.parametrize("degraded,nan_rows", _CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_stream_median_is_bitwise_jax(seed, degraded, nan_rows):
    jreb, treb, w = _chunks(seed, nan_rows=nan_rows)
    kw, jn, tn = _kw(w, degraded)
    want = np.asarray(jagg.stream_median(jreb, n_finite=jn, **kw))
    got = tagg.stream_median(treb, n_finite=tn, device="cpu", **kw).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    if not degraded:  # and the resident selection's (the kernel's plain version)
        ref = tkernels.fused_median_ref(_t(w)).numpy()
        assert np.array_equal(got.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("degraded,nan_rows", _CASES)
@pytest.mark.parametrize("quantile", ["exact", "sketch"])
def test_stream_trimmed_mean_matches_jax(quantile, degraded, nan_rows):
    jreb, treb, w = _chunks(3, nan_rows=nan_rows)
    kw, jn, tn = _kw(w, degraded)
    want = np.asarray(jagg.stream_trimmed_mean(jreb, n_finite=jn, quantile=quantile,
                                                sketch_bins=64, trim_ratio=0.2, **kw))
    got = tagg.stream_trimmed_mean(treb, n_finite=tn, quantile=quantile, sketch_bins=64,
                                   trim_ratio=0.2, device="cpu", **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if quantile == "exact" and not degraded:
        ref = tkernels.fused_trimmed_mean_ref(_t(w), int(16 * 0.2)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("degraded,nan_rows", _CASES[:2])
@pytest.mark.parametrize("seed,bins", [(4, 64), (5, 512), (6, 7)])
def test_sketch_keys_are_bitwise_jax(seed, bins, degraded, nan_rows):
    jreb, treb, w = _chunks(seed, nan_rows=nan_rows)
    ns = [2, 6, 11]
    want = np.asarray(jagg._stream_sketch_keys(jreb, 4, 300, jnp.asarray(ns, jnp.int32), 3,
                                               bins, degraded))
    got = tagg._stream_sketch_keys(treb, 4, 300, torch.tensor(ns), 3, bins, degraded,
                                   "cpu").numpy()
    assert np.array_equal(got, want)


def test_sketch_median_within_one_bucket_as_jax_holds_it():
    """JAX's ``test_stream_sketch_within_one_bucket_bound`` on the port: the
    estimate is the bucket's upper edge, at or above the exact median's key
    by at most one bucket width of the key span (JAX's stack and bins)."""
    stack = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (24, 33), jnp.float32))
    tw = _t(stack).reshape(4, 6, 33)
    est = tagg.stream_median(lambda c: tw[c], k=24, d=33, n_chunks=4, device="cpu",
                             quantile="sketch", sketch_bins=4096)
    true = tagg.median(_t(stack))
    keys = tkernels.total_order_keys(_t(stack)).numpy().astype(np.int64)
    k_est = tkernels.total_order_keys(est[None, :]).numpy()[0].astype(np.int64)
    k_true = tkernels.total_order_keys(true[None, :]).numpy()[0].astype(np.int64)
    span = keys.max(axis=0) - keys.min(axis=0)
    assert (k_est >= k_true).all() and (k_est - k_true <= span / 4096 + 2).all()


@pytest.mark.parametrize("degraded,nan_rows", _CASES[:2])
def test_stream_gm2_and_mean_match_jax(degraded, nan_rows):
    jreb, treb, w = _chunks(7, nan_rows=nan_rows)
    kw, _, _ = _kw(w, degraded)
    guess = np.random.default_rng(8).normal(size=300).astype(np.float32) * 0.1
    want = np.asarray(jagg.stream_gm2(jreb, guess=jnp.asarray(guess), maxiter=200,
                                      tol=1e-6, **kw))
    got, steps = tagg.stream_gm2_solve(treb, guess=_t(guess), maxiter=200, tol=1e-6,
                                       device="cpu", **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert 1 < steps < 200
    # the same solve on the resident stack (the kernel's plain version)
    resident = tagg.gm2(_t(w), guess=_t(guess), maxiter=200, tol=1e-6)
    np.testing.assert_allclose(got.numpy(), resident.numpy(), rtol=0, atol=1e-5)
    want_mean = np.asarray(jagg.stream_mean(jreb, **kw))
    got_mean = tagg.stream_mean(treb, device="cpu", **kw).numpy()
    np.testing.assert_allclose(got_mean, want_mean, rtol=0, atol=1e-6)


def test_stream_gm2_launches_one_step_per_chunk_per_step():
    _, treb, w = _chunks(9)
    calls = []
    real = tkernels.weiszfeld_step

    def counting(chunk, g):
        calls.append(tuple(chunk.shape))
        return real(chunk, g)

    tkernels.weiszfeld_step = counting
    try:
        _, steps = tagg.stream_gm2_solve(treb, k=16, d=300, n_chunks=4, device="cpu",
                                         guess=torch.zeros(300), maxiter=50, tol=1e-6)
    finally:
        tkernels.weiszfeld_step = real
    assert calls == [(4, 300)] * (4 * steps)


def test_stream_aggregate_rejects_an_unstreamable_rule():
    _, treb, _ = _chunks(0)
    with pytest.raises(ValueError, match="no streaming realization"):
        tagg.stream_aggregate("krum", treb, k=16, d=300, n_chunks=4, device="cpu")
    assert [n for n in ("mean", "median", "trimmed_mean", "gm2", "gm", "krum", "signmv")
            if tagg.streamable(n)] == ["mean", "median", "trimmed_mean", "gm2"]


# ---------------------------------------------------------------------------
# one whole streamed iteration against JAX


@pytest.mark.parametrize("kw", [
    dict(agg="gm2", attack="signflip", byz_size=4),
    dict(agg="median", attack="classflip", byz_size=4),
    dict(agg="gm2", service="on", population=48, straggler_prob=0.2, attack="signflip",
         byz_size=4),
], ids=["gm2_signflip", "median_classflip", "gm2_service"])
def test_streamed_iteration_matches_jax(mnist, kw):
    kw = dict(dict(honest_size=12, rounds=1, display_interval=2, batch_size=16,
                   cohort_size=4, eval_train=False, agg_maxiter=100), **kw)
    jcfg = JaxFedConfig(agg_impl="xla", **kw)
    jt = FedTrainer(jcfg, dataset=mnist)
    cfg = FedConfig(**kw)
    tt = Trainer(cfg, dataset=mnist, device="cpu", params=_t(jt.flat_params))
    key = jax.random.fold_in(jax.random.PRNGKey(2), 1)
    carry = (jt.flat_params, jt.server_opt_state, jt.client_m, jt.fault_state,
             jt.defense_state, jt.attack_iter, jt.service_state)
    if cfg.service == "on":
        draws = _service_draws(jt, key, cfg, np.ones(48, bool), tt.dim)
    else:
        k_batch = jax.random.split(key, 4)[0]
        draws = {"u": _t(jax.random.uniform(k_batch, (16, 16)))}
    carry, outs = jt._iteration(carry, key, jt.x_train, jt.y_train, True)
    flat, var = tt.iteration(tt.flat_params, draws=draws, want_variance=True)
    np.testing.assert_allclose(flat.numpy(), np.asarray(carry[0]), rtol=0, atol=1e-5)
    sq_norm = float(np.sum(np.asarray(carry[0], np.float64) ** 2))
    assert abs(float(var) - float(outs[0])) <= 1e-6 * sq_norm
    if cfg.service == "on":
        assert np.array_equal(tt.iteration_service_metrics.numpy(), np.asarray(outs[3]))


# ---------------------------------------------------------------------------
# the port's streamed trainer against its resident one


def _cfg(**kw):
    base = dict(honest_size=8, byz_size=0, rounds=1, display_interval=2, batch_size=16,
                agg="median", eval_train=False, agg_maxiter=50, agg_tol=1e-5)
    base.update(kw)
    return FedConfig(**base)


def _final(cfg, ds):
    t = Trainer(cfg, dataset=ds, device="cpu")
    paths = t.train()
    return t, paths


@contextlib.contextmanager
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("agg", ["mean", "median", "trimmed_mean", "gm2"])
def test_streamed_matches_resident_trainer(mnist, agg):
    with _one_thread():
        resident, _ = _final(_cfg(agg=agg), mnist)
        streamed, _ = _final(_cfg(agg=agg, cohort_size=4), mnist)
    if agg == "median":
        assert torch.equal(streamed.flat_params, resident.flat_params)
    else:
        np.testing.assert_allclose(streamed.flat_params.numpy(),
                                   resident.flat_params.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("attack", ["signflip", "classflip"])
def test_streamed_attack_parity(mnist, attack):
    kw = dict(byz_size=4, attack=attack, agg="median")
    with _one_thread():
        resident, _ = _final(_cfg(**kw), mnist)
        streamed, _ = _final(_cfg(cohort_size=4, **kw), mnist)
    assert torch.equal(streamed.flat_params, resident.flat_params)


def test_streamed_partial_participation_matches_resident(mnist):
    kw = dict(agg="median", participation=0.5)
    resident, _ = _final(_cfg(**kw), mnist)
    streamed, _ = _final(_cfg(cohort_size=2, **kw), mnist)
    np.testing.assert_allclose(streamed.flat_params.numpy(), resident.flat_params.numpy(),
                               rtol=0, atol=1e-4)


def test_service_streamed_matches_resident(mnist):
    kw = dict(rounds=2, noise_var=1.0, agg="trimmed_mean", service="on", population=24,
              churn_arrival=0.05, churn_departure=0.02, straggler_prob=0.2)
    resident, res_paths = _final(_cfg(**kw), mnist)
    streamed, st_paths = _final(_cfg(cohort_size=4, **kw), mnist)
    np.testing.assert_allclose(streamed.flat_params.numpy(), resident.flat_params.numpy(),
                               rtol=0, atol=1e-4)
    assert st_paths["effectiveKPath"] == res_paths["effectiveKPath"]
    assert st_paths["serviceAvailPath"] == res_paths["serviceAvailPath"]
    assert min(res_paths["effectiveKPath"]) < 8


def test_streamed_fault_round_runs_finite(mnist):
    t, paths = _final(_cfg(agg="trimmed_mean", cohort_size=4, fault="deep_fade"), mnist)
    assert torch.isfinite(t.flat_params).all() and paths["faultDroppedPath"] == [0.0]


def test_streamed_corruption_picks_the_resident_clients(mnist):
    """``row_offset``: corrupt_size-limited corruption crashes only the
    first global rows, in whichever chunk they land."""
    t, paths = _final(_cfg(agg="median", cohort_size=2, fault="corrupt", corrupt_prob=1.0,
                           corrupt_size=3, rounds=1), mnist)
    assert paths["faultCorruptPath"] == [6.0] and paths["effectiveKPath"] == [5.0]
    assert torch.isfinite(t.flat_params).all()


def test_streamed_adaptive_defense_runs(mnist):
    t, paths = _final(_cfg(agg="mean", cohort_size=4, defense="adaptive",
                           defense_ladder="mean,trimmed_mean,median"), mnist)
    assert torch.isfinite(t.flat_params).all() and len(paths["defenseRungPath"]) == 1


def test_streamed_duty_cycle_monitor_parity(mnist):
    kw = dict(byz_size=2, attack="duty_cycle", agg="median", rounds=4, defense="monitor",
              defense_ladder="mean,trimmed_mean,median", defense_up=1, defense_down=1)
    with _one_thread():
        resident, _ = _final(_cfg(**kw), mnist)
        streamed, _ = _final(_cfg(cohort_size=2, **kw), mnist)
    assert torch.equal(streamed.flat_params, resident.flat_params)
    off, _ = _final(_cfg(**dict(kw, defense="adaptive", defense_ladder="median,mean",
                                cohort_size=2)), mnist)
    assert torch.isfinite(off.flat_params).all()


@pytest.mark.parametrize("kw", [
    dict(agg="gm2", noise_var=1e-2, attack="gaussian", byz_size=4, fault="chaos",
         dropout_prob=0.0),
    dict(agg="median", noise_var=1e-2, service="on", population=24, straggler_prob=0.3,
         attack="duty_cycle", byz_size=4, honest_size=4, defense="monitor"),
], ids=["channel_fault_gaussian", "service_duty_cycle"])
def test_a_rebuilt_chunk_is_the_same_on_two_passes(mnist, kw):
    cfg = _cfg(cohort_size=2, **kw)
    t = Trainer(cfg, dataset=mnist, device="cpu")
    gens = t.iteration_generators(0, 0)
    if cfg.service == "on":
        pop_ids, arrived, _ = t._service_stage(gens, {})
        missed = torch.rand(8, generator=torch.Generator().manual_seed(1)) < 0.5
    else:
        pop_ids = missed = None
    idx = torch.randint(0, 600, (cfg.node_size, 16), generator=torch.Generator().manual_seed(0))
    ge = t.fault_state.ge_bad if t.fault is not None else None
    rebuild = t.make_rebuild(t.flat_params, gens, idx, None, pop_ids, missed, ge,
                             t.defense_state)
    for c in range(cfg.node_size // 2):
        a, b = rebuild(c)[0].numpy(), rebuild(c)[0].numpy()
        assert np.array_equal(a.view(np.int32), b.view(np.int32)), c


# ---------------------------------------------------------------------------
# the config's checks, titles and hashes


@pytest.mark.parametrize("kw,match", [
    (dict(cohort_size=3), "must divide"),
    (dict(agg="krum", cohort_size=4), "no streaming"),
    (dict(byz_size=4, attack="alie", cohort_size=4), "omniscient"),
    (dict(cohort_size=4, bucket_size=2), "bucketing"),
    (dict(cohort_size=4, participation=0.75), "must divide"),
    (dict(cohort_quantile="sketch"), "require --cohort-size"),
    (dict(cohort_size=4, client_momentum=0.5), "client_momentum"),
    (dict(cohort_size=4, fault="dropout"), "stale-replay"),
    (dict(cohort_size=4, cohort_quantile="median"), "cohort_quantile"),
    (dict(cohort_size=4, cohort_sketch_bins=1), "cohort_sketch_bins"),
    (dict(cohort_size=-1), "cohort_size must be"),
    (dict(cohort_size=4, agg="mean", defense="adaptive",
          defense_ladder="mean,multi_krum"), "no streaming"),
])
def test_validation_errors_match_jax(kw, match):
    base = dict(honest_size=8, byz_size=0, agg="median")
    for cls in (JaxFedConfig, FedConfig):
        with pytest.raises(ValueError, match=match):
            cls(**dict(base, **kw)).validate()
    FedConfig(**dict(base, cohort_size=4)).validate()
    FedConfig(**dict(base, cohort_size=4, participation=0.5)).validate()


@pytest.mark.parametrize("kw", [
    dict(cohort_size=4),
    dict(cohort_size=2, cohort_quantile="sketch", cohort_sketch_bins=64),
    dict(cohort_size=4, participation=0.5),
])
def test_titles_match_jax_and_fork_the_hash(kw):
    base = dict(honest_size=8, byz_size=0, agg="median")
    cfg = FedConfig(**base, **kw)
    assert tharness.run_title(cfg) == jharness.run_title(JaxFedConfig(**base, **kw))
    plain = dataclasses.replace(cfg, cohort_size=0, cohort_quantile="exact",
                                cohort_sketch_bins=512)
    assert tharness.config_hash(cfg) != tharness.config_hash(plain)
    assert "cohort" not in tharness.run_title(plain)
