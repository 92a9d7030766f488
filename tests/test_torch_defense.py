"""The online defense of the port against the JAX package on the CPU: the
scores, the detector, the policy, the defense-aware attacks, whole
iterations under ``--defense adaptive`` and ``monitor``, the round's
metrics and the record, from the same numpy inputs made from a seed.

Tolerances: ``masked_median`` exactly; over a 30-iteration sequence of
stacks with non-finite rows, the flags and the rungs exactly, the scores,
their components and the detector state within 1e-5; the attacks on a
given ``DefenseView`` within 1e-5 (relative and absolute); whole
iterations within 1e-5 with the rung and the flag counts exact; ``--defense monitor`` bitwise equal to ``--defense off``.
These compare functions, not the expectations of the JAX package's own
defense tests.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantine_aircomp_tpu import defense as jdefense
from byzantine_aircomp_tpu.analysis.plots import load_record
from byzantine_aircomp_tpu.fed.config import FedConfig as JaxFedConfig
from byzantine_aircomp_tpu.fed.train import FedTrainer
from byzantine_aircomp_tpu.ops import attacks as jattacks
from byzantine_aircomp_tpu_torch import defense as tdefense
from byzantine_aircomp_tpu_torch.data import datasets as tdata
from byzantine_aircomp_tpu_torch.fed import harness as tharness
from byzantine_aircomp_tpu_torch.fed.config import FedConfig
from byzantine_aircomp_tpu_torch.fed.train import Trainer
from byzantine_aircomp_tpu_torch.ops import attacks as tattacks
from byzantine_aircomp_tpu_torch.registry import ATTACKS
from test_torch_training_options import crop8, jax_carry, jax_iteration_draws

REPO = Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def mnist():
    return tdata.load("mnist", synthetic_train=600, synthetic_val=100)


def test_masked_median_matches_jax():
    rng = np.random.default_rng(0)
    for n in (1, 2, 5, 10, 11):
        for trial in range(6):
            x = rng.standard_normal(n).astype(np.float32)
            x[rng.random(n) < 0.2] = x[0]  # ties
            mask = rng.random(n) < (0.7 if trial else 0.0)
            want = np.asarray(jdefense.scores.masked_median(jnp.asarray(x), jnp.asarray(mask)))
            got = tdefense.scores.masked_median(_t(x), _t(mask)).numpy()
            assert np.array_equal(got, want), (n, trial)
    assert np.isinf(got) or mask.any()


def _stack_sequence(k=10, byz=2, d=64, iters=30, seed=1, offset=1.0):
    """30 received stacks around a drifting guess of scale ``offset``:
    honest rows one small step from it, the Byzantine rows honest until
    iteration 12 and sign-flipped after; erased (NaN) and overflowed (Inf)
    rows in some iterations."""
    rng = np.random.default_rng(seed)
    guess = offset * rng.standard_normal(d).astype(np.float32)
    out = []
    for it in range(iters):
        w = guess + 0.01 * rng.standard_normal((k, d)).astype(np.float32)
        if it >= 12:
            w[-byz:] = -w[-byz:] - 0.05
        if it % 7 == 3:
            w[rng.integers(0, k)] = np.nan
        if it % 11 == 5:
            w[rng.integers(0, k), 3] = np.inf
        out.append((w.astype(np.float32), guess.copy()))
        guess = (guess + 0.005 * rng.standard_normal(d)).astype(np.float32)
    return out


def _gram_tolerance(w):
    """The distance term's agreement bound on ``w``: the Gram form
    ``|a|^2 + |b|^2 - 2<a, b>`` (both packages) loses about
    eps_f32 * max |w_i|^2 to cancellation, relative to the median
    distance, and the two libraries round their sums in other orders."""
    fin = np.isfinite(w).all(axis=1)
    wf = w[fin].astype(np.float64)
    sq = np.sum(wf * wf, axis=1)
    dist = sq[:, None] + sq[None, :] - 2 * wf @ wf.T
    med = np.median(dist.sum(axis=1) / max(len(wf) - 1, 1))
    return max(1e-5, 16 * 2.0**-24 * sq.max() / med)


@pytest.mark.parametrize("offset", [0.0, 1.0], ids=["centered", "offset"])
@pytest.mark.parametrize("knobs", [
    dict(),
    dict(defense_warmup=2, defense_up=1, defense_down=3, defense_floor=0.0),
    dict(defense_z=2.0, defense_cusum=3.0, defense_min_flagged=2, defense_leak=0.2),
], ids=["defaults", "fast_no_floor", "tight_leaky"])
def test_scores_detector_and_policy_match_jax_over_30_iterations(knobs, offset):
    """Each iteration: the score components on the same stack (the norm
    and cosine terms within 1e-5, relative and absolute; the distance term
    within 1e-5 on stacks
    centered at 0 and within :func:`_gram_tolerance` on stacks offset from
    it, where the Gram form's cancellation dominates in both packages);
    each detector on the JAX package's scores within 1e-5; and the flags,
    the suspicious bit and the rung of each package's own chain exactly."""
    kw = dict(defense="monitor", agg="mean", **knobs)
    jspec = jdefense.from_config(JaxFedConfig(**kw))
    tspec = tdefense.from_config(FedConfig(**kw))
    k = 10
    j_det, j_pol = jdefense.init_state(jspec, k)
    t_det, t_pol = tdefense.init_state(tspec, k, "cpu")
    s_det = t_det
    rungs, flagged = [], 0
    for w, g in _stack_sequence(k, offset=offset):
        j_score, j_fin, j_parts = jdefense.client_score_components(jnp.asarray(w), jnp.asarray(g))
        t_score, t_fin, t_parts = tdefense.client_score_components(_t(w), _t(g))
        assert np.array_equal(t_fin.numpy(), j_fin)
        j_parts = np.asarray(j_parts)
        np.testing.assert_allclose(t_parts.numpy()[:, :2], j_parts[:, :2], rtol=1e-5, atol=1e-5)
        tol = 1e-5 if offset == 0.0 else _gram_tolerance(w)
        np.testing.assert_allclose(t_parts.numpy()[:, 2], j_parts[:, 2], rtol=1e-5, atol=tol)
        np.testing.assert_allclose(t_score.numpy(), j_score, rtol=1e-5, atol=tol + 2e-5)
        # the port's detector on the JAX scores
        s_det, same_flags = tdefense.detector_update(s_det, _t(j_score), t_fin,
                                                     tspec.detector)
        j_det, j_flags = jdefense.detector_update(j_det, j_score, j_fin, jspec.detector)
        assert np.array_equal(same_flags.numpy(), j_flags)
        for a, b in zip(s_det, j_det):
            assert a.numpy().dtype == np.asarray(b).dtype
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5)
        # and on its own
        t_det, t_flags = tdefense.detector_update(t_det, t_score, t_fin, tspec.detector)
        assert np.array_equal(t_flags.numpy(), j_flags)
        j_pol, j_susp = jdefense.policy_update(j_pol, jnp.sum(j_flags), jspec.policy)
        t_pol, t_susp = tdefense.policy_update(t_pol, torch.sum(t_flags), tspec.policy)
        assert bool(t_susp) == bool(j_susp)
        for a, b in zip(t_pol, j_pol):
            assert a.numpy().dtype == np.asarray(b).dtype
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=0)
        rungs.append(int(t_pol[0]))
        flagged += int(t_flags.sum())
    assert flagged > 0 and max(rungs) >= 1  # the sequence exercises both


def test_policy_floor_and_deescalation_match_jax():
    """A scripted flag sequence: bursts, sleeps, and the budget floor."""
    for floor in (1.5, 0.0):
        p = dict(up_n=2, down_m=3, min_flagged=1, n_rungs=3, budget_leak=0.05,
                 floor_thresh=floor)
        jp, tp = jdefense.PolicyParams(**p), tdefense.PolicyParams(**p)
        j_pol, t_pol = jdefense.init_policy(), tdefense.init_policy("cpu")
        seq = [2] * 6 + [0] * 8 + [1] * 5 + [0] * 12 + [3] * 3 + [0] * 20
        rungs = []
        for n in seq:
            j_pol, _ = jdefense.policy_update(j_pol, jnp.int32(n), jp)
            t_pol, _ = tdefense.policy_update(t_pol, torch.tensor(n), tp)
            assert [float(x) for x in t_pol] == pytest.approx(
                [float(x) for x in j_pol], rel=1e-6)
            rungs.append(int(t_pol[0]))
        assert max(rungs) == 2 and 0 in rungs[6:]


def _view(pkg, k, d, step, seed, spec_kw=None):
    rng = np.random.default_rng(seed)
    cfg_kw = dict(defense="adaptive", agg="mean", **(spec_kw or {}))
    ema = np.abs(rng.standard_normal(k)).astype(np.float32)
    dev = (0.1 + np.abs(rng.standard_normal(k))).astype(np.float32)
    cusum = np.abs(rng.standard_normal(k)).astype(np.float32) * 3
    guess = rng.standard_normal(d).astype(np.float32)
    if pkg == "jax":
        spec = jdefense.from_config(JaxFedConfig(**cfg_kw))
        return jattacks.DefenseView(
            step=jnp.int32(step), ema=jnp.asarray(ema), dev=jnp.asarray(dev),
            cusum=jnp.asarray(cusum), rung=jnp.int32(1), detector=spec.detector,
            policy=spec.policy, guess=jnp.asarray(guess))
    spec = tdefense.from_config(FedConfig(**cfg_kw))
    return tattacks.DefenseView(
        step=torch.tensor(step, dtype=torch.int32), ema=_t(ema), dev=_t(dev), cusum=_t(cusum),
        rung=torch.tensor(1, dtype=torch.int32), detector=spec.detector, policy=spec.policy,
        guess=_t(guess))


@pytest.mark.parametrize("name,param", [
    ("mimic", None), ("under_radar", None), ("under_radar", 0.5), ("duty_cycle", None),
])
@pytest.mark.parametrize("step", [2, 7, 13, 50])
def test_defense_aware_attacks_match_jax(name, param, step):
    k, byz, d = 12, 3, 200
    rng = np.random.default_rng(step)
    base = _view("torch", k, d, step, seed=step).guess.numpy()
    w = (base + 0.01 * rng.standard_normal((k, d))).astype(np.float32)
    want = jattacks.resolve(name).apply_message(
        jnp.asarray(w), byz, jax.random.PRNGKey(0), param=param,
        defense=_view("jax", k, d, step, seed=step))
    got = tattacks.resolve(name).apply_message(
        _t(w), byz, None, param=param, defense=_view("torch", k, d, step, seed=step))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert np.array_equal(got.numpy()[:-byz], w[:-byz])


def test_all_thirteen_attacks_resolve_with_the_jax_tiers():
    names = {"classflip", "dataflip", "weightflip", "signflip", "gradascent", "alie", "ipm",
             "gaussian", "minmax", "minsum", "mimic", "under_radar", "duty_cycle"}
    assert set(ATTACKS.names()) == names
    for name in names:
        assert tattacks.resolve(name).meta() == jattacks.resolve(name).meta(), name
    on, period = tattacks.duty_cycle_schedule(tdefense.PolicyParams())
    assert (on, period) == jattacks.duty_cycle_schedule(jdefense.PolicyParams())
    with pytest.raises(ValueError, match="defense-aware"):
        tattacks.resolve("mimic").apply_message(torch.zeros(4, 3), 1)


@pytest.mark.parametrize("kw,match", [
    (dict(defense="on"), "off|monitor|adaptive"),
    (dict(defense_z=3.0), "require --defense"),
    (dict(defense="adaptive", agg="median"), "must equal --agg"),
    (dict(defense="adaptive", agg="mean", defense_ladder="mean"), ">= 2 rungs"),
    (dict(defense="monitor", defense_ladder="mean,gm"), "owns its channel"),
    (dict(defense="monitor", defense_ladder="mean,nope"), "unknown aggregator"),
    (dict(defense="monitor", participation=0.5), "full participation"),
    (dict(defense="monitor", defense_alpha=0.0), "defense_alpha"),
    (dict(defense="monitor", defense_up=0), "hysteresis"),
    (dict(defense="monitor", defense_leak=1.0), "defense_leak"),
    (dict(defense="monitor", defense_floor=-1.0), "defense_floor"),
    (dict(attack="under_radar", byz_size=1), "defense-aware"),
])
def test_validation_errors_match_jax(kw, match):
    with pytest.raises((ValueError, KeyError), match=match):
        FedConfig(**kw).validate()
    with pytest.raises((AssertionError, ValueError, KeyError), match=match):
        JaxFedConfig(**kw).validate()


def _iterations_with_rungs(ds, kw, n):
    """``n`` chained iterations of both trainers from the same params and
    draws; at each the params within 1e-5, the policy's rung and streaks
    and the flagged and suspicious counts exactly, the baselines and the
    score and CUSUM maxima within 1e-3 relative (the distance term's Gram
    form loses ~1e-4 relative to cancellation on real stacks, in both
    packages); returns the port trainer and the rungs."""
    jt = FedTrainer(JaxFedConfig(agg_impl="xla", **kw), dataset=ds)
    tt = Trainer(FedConfig(**kw), dataset=ds, device="cpu", params=_t(jt.flat_params))
    carry, flat, rungs = jax_carry(jt), tt.flat_params, []
    for i in range(n):
        key = jax.random.fold_in(jax.random.PRNGKey(9), i)
        carry, outs = jt._iteration(carry, key, jt.x_train, jt.y_train, False)
        flat, _ = tt.iteration(flat, draws=jax_iteration_draws(tt.cfg, key, tt.dim))
        np.testing.assert_allclose(flat.numpy(), np.asarray(carry[0]), rtol=0, atol=1e-5)
        (j_det, j_pol), (t_det, t_pol) = carry[4], tt.defense_state
        assert [int(x) for x in t_pol[:3]] == [int(x) for x in j_pol[:3]]
        # the baselines and the score and CUSUM maxima carry the distance
        # term's Gram-form cancellation (test_scores_detector_and_policy_...)
        np.testing.assert_allclose(t_det[1].numpy(), j_det[1], rtol=1e-3, atol=1e-5)
        got, want = tt.iteration_defense_metrics.numpy(), np.asarray(outs[2])
        assert np.array_equal(got[:3], want[:3])  # rung, flagged, suspicious
        np.testing.assert_allclose(got[3:], want[3:], rtol=1e-3, atol=1e-5)
        rungs.append(int(t_pol[0]))
    return tt, rungs


def test_adaptive_signflip_escalates_like_jax(mnist):
    """Run (x)'s config at K=10: mean, --defense adaptive, signflip from
    iteration 5 on (the onset counter), 14 iterations: the rung leaves 0
    and the trimmed_mean rung aggregates."""
    tt, rungs = _iterations_with_rungs(mnist, dict(
        honest_size=8, byz_size=2, attack="signflip@1", agg="mean", defense="adaptive",
        display_interval=5, batch_size=8, seed=11), 14)
    assert rungs[0] == 0 and max(rungs) >= 1, rungs


@pytest.mark.parametrize("attack", ["mimic", "duty_cycle", "under_radar"])
def test_defense_aware_iterations_match_jax(mnist, attack):
    _iterations_with_rungs(mnist, dict(
        honest_size=8, byz_size=2, attack=attack, agg="mean", defense="adaptive",
        defense_warmup=2, batch_size=8, seed=11), 4)


def test_monitor_under_radar_cnn_median_var_matches_jax(mnist):
    """Run (y)'s config at a small width: the CNN (fc 32, 8x8), median
    --var, under_radar, --defense monitor, 3 iterations with the detector
    armed after the first.

    under_radar's bracket top holds ``sqrt(max honest pair distance)``,
    from the Gram form, whose cancellation error (~eps_f32 * |w|^2, in
    both packages) dwarfs the CNN clients' pair distances, and its
    bisection compares scores with thresholds.  So each iteration's
    attacked rows are held against the JAX attack on the same stack and
    view within the bound that error gives (the bracket's top moved by
    sqrt of it, times the largest |u_i|), and the port then carries on from
    the JAX package's rows, so the rest of the iteration (channel, scores,
    median) is held within 1e-5."""
    seen = []

    def wrap(spec):
        def message(w, byz, gen, defense=None, **kw):
            got = spec.message_fn(w, byz, gen, defense=defense, **kw)
            jview = jattacks.DefenseView(
                step=jnp.asarray(defense.step.numpy()), ema=jnp.asarray(defense.ema.numpy()),
                dev=jnp.asarray(defense.dev.numpy()), cusum=jnp.asarray(defense.cusum.numpy()),
                rung=jnp.asarray(defense.rung.numpy()),
                detector=jdefense.DetectorParams(**dataclasses.asdict(defense.detector)),
                policy=jdefense.PolicyParams(**dataclasses.asdict(defense.policy)),
                guess=jnp.asarray(defense.guess.numpy()))
            want = np.asarray(jattacks.resolve("under_radar").apply_message(
                jnp.asarray(w.numpy()), byz, None, defense=jview))
            h = w[:-byz].double()
            sq = (h * h).sum(dim=1)
            pair = float((sq[:, None] + sq[None, :] - 2 * h @ h.T).max())
            err = 16 * 2.0**-24 * float(sq.max())
            bound = (np.sqrt(pair + err) - np.sqrt(max(pair - err, 0.0)) + 1e-5) * 1.01
            diff = float(np.abs(got.numpy() - want).max())
            seen.append((diff, bound))
            assert diff <= bound, (diff, bound)
            return torch.from_numpy(want.copy())
        return dataclasses.replace(spec, message_fn=message)

    kw = dict(model="CNN", fc_width=32, honest_size=8, byz_size=2, attack="under_radar",
              agg="median", noise_var=1e-2, defense="monitor", defense_warmup=1, batch_size=4,
              seed=11)
    jt = FedTrainer(JaxFedConfig(agg_impl="xla", **kw), dataset=crop8(mnist))
    tt = Trainer(FedConfig(**kw), dataset=crop8(mnist), device="cpu",
                 params=_t(jt.flat_params))
    tt.attack = wrap(tt.attack)
    carry, flat = jax_carry(jt), tt.flat_params
    for i in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(9), i)
        carry, outs = jt._iteration(carry, key, jt.x_train, jt.y_train, False)
        flat, _ = tt.iteration(flat, draws=jax_iteration_draws(tt.cfg, key, tt.dim))
        np.testing.assert_allclose(flat.numpy(), np.asarray(carry[0]), rtol=0, atol=1e-5)
        got, want = tt.iteration_defense_metrics.numpy(), np.asarray(outs[2])
        assert np.array_equal(got[:3], want[:3])
        np.testing.assert_allclose(got[3:], want[3:], rtol=1e-3, atol=1e-5)
    assert len(seen) == 3


@pytest.mark.parametrize("kw", [
    dict(agg="median", noise_var=1e-2, attack="signflip"),
    dict(agg="gm2", attack="classflip", agg_maxiter=30, bucket_size=2),
], ids=["median_var", "gm2_buckets"])
def test_monitor_is_bitwise_off(mnist, kw):
    """--defense monitor scores and tracks the rung; the params and every
    path of the record are bitwise those of --defense off."""
    base = dict(honest_size=8, byz_size=2, rounds=2, display_interval=3, batch_size=8,
                eval_train=False, **kw)
    off_t, off = tharness.run_with_trainer(FedConfig(**base), "cpu", record_in_file=False,
                                           dataset=mnist)
    mon_t, mon = tharness.run_with_trainer(FedConfig(defense="monitor", **base), "cpu",
                                           record_in_file=False, dataset=mnist)
    assert torch.equal(off_t.flat_params, mon_t.flat_params)
    for key in off:
        if key != "roundsPerSec":
            assert off[key] == mon[key], key
    assert set(mon) - set(off) == {"defense", "defenseLadder",
                                   *tdefense.events.PATH_KEYS.values()}
    assert len(mon["defenseRungPath"]) == 2 and max(mon["defenseScorePath"]) > 0


def test_round_vector_matches_jax_round(mnist):
    """One round of 6 iterations in each package: the [6] round vector
    (rung, flagged, suspicious, score, CUSUM, transitions)."""
    kw = dict(honest_size=8, byz_size=2, attack="signflip@1", agg="mean", defense="adaptive",
              defense_warmup=1, defense_up=1, display_interval=6, batch_size=8, seed=2)
    jt = FedTrainer(JaxFedConfig(agg_impl="xla", **kw), dataset=mnist)
    # the onset (iteration 6) three iterations in
    carry = list(jax_carry(jt))
    carry[5] = jnp.int32(3)
    out = jt._round_core(*carry, jax.random.PRNGKey(1), jt.x_train, jt.y_train)
    want = np.asarray(out[9])
    keys = jax.random.split(jax.random.PRNGKey(1), 6)
    tt = Trainer(FedConfig(**kw), dataset=mnist, device="cpu", params=_t(jt.flat_params))
    tt.attack_iter.fill_(3)
    rung_in, observed, flat = tt.defense_state[1][0], [], tt.flat_params
    for key in keys:
        flat, _ = tt.iteration(flat, draws=jax_iteration_draws(tt.cfg, key, tt.dim))
        observed.append(tt.iteration_defense_metrics)
    got = tdefense.events.reduce_round(rung_in, observed).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert got[0] >= 1 and got[5] >= 1
    assert tdefense.events.round_metrics(got)["transitions"] == float(got[5])
    assert tdefense.events.active_agg("adaptive", ("mean", "x"), 1, "mean") == "x"
    assert tdefense.events.active_agg("monitor", ("mean", "x"), 1, "mean") == "mean"


def test_record_and_log_carry_the_defense(tmp_path, mnist, capsys):
    cfg = FedConfig(honest_size=8, byz_size=2, attack="signflip", agg="mean",
                    defense="adaptive", defense_ladder="mean,median", rounds=2,
                    display_interval=4, batch_size=8, eval_train=False,
                    cache_dir=str(tmp_path))
    _, record = tharness.run_with_trainer(cfg, "cpu", dataset=mnist)
    assert record["defense"] == "adaptive" and record["defenseLadder"] == ["mean", "median"]
    for key in tdefense.events.PATH_KEYS.values():
        assert len(record[key]) == 2, key
    assert "rung=" in capsys.readouterr().out
    saved = load_record(tharness.cache_path(cfg, "mnist"))
    assert saved["defenseRungPath"] == record["defenseRungPath"]
    assert tharness.run_title(cfg).endswith("_defadaptive_defenseladdermean-median")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env["OMP_NUM_THREADS"] = "2"
    return env


@pytest.mark.parametrize("argv,title", [
    (["--agg", "gm2", "--attack", "classflip", "--local-steps", "2", "--server-opt", "adam",
      "--server-lr", "0.01"], "MLP_SGD_classflip_gm2_E2_adam0.01"),
    (["--agg", "mean", "--attack", "signflip@1", "--defense", "adaptive"],
     "MLP_SGD_signflip@1_mean_defadaptive"),
], ids=["fedadam", "defense_adaptive"])
def test_cli_cpu_run(tmp_path, argv, title):
    cmd = [sys.executable, "-m", "byzantine_aircomp_tpu_torch", "--device", "cpu", "--K", "8",
           "--B", "2", "--rounds", "2", "--interval", "2", "--no-eval-train",
           "--cache-dir", "recs"] + argv
    proc = subprocess.run(cmd, cwd=tmp_path, env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    record = load_record(str(tmp_path / "recs" / f"mnist_K8_B2_{title}"))
    assert len(record["valAccPath"]) == 3
    assert np.isfinite(record["valLossPath"]).all()


def test_run_x_escalates_before_the_onset_in_both_packages():
    """Run (x)'s config at its K=50 on the CPU, 14 iterations: benign
    clients already flag in the first round (the model moves fast in its
    first iterations), so the rung leaves 0 before the onset at iteration
    10, in the JAX package as in the port; the rung and the flagged count
    agree exactly at every iteration, the params within 1e-5."""
    ds = tdata.load("mnist", synthetic_train=3000, synthetic_val=100)
    kw = dict(honest_size=40, byz_size=10, attack="signflip@1", agg="mean",
              defense="adaptive", display_interval=10, seed=2021)
    jt = FedTrainer(JaxFedConfig(agg_impl="xla", **kw), dataset=ds)
    tt = Trainer(FedConfig(**kw), dataset=ds, device="cpu", params=_t(jt.flat_params))
    carry, flat, rungs = jax_carry(jt), tt.flat_params, []
    for i in range(14):
        key = jax.random.fold_in(jax.random.PRNGKey(9), i)
        carry, outs = jt._iteration(carry, key, jt.x_train, jt.y_train, False)
        flat, _ = tt.iteration(flat, draws=jax_iteration_draws(tt.cfg, key, tt.dim))
        np.testing.assert_allclose(flat.numpy(), np.asarray(carry[0]), rtol=0, atol=1e-5)
        assert int(tt.defense_state[1][0]) == int(carry[4][1][0])
        assert float(tt.iteration_defense_metrics[1]) == float(outs[2][1])
        rungs.append(int(tt.defense_state[1][0]))
    assert max(rungs[:10]) >= 1 and rungs[-1] == 2, rungs
