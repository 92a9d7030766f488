"""Service rounds of the port (``--service on``) against the JAX package on
the CPU: the stratified draw, the churn, the deadline, the masked honest
variance, the population-keyed detector, the degraded trimmed mean with a
device trim ratio, the per-id link (``channel.oma_by_id``), one whole
service iteration from the same params and draws, warm rollback, resume
under churn, checkpoints across the two packages, titles, hashes and the
CLI; and the pin of the default path (its params' SHA-256 after one round,
computed on the tree before service rounds were ported).

Inputs are made from numpy with a seed; where a JAX function draws, its
draws are made first from its key and handed to the port.  Tolerances:
the draw's ids, the churn, the deadline and the flags bitwise; the masked
variance 1e-6 relative; the detector rows 1e-6; the trimmed mean 1e-6; the
per-row link formula within 4 ULP of JAX's ``_oma_row`` (XLA may contract
a multiply-add into an FMA); one whole iteration's params within 1e-5 and
its variance 1e-4 relative (f32 sums in another order).
"""

import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantine_aircomp_tpu import cli as jcli
from byzantine_aircomp_tpu import defense as jdefense
from byzantine_aircomp_tpu.fed import checkpoint as jcheckpoint
from byzantine_aircomp_tpu.fed import harness as jharness
from byzantine_aircomp_tpu.fed.config import FedConfig as JaxFedConfig
from byzantine_aircomp_tpu.fed.train import FedTrainer
from byzantine_aircomp_tpu.ops import aggregators as jagg
from byzantine_aircomp_tpu.ops import channel as jchannel
from byzantine_aircomp_tpu.ops import faults as jfaults
from byzantine_aircomp_tpu_torch import cli as tcli
from byzantine_aircomp_tpu_torch import defense as tdefense
from byzantine_aircomp_tpu_torch.data import datasets as tdata
from byzantine_aircomp_tpu_torch.fed import checkpoint as tcheckpoint
from byzantine_aircomp_tpu_torch.fed import harness as tharness
from byzantine_aircomp_tpu_torch.fed.config import FedConfig
from byzantine_aircomp_tpu_torch.fed.train import (
    Trainer,
    detector_update_by_id,
    masked_honest_variance,
)
from byzantine_aircomp_tpu_torch.ops import aggregators as tagg
from byzantine_aircomp_tpu_torch.ops import channel as tchannel
from byzantine_aircomp_tpu_torch.ops import faults as tfaults

REPO = Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def mnist():
    return tdata.load("mnist", synthetic_train=600, synthetic_val=200)


def _kw(**kw):
    base = dict(honest_size=8, byz_size=0, rounds=2, display_interval=2, batch_size=16,
                agg="trimmed_mean", eval_train=False, service="on", population=24,
                churn_arrival=0.05, churn_departure=0.02, straggler_prob=0.2)
    base.update(kw)
    return base


# ---------------------------------------------------------------------------
# the pin of the default path

# one round of the default MLP config below, the final params' SHA-256 on one
# CPU thread, computed on the tree before service rounds and cohort
# streaming were ported
_PINNED_SHA256 = "7eb35e98c2be77d17a6b8b37f04b4615f3c2e36de8c890a7287ce7acd652fb26"
_PIN_SCRIPT = """
import hashlib
from byzantine_aircomp_tpu_torch.data import datasets as tdata
from byzantine_aircomp_tpu_torch.fed.config import FedConfig
from byzantine_aircomp_tpu_torch.fed.train import Trainer
ds = tdata.load("mnist", synthetic_train=600, synthetic_val=100)
cfg = FedConfig(honest_size=6, byz_size=2, agg="gm2", attack="classflip", rounds=1,
                display_interval=2, batch_size=8)
t = Trainer(cfg, dataset=ds, device="cpu")
t.run_round(0)
print(hashlib.sha256(t.flat_params.numpy().tobytes()).hexdigest())
"""


def test_a_default_run_is_bitwise_what_it_was():
    """K=8, gm2, classflip, service and cohorts off: one round gives the
    params it gave before the service streams and the rollback epoch
    existed.  Run in a child process on one thread, since a multithreaded
    CPU matmul may add in another order."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", _PIN_SCRIPT], env=env, cwd=str(REPO),
                         capture_output=True, text=True, timeout=300, check=True)
    assert out.stdout.split()[-1] == _PINNED_SHA256


def test_a_default_run_draws_from_the_same_seeds(mnist):
    cfg = FedConfig(honest_size=6, byz_size=2, agg="gm2", attack="classflip", rounds=1,
                    display_interval=2, batch_size=8)
    t = Trainer(cfg, dataset=mnist, device="cpu")
    gens = t.iteration_generators(3, 1)
    assert [g.initial_seed() for g in gens if isinstance(g, torch.Generator)] == [
        3005929481693809253, 8922864228796210280, 7667441458973261642, 7451517355184681311]
    assert gens.churn is None and gens.cohort is None and gens.link_key is None
    t._rollback_epoch = 1  # a rollback salts every seed
    assert not {g.initial_seed() for g in t.iteration_generators(3, 1)[:4]} & {
        3005929481693809253, 8922864228796210280, 7667441458973261642, 7451517355184681311}


# ---------------------------------------------------------------------------
# the service stages against JAX


@pytest.fixture(scope="module")
def pair(mnist):
    """A JAX FedTrainer and a port Trainer of one service config with
    Byzantine clients (population 48: 36 honest ids, 12 Byzantine)."""
    kw = _kw(honest_size=12, byz_size=4, population=48, attack="signflip")
    jt = FedTrainer(JaxFedConfig(agg_impl="xla", **kw), dataset=mnist)
    tt = Trainer(FedConfig(**kw), dataset=mnist, device="cpu", params=_t(jt.flat_params))
    return jt, tt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_service_draw_matches_jax(pair, seed):
    jt, tt = pair
    rng = np.random.default_rng(seed)
    avail = rng.random(48) < 0.7
    avail[36:46] = False  # a stratum short of available ids: topped up
    key = jax.random.PRNGKey(seed)
    ids_j, arrived_j = jt._service_draw(key, jnp.asarray(avail))
    kh, kb = jax.random.split(key)
    u = (_t(jax.random.uniform(kh, (36,))), _t(jax.random.uniform(kb, (12,))))
    ids_t, arrived_t = tt.service_draw(_t(avail), u=u)
    assert np.array_equal(ids_t.numpy(), np.asarray(ids_j))
    assert np.array_equal(arrived_t.numpy(), np.asarray(arrived_j))
    assert not arrived_t.all()


def test_churn_matches_jax(pair):
    _, tt = pair
    cfg = tt.cfg
    avail = np.random.default_rng(3).random(48) < 0.5
    k_arr, k_dep = jax.random.split(jax.random.PRNGKey(7))
    depart = jax.random.bernoulli(k_dep, cfg.churn_departure, (48,))
    arrive = jax.random.bernoulli(k_arr, cfg.churn_arrival, (48,))
    # the JAX trainer's churn step (fed/train.py:695-705)
    want = jnp.where(jnp.asarray(avail), ~depart, arrive)
    got = tt.churn(_t(avail), masks=(_t(arrive), _t(depart)))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("p", [0.0, 0.3])
def test_deadline_matches_jax(p):
    rng = np.random.default_rng(4)
    w = rng.normal(size=(16, 300)).astype(np.float32)
    arrived = rng.random(16) < 0.7
    key = jax.random.PRNGKey(11)
    w_j, absent_j, late_j = jfaults.apply_deadline(key, jnp.asarray(w), jnp.asarray(arrived), p)
    late = jax.random.bernoulli(key, p, (16,)) if p else None
    w_t, absent_t, late_t = tfaults.apply_deadline(
        _t(w), _t(arrived), p, late=None if late is None else _t(late))
    assert np.array_equal(w_t.numpy().view(np.int32), np.asarray(w_j).view(np.int32))
    assert (float(absent_t), float(late_t)) == (float(absent_j), float(late_j))


def test_masked_honest_variance_matches_jax():
    rng = np.random.default_rng(5)
    w = rng.normal(size=(12, 7850)).astype(np.float32)
    w[[2, 7]] = np.nan
    want = float(FedTrainer._masked_honest_variance(jnp.asarray(w)))
    got = float(masked_honest_variance(_t(w)))
    assert math.isfinite(got) and abs(got - want) <= 1e-6 * abs(want)


def test_population_keyed_detector_matches_jax():
    """The gather, the update under ``first = dev == 0`` and the scatter of
    the drawn ids' rows (JAX fed/train.py:879-909), over a few iterations
    of scores with NaN rows, on JAX's own scores."""
    p_j = jdefense.DetectorParams(warmup=2)
    p_t = tdefense.DetectorParams(warmup=2)
    rng = np.random.default_rng(6)
    det_j = jdefense.init_detector(48)
    det_t = tdefense.init_detector(48, "cpu")
    for step in range(6):
        ids = rng.choice(48, 16, replace=False)
        w = rng.normal(size=(16, 200)).astype(np.float32)
        w[-2:] += 3.0 * step
        w[rng.integers(16)] = np.nan
        guess = np.zeros(200, np.float32)
        score, finite = jdefense.client_scores(jnp.asarray(w), jnp.asarray(guess))
        step_j, ema, dev, cus = det_j
        ids_j = jnp.asarray(ids)
        (_, ema_r, dev_r, cus_r), flags_j = jdefense.detector_update(
            (step_j, ema[ids_j], dev[ids_j], cus[ids_j]), score, finite, p_j,
            first=dev[ids_j] == 0.0)
        det_j = (step_j + 1, ema.at[ids_j].set(ema_r), dev.at[ids_j].set(dev_r),
                 cus.at[ids_j].set(cus_r))
        rows, flags_t = detector_update_by_id(det_t, _t(score), _t(finite), _t(ids), p_t)
        det_t = (det_t[0] + 1,) + rows
        assert np.array_equal(flags_t.numpy(), np.asarray(flags_j))
        for a, b in zip(det_t[1:], det_j[1:]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    assert int(det_t[0]) == int(det_j[0]) == 6


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4])
def test_degraded_trimmed_mean_with_the_widened_trim(n):
    rng = np.random.default_rng(8 + n)
    w = rng.normal(size=(20, 500)).astype(np.float32)
    w[[1, 5, 9]] = np.nan
    widen = np.float32(1.5**n)
    want = jagg.trimmed_mean(jnp.asarray(w), degraded=True,
                             trim_ratio=jnp.minimum(jnp.float32(0.1) * widen, 0.45))
    ratio = torch.clamp(torch.tensor(0.1, dtype=torch.float32) * _t(widen), max=0.45)
    got = tagg.trimmed_mean(_t(w), degraded=True, trim_ratio=ratio)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the per-id link


def test_oma_by_id_same_id_same_terms_and_chunks_are_the_resident_rows():
    rng = np.random.default_rng(9)
    w = _t(rng.normal(size=(16, 7850)).astype(np.float32))
    ids = torch.tensor([3, 40, 7, 3, 11, 12, 0, 47, 5, 6, 8, 9, 20, 21, 22, 40])
    key = 0x1234_5678_9ABC
    terms = tchannel.oma_by_id_terms(key, ids, 7850, 1e-2)
    for i, j in ((0, 3), (1, 15)):  # one id at two stack positions
        for t in terms:
            assert torch.equal(t[i], t[j])
    full = tchannel.oma_by_id(w, ids, 1e-2, key=key)
    chunks = torch.cat([tchannel.oma_by_id(w[c:c + 4], ids[c:c + 4], 1e-2, key=key)
                        for c in range(0, 16, 4)])
    assert torch.equal(chunks, full)
    assert not torch.equal(tchannel.oma_by_id(w, ids, 1e-2, key=key + 1), full)
    # the draws are standard normals and N(0, 1/2) fades
    z = (terms.n_r / 0.1).flatten()
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1.0) < 0.01


def test_oma_by_id_row_physics_is_jax_oma_row():
    """On JAX's own per-row fades and noise (drawn as ``_oma_row`` draws
    them from ``fold_in(key, id)``), the port's residual is JAX's row."""
    rng = np.random.default_rng(10)
    d, noise_var = 7850, 1e-2
    w = rng.normal(size=(4, d)).astype(np.float32)
    ids = np.array([5, 0, 31, 7])
    key = jax.random.PRNGKey(12)
    want = np.asarray(jchannel.oma_by_id(key, jnp.asarray(w), jnp.asarray(ids), noise_var))
    parts = []
    for i in ids:
        key_h, key_nr, key_ni = jax.random.split(jax.random.fold_in(key, int(i)), 3)
        kr, ki = jax.random.split(key_h)
        std, scale = np.float32(1.0 / math.sqrt(2.0)), jnp.sqrt(jnp.float32(noise_var))
        parts.append((std * jax.random.normal(kr, ()), std * jax.random.normal(ki, ()),
                      scale * jax.random.normal(key_nr, (d,)),
                      scale * jax.random.normal(key_ni, (d,))))
    h_r, h_i = (_t(np.stack([p[j] for p in parts])) for j in (0, 1))
    n_r, n_i = (_t(np.stack([p[j] for p in parts])) for j in (2, 3))
    terms = tchannel.OmaTerms(h_r, h_i, tchannel.floored_hsq(h_r, h_i), n_r, n_i)
    got = tchannel.oma_by_id(_t(w), _t(ids), noise_var, terms=terms).numpy()
    ulp = np.spacing(np.maximum(np.abs(want), np.abs(got)))
    assert np.all(np.abs(got - want) <= 4 * ulp)
    # and the floor: a deep fade divides by HSQ_FLOOR
    assert float(tchannel.floored_hsq(torch.zeros(1), torch.zeros(1))) == np.float32(1e-6)


# ---------------------------------------------------------------------------
# one whole service iteration against JAX


def _service_draws(jt, key, cfg, avail, d):
    """The draws of JAX's service ``_iteration`` from its key, for the port:
    keys = split(key, 5); service key -> (churn, draw, deadline)."""
    keys = jax.random.split(key, 5)
    k_batch, k_chan = keys[0], keys[1]
    k_churn, k_draw, k_dead = jax.random.split(keys[4], 3)
    pop_h, pop_b = cfg.population_counts()
    kh, kb = jax.random.split(k_draw)
    k_arr, k_dep = jax.random.split(k_churn)
    k = cfg.node_size
    draws = {
        "u": _t(jax.random.uniform(k_batch, (k, cfg.local_steps * cfg.batch_size))),
        "service_u": (_t(jax.random.uniform(kh, (pop_h,))), _t(jax.random.uniform(kb, (pop_b,)))),
        "churn": (_t(jax.random.bernoulli(k_arr, cfg.churn_arrival, (cfg.population,))),
                  _t(jax.random.bernoulli(k_dep, cfg.churn_departure, (cfg.population,)))),
    }
    if cfg.straggler_prob:
        draws["late"] = _t(jax.random.bernoulli(k_dead, cfg.straggler_prob, (k,)))
    if cfg.noise_var is not None and cfg.agg not in ("gm", "signmv"):
        ids, _ = jt._service_draw(k_draw, jnp.asarray(avail))
        rows = [jax.random.split(jax.random.fold_in(k_chan, int(i)), 3) for i in ids]
        std, scale = np.float32(1.0 / math.sqrt(2.0)), jnp.sqrt(jnp.float32(cfg.noise_var))
        h = [jax.random.split(r[0]) for r in rows]
        h_r = _t(np.stack([std * jax.random.normal(a, ()) for a, _ in h]))
        h_i = _t(np.stack([std * jax.random.normal(b, ()) for _, b in h]))
        n_r = _t(np.stack([scale * jax.random.normal(r[1], (d,)) for r in rows]))
        n_i = _t(np.stack([scale * jax.random.normal(r[2], (d,)) for r in rows]))
        draws["oma"] = tchannel.OmaTerms(h_r, h_i, tchannel.floored_hsq(h_r, h_i), n_r, n_i)
    return draws


@pytest.mark.parametrize("kw", [
    dict(agg="gm2", noise_var=1e-2, attack="classflip", byz_size=4, honest_size=12,
         population=48),
    dict(agg="trimmed_mean", noise_var=1e-2, attack="signflip", byz_size=4, honest_size=12,
         population=48, defense="adaptive", defense_ladder="trimmed_mean,median,gm2",
         defense_warmup=1),
    dict(agg="mean", straggler_prob=0.0, churn_departure=0.3),
], ids=["gm2_var", "trimmed_mean_var_adaptive", "mean_churn"])
def test_service_iteration_matches_jax(mnist, kw):
    kw = _kw(**kw)
    jcfg = JaxFedConfig(agg_impl="xla", **kw)
    jt = FedTrainer(jcfg, dataset=mnist)
    cfg = FedConfig(**kw)
    tt = Trainer(cfg, dataset=mnist, device="cpu", params=_t(jt.flat_params))
    # a shared state: some ids offline, the trim widened twice
    avail = np.random.default_rng(13).random(cfg.population) < 0.75
    widen = np.float32(2.25)
    jt.service_state = (jnp.asarray(avail), jnp.float32(widen))
    tt.service_state = (_t(avail), _t(widen))
    carry = (jt.flat_params, jt.server_opt_state, jt.client_m, jt.fault_state,
             jt.defense_state, jt.attack_iter, jt.service_state)
    flat = tt.flat_params
    for it in range(2):
        key = jax.random.fold_in(jax.random.PRNGKey(1), it)
        draws = _service_draws(jt, key, cfg, np.asarray(carry[6][0]), tt.dim)
        carry, outs = jt._iteration(carry, key, jt.x_train, jt.y_train, True)
        flat, var = tt.iteration(flat, draws=draws, want_variance=True)
        np.testing.assert_allclose(flat.numpy(), np.asarray(carry[0]), rtol=0, atol=1e-5)
        want_var = float(outs[0])
        assert abs(float(var) - want_var) <= 1e-4 * abs(want_var)
        assert np.array_equal(tt.iteration_service_metrics.numpy(), np.asarray(outs[3]))
        assert np.array_equal(tt.service_state[0].numpy(), np.asarray(carry[6][0]))
        if cfg.defense != "off":
            got, want = tt.iteration_defense_metrics.numpy(), np.asarray(outs[2])
            assert np.array_equal(got[:3], want[:3])
            np.testing.assert_allclose(got[3:], want[3:], rtol=1e-4)
        # a deadline-missed row reached the rule in every iteration here
    assert float(tt.iteration_service_metrics[3]) <= cfg.node_size


# ---------------------------------------------------------------------------
# warm rollback


def _poison_after(round_done):
    def fn(r, trainer, paths):
        if r == round_done and not getattr(fn, "done", False):
            fn.done = True
            trainer.flat_params.mul_(math.nan)  # in place: the snapshot must not see it
    return fn


def test_rollback_fires_exactly_once(mnist):
    cfg = FedConfig(**_kw(rounds=4, rollback_max=2))
    t = Trainer(cfg, dataset=mnist, device="cpu")
    lines = []
    paths = t.train(log_fn=lines.append, checkpoint_fn=_poison_after(2))
    rollbacks = [line for line in lines if line.startswith("[rollback")]
    assert rollbacks == ["[rollback 1/2] round 3 diverged (non_finite); restored round 2, "
                         "trim widened x1.50"]
    assert t._rollbacks_done == 1 and t._rollback_epoch == 1
    assert float(t.service_state[1]) == 1.5
    for key in ("valLossPath", "trainLossPath", "variencePath", "serviceAvailPath",
                "effectiveKPath"):
        want = cfg.rounds + (1 if key in ("valLossPath", "trainLossPath") else 0)
        assert len(paths[key]) == want and np.isfinite(paths[key]).all(), key
    assert torch.isfinite(t.flat_params).all()


def test_rollback_off_keeps_the_divergence(mnist):
    t = Trainer(FedConfig(**_kw(rounds=3, rollback="off")), dataset=mnist, device="cpu")
    paths = t.train(checkpoint_fn=_poison_after(1))
    assert not np.isfinite(paths["valLossPath"]).all() and t._rollbacks_done == 0


def test_loss_spike_guard_trips_on_a_jump(mnist):
    cfg = FedConfig(**_kw(rounds=5, rollback_max=1))
    t = Trainer(cfg, dataset=mnist, device="cpu")
    assert t._divergence(1.0, 1.0, 0.1, []) is None
    assert t._divergence(1.0, math.inf, 0.1, []) == "non_finite"
    assert t._divergence(1.0, 3.2, 0.1, [1.0, 1.0, 1.0]) == "loss_spike"
    assert t._divergence(1.0, 2.9, 0.1, [1.0, 1.0, 1.0]) is None


# ---------------------------------------------------------------------------
# resume under churn, and checkpoints across the packages


def _resume_cfg(tmp_path, rounds, **kw):
    return FedConfig(**_kw(
        rounds=rounds, honest_size=6, population=18, agg="mean",
        defense="adaptive", defense_ladder="mean,trimmed_mean,median",
        checkpoint_dir=str(tmp_path / "ck"), cache_dir=str(tmp_path / "rec"), **kw))


def test_resume_under_churn_is_bitwise_the_straight_run(tmp_path, mnist):
    run = lambda cfg: tharness.run_with_trainer(  # noqa: E731
        cfg, device="cpu", record_in_file=False, dataset=mnist)
    t_full, full = run(_resume_cfg(tmp_path / "a", 4))
    run(_resume_cfg(tmp_path / "b", 2))
    t_res, res = run(dataclasses.replace(_resume_cfg(tmp_path / "b", 4), inherit=True))
    assert torch.equal(t_full.flat_params, t_res.flat_params)
    for key in full:
        if key.endswith("Path"):
            assert np.array_equal(full[key], res[key], equal_nan=True), key
        elif key != "roundsPerSec":
            assert full[key] == res[key], key
    assert torch.equal(t_full.service_state[0], t_res.service_state[0])


def _jax_kw(cfg):
    keep = ("honest_size", "byz_size", "agg", "attack", "display_interval", "batch_size",
            "seed", "service", "population", "churn_arrival", "churn_departure",
            "straggler_prob", "defense", "defense_ladder")
    return {k: getattr(cfg, k) for k in keep}


def test_service_checkpoints_cross_load_with_jax(tmp_path, mnist):
    cfg = _resume_cfg(tmp_path, 3)
    jcfg = JaxFedConfig(**_jax_kw(cfg))
    jt = FedTrainer(jcfg, dataset=mnist)
    t = Trainer(cfg, dataset=mnist, device="cpu")
    j_leaves = jax.tree.leaves(jharness.extra_state(jt, jcfg))
    t_leaves = tharness.extra_state(t)
    assert len(t_leaves) == len(j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        assert tuple(a.shape) == np.shape(b) and a.numpy().dtype == np.asarray(b).dtype

    # port -> JAX: a moved state (some ids offline, widened, epoch 2)
    t.service_state = (_t(np.random.default_rng(1).random(18) < 0.5), _t(np.float32(2.25)))
    t._rollback_epoch = t._rollbacks_done = 2
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    tcheckpoint.save(port_dir, "run", 2, t.flat_params, tharness.extra_state(t))
    restored = jcheckpoint.load(port_dir, "run")
    assert jharness.restore_trainer(jt, jcfg, restored, log_fn=_no_log) == 2
    assert jt._rollback_epoch == jt._rollbacks_done == 2
    for a, b in zip(jax.tree.leaves(jharness.extra_state(jt, jcfg)), tharness.extra_state(t)):
        assert np.array_equal(np.asarray(a), b.numpy())

    # JAX -> port, into a fresh trainer that then runs a round
    jcheckpoint.save(jax_dir, "run", 2, jt.flat_params,
                     jax.tree.leaves(jharness.extra_state(jt, jcfg)))
    fresh = Trainer(cfg, dataset=mnist, device="cpu")
    assert tharness.restore_trainer(fresh, tcheckpoint.load(jax_dir, "run"),
                                    log_fn=_no_log) == 2
    assert fresh._rollback_epoch == fresh._rollbacks_done == 2
    for a, b in zip(tharness.extra_state(fresh), tharness.extra_state(t)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    paths = fresh.train(start_round=2)
    assert len(paths["effectiveKPath"]) == 1 and np.isfinite(paths["valLossPath"]).all()


def _no_log(line):
    raise AssertionError(f"unexpected warning: {line}")


# ---------------------------------------------------------------------------
# validation, titles, hashes, record and CLI


@pytest.mark.parametrize("kw,match", [
    (dict(service="off", straggler_prob=0.0), "require --service on"),
    (dict(population=20), "multiple of node_size"),
    (dict(population=0), "multiple of node_size"),
    (dict(participation=0.5), "leave participation"),
    (dict(fault="dropout"), "subsumes fault injection"),
    (dict(bucket_size=2), "bucket-size 1"),
    (dict(client_momentum=0.5), "server_opt momentum"),
    (dict(churn_arrival=1.5), "per-iteration probabilities"),
    (dict(straggler_prob=1.0), "straggler_prob"),
    (dict(rollback_loss_factor=0.9), "rollback_loss_factor"),
    (dict(rollback="maybe"), "rollback must be"),
    (dict(rollback_cusum=2.0), "requires --defense"),
    (dict(rollback_widen=0.5), "rollback_widen"),
    (dict(rollback_max=0), "rollback_max"),
    (dict(service="sometimes"), "service must be"),
])
def test_validation_errors_match_jax(kw, match):
    for cls in (JaxFedConfig, FedConfig):
        with pytest.raises(ValueError, match=match):
            cls(**_kw(**kw)).validate()
    FedConfig(**_kw()).validate()


@pytest.mark.parametrize("kw", [
    dict(),
    dict(cohort_size=4),
    dict(straggler_prob=0.0, churn_arrival=0.02, churn_departure=0.01),
    dict(rollback="off", rollback_widen=2.0, rollback_max=5, cohort_size=2,
         cohort_quantile="sketch"),
])
def test_titles_match_jax(kw):
    assert tharness.run_title(FedConfig(**_kw(**kw))) == jharness.run_title(
        JaxFedConfig(**_kw(**kw)))


@pytest.mark.parametrize("kw,title,digest", [
    (dict(), "MLP_SGD_baseline_gm", "fb10ef9d"),
    (dict(agg="median", attack="signflip", byz_size=2, noise_var=1e-2),
     "MLP_SGD_signflip_median_0.01", "67b1a9e8"),
    (dict(agg="gm2", fault="chaos"), "MLP_SGD_baseline_gm2_faultchaos", "fc4cd417"),
])
def test_service_off_and_cohort_zero_keep_title_and_hash(kw, title, digest):
    """The digests of the tree before the fields were ported; setting any
    service or cohort field forks them."""
    cfg = FedConfig(**kw)
    assert (tharness.run_title(cfg), tharness.config_hash(cfg)) == (title, digest)
    for new in (dict(service="on", population=50), dict(cohort_size=5),
                dict(service="on", population=100, straggler_prob=0.1)):
        assert tharness.config_hash(dataclasses.replace(cfg, **new)) != digest, new


def test_record_and_log_carry_the_service(tmp_path, mnist, capsys):
    cfg = FedConfig(**_kw(rounds=1, cache_dir=str(tmp_path)))
    _, record = tharness.run_with_trainer(cfg, device="cpu", record_in_file=False,
                                          dataset=mnist)
    assert record["service"] == "on" and record["population"] == 24
    for key in ("serviceAvailPath", "serviceAbsentPath", "serviceLatePath", "effectiveKPath"):
        assert len(record[key]) == 1, key
    assert " avail=" in capsys.readouterr().out


_CLI_ARGV = ["--K", "16", "--B", "4", "--attack", "signflip", "--agg", "median",
             "--service", "on", "--population", "64", "--churn-arrival", "0.1",
             "--churn-departure", "0.05", "--straggler-prob", "0.2", "--rollback", "off",
             "--rollback-loss-factor", "4", "--rollback-widen", "2", "--rollback-max", "5",
             "--cohort-size", "4", "--cohort-quantile", "sketch", "--cohort-sketch-bins", "64"]


def test_cli_flags_parse_like_the_jax_cli():
    port = tcli.config_from_args(tcli.build_parser().parse_args(_CLI_ARGV))
    want = jcli.config_from_args(jcli.build_parser().parse_args(_CLI_ARGV), _CLI_ARGV)
    for field in ("honest_size", "byz_size", "cohort_size", "cohort_quantile",
                  "cohort_sketch_bins", "service") + FedConfig._SERVICE_KNOBS:
        assert getattr(port, field) == getattr(want, field), field
    assert port.validate() is port


def test_on_round_hook_can_force_the_rollback(mnist):
    """``harness.run_with_trainer(on_round=...)`` runs after every round; a
    hook that poisons the params gives exactly one rollback there too."""
    cfg = FedConfig(**_kw(rounds=3))
    seen = []

    def hook(r, trainer):
        seen.append(r)
        if r == 1 and seen.count(1) == 1:
            trainer.flat_params.mul_(math.nan)

    t, record = tharness.run_with_trainer(cfg, device="cpu", record_in_file=False,
                                          dataset=mnist, on_round=hook)
    assert seen == [1, 2, 3] and t._rollbacks_done == 1
    assert np.isfinite(record["valLossPath"]).all() and len(record["valLossPath"]) == 4
