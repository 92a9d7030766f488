"""The port's static attacks (``ops/attacks.py``) and their trainer surface
(the gradient scale, the delayed onset, ``--attack-param``) vs the JAX
package's, on the CPU.

Message attacks run on the same numpy stack through both packages:
signflip, ipm and gaussian (JAX's normals passed in) agree bitwise, alie
within 1e-6 (the population std of each column, rounded in another order).
ipm's row is the honest column mean times -eps; the mean is the f32 sum
times the f32 reciprocal of the count in both packages, but XLA and torch
sum the rows in orders of their own, so the bitwise case runs on a stack of
dyadic values whose column sums are exact in f32 in any order; on a random
stack the two agree within 1e-6 relative (a few ulp of a 40-row sum).
minmax and minsum agree within 1e-5 on stacks whose bisection predicates
have margins wider than the f32 rounding of the Gram-matrix distances: one
bisection step that branches the other way moves gamma by up to the
bracket's width at that step, ``hi/2^k`` at step k, far beyond any
tolerance while k is small.  So every step whose bracket is wider than the
tolerance must sit clear of its threshold, by 2e-6 relative (about 30
times the f32 rounding of the predicate's sums), and the test checks that
on the stack first, replaying the bisection in float64.
One iteration under gradascent and under signflip@1, before and after the
onset, agrees with the JAX ``FedTrainer`` from the same params and draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantine_aircomp_tpu.fed import harness as jharness
from byzantine_aircomp_tpu.fed.config import FedConfig as JaxFedConfig
from byzantine_aircomp_tpu.fed.train import FedTrainer
from byzantine_aircomp_tpu.ops import attacks as jattacks
from byzantine_aircomp_tpu_torch.data import datasets as tdata
from byzantine_aircomp_tpu_torch.fed import harness as tharness
from byzantine_aircomp_tpu_torch.fed.config import FedConfig
from byzantine_aircomp_tpu_torch.fed.train import Trainer
from byzantine_aircomp_tpu_torch.ops import attacks as tattacks
from byzantine_aircomp_tpu_torch.registry import ATTACKS

STATIC = ("signflip", "gradascent", "gaussian", "alie", "ipm", "minmax", "minsum")


def _t(a):
    return torch.from_numpy(np.array(a))


def _stack(seed, k=12, d=300, spread=0.01):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(d).astype(np.float32)
    return (base + spread * rng.standard_normal((k, d))).astype(np.float32)


def test_registered_static_attacks():
    for name in ("classflip", "dataflip", "weightflip") + STATIC:
        j, t = jattacks.resolve(name), tattacks.resolve(name)
        assert (t.name, t.grad_scale, t.param_name, t.onset_round) == (
            j.name, j.grad_scale, j.param_name, j.onset_round), name
        assert (t.data_fn is None, t.message_fn is None) == (
            j.data_fn is None, j.message_fn is None), name
    assert set(ATTACKS.names()) == {"classflip", "dataflip", "weightflip", *STATIC}


@pytest.mark.parametrize("name,param", [
    ("signflip", None), ("ipm", None), ("ipm", 0.8), ("gaussian", None), ("gaussian", 0.3),
])
def test_bitwise_message_attacks_match_jax(name, param):
    # multiples of 2^-12 below 2^4: every partial sum of 12 rows is exact
    w = (np.round(_stack(1) * 4096) / 4096).astype(np.float32)
    b = 3
    key = jax.random.PRNGKey(7)
    want = np.asarray(jattacks.resolve(name).apply_message(jnp.asarray(w), b, key, param=param))
    noise = None
    if name == "gaussian":
        # the JAX function's own draw: normal(key, [B, d])
        noise = _t(jax.random.normal(key, (b, w.shape[1]), dtype=jnp.float32))
    got = tattacks.resolve(name).apply_message(_t(w), b, None, param=param, noise=noise)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    assert np.array_equal(got.numpy()[:-b], w[:-b])  # honest rows untouched


def test_ipm_on_a_random_stack_within_f32_sum_rounding_of_jax():
    w = _stack(9, k=50, d=2000)
    want = np.asarray(jattacks.resolve("ipm").apply_message(jnp.asarray(w), 10, None))
    got = tattacks.resolve("ipm").apply_message(_t(w), 10, None).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_gaussian_draws_from_the_message_generator():
    w = _t(_stack(2))
    g = torch.Generator().manual_seed(5)
    got = tattacks.resolve("gaussian").apply_message(w, 4, g, param=2.0)
    noise = torch.randn((4, w.shape[1]), generator=torch.Generator().manual_seed(5))
    assert torch.equal(got[-4:], 2.0 * noise)


@pytest.mark.parametrize("param", [None, 0.5, 3.0])
def test_alie_matches_jax(param):
    w = _stack(3)
    want = np.asarray(jattacks.resolve("alie").apply_message(jnp.asarray(w), 4, None, param=param))
    got = tattacks.resolve("alie").apply_message(_t(w), 4, None, param=param).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the population std (divide by n), not torch's default n-1
    h = w[:-4]
    np.testing.assert_allclose(got[-1], h.mean(0) - (1.5 if param is None else param)
                               * h.std(0), rtol=0, atol=1e-6)


def _bisection_margins(honest, pred):
    """(relative margin of the predicate from its threshold, bracket
    width) of every bisection step, replayed in float64."""
    h = honest.astype(np.float64)
    mu = h.mean(0)
    p = -mu / max(np.linalg.norm(mu), 1e-12)
    pair = ((h[:, None, :] - h[None, :, :]) ** 2).sum(-1)
    hi = np.sqrt(pair.max()) + np.linalg.norm(h - mu, axis=1).max() + 1.0
    lo, steps = 0.0, []
    for _ in range(tattacks.AGR_STEPS):
        mid = 0.5 * (lo + hi)
        d = ((h - (mu + mid * p)) ** 2).sum(1)
        lhs, rhs = (d.max(), pair.max()) if pred == "minmax" else (d.sum(), pair.sum(1).max())
        steps.append((abs(lhs - rhs) / rhs, hi - lo))
        lo, hi = (mid, hi) if lhs <= rhs else (lo, mid)
    return np.array(steps)


@pytest.mark.parametrize("name", ["minmax", "minsum"])
@pytest.mark.parametrize("seed", [14, 22])
def test_agr_attacks_match_jax(name, seed):
    w = (0.1 * np.random.default_rng(seed).standard_normal((10, 200))).astype(np.float32)
    b = 2
    margin, width = _bisection_margins(w[:-b], name).T
    assert np.all(margin[width > 1e-5] > 2e-6)
    want = np.asarray(jattacks.resolve(name).apply_message(jnp.asarray(w), b, None))
    got = tattacks.resolve(name).apply_message(_t(w), b, None).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert not np.allclose(got[-1], w[:-b].mean(0), atol=1e-3)  # gamma > 0


@pytest.mark.parametrize("name", ["minmax", "minsum"])
def test_agr_fixed_gamma_matches_jax(name):
    w = _stack(6)
    want = np.asarray(jattacks.resolve(name).apply_message(jnp.asarray(w), 3, None, param=0.7))
    got = tattacks.resolve(name).apply_message(_t(w), 3, None, param=0.7).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_pairwise_sq_dists_matches_jax():
    # the Gram form cancels: each distance carries the f32 rounding of the
    # squared norms (about 50 here), so the bound is absolute, 1e-4
    h = _stack(8, k=9, d=50, spread=0.2)
    got = tattacks.pairwise_sq_dists(_t(h)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jattacks._pairwise_sq_dists(jnp.asarray(h))), rtol=0, atol=1e-4)
    exact = ((h[:, None].astype(np.float64) - h[None]) ** 2).sum(-1)
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-4)


@pytest.mark.parametrize("spelled", ["signflip@0", "alie@3", "gradascent@12"])
def test_onset_spelling_parses_like_jax(spelled):
    j, t = jattacks.resolve(spelled), tattacks.resolve(spelled)
    assert (t.name, t.onset_round, t.param_name, t.grad_scale) == (
        j.name, j.onset_round, j.param_name, j.grad_scale)


@pytest.mark.parametrize("spelled,exc,match", [
    ("signflip@x", ValueError, "integer round"),
    ("signflip@-1", ValueError, ">= 0"),
    ("signflip@", ValueError, "integer round"),
    ("nosuch@2", KeyError, "unknown attack"),
])
def test_onset_spelling_errors_like_jax(spelled, exc, match):
    with pytest.raises(exc, match=match):
        jattacks.resolve(spelled)
    with pytest.raises(exc, match=match):
        tattacks.resolve(spelled)
    with pytest.raises(exc, match=match):
        FedConfig(attack=spelled, byz_size=1).validate()


@pytest.mark.parametrize("name", ["signflip", "classflip", "gradascent", "weightflip"])
def test_attack_param_on_a_knobless_attack_raises(name):
    with pytest.raises(ValueError, match="takes no scalar parameter"):
        jattacks.resolve(name).apply_message(jnp.zeros((4, 3)), 1, None, param=1.0)
    with pytest.raises(ValueError, match="takes no scalar parameter"):
        tattacks.resolve(name).apply_message(torch.zeros((4, 3)), 1, None, param=1.0)
    with pytest.raises(ValueError, match="takes no scalar parameter"):
        FedConfig(attack=name, byz_size=1, attack_param=1.0).validate()
    with pytest.raises(ValueError, match="takes no scalar parameter"):
        FedConfig(attack=None, attack_param=1.0).validate()


@pytest.mark.parametrize("kw", [
    dict(attack="alie", attack_param=2.0),
    dict(attack="gaussian", attack_param=0.1, noise_var=1e-2, agg="median"),
    dict(attack="minsum@3", attack_param=1.5),
    dict(attack="signflip@2", agg="gm2"),
])
def test_run_title_with_attack_param_matches_jax(kw):
    kw = dict(honest_size=8, byz_size=2, **kw)
    title = tharness.run_title(FedConfig(**kw))
    assert title == jharness.run_title(JaxFedConfig(**kw))
    assert ("_ap" in title) == ("attack_param" in kw)


# ---------------------------------------------------------------------------
# one trainer iteration against the JAX FedTrainer


def _one_iteration(kw, attack_iter=None):
    """New params of one iteration from the same params and key-derived
    draws (batch uniforms, and the gaussian attack's normals from the
    message key), the JAX trainer's and the port's; ``attack_iter`` sets
    the onset counter on both sides."""
    ds = tdata.load("mnist", synthetic_train=600, synthetic_val=100)
    jt = FedTrainer(JaxFedConfig(agg_impl="xla", **kw), dataset=ds)
    cfg = FedConfig(**kw)
    tt = Trainer(cfg, dataset=ds, device="cpu", params=_t(jt.flat_params))
    k = cfg.node_size
    key = jax.random.fold_in(jax.random.PRNGKey(0), 4)
    k_batch, _, _, k_msg = jax.random.split(key, 4)
    draws = {"u": _t(jax.random.uniform(k_batch, (k, cfg.batch_size), dtype=jnp.float32))}
    if cfg.attack == "gaussian":
        draws["message"] = _t(jax.random.normal(k_msg, (cfg.byz_size, tt.dim), jnp.float32))
    j_iter = jt.attack_iter
    if attack_iter is not None:
        j_iter = jnp.int32(attack_iter)
        tt.attack_iter = torch.tensor(attack_iter, dtype=torch.int32)
    carry = (jt.flat_params, jt.server_opt_state, jt.client_m, jt.fault_state,
             jt.defense_state, j_iter, jt.service_state)
    carry_out, _ = jt._iteration(carry, key, jt.x_train, jt.y_train, True)
    new_port, _ = tt.iteration(tt.flat_params, draws=draws, want_variance=True)
    if attack_iter is not None:
        assert int(carry_out[5]) == int(tt.attack_iter) == attack_iter + 1
    return np.asarray(carry_out[0]), new_port.numpy(), tt


_BASE = dict(honest_size=6, byz_size=2, batch_size=8, agg="mean", seed=11, display_interval=3)


@pytest.mark.parametrize("attack,attack_iter", [
    ("gradascent", None),
    ("gaussian", None),
    ("minmax", None),
    ("signflip@1", 2),   # before the onset (iteration 3)
    ("signflip@1", 3),   # at it
    ("gradascent@1", 2),
    ("gradascent@1", 5),
])
def test_one_iteration_matches_jax(attack, attack_iter):
    new_jax, new_port, _ = _one_iteration(dict(_BASE, attack=attack), attack_iter)
    np.testing.assert_allclose(new_port, new_jax, rtol=0, atol=1e-6)


@pytest.mark.parametrize("attack", ["signflip@1", "gradascent@1", "classflip@1"])
def test_before_onset_the_byzantine_rows_are_honest(attack):
    """Before the onset every Byzantine row is bitwise what the same
    client sends with no attack set; from the onset on, it differs."""
    ds = tdata.load("mnist", synthetic_train=600, synthetic_val=100)
    rows = {}
    for name, it in ((None, 0), (attack, 0), (attack, 3)):
        kw = dict(_BASE, attack=name) if name else dict(_BASE, attack="classflip")
        tt = Trainer(FedConfig(**kw), dataset=ds, device="cpu")
        if name is None:
            tt.attack = None  # the same clients, no attack at all
        elif it:
            tt.attack_iter = torch.tensor(it, dtype=torch.int32)
        captured, agg = {}, tt.agg_fn

        def capture(w, **k):
            captured["w"] = w.clone()
            return agg(w, **k)

        tt.agg_fn = capture
        tt.iteration(tt.flat_params, tt.iteration_generators(0, 0))
        rows[(name, it)] = captured["w"]
    assert torch.equal(rows[(attack, 0)], rows[(None, 0)])
    assert not torch.equal(rows[(attack, 3)][-2:], rows[(None, 0)][-2:])
    assert torch.equal(rows[(attack, 3)][:-2], rows[(None, 0)][:-2])


def test_onset_counter_counts_global_iterations():
    ds = tdata.load("mnist", synthetic_train=600, synthetic_val=100)
    tt = Trainer(FedConfig(**dict(_BASE, attack="signflip@2", rounds=2)), dataset=ds,
                 device="cpu")
    assert tt._attack_onset == 6 and int(tt.attack_iter) == 0
    tt.train()
    assert tt.attack_iter.dtype == torch.int32 and int(tt.attack_iter) == 6
    assert Trainer(FedConfig(**dict(_BASE, attack="signflip")), dataset=ds,
                   device="cpu").attack_iter is None
