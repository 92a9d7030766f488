"""The training options of the port against the JAX package on the CPU:
local steps (FedAvg) and FedProx, client momentum, partial participation,
bucketing and the server optimizers (FedAvgM, FedAdam), each from the same
numpy inputs made from a seed, at small widths (the MNIST MLP, d = 7,850;
the CNN at fc 32 on 8x8 crops, d = 60,650).

Tolerances: the local steps within 1e-5 relative (max |diff| over max
|value|), one local step without FedProx bitwise the single-step formula;
the momentum steps 1e-5; the participant counts exactly; the bucket means
1e-6; the server optimizers 1e-6 against optax with the state leaves in
optax's order; one whole iteration per new config, with the draws derived
from the JAX iteration key, within 1e-5 (the params) and 1e-4 relative
(the honest variance); checkpoints of the new state load across the two
packages bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from byzantine_aircomp_tpu import cli as jcli
from byzantine_aircomp_tpu.fed import checkpoint as jcheckpoint
from byzantine_aircomp_tpu.fed import harness as jharness
from byzantine_aircomp_tpu.fed.config import FedConfig as JaxFedConfig
from byzantine_aircomp_tpu.fed.train import FedTrainer
from byzantine_aircomp_tpu.ops import channel as jchannel
from byzantine_aircomp_tpu_torch import cli as tcli
from byzantine_aircomp_tpu_torch.data import datasets as tdata
from byzantine_aircomp_tpu_torch.fed import checkpoint as tcheckpoint
from byzantine_aircomp_tpu_torch.fed import harness as tharness
from byzantine_aircomp_tpu_torch.fed import server_opt
from byzantine_aircomp_tpu_torch.fed.config import FedConfig
from byzantine_aircomp_tpu_torch.fed import train as train_lib
from byzantine_aircomp_tpu_torch.fed.train import Trainer, bucket_means
from byzantine_aircomp_tpu_torch.ops import channel as tchannel


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


@pytest.fixture(scope="module")
def mnist():
    return tdata.load("mnist", synthetic_train=600, synthetic_val=100)


def crop8(ds):
    """``ds`` cut to its central 8x8 pixels: a CNN at a small width."""
    cut = lambda a: np.ascontiguousarray(a[:, 10:18, 10:18])  # noqa: E731
    return dataclasses.replace(ds, x_train=cut(ds.x_train), x_val=cut(ds.x_val),
                               x_train_raw=cut(ds.x_train_raw))


def _pair(ds, **kw):
    """A JAX FedTrainer (XLA aggregation) and a port Trainer of the same
    config, the port starting from the JAX params."""
    jt = FedTrainer(JaxFedConfig(agg_impl="xla", **kw), dataset=ds)
    tt = Trainer(FedConfig(**kw), dataset=ds, device="cpu", params=_t(jt.flat_params))
    return jt, tt


def _client_batches(tt, seed, m, steps, b):
    """[m, E, B, ...] normalized inputs and [m, E, B] labels from the
    trainer's train set, at indices drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, tt.x_train.shape[0], (m, steps * b)))
    x = tt.x_train[idx].float() * tt._norm_scale + tt._norm_bias
    x = x.reshape((m, steps, b) + tt._sample_shape)
    return x, tt.y_train[idx].reshape(m, steps, b)


@pytest.mark.parametrize("attack", ["classflip", "gradascent"])
@pytest.mark.parametrize("mu", [0.0, 0.05])
def test_local_steps_match_jax_per_client_weights(mnist, attack, mu):
    jt, tt = _pair(mnist, honest_size=3, byz_size=1, attack=attack, local_steps=3,
                   fedprox_mu=mu, weight_decay=1e-3, gamma=0.05, agg="mean")
    x, y = _client_batches(tt, 1, 4, 3, 8)
    want = jax.vmap(jt._per_client_weights, in_axes=(None, 0, 0, 0))(
        jt.flat_params, jnp.asarray(x.numpy()), jnp.asarray(y.numpy()), jt.byz_mask)
    got = tt.client_stack(tt.flat_params, x, y, tt.byz_mask)
    assert got.shape == (4, tt.dim)
    assert _rel(got.numpy(), want) <= 1e-5
    # three steps moved further than one
    assert np.abs(np.asarray(want) - np.asarray(jt.flat_params)).max() > 0


@pytest.mark.parametrize("mu", [0.0, 0.05])
def test_one_local_step_is_the_single_step_formula(mnist, mu):
    """E = 1 without FedProx is bitwise ``w - gamma*(g + wd*w)`` from the
    per-client gradients (the single-step trainer); with FedProx, whose term
    is 0 at one step, it matches the JAX package's one-step scan."""
    jt, tt = _pair(mnist, honest_size=3, byz_size=1, attack="gradascent", fedprox_mu=mu,
                   weight_decay=1e-3, agg="mean")
    x, y = _client_batches(tt, 2, 4, 1, 8)
    got = tt.client_stack(tt.flat_params, x[:, 0], y[:, 0], tt.byz_mask)
    g = tt._per_client_grad(tt.flat_params, x[:, 0], y[:, 0])
    g = g * torch.where(tt.byz_mask, -1.0, 1.0)[:, None]
    single = tt.flat_params - 1e-2 * (g + 1e-3 * tt.flat_params)
    if not mu:
        assert torch.equal(got, single)
    want = jax.vmap(jt._per_client_weights, in_axes=(None, 0, 0, 0))(
        jt.flat_params, jnp.asarray(x.numpy()), jnp.asarray(y.numpy()), jt.byz_mask)
    assert _rel(got.numpy(), want) <= 1e-5


def test_local_steps_on_the_cnn_match_jax(mnist):
    """Each client carries its own CNN params past the first step."""
    ds = crop8(mnist)
    jt, tt = _pair(ds, model="CNN", fc_width=32, honest_size=2, byz_size=1,
                   attack="classflip", local_steps=2, fedprox_mu=0.01, agg="gm2")
    assert tt.dim == 60650
    x, y = _client_batches(tt, 3, 3, 2, 4)
    want = jax.vmap(jt._per_client_weights, in_axes=(None, 0, 0, 0))(
        jt.flat_params, jnp.asarray(x.numpy()), jnp.asarray(y.numpy()), jt.byz_mask)
    got = tt.client_stack(tt.flat_params, x, y, tt.byz_mask)
    assert _rel(got.numpy(), want) <= 1e-5


def test_client_momentum_matches_jax_over_4_iterations(mnist):
    jt, tt = _pair(mnist, honest_size=3, byz_size=1, attack="gradascent",
                   client_momentum=0.9, weight_decay=1e-3, agg="mean")
    m_jax = jnp.zeros((4, tt.dim), jnp.float32)
    m_port = torch.zeros(4, tt.dim)
    step = jax.vmap(jt._per_client_momentum_step, in_axes=(None, 0, 0, 0, 0))
    for i in range(4):
        x, y = _client_batches(tt, 10 + i, 4, 1, 8)
        w_jax, m_jax = step(jt.flat_params, jnp.asarray(x.numpy()),
                            jnp.asarray(y.numpy()), jt.byz_mask, m_jax)
        w_port, m_port = tt.client_stack_momentum(tt.flat_params, x[:, 0], y[:, 0],
                                                  tt.byz_mask, m_port)
        np.testing.assert_allclose(w_port.numpy(), w_jax, rtol=0, atol=1e-5)
        np.testing.assert_allclose(m_port.numpy(), m_jax, rtol=0, atol=1e-5)
    assert float(np.abs(np.asarray(m_jax)).max()) > 0


def test_participant_counts_match_jax_on_a_grid():
    fracs = (0.05, 0.1, 0.25, 0.29, 0.3, 1 / 3, 0.5, 0.7, 0.75, 0.9, 0.99, 1.0)
    ties = 0
    for h in range(1, 41):
        for b in (0, 1, 2, 3, 5, 10, 13):
            for f in fracs:
                kw = dict(honest_size=h, byz_size=b, participation=f)
                want = JaxFedConfig(**kw).participant_counts()
                assert FedConfig(**kw).participant_counts() == want, kw
                ties += (f * h) % 1 == 0.5
    assert ties > 20  # the .5 ties are on the grid
    # the guards: 0.29 * 100 = 28.999999999999996 floors to 29
    assert FedConfig(honest_size=100, byz_size=100, participation=0.29).participant_counts() \
        == (29, 29)


def test_bucket_means_match_jax_segment_sum():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((12, 50)).astype(np.float32)
    w[5, 7] = np.nan
    for s in (2, 3, 4):
        perm = rng.permutation(12)
        ids = jnp.zeros(12, jnp.int32).at[jnp.asarray(perm)].set(
            jnp.arange(12, dtype=jnp.int32) // s)
        want = np.asarray(jax.ops.segment_sum(jnp.asarray(w), ids, num_segments=12 // s) / s)
        got = bucket_means(torch.from_numpy(w), torch.from_numpy(perm), s).numpy()
        assert np.array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(got).any(axis=1).sum() == 1  # the NaN row poisons its bucket only
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["momentum", "adam"])
def test_server_optimizers_match_optax_over_5_steps(kind):
    rng = np.random.default_rng(6)
    flat = rng.standard_normal(300).astype(np.float32)
    tx = (optax.sgd(0.5, momentum=0.9) if kind == "momentum" else optax.adam(0.01))
    j_flat, j_state = jnp.asarray(flat), tx.init(jnp.asarray(flat))
    t_flat = torch.from_numpy(flat.copy())
    t_state = server_opt.init(kind, t_flat)
    assert [tuple(x.shape) for x in t_state] == [np.shape(x) for x in jax.tree.leaves(j_state)]
    for i in range(5):
        agg = (flat - 0.1 * (i + 1) * rng.standard_normal(300)).astype(np.float32)
        updates, j_state = tx.update(j_flat - jnp.asarray(agg), j_state, j_flat)
        j_flat = optax.apply_updates(j_flat, updates)
        t_flat, t_state = server_opt.step(kind, t_flat, torch.from_numpy(agg), t_state,
                                          0.5 if kind == "momentum" else 0.01, 0.9)
        np.testing.assert_allclose(t_flat.numpy(), j_flat, rtol=0, atol=1e-6)
        leaves = jax.tree.leaves(j_state)
        assert len(leaves) == len(t_state)
        for got, want in zip(t_state, leaves):
            assert got.numpy().dtype == np.asarray(want).dtype
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    if kind == "adam":
        assert int(t_state[0]) == 5


def jax_iteration_draws(cfg, key, d):
    """The draws of one JAX iteration from its key, for the port: the key
    splits into 4 + (participation, bucketing, fault) keys (JAX
    ``fed/train.py:645-680``)."""
    m_h, m_b = cfg.participant_counts()
    m = m_h + m_b
    n_extra = int(cfg.participation < 1.0) + int(cfg.bucket_size > 1) + int(
        cfg.fault is not None)
    keys = jax.random.split(key, 4 + n_extra)
    k_batch, k_chan = keys[0], keys[1]
    nxt, draws = 4, {}
    if cfg.participation < 1.0:
        kh, kb = jax.random.split(keys[nxt])
        nxt += 1
        part = jax.random.permutation(kh, cfg.honest_size)[:m_h]
        if m_b:
            part = jnp.concatenate(
                [part, cfg.honest_size + jax.random.permutation(kb, cfg.byz_size)[:m_b]])
        draws["part"] = _t(part).long()
    if cfg.bucket_size > 1:
        draws["bucket"] = _t(jax.random.permutation(keys[nxt], m)).long()
        nxt += 1
    draws["u"] = _t(jax.random.uniform(k_batch, (m, cfg.local_steps * cfg.batch_size),
                                       dtype=jnp.float32))
    if cfg.noise_var is not None and cfg.agg not in ("gm", "signmv"):
        draws["oma"] = tchannel.OmaTerms(
            *(_t(a) for a in jchannel.oma_terms(k_chan, m, d, cfg.noise_var)))
    return draws


def jax_carry(jt):
    return (jt.flat_params, jt.server_opt_state, jt.client_m, jt.fault_state,
            jt.defense_state, jt.attack_iter, jt.service_state)


class _DeltaTap:
    """Records the pseudo-gradient each package hands its server optimizer:
    the JAX trainer's ``_server_tx.update`` and the port's
    ``server_opt.step`` (through ``monkeypatch``)."""

    def __init__(self, jt, monkeypatch):
        self.jax, self.port = [], []
        tx, tap = jt._server_tx, self

        class Tx:
            def update(self, delta, state, params):
                tap.jax.append(np.asarray(delta))
                return tx.update(delta, state, params)

        jt._server_tx = Tx()
        step = server_opt.step

        def port_step(kind, flat, aggregated, state, lr, momentum):
            tap.port.append((flat - aggregated).numpy())
            return step(kind, flat, aggregated, state, lr, momentum)

        monkeypatch.setattr(train_lib.server_opt_lib, "step", port_step)


def iterations_against_jax(ds, kw, n=2, atol=1e-5, monkeypatch=None):
    """``n`` chained iterations of both trainers from the same params and
    key-derived draws; the params (and the carried state) held each
    iteration.  Returns the two trainers and the JAX carry.

    With ``monkeypatch`` (for Adam) a :class:`_DeltaTap` is set, and the
    pseudo-gradients are
    held within ``atol`` instead of the params everywhere: Adam's first
    steps send each coordinate about ``-lr * sign(delta)``, so where the
    aggregate sits within float rounding of the params the two packages'
    last-bit differences flip the step's sign (a 2*lr difference, not a
    port fault).  There the port's optimizer on the JAX package's
    pseudo-gradient must give the JAX params within 1e-6, and the port's
    own params must match wherever |delta| > 1e-4."""
    jt, tt = _pair(ds, **kw)
    tap = None if monkeypatch is None else _DeltaTap(jt, monkeypatch)
    cfg = tt.cfg
    carry = jax_carry(jt)
    flat = tt.flat_params
    for i in range(n):
        key = jax.random.fold_in(jax.random.PRNGKey(3), i)
        jax_opt_before = carry[1]
        prev = flat
        carry, outs = jt._iteration(carry, key, jt.x_train, jt.y_train, True)
        flat, var = tt.iteration(flat, draws=jax_iteration_draws(cfg, key, tt.dim),
                                 want_variance=True)
        new_jax = np.asarray(carry[0])
        assert np.isfinite(flat.numpy()).all()
        np.testing.assert_allclose(float(var), float(outs[0]), rtol=1e-4)
        if tap is None:
            np.testing.assert_allclose(flat.numpy(), new_jax, rtol=0, atol=atol)
        else:
            delta_jax, delta_port = tap.jax[-1], tap.port[-1]
            np.testing.assert_allclose(delta_port, delta_jax, rtol=0, atol=atol)
            state = tuple(_t(x) for x in jax.tree.leaves(jax_opt_before))
            upd, state = server_opt.update(cfg.server_opt, _t(delta_jax), state,
                                           cfg.server_lr, cfg.server_momentum)
            replay = prev + upd
            np.testing.assert_allclose(replay.numpy(), new_jax, rtol=0, atol=1e-6)
            for got, want in zip(state, jax.tree.leaves(carry[1])):
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
            sure = np.abs(delta_jax) > 1e-4
            assert sure.mean() > 0.25  # the check covers a good share
            np.testing.assert_allclose(flat.numpy()[sure], new_jax[sure], rtol=0, atol=atol)
            # the next iteration starts where JAX's did
            flat, tt.server_opt_state = replay, state
        if tt.server_opt_state is not None and tap is None:
            for got, want in zip(tt.server_opt_state, jax.tree.leaves(carry[1])):
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
        if tt.client_m is not None:
            np.testing.assert_allclose(tt.client_m.numpy(), carry[2], rtol=0, atol=1e-5)
    assert not np.allclose(np.asarray(carry[0]), np.asarray(jt.flat_params))  # it moved
    return jt, tt, carry


def test_iteration_fedavg_prox_adam_gm2_cnn_matches_jax(mnist, monkeypatch):
    """Run (u)'s config at a small width: the CNN (fc 32, 8x8), gm2,
    classflip, 5 local steps, FedProx 0.01, server Adam 0.01, over 2
    iterations (see :func:`iterations_against_jax` on Adam's sign)."""
    iterations_against_jax(crop8(mnist), dict(
        model="CNN", fc_width=32, honest_size=3, byz_size=1, attack="classflip",
        agg="gm2", agg_maxiter=30, batch_size=4, local_steps=5, fedprox_mu=0.01,
        server_opt="adam", server_lr=0.01, seed=11), monkeypatch=monkeypatch)


def test_iteration_participation_bucketing_median_var_matches_jax(mnist):
    """Run (v)'s config at a small K: median --var, signflip, participation
    0.5 of 12 + 4 (6 + 2 drawn), buckets of 2 (4 means, honest size 2)."""
    jt, tt, _ = iterations_against_jax(mnist, dict(
        honest_size=12, byz_size=4, attack="signflip", agg="median", noise_var=1e-2,
        participation=0.5, bucket_size=2, batch_size=8, seed=11))
    assert (tt._part_h, tt._part_b) == (6, 2)


def test_iteration_client_momentum_cclip_alie_matches_jax(mnist):
    """Run (w)'s config: cclip against alie, client momentum 0.9 and
    FedAvgM, over 3 iterations (the momentum buffer carried)."""
    iterations_against_jax(mnist, dict(
        honest_size=8, byz_size=2, attack="alie", agg="cclip", client_momentum=0.9,
        server_opt="momentum", batch_size=8, seed=11), n=3)


def test_iteration_momentum_under_participation_writes_back_the_drawn_rows(mnist):
    jt, tt, carry = iterations_against_jax(mnist, dict(
        honest_size=8, byz_size=2, attack="signflip", agg="trimmed_mean",
        client_momentum=0.5, participation=0.5, batch_size=8, seed=5), n=3)
    rows_moved = (tt.client_m.abs().sum(dim=1) > 0).sum()
    assert 5 <= int(rows_moved) < 10


@pytest.mark.parametrize("kw", [
    dict(local_steps=5, fedprox_mu=0.01, server_opt="adam", server_lr=0.01),
    dict(server_opt="momentum", server_lr=0.5, server_momentum=0.8),
    dict(client_momentum=0.9),
    dict(participation=0.5, bucket_size=2, honest_size=40, byz_size=10, attack="signflip"),
    dict(defense="adaptive", agg="mean", defense_up=2, defense_ladder="mean,median"),
    dict(defense="monitor", agg="median", attack="under_radar", byz_size=2),
])
def test_titles_match_jax_and_each_option_forks_the_hash(kw):
    cfg = FedConfig(**kw)
    assert tharness.run_title(cfg) == jharness.run_title(JaxFedConfig(**kw))
    assert tharness.config_hash(cfg) != tharness.config_hash(FedConfig())


@pytest.mark.parametrize("kw,title,digest", [
    (dict(), "MLP_SGD_baseline_gm", "fb10ef9d"),
    (dict(agg="median", attack="signflip", byz_size=2, noise_var=1e-2),
     "MLP_SGD_signflip_median_0.01", "67b1a9e8"),
    (dict(agg="gm2", fault="chaos"), "MLP_SGD_baseline_gm2_faultchaos", "fc4cd417"),
])
def test_a_config_without_the_new_fields_keeps_its_title_and_hash(kw, title, digest):
    """Every new field at its default (the defense's while it is off) is
    left out of the hash, so a run that does not use them keeps the
    checkpoint key it had before they were ported (the digests of the
    parent tree); setting any one of them forks it."""
    cfg = FedConfig(**kw)
    assert (tharness.run_title(cfg), tharness.config_hash(cfg)) == (title, digest)
    for new in (dict(local_steps=2), dict(fedprox_mu=0.1), dict(server_opt="adam"),
                dict(server_lr=0.5), dict(server_momentum=0.5), dict(client_momentum=0.5),
                dict(participation=0.5), dict(bucket_size=2), dict(defense="monitor")):
        assert tharness.config_hash(dataclasses.replace(cfg, **new)) != digest, new


_CLI_ARGV = ["--attack", "signflip", "--K", "20", "--B", "4", "--agg", "trimmed_mean",
             "--local-steps", "1", "--fedprox-mu", "0.02", "--server-opt", "adam",
             "--server-lr", "0.05", "--server-momentum", "0.8", "--client-momentum", "0.9",
             "--bucket-size", "2", "--defense", "adaptive",
             "--defense-ladder", "trimmed_mean,multi_krum", "--defense-warmup", "3",
             "--defense-alpha", "0.2", "--defense-drift", "0.4", "--defense-cusum", "6",
             "--defense-z", "3.5", "--defense-up", "2", "--defense-down", "10",
             "--defense-min-flagged", "2", "--defense-floor", "1.2", "--defense-leak", "0.01"]
_CLI_FIELDS = ("local_steps", "fedprox_mu", "server_opt", "server_lr", "server_momentum",
               "client_momentum", "participation", "bucket_size", *FedConfig._DEFENSE_KNOBS,
               "defense", "honest_size", "byz_size", "agg", "attack")


@pytest.mark.parametrize("argv", [
    _CLI_ARGV,
    ["--participation", "0.5", "--K", "20", "--B", "4", "--attack", "signflip",
     "--local-steps", "3"],
    [],
], ids=["every_new_flag", "participation_local_steps", "defaults"])
def test_new_flags_parse_to_the_jax_cli_config(argv):
    port = tcli.config_from_args(tcli.build_parser().parse_args(argv + ["--device", "cpu"]))
    want = jcli.config_from_args(jcli.build_parser().parse_args(argv), argv)
    for field in _CLI_FIELDS:
        assert getattr(port, field) == getattr(want, field), field
    assert port.validate() is port


@pytest.mark.parametrize("kw,match", [
    (dict(participation=0.0), "participation must be in"),
    (dict(participation=0.01, honest_size=10), "zero honest"),
    (dict(participation=0.5, honest_size=10, byz_size=1, attack="signflip"),
     "silently drop"),
    (dict(bucket_size=3, honest_size=10), "must divide"),
    (dict(bucket_size=2, honest_size=2, byz_size=2, attack="signflip"), "degenerate"),
    (dict(bucket_size=2, agg="gm"), "undefined for agg"),
    (dict(bucket_size=2, agg="bev", sign_bits=1, sign_eta=0.1), "packed words"),
    (dict(bucket_size=2, honest_size=6, byz_size=2, attack="signflip", agg="krum"),
     "clean buckets"),
    (dict(fedprox_mu=-1.0), "fedprox_mu"),
    (dict(client_momentum=1.0), "client_momentum must be"),
    (dict(client_momentum=0.9, local_steps=2), "requires local_steps == 1"),
    (dict(local_steps=0), "local_steps"),
    (dict(server_opt="sgd"), "none|momentum|adam"),
    (dict(fault="chaos", participation=0.5), "full participation"),
    (dict(krum_m=30, bucket_size=2, agg="krum"), r"\[1, 25\]"),
])
def test_validation_errors_match_jax(kw, match):
    with pytest.raises(ValueError, match=match):
        FedConfig(**kw).validate()
    with pytest.raises((AssertionError, ValueError), match=match):
        JaxFedConfig(**kw).validate()


_CKPT_KW = dict(honest_size=8, byz_size=2, attack="signflip", agg="trimmed_mean",
                client_momentum=0.9, server_opt="adam", bucket_size=2, defense="adaptive",
                defense_ladder="trimmed_mean,multi_krum", display_interval=2, batch_size=8,
                seed=3)


def test_checkpoints_with_the_new_state_load_across_packages(tmp_path, mnist):
    """Server Adam, client momentum and the defense's state: a port npz
    restores into the JAX trainer leaf for leaf, and a JAX npz into the
    port, after a round that moved every leaf."""
    jcfg, cfg = JaxFedConfig(**_CKPT_KW), FedConfig(**_CKPT_KW)
    jt = FedTrainer(jcfg, dataset=mnist)
    t = Trainer(cfg, dataset=mnist, device="cpu", params=_t(jt.flat_params))
    j_leaves = jax.tree.leaves(jharness.extra_state(jt, jcfg))
    t_leaves = tharness.extra_state(t)
    # adam (count, mu, nu), client_m, detector (step, ema, dev, cusum),
    # policy (rung, up, down, budget)
    assert len(t_leaves) == len(j_leaves) == 12
    for a, b in zip(t_leaves, j_leaves):
        assert tuple(a.shape) == np.shape(b) and a.numpy().dtype == np.asarray(b).dtype
    t.run_round(0)
    moved = tharness.extra_state(t)
    assert int(moved[0]) == 2 and float(moved[1].abs().max()) > 0 and int(moved[4]) == 2

    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    tcheckpoint.save(port_dir, "run", 1, t.flat_params, moved)
    r, flat, leaves = jcheckpoint.load(port_dir, "run")
    lines = []
    assert jharness.restore_trainer(jt, jcfg, (r, flat, leaves), log_fn=lines.append) == 1
    assert not lines
    for a, b in zip(jax.tree.leaves(jharness.extra_state(jt, jcfg)), moved):
        assert np.asarray(a).dtype == b.numpy().dtype and np.array_equal(np.asarray(a), b.numpy())

    jcheckpoint.save(jax_dir, "run", 1, jt.flat_params,
                     jax.tree.leaves(jharness.extra_state(jt, jcfg)))
    fresh = Trainer(cfg, dataset=mnist, device="cpu")
    assert tharness.restore_trainer(fresh, tcheckpoint.load(jax_dir, "run"),
                                    log_fn=lines.append) == 1 and not lines
    assert torch.equal(fresh.flat_params, t.flat_params)
    for a, b in zip(tharness.extra_state(fresh), moved):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # and the restored state is the one the trainer runs on: a round from
    # each gives the same bits
    fresh.run_round(1)
    t.run_round(1)
    assert torch.equal(fresh.flat_params, t.flat_params)


def test_harness_resume_with_the_new_state_is_bitwise(tmp_path, mnist):
    """The resume config of chip_smoke.py at K=10: 2 rounds straight
    against 1 round checkpointed and resumed in a fresh trainer."""
    kw = dict(_CKPT_KW, rounds=2, cache_dir=str(tmp_path / "recs"), eval_train=False)
    straight_t, straight = tharness.run_with_trainer(FedConfig(**kw), "cpu", dataset=mnist)
    ck = str(tmp_path / "ck")
    tharness.run_with_trainer(FedConfig(**dict(kw, rounds=1, checkpoint_dir=ck)), "cpu",
                              dataset=mnist)
    resumed_t, resumed = tharness.run_with_trainer(
        FedConfig(**dict(kw, checkpoint_dir=ck, inherit=True)), "cpu", dataset=mnist)
    assert torch.equal(straight_t.flat_params, resumed_t.flat_params)
    for key in straight:
        if key != "roundsPerSec":
            assert straight[key] == resumed[key], key
    assert resumed["defenseLadder"] == ["trimmed_mean", "multi_krum"]


def test_remat_blocks_take_per_client_params():
    """ResNet-18's remat blocks (an ``autograd.Function`` with
    ``generate_vmap_rule``) under ``vmap(grad)`` over per-client params:
    two local steps with remat on equal them with remat off."""
    ds = tdata.load("cifar10_hard", synthetic_train=200, synthetic_val=20)
    out = {}
    for remat in (False, True):
        t = Trainer(FedConfig(model="ResNet18", resnet_width=8, remat=remat, dataset="cifar10_hard",
                              honest_size=2, byz_size=1, attack="classflip", agg="mean",
                              batch_size=2, local_steps=2), dataset=ds, device="cpu")
        x, y = _client_batches(t, 7, 3, 2, 2)
        out[remat] = t.client_stack(t.flat_params, x, y, t.byz_mask)
    assert torch.isfinite(out[True]).all()
    torch.testing.assert_close(out[True], out[False], rtol=1e-6, atol=1e-7)
