"""One global iteration of the port's Trainer vs the JAX package's
``FedTrainer._iteration`` (fed/train.py:605), from the same params and the
same key-derived draws, on the CPU at K=6 (K=10 for the selection rules,
the votes, cclip and dnc), B=2, with the full-width MLP.

The test splits the iteration key as the JAX trainer does (batch, channel,
aggregation, message; with a fault a fifth key, split into the dropout and
the transmission keys, fed/train.py:655-680), draws the batch uniforms, the
OMA terms, gm's per-step fades and receiver normals, signmv's vote noise,
dnc's columns and power-step starts and the fault channel's draws from
those keys, and hands them to the port.  New params agree within atol=1e-5
(bitwise for signmv and bev, whose step is +-eta or 0), the honest variance
within rtol=1e-4 (f32 reductions in different orders), and the fault counts
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantine_aircomp_tpu.fed.config import FedConfig as JaxFedConfig
from byzantine_aircomp_tpu.fed.train import FedTrainer
from byzantine_aircomp_tpu.ops import channel as jchannel
from byzantine_aircomp_tpu.ops import faults as jfaults
from byzantine_aircomp_tpu_torch.data import datasets as tdata
from byzantine_aircomp_tpu_torch.fed.config import FedConfig
from byzantine_aircomp_tpu_torch.fed.train import Trainer
from byzantine_aircomp_tpu_torch.ops import channel as tchannel


def _t(a):
    return torch.from_numpy(np.array(a))


def _gm_draws(key, k, d, steps):
    h_r, h_i, z = [], [], []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        key_h, key_n = jax.random.split(sub)
        hr, hi = jchannel.rayleigh_fade(key_h, k)
        h_r.append(np.asarray(hr))
        h_i.append(np.asarray(hi))
        z.append(np.asarray(jax.random.normal(key_n, (d + 1,), dtype=jnp.float32)))
    return (_t(np.stack(h_r)), _t(np.stack(h_i))), _t(np.stack(z))


def _dnc_draws(key, d, iters, sub_dim):
    """dnc's columns and power-step starts per filtering round, as JAX's
    ``dnc`` draws them from ``fold_in(key, it)`` (ops/aggregators.py:557)."""
    out = []
    r = min(d, sub_dim)
    for it in range(iters):
        k_cols, k_v = jax.random.split(jax.random.fold_in(key, it))
        out.append((_t(jax.random.randint(k_cols, (r,), 0, d)).long(),
                    _t(jax.random.normal(k_v, (r,), jnp.float32))))
    return out


def _fault_draws(spec, k_fault, k):
    """The fault channel's draws from the iteration's fifth key, in the JAX
    package's layout: (k_drop, k_trans) = split(key); k_trans splits into
    (corrupt, fade, csi, ge), and ge into (recover, degrade)."""
    k_drop, k_trans = jax.random.split(k_fault)
    k_corrupt, k_fade, k_csi, k_ge = jax.random.split(k_trans, 4)
    k_recover, k_degrade = jax.random.split(k_ge)
    return {
        "dropped": _t(jax.random.bernoulli(k_drop, spec.dropout_prob, (k,))),
        "crash": _t(jax.random.bernoulli(k_corrupt, spec.corrupt_prob, (k,))),
        "fade": tuple(_t(h) for h in jchannel.rayleigh_fade(k_fade, k)),
        "ge_recover": _t(jax.random.bernoulli(k_recover, spec.ge_p_bg, (k,))),
        "ge_degrade": _t(jax.random.bernoulli(k_degrade, spec.ge_p_gb, (k,))),
        "csi_z": _t(jax.random.normal(k_csi, (k,), dtype=jnp.float32)),
    }


def _one_iteration(kw, **jax_kw):
    """(new params, variance, fault counts) of one iteration from the same
    params and key-derived draws: the JAX trainer's (with ``jax_kw`` on top
    of ``agg_impl="xla"``), and the port's."""
    ds = tdata.load("mnist", synthetic_train=600, synthetic_val=100)
    jt = FedTrainer(JaxFedConfig(**dict(dict(agg_impl="xla"), **jax_kw), **kw), dataset=ds)
    cfg = FedConfig(**kw)
    tt = Trainer(cfg, dataset=ds, device="cpu", params=_t(jt.flat_params))
    k, d = cfg.node_size, tt.dim
    assert d == 7850

    key = jax.random.fold_in(jax.random.PRNGKey(0), 4)
    keys = jax.random.split(key, 4 if cfg.fault is None else 5)
    k_batch, k_chan, k_agg, _ = keys[:4]
    draws = {"u": _t(jax.random.uniform(k_batch, (k, cfg.batch_size), dtype=jnp.float32))}
    if cfg.noise_var is not None and cfg.agg not in ("gm", "signmv"):
        draws["oma"] = tchannel.OmaTerms(
            *(_t(a) for a in jchannel.oma_terms(k_chan, k, d, cfg.noise_var))
        )
    if cfg.agg == "gm":
        draws["fades"], draws["noise"] = _gm_draws(k_agg, k, d, cfg.agg_maxiter)
    if cfg.agg == "signmv":
        draws["vote_noise"] = _t(jax.random.normal(k_agg, (d,), dtype=jnp.float32))
    if cfg.agg == "dnc":
        draws["dnc"] = _dnc_draws(k_agg, d, cfg.dnc_iters, cfg.dnc_sub_dim)
    if cfg.fault is not None:
        draws["fault"] = _fault_draws(jt.fault, keys[4], k)

    carry = (jt.flat_params, jt.server_opt_state, jt.client_m, jt.fault_state,
             jt.defense_state, jt.attack_iter, jt.service_state)
    carry_out, outs = jt._iteration(carry, key, jt.x_train, jt.y_train, True)
    new_jax, var_jax = np.asarray(carry_out[0]), float(outs[0])
    assert not np.allclose(new_jax, np.asarray(jt.flat_params))  # it moved

    new_port, var_port = tt.iteration(tt.flat_params, draws=draws, want_variance=True)
    assert torch.isfinite(new_port).all()
    counts = None
    if cfg.fault is not None:
        counts = (np.asarray(outs[1]), tt.iteration_fault_metrics.numpy())
    return (new_jax, var_jax), (new_port.numpy(), float(var_port)), counts


# K=10 (B=2) for the selection rules, so that trimmed_mean trims b = 1
_K10 = dict(honest_size=8, byz_size=2)


@pytest.mark.parametrize("kw", [
    dict(agg="gm2", attack="classflip"),
    # at K=6 the noisy AirComp solve is noise-dominated and random-walks
    # off over tens of steps (the reference's physics, on both sides), so
    # the gm case stops after 5 steps, while its iterates are still O(0.1)
    dict(agg="gm", attack="classflip", noise_var=1e-2, agg_maxiter=5),
    dict(agg="gm2", attack="weightflip", noise_var=1e-2),
    dict(agg="median", attack="classflip", noise_var=1e-2, **_K10),
    dict(agg="trimmed_mean", attack="classflip", noise_var=1e-2, **_K10),
    dict(agg="krum", attack="weightflip", **_K10),
    dict(agg="signmv", attack="classflip", noise_var=1e-2, sign_bits=1,
         sign_eta=0.01, **_K10),
    dict(agg="multi_krum", attack="weightflip", **_K10),
    dict(agg="bulyan", attack="classflip", noise_var=1e-2, **_K10),
    dict(agg="cclip", attack="weightflip", **_K10),
    dict(agg="bev", attack="classflip", sign_bits=1, sign_eta=0.01, **_K10),
    dict(agg="dnc", attack="classflip", **_K10),
    dict(agg="signmv", attack="classflip", sign_bits=8, sign_eta=0.01, **_K10),
    # the chaos scenario with its rates raised so that this one iteration
    # drops, corrupts and erases rows
    dict(agg="trimmed_mean", attack="classflip", noise_var=1e-2, fault="chaos",
         dropout_prob=0.3, fade_floor=0.3, corrupt_prob=1.0, corrupt_size=2, **_K10),
], ids=["gm2_classflip", "gm_classflip_var", "gm2_weightflip_var",
        "median_classflip_var", "trimmed_mean_classflip_var", "krum_weightflip",
        "signmv1_classflip_var", "multi_krum_weightflip", "bulyan_classflip_var",
        "cclip_weightflip", "bev1_classflip", "dnc_classflip", "signmv8_classflip",
        "trimmed_mean_classflip_var_chaos"])
def test_one_iteration_matches_jax(kw):
    kw = dict(dict(honest_size=4, byz_size=2, batch_size=8, agg_maxiter=30,
                   seed=11), **kw)
    (new_jax, var_jax), (new_port, var_port), counts = _one_iteration(kw)
    if kw["agg"] in ("signmv", "bev"):
        assert np.array_equal(new_port.view(np.uint32), new_jax.view(np.uint32))
    np.testing.assert_allclose(new_port, new_jax, rtol=0, atol=1e-5)
    # an erased or corrupted honest row makes the variance NaN on both sides
    np.testing.assert_allclose(var_port, var_jax, rtol=1e-4, equal_nan=True)
    if counts is not None:
        want, got = counts
        assert np.array_equal(got, want)
        assert want[3] < kw["honest_size"] + kw["byz_size"] and min(want[:3]) > 0


def test_median_var_against_jax_fused_epilogue_pins_the_variance_divergence():
    """JAX's Pallas path with the fused epilogue (interpret mode here)
    defers the channel into the kernel's read and then takes the honest
    variance on the NOISELESS stack (fed/train.py:844, :1065-1076); the
    reference and JAX's XLA path take it on the post-channel stack.  The
    port follows the reference.  The new params agree either way."""
    kw = dict(honest_size=8, byz_size=2, batch_size=8, seed=11,
              agg="median", attack="classflip", noise_var=1e-2)
    (new_fused, var_fused), (new_port, var_port), _ = _one_iteration(
        kw, agg_impl="pallas", fused_epilogue="on")
    np.testing.assert_allclose(new_port, new_fused, rtol=0, atol=1e-5)
    (_, var_noiseless), _, _ = _one_iteration(dict(kw, noise_var=None))
    np.testing.assert_allclose(var_fused, var_noiseless, rtol=1e-6)
    (_, var_xla), _, _ = _one_iteration(kw)
    np.testing.assert_allclose(var_port, var_xla, rtol=1e-4)
    # the OMA noise at var 1e-2 dwarfs the clients' own spread
    assert var_port > 10 * var_fused


def test_round_draws_are_seeded_and_trains():
    """A round from the seeded generators is reproducible, and a short run
    learns (CPU, small synthetic set)."""
    ds = tdata.load("mnist", synthetic_train=2000, synthetic_val=400)
    cfg = FedConfig(honest_size=6, byz_size=2, attack="classflip", agg="gm2",
                    rounds=2, display_interval=5, batch_size=16)
    a = Trainer(cfg, dataset=ds, device="cpu")
    b = Trainer(cfg, dataset=ds, device="cpu")
    assert torch.equal(a.flat_params, b.flat_params)
    va, vb = a.run_round(0), b.run_round(0)
    assert torch.equal(a.flat_params, b.flat_params) and torch.equal(va, vb)
    paths = Trainer(cfg, dataset=ds, device="cpu").train()
    assert len(paths["valAccPath"]) == 3 and len(paths["variencePath"]) == 2
    assert paths["valAccPath"][-1] > 0.3
