"""One global iteration of the port's Trainer with the conv models against
the JAX package's ``FedTrainer._iteration`` on the CPU, from the same
params and the same key-derived draws (as tests/test_torch_slice.py does
for the MLP): the CNN under gm2 on mnist_hard and ResNet-18 at width 8
under median with the OMA channel on cifar10_hard, K = 6.  New params
agree within atol 1e-5 (per-client gradients within rtol 1e-3, scaled by
gamma 1e-2), the honest variance within rtol 1e-4.

Also: a CNN checkpoint round-trips through the JAX package's npz keys,
and a CNN run resumed from its checkpoint equals the straight run bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantine_aircomp_tpu.fed import checkpoint as jcheckpoint
from byzantine_aircomp_tpu.fed.config import FedConfig as JaxFedConfig
from byzantine_aircomp_tpu.fed.train import FedTrainer
from byzantine_aircomp_tpu.ops import channel as jchannel
from byzantine_aircomp_tpu_torch.data import datasets as tdata
from byzantine_aircomp_tpu_torch.fed import checkpoint as tcheckpoint
from byzantine_aircomp_tpu_torch.fed import harness as tharness
from byzantine_aircomp_tpu_torch.fed.config import FedConfig
from byzantine_aircomp_tpu_torch.fed.train import Trainer
from byzantine_aircomp_tpu_torch.ops import channel as tchannel


def _t(a):
    return torch.from_numpy(np.array(a))


def _one_iteration(kw, ds):
    jt = FedTrainer(JaxFedConfig(agg_impl="xla", **kw), dataset=ds)
    cfg = FedConfig(**kw)
    tt = Trainer(cfg, dataset=ds, device="cpu", params=_t(jt.flat_params))
    k, d = cfg.node_size, tt.dim
    assert d == jt.dim

    key = jax.random.fold_in(jax.random.PRNGKey(0), 4)
    k_batch, k_chan, _, _ = jax.random.split(key, 4)
    draws = {"u": _t(jax.random.uniform(k_batch, (k, cfg.batch_size), dtype=jnp.float32))}
    if cfg.noise_var is not None:
        draws["oma"] = tchannel.OmaTerms(
            *(_t(a) for a in jchannel.oma_terms(k_chan, k, d, cfg.noise_var)))
    carry = (jt.flat_params, jt.server_opt_state, jt.client_m, jt.fault_state,
             jt.defense_state, jt.attack_iter, jt.service_state)
    carry_out, outs = jt._iteration(carry, key, jt.x_train, jt.y_train, True)
    new_jax, var_jax = np.asarray(carry_out[0]), float(outs[0])
    assert not np.allclose(new_jax, np.asarray(jt.flat_params))  # it moved
    new_port, var_port = tt.iteration(tt.flat_params, draws=draws, want_variance=True)
    return (new_jax, var_jax), (new_port.numpy(), float(var_port))


@pytest.mark.parametrize("kw,data", [
    (dict(model="CNN", fc_width=16, agg="gm2", attack="classflip", agg_maxiter=30),
     ("mnist_hard", 300)),
    (dict(model="ResNet18", resnet_width=8, agg="median", attack="classflip",
          noise_var=1e-2), ("cifar10_hard", 200)),
], ids=["cnn_gm2_mnist_hard", "resnet18_w8_median_var_cifar10_hard"])
def test_one_iteration_matches_jax(kw, data):
    name, n = data
    ds = tdata.load(name, synthetic_train=n, synthetic_val=50)
    kw = dict(dict(honest_size=4, byz_size=2, batch_size=4, seed=11, dataset=name), **kw)
    (new_jax, var_jax), (new_port, var_port) = _one_iteration(kw, ds)
    assert np.isfinite(new_port).all()
    np.testing.assert_allclose(new_port, new_jax, rtol=0, atol=1e-5)
    np.testing.assert_allclose(var_port, var_jax, rtol=1e-4)


@pytest.fixture(scope="module")
def ds():
    return tdata.load("mnist_hard", synthetic_train=400, synthetic_val=100)


def _cfg(tmp_path, **kw):
    base = dict(model="CNN", fc_width=8, honest_size=5, byz_size=1, attack="classflip",
                agg="gm2", rounds=2, display_interval=2, batch_size=4, dataset="mnist_hard",
                agg_maxiter=20, eval_batch=50, cache_dir=str(tmp_path / "records"))
    base.update(kw)
    return FedConfig(**base)


def _run(cfg, ds):
    return tharness.run_with_trainer(cfg, device="cpu", record_in_file=False, dataset=ds)


def test_cnn_resume_equals_the_straight_run_bitwise(tmp_path, ds):
    straight_t, straight = _run(_cfg(tmp_path), ds)
    ck = str(tmp_path / "ck")
    _run(_cfg(tmp_path, rounds=1, checkpoint_dir=ck), ds)
    resumed_t, resumed = _run(_cfg(tmp_path, checkpoint_dir=ck, inherit=True), ds)
    assert torch.equal(resumed_t.flat_params, straight_t.flat_params)
    for key in ("valAccPath", "valLossPath", "variencePath", "trainLossPath"):
        assert np.array_equal(resumed[key], straight[key]), key


def test_cnn_checkpoint_round_trips_through_the_jax_npz(tmp_path, ds):
    cfg = _cfg(tmp_path)
    t = Trainer(cfg, dataset=ds, device="cpu")
    t.flat_params = t.flat_params + 0.5
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    tcheckpoint.save(port_dir, "run", 2, t.flat_params, tharness.extra_state(t), meta="{}")
    with np.load(tcheckpoint.checkpoint_file(port_dir, "run")) as z:
        assert sorted(z.files) == ["flat_params", "meta_json", "round_idx"]
    r, flat, leaves = jcheckpoint.load(port_dir, "run")
    assert r == 2 and leaves == [] and np.array_equal(flat, t.flat_params.numpy())
    # the JAX trainer of the same config takes it as its params
    jcfg = JaxFedConfig(model="CNN", fc_width=8, honest_size=5, byz_size=1,
                        attack="classflip", agg="gm2", dataset="mnist_hard")
    jt = FedTrainer(jcfg, dataset=ds)
    assert jt.dim == flat.size == t.dim
    jcheckpoint.save(jax_dir, "run", 2, jnp.asarray(flat), [], meta="m")
    fresh = Trainer(cfg, dataset=ds, device="cpu")
    assert tharness.restore_trainer(fresh, tcheckpoint.load(jax_dir, "run")) == 2
    assert torch.equal(fresh.flat_params, t.flat_params)
