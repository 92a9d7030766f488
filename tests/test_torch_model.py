"""The port's MLP, flat layout, interop and per-client gradients vs the JAX
package, plus its FedConfig against the JAX FedConfig.

Gradients are compared on the same flat vector and batches, in the manner
of tests/test_parity.py (rtol=1e-4, atol=1e-5: f32 matmuls and softmax in
different orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from byzantine_aircomp_tpu.fed.config import FedConfig as JaxFedConfig
from byzantine_aircomp_tpu.fed.train import FedTrainer
from byzantine_aircomp_tpu.models.mlp import MLP as JaxMLP
from byzantine_aircomp_tpu.ops import flatten as jflatten
from byzantine_aircomp_tpu_torch import interop
from byzantine_aircomp_tpu_torch.data import datasets as tdata
from byzantine_aircomp_tpu_torch.fed.config import FedConfig
from byzantine_aircomp_tpu_torch.fed.train import Trainer
from byzantine_aircomp_tpu_torch.models.mlp import MLP
from byzantine_aircomp_tpu_torch.ops import flatten as tflatten


def _jax_mlp(seed=0):
    model = JaxMLP(num_classes=10)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 28, 28)))
    return model, jax.tree.map(np.asarray, params)


def test_flat_layout_matches_flax():
    _, params = _jax_mlp()
    jspec = jflatten.make_flat_spec(params)
    spec = tflatten.make_flat_spec(MLP())
    assert jspec.shapes == ((10,), (784, 10)) and jspec.offsets == (0, 10)
    assert spec.total == jspec.total == 7850
    assert tuple(l.jax_shape for l in spec.leaves) == jspec.shapes
    assert tuple(l.offset for l in spec.leaves) == jspec.offsets
    assert [l.jax_path for l in spec.leaves] == [("Dense_0", "bias"), ("Dense_0", "kernel")]


def test_interop_round_trips_and_forward_matches():
    model_j, params = _jax_mlp(seed=3)
    jspec = jflatten.make_flat_spec(params)
    flat_j = np.asarray(jflatten.flatten(params, jspec))
    module = MLP()
    spec = tflatten.make_flat_spec(module)

    state, flat = interop.from_jax(params, spec)
    np.testing.assert_array_equal(flat.numpy(), flat_j)  # coordinate for coordinate
    _, flat_from_vec = interop.from_jax(flat_j, spec)
    assert torch.equal(flat, flat_from_vec)
    tree, flat_back = interop.to_jax(state, spec)
    np.testing.assert_array_equal(flat_back, flat_j)
    for name in ("bias", "kernel"):
        np.testing.assert_array_equal(
            tree["params"]["Dense_0"][name], params["params"]["Dense_0"][name]
        )

    module.load_state_dict(state)
    x = np.random.default_rng(0).standard_normal((5, 28, 28)).astype(np.float32)
    with torch.no_grad():
        logits = module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        logits, np.asarray(model_j.apply(params, jnp.asarray(x))), rtol=1e-5, atol=1e-5
    )
    with pytest.raises(ValueError, match="7850"):
        interop.from_jax(flat_j[:-1], spec)


@pytest.mark.parametrize("attack", [None, "classflip", "dataflip"])
def test_per_client_grads_match_jax_grad(attack):
    """Per-client gradients w.r.t. the flat vector: the port's
    vmap(grad(functional_call)) vs the JAX trainer's per-client grad,
    Byzantine rows under the data-level attack."""
    k, b = 5, 6
    ds = tdata.load("mnist", synthetic_train=200, synthetic_val=50)
    kw = dict(honest_size=3 if attack else k, byz_size=2 if attack else 0,
              attack=attack,
              batch_size=b)
    jt = FedTrainer(JaxFedConfig(**kw), dataset=ds)
    flat = np.array(jt.flat_params)
    tt = Trainer(FedConfig(**kw), dataset=ds, device="cpu",
                 params=torch.from_numpy(flat))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((k, b, 784)).astype(np.float32)
    y = rng.integers(0, 10, (k, b)).astype(np.int32)
    g_jax = np.asarray(jax.vmap(jt._per_client_grad, in_axes=(None, 0, 0, 0))(
        jnp.asarray(flat), jnp.asarray(x), jnp.asarray(y), jt.byz_mask,
    ))
    is_byz = tt.byz_mask
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    if attack:
        x_att, y_att = tt.attack.apply_data(xt, yt, 10)
        xt = torch.where(is_byz[:, None, None], x_att, xt)
        yt = torch.where(is_byz[:, None], y_att, yt)
    g_port = tt._per_client_grad(tt.flat_params, xt, yt).numpy()
    np.testing.assert_allclose(g_port, g_jax, rtol=1e-4, atol=1e-5)
    # and the local step built from them
    w_port = tt.client_stack(tt.flat_params, torch.from_numpy(x),
                             torch.from_numpy(y).long(), is_byz).numpy()
    np.testing.assert_allclose(w_port, flat - 1e-2 * g_jax, rtol=1e-5, atol=1e-7)


def test_config_fields_mirror_jax_fedconfig():
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxFedConfig)}
    # use_gpu is the reference's --use-gpu, which the JAX CLI parses (default
    # "true") and ignores, and the port keeps as a field
    from byzantine_aircomp_tpu.cli import build_parser

    assert build_parser().get_default("use_gpu") == "true"
    jax_fields["use_gpu"] = True
    for f in dataclasses.fields(FedConfig):
        assert f.name in jax_fields, f"{f.name} is not a JAX FedConfig field"
        assert f.default == jax_fields[f.name], f.name
    assert {"agg_impl", "fused_epilogue", "stack_dtype", "prng_impl"} <= {
        f.name for f in dataclasses.fields(FedConfig)}


@pytest.mark.parametrize("kw,match", [
    (dict(byz_size=2), "requires an attack"),
    (dict(honest_size=0), "honest_size"),
    (dict(agg="bulyan", attack="classflip", honest_size=6, byz_size=2), "K > 4B"),
    (dict(attack="mimic", byz_size=1), "defense-aware"),
    (dict(attack="nope", byz_size=1), "unknown attack"),
    (dict(display_interval=0), "display_interval"),
    (dict(agg="median", sign_bits=1, sign_eta=0.1), "only signmv"),
    (dict(agg="signmv", sign_bits=1), "sign-eta"),
    (dict(agg="mean", dropout_prob=0.1), "require --fault"),
    (dict(agg="signmv", sign_bits=3), "one of 1, 8, 16, 32"),
    (dict(agg="signmv", sign_eta=0.0), "sign_eta must be positive"),
])
def test_config_validate_rejects(kw, match):
    with pytest.raises((ValueError, KeyError), match=match):
        FedConfig(**kw).validate()


def test_mlp_forward_via_flat_vector_matches_module():
    module = MLP(generator=torch.Generator().manual_seed(0))
    spec = tflatten.make_flat_spec(module)
    flat = tflatten.flatten(dict(module.named_parameters()), spec)
    x = torch.randn(4, 28, 28)
    out = functional_call(module, tflatten.unflatten(flat, spec), (x,))
    with torch.no_grad():
        assert torch.allclose(out, module(x), rtol=1e-5, atol=1e-5)
    std = module.fc.weight.std().item()
    assert abs(std - np.sqrt(2.0) * np.sqrt(2.0 / 794)) < 0.01  # xavier, relu gain
    assert torch.all(module.fc.bias == 0.01)
