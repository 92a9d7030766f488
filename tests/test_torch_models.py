"""The port's CNN and ResNet-18 against the JAX package's on the CPU: their
sizes, their flat layout (``jax.tree.flatten``'s leaf order, HWIO conv
kernels, GroupNorm ``scale``), the carry of weights both ways, and logits
and per-sample loss gradients on the same weights and inputs.

Inputs come from a numpy seed; weights are the JAX model's own init,
carried over with ``interop.from_jax``.  Tolerances as in
tests/test_parity.py:140,:144: logits rtol 1e-4 / atol 1e-5, gradients
rtol 1e-3 / atol 1e-4 (f32 convolutions and reductions in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.func import functional_call, grad, vmap

from byzantine_aircomp_tpu.models.cnn import CNN as JaxCNN
from byzantine_aircomp_tpu.models.resnet import ResNet18 as JaxResNet18
from byzantine_aircomp_tpu.ops import flatten as jflatten
from byzantine_aircomp_tpu_torch import interop
from byzantine_aircomp_tpu_torch.models import initializers
from byzantine_aircomp_tpu_torch.models.cnn import CNN
from byzantine_aircomp_tpu_torch.models.resnet import ResNet18, same_conv
from byzantine_aircomp_tpu_torch.ops import flatten as tflatten
from byzantine_aircomp_tpu_torch.registry import MODELS


@pytest.mark.parametrize("build,total", [
    (lambda: CNN((28, 28), 10, 1024), 3_274_634),
    (lambda: CNN((32, 32, 3), 10, 1024), 4_259_274),
    (lambda: CNN((28, 28), 62, 2048), 6_603_710),
    (lambda: ResNet18((32, 32, 3), 10, 64), 11_173_962),
], ids=["cnn_mnist", "cnn_cifar10", "cnn_emnist", "resnet18_cifar10"])
def test_parameter_counts(build, total):
    module = build()
    assert tflatten.make_flat_spec(module).total == total
    assert sum(p.numel() for p in module.parameters()) == total


def test_registry_builds_the_new_models_with_their_knobs():
    cnn = MODELS.get("cnn")(input_shape=(28, 28), num_classes=10, fc_width=16, width=8)
    assert cnn.Dense_0.out_features == 16
    net = MODELS.get("ResNet18")(input_shape=(32, 32, 3), num_classes=10, width=16,
                                 remat=True, fc_width=7)
    assert net.remat and net.Conv_0.out_channels == 16
    with pytest.raises(ValueError, match="multiple of 8"):
        ResNet18(width=12)


CASES = {
    "cnn_mnist": (lambda: JaxCNN(num_classes=10, fc_width=16),
                  lambda: CNN((28, 28), 10, 16), (28, 28)),
    "cnn_cifar": (lambda: JaxCNN(num_classes=10, fc_width=16),
                  lambda: CNN((32, 32, 3), 10, 16), (32, 32, 3)),
    "resnet_w8": (lambda: JaxResNet18(num_classes=10, width=8),
                  lambda: ResNet18((32, 32, 3), 10, 8), (32, 32, 3)),
}


def _pair(name, seed=0):
    jax_build, torch_build, shape = CASES[name]
    model_j = jax_build()
    params = jax.tree.map(np.asarray, jax.jit(model_j.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1,) + shape, jnp.float32)))
    module = torch_build()
    spec = tflatten.make_flat_spec(module)
    state, flat = interop.from_jax(params, spec)
    module.load_state_dict(state)
    return model_j, params, module, spec, flat, shape


@pytest.mark.parametrize("name", ["cnn_mnist", "resnet_w8"])
def test_flat_layout_is_jax_tree_flatten_order(name):
    _, params, module, spec, flat, _ = _pair(name)
    jspec = jflatten.make_flat_spec(params)
    paths = [tuple(k.key for k in path)[1:]
             for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    assert [leaf.jax_path for leaf in spec.leaves] == paths
    assert tuple(leaf.jax_shape for leaf in spec.leaves) == jspec.shapes
    assert tuple(leaf.offset for leaf in spec.leaves) == jspec.offsets
    assert spec.total == jspec.total
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflatten.flatten(params, jspec)))
    # to_jax(from_jax(tree)) is the same tree, bit for bit
    tree, flat_back = interop.to_jax(flat, spec)
    np.testing.assert_array_equal(flat_back, flat.numpy())
    leaves_back = jax.tree.leaves(tree["params"])
    for a, b in zip(leaves_back, jax.tree.leaves(params["params"]), strict=True):
        assert a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32))
    # and the torch state dict flattens back to the same vector
    module_flat = tflatten.flatten(dict(module.named_parameters()), spec)
    assert torch.equal(module_flat, flat)


def test_resnet_leaf_names_mirror_flax():
    spec = tflatten.make_flat_spec(ResNet18(width=8))
    by_path = {leaf.jax_path: leaf for leaf in spec.leaves}
    proj = by_path[("BasicBlock_2", "Conv_2", "kernel")]
    assert proj.torch_name == "BasicBlock_2.Conv_2.weight" and proj.jax_shape == (1, 1, 8, 16)
    assert by_path[("BasicBlock_2", "GroupNorm_2", "scale")].torch_name == \
        "BasicBlock_2.GroupNorm_2.weight"
    assert ("BasicBlock_1", "Conv_2", "kernel") not in by_path  # no projection in stage 0
    assert by_path[("Conv_0", "kernel")].jax_shape == (3, 3, 3, 8)  # HWIO


def test_misnamed_layer_is_refused():
    class Bad(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.Conv_1 = torch.nn.Conv2d(1, 2, 3)

    with pytest.raises(ValueError, match="Conv_0"):
        tflatten.make_flat_spec(Bad())


def _loss_j(model_j, jspec):
    def loss(fp, x, y):
        logits = model_j.apply(jflatten.unflatten(fp, jspec), x[None])
        return -jax.nn.log_softmax(logits)[0, y]
    return loss


def _loss_t(module, spec):
    def loss(fp, x, y):
        logits = functional_call(module, tflatten.unflatten(fp, spec), (x[None],))
        return F.cross_entropy(logits, y[None])
    return loss


@pytest.mark.parametrize("name", list(CASES))
def test_logits_and_per_sample_grads_match_jax(name):
    model_j, params, module, spec, flat, shape = _pair(name, seed=1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4,) + shape).astype(np.float32)
    y = rng.integers(0, 10, 4).astype(np.int32)
    logits_j = np.asarray(jax.jit(model_j.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        logits_t = module(torch.from_numpy(x)).numpy()
        # the trainer's flat NHWC rows give the same logits
        rows_t = module(torch.from_numpy(x.reshape(4, -1))).numpy()
    np.testing.assert_allclose(logits_t, logits_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(rows_t, logits_t)

    jspec = jflatten.make_flat_spec(params)
    g_j = np.asarray(jax.jit(jax.vmap(jax.grad(_loss_j(model_j, jspec)), in_axes=(None, 0, 0)))(
        jnp.asarray(flat.numpy()), jnp.asarray(x), jnp.asarray(y)))
    g_t = vmap(grad(_loss_t(module, spec)), in_dims=(None, 0, 0))(
        flat, torch.from_numpy(x), torch.from_numpy(y).long()).numpy()
    np.testing.assert_allclose(g_t, g_j, rtol=1e-3, atol=1e-4)


def test_stride_two_conv_pads_as_flax_same():
    """A 3x3 stride-2 conv on a 6x6 input reads windows at rows and
    columns 0, 2, 4 (padding (0, 1)), as flax's SAME does; torch's
    symmetric padding=1 reads other windows."""
    torch.manual_seed(0)
    conv = torch.nn.Conv2d(2, 3, 3, stride=2, bias=False)
    x = torch.randn(1, 2, 6, 6)
    got = same_conv(conv, x)
    want = F.conv2d(F.pad(x, (0, 1, 0, 1)), conv.weight, stride=2)
    symmetric = F.conv2d(x, conv.weight, stride=2, padding=1)
    assert got.shape == symmetric.shape == (1, 3, 3, 3)
    assert torch.equal(got, want)
    assert not torch.allclose(got, symmetric, atol=1e-3)
    # the window at output (0, 0) starts on input row and column 0
    np.testing.assert_allclose(got[0, :, 0, 0].detach().numpy(),
                               (conv.weight * x[:, :, 0:3, 0:3]).sum(dim=(1, 2, 3)).detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    # and a stride-1 3x3 conv pads (1, 1)
    conv1 = torch.nn.Conv2d(2, 3, 3, bias=False)
    assert torch.equal(same_conv(conv1, x), F.conv2d(x, conv1.weight, padding=1))


def test_remat_gives_the_same_per_client_grads():
    """remat=True recomputes each block in the backward pass under the
    trainer's vmap(grad); the per-client gradients of 3 clients equal
    those of remat=False."""
    module = ResNet18((32, 32, 3), 10, 8, generator=torch.Generator().manual_seed(3))
    spec = tflatten.make_flat_spec(module)
    flat = tflatten.flatten(dict(module.named_parameters()), spec).detach()
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 2, 32 * 32 * 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, (3, 2))).long()

    def loss(fp, xb, yb):
        logits = functional_call(module, tflatten.unflatten(fp, spec), (xb,))
        return torch.mean(F.cross_entropy(logits, yb, reduction="none"))

    per_client = vmap(grad(loss), in_dims=(None, 0, 0))
    plain = per_client(flat, x, y)
    module.remat = True
    remat = per_client(flat, x, y)
    assert torch.isfinite(plain).all() and plain.abs().max() > 0
    torch.testing.assert_close(remat, plain, rtol=1e-6, atol=1e-7)


def _peak_allocated_bytes(fn, trace_path):
    """The most CPU memory held at once while ``fn()`` runs, from the
    profiler's memory events."""
    import json

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        fn()
    prof.export_chrome_trace(str(trace_path))
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return max(e["args"]["Total Allocated"] for e in events if e.get("name") == "[memory]")


def test_remat_lowers_the_peak_memory_of_the_per_client_grads(tmp_path):
    """Under the trainer's vmap(grad), remat=True holds less memory at its
    peak than remat=False: each block's activations are recomputed in the
    backward pass and dropped with it."""
    module = ResNet18((32, 32, 3), 10, 8, generator=torch.Generator().manual_seed(3))
    spec = tflatten.make_flat_spec(module)
    flat = tflatten.flatten(dict(module.named_parameters()), spec).detach()
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 16, 32 * 32 * 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, (3, 16))).long()

    def loss(fp, xb, yb):
        logits = functional_call(module, tflatten.unflatten(fp, spec), (xb,))
        return torch.mean(F.cross_entropy(logits, yb, reduction="none"))

    per_client = vmap(grad(loss), in_dims=(None, 0, 0))
    peaks = {}
    for remat in (False, True):
        module.remat = remat
        peaks[remat] = _peak_allocated_bytes(lambda: per_client(flat, x, y),
                                             tmp_path / f"{remat}.json")
    assert peaks[True] < 0.6 * peaks[False], peaks


@pytest.mark.parametrize("shape,fans", [
    ((10, 784), (784, 10)),
    ((32, 1, 5, 5), (25, 800)),
    ((64, 32, 3, 3), (288, 576)),
])
def test_xavier_fans_count_the_receptive_field(shape, fans):
    """std = sqrt(2) * sqrt(2 / (fan_in + fan_out)) with a conv's fans
    times kh*kw, as JAX's variance_scaling(fan_avg) and torch's
    xavier_normal_ take them."""
    w = torch.empty(shape)
    gen = torch.Generator().manual_seed(0)
    initializers.xavier_normal_relu_(w, gen)
    draw = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    std = initializers.RELU_GAIN * (2.0 / sum(fans)) ** 0.5
    torch.testing.assert_close(w, std * draw)
    fan_in, fan_out = torch.nn.init._calculate_fan_in_and_fan_out(w)
    assert (fan_in, fan_out) == fans
