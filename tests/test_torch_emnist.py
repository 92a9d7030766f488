"""The mnist_hard, emnist and emnist_hard sets of the port vs the JAX
package's, and one iteration of the 62-class MLP on emnist_hard against the
JAX ``FedTrainer``, on the CPU.

The synthetic sets are byte-identical (the same ``default_rng(2021)``
stream).  The iteration (gm2, K=8, classflip) starts from the same params
and batch uniforms; the new params agree within atol=1e-5, the f32 bound
the other port iteration tests use (the Weiszfeld sums and the per-client
gradients round in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantine_aircomp_tpu.data import datasets as jdata
from byzantine_aircomp_tpu.fed.config import FedConfig as JaxFedConfig
from byzantine_aircomp_tpu.fed.train import FedTrainer
from byzantine_aircomp_tpu_torch.data import datasets as tdata
from byzantine_aircomp_tpu_torch.fed import harness as tharness
from byzantine_aircomp_tpu_torch.fed.config import FedConfig
from byzantine_aircomp_tpu_torch.fed.train import Trainer


@pytest.mark.parametrize("name,classes,ceiling", [
    ("mnist_hard", 10, 1 - 0.09 * 9 / 10),
    ("emnist", 62, None),
    ("emnist_hard", 62, 1 - 0.09 * 61 / 62),
])
def test_synthetic_sets_are_byte_identical(name, classes, ceiling):
    a = jdata.load(name, synthetic_train=700, synthetic_val=300)
    b = tdata.load(name, synthetic_train=700, synthetic_val=300)
    assert b.source == a.source == "synthetic"
    assert (b.name, b.num_classes, b.stats, b.input_shape) == (
        a.name, classes, a.stats, a.input_shape)
    for field in ("x_train", "y_train", "x_val", "y_val", "x_train_raw"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and x.shape == y.shape, field
        assert x.tobytes() == y.tobytes(), field
    if ceiling is not None:
        # the label noise is there: some labels are resampled
        clean = tdata.load(name.replace("_hard", ""), synthetic_train=700, synthetic_val=300)
        assert 0 < np.mean(clean.y_train != b.y_train) < 0.12


def test_default_sizes_and_stats_match_jax():
    import inspect

    for name in ("mnist_hard", "emnist", "emnist_hard"):
        tp = inspect.signature(tdata.DATASETS.get(name)).parameters
        jp = inspect.signature(jdata.DATASETS.get(name)).parameters
        for k in ("synthetic_train", "synthetic_val"):
            assert tp[k].default == jp[k].default, (name, k)
    assert tdata.EMNIST_STATS == jdata.EMNIST_STATS


def test_emnist_idx_files_on_disk_are_read(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    raw = tmp_path / "EMNIST" / "raw"
    raw.mkdir(parents=True)
    for split, n in (("train", 12), ("test", 5)):
        img = rng.integers(0, 256, (n, 28, 28), dtype=np.uint8)
        lbl = rng.integers(0, 62, n, dtype=np.uint8)
        (raw / f"emnist-byclass-{split}-images-idx3-ubyte").write_bytes(
            b"\x00\x00\x08\x03" + np.array(img.shape, ">u4").tobytes() + img.tobytes())
        (raw / f"emnist-byclass-{split}-labels-idx1-ubyte").write_bytes(
            b"\x00\x00\x08\x01" + np.array([n], ">u4").tobytes() + lbl.tobytes())
    monkeypatch.setattr(tdata, "DATA_ROOTS", (str(tmp_path),))
    monkeypatch.setattr(jdata, "DATA_ROOTS", (str(tmp_path),))
    a, b = jdata.load("emnist"), tdata.load("emnist")
    assert b.source == a.source == "disk" and b.num_classes == 62
    for field in ("y_train", "y_val", "x_train_raw"):
        assert getattr(a, field).tobytes() == getattr(b, field).tobytes(), field
    # both packages read and normalize through the native C++ reader where
    # it is built: the same bits
    assert b.reader.startswith("native C++")
    for field in ("x_train", "x_val"):
        assert np.array_equal(getattr(b, field), getattr(a, field)), field
    # the numpy path (AIRCOMP_NO_NATIVE) is the formula, which the native
    # helper rounds otherwise: within 1 ulp of the largest values (|x| < 4,
    # 1 ulp = 2.4e-7)
    from byzantine_aircomp_tpu_torch.data import native_io

    monkeypatch.setenv("AIRCOMP_NO_NATIVE", "1")
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_lib_attempted", False)
    c = tdata.load("emnist")
    assert c.reader.startswith("numpy")
    for field in ("x_train", "x_val"):
        np.testing.assert_allclose(getattr(c, field), getattr(a, field), rtol=0, atol=2.4e-7)
    m, sd = np.float32(tdata.EMNIST_STATS[0]), np.float32(tdata.EMNIST_STATS[1])
    assert np.array_equal(c.x_train, (c.x_train_raw.astype(np.float32) / 255.0 - m) / sd)


def test_emnist_cache_dir_follows_the_name(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = FedConfig(dataset="emnist", attack="classflip", honest_size=8, byz_size=2)
    path = tharness.cache_path(cfg, "emnist")
    assert path.startswith("./EMNIST_Air_weight_torch/emnist_K10_B2_")


def test_one_emnist_hard_iteration_matches_jax():
    ds = tdata.load("emnist_hard", synthetic_train=800, synthetic_val=100)
    kw = dict(honest_size=6, byz_size=2, batch_size=8, agg="gm2", attack="classflip",
              dataset="emnist_hard", agg_maxiter=30, seed=11)
    jt = FedTrainer(JaxFedConfig(agg_impl="xla", **kw), dataset=ds)
    tt = Trainer(FedConfig(**kw), dataset=ds, device="cpu",
                 params=torch.from_numpy(np.array(jt.flat_params)))
    assert tt.dim == 784 * 62 + 62 == 48670
    key = jax.random.fold_in(jax.random.PRNGKey(0), 4)
    k_batch = jax.random.split(key, 4)[0]
    u = torch.from_numpy(np.array(jax.random.uniform(k_batch, (8, 8), dtype=jnp.float32)))
    carry = (jt.flat_params, jt.server_opt_state, jt.client_m, jt.fault_state,
             jt.defense_state, jt.attack_iter, jt.service_state)
    carry_out, outs = jt._iteration(carry, key, jt.x_train, jt.y_train, True)
    new_jax = np.asarray(carry_out[0])
    new_port, var_port = tt.iteration(tt.flat_params, draws={"u": u}, want_variance=True)
    assert not np.allclose(new_jax, np.asarray(jt.flat_params))
    np.testing.assert_allclose(new_port.numpy(), new_jax, rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(var_port), float(outs[0]), rtol=1e-4)
    # the Byzantine clients trained on 61 - y (the reference EMNIST script)
    x, y = torch.zeros(1), torch.tensor([0, 61, 30])
    assert tt.attack.apply_data(x, y, 62)[1].tolist() == [61, 0, 31]
