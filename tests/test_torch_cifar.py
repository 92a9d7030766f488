"""CIFAR-10, the client partitions and the new CLI flags of the port against
the JAX package's, on the CPU: the synthetic sets and the readers of the
binary and pickled distributions (a tiny set written to ``tmp_path``) give
the same arrays; ``dirichlet_shards``, ``zipf_shards`` and
``parse_size_skew`` the same shards and errors; and a trainer with
``partition="dirichlet"`` (and a Zipf size skew) the same offsets, sizes
and permuted rows as the JAX ``FedTrainer``.
"""

import os
import pickle

import numpy as np
import pytest

from byzantine_aircomp_tpu.data import datasets as jdata
from byzantine_aircomp_tpu.fed.config import FedConfig as JaxFedConfig
from byzantine_aircomp_tpu.fed.train import FedTrainer
from byzantine_aircomp_tpu_torch import cli
from byzantine_aircomp_tpu_torch.data import datasets as tdata
from byzantine_aircomp_tpu_torch.fed import harness as tharness
from byzantine_aircomp_tpu_torch.fed.config import FedConfig
from byzantine_aircomp_tpu_torch.fed.train import Trainer


@pytest.fixture
def roots(tmp_path, monkeypatch):
    """Both packages search only ``tmp_path`` for data sets."""
    monkeypatch.setattr(jdata, "DATA_ROOTS", (str(tmp_path),))
    monkeypatch.setattr(tdata, "DATA_ROOTS", (str(tmp_path),))
    return tmp_path


def _same_dataset(a, b, normalized_atol=0.0):
    assert (a.name, a.num_classes, a.source) == (b.name, b.num_classes, b.source)
    assert a.stats == b.stats and a.input_shape == b.input_shape
    for key in ("y_train", "y_val", "x_train_raw"):
        va, vb = getattr(a, key), getattr(b, key)
        assert va.dtype == vb.dtype and np.array_equal(va, vb), key
    for key in ("x_train", "x_val"):
        va, vb = getattr(a, key), getattr(b, key)
        assert va.dtype == vb.dtype == np.float32 and va.shape == vb.shape, key
        np.testing.assert_allclose(va, vb, rtol=0, atol=normalized_atol)


@pytest.mark.parametrize("name", ["cifar10", "cifar10_hard"])
def test_synthetic_cifar_is_the_jax_packages(roots, name):
    kw = dict(synthetic_train=300, synthetic_val=120)
    port, ref = tdata.load(name, **kw), jdata.load(name, **kw)
    assert port.source == "synthetic" and port.input_shape == (32, 32, 3)
    _same_dataset(port, ref)


def _tiny_cifar(rng, n):
    labels = rng.integers(0, 10, n).astype(np.uint8)
    pixels = rng.integers(0, 256, (n, 3072)).astype(np.uint8)
    return labels, pixels


def test_cifar_binary_batches_parse_as_in_jax(roots):
    rng = np.random.default_rng(0)
    d = roots / "cifar-10-batches-bin"
    d.mkdir()
    for name, n in [(f"data_batch_{i}.bin", 3 + i) for i in range(1, 6)] + [("test_batch.bin", 4)]:
        labels, pixels = _tiny_cifar(rng, n)
        np.concatenate([labels[:, None], pixels], axis=1).tofile(d / name)
    port, ref = tdata.load("cifar10"), jdata.load("cifar10")
    assert port.source == "disk" and len(port.y_train) == 30 and len(port.y_val) == 4
    _same_dataset(port, ref, normalized_atol=1e-6)
    # CHW records become NHWC images
    rows = np.fromfile(d / "data_batch_1.bin", np.uint8).reshape(-1, 3073)
    assert np.array_equal(port.x_train_raw[:4],
                          rows[:, 1:].reshape(4, 3, 32, 32).transpose(0, 2, 3, 1))
    assert np.array_equal(port.y_train[:4], rows[:, 0])
    # a malformed batch is no distribution: the synthetic set stands in
    (d / "test_batch.bin").write_bytes(b"\x01" * 100)
    assert tdata.load("cifar10", synthetic_train=50, synthetic_val=20).source == "synthetic"


def test_cifar_python_pickles_parse_as_in_jax(roots):
    rng = np.random.default_rng(1)
    d = roots / "cifar-10-batches-py"
    d.mkdir()
    for name, n in [(f"data_batch_{i}", 2 + i) for i in range(1, 6)] + [("test_batch", 5)]:
        labels, pixels = _tiny_cifar(rng, n)
        with open(d / name, "wb") as f:
            pickle.dump({b"data": pixels, b"labels": [int(v) for v in labels]}, f)
    port, ref = tdata.load("cifar10"), jdata.load("cifar10")
    assert port.source == "disk" and len(port.y_train) == 25
    _same_dataset(port, ref, normalized_atol=1e-6)


def _labels(seed, n, classes=10):
    return np.random.default_rng(seed).integers(0, classes, n).astype(np.int32)


@pytest.mark.parametrize("seed,n,k,alpha", [
    (0, 600, 10, 0.3), (1, 400, 50, 0.05), (2, 300, 7, 100.0), (3, 60, 60, 0.01),
    (2021, 1000, 20, 1.0),
])
def test_dirichlet_shards_are_the_jax_packages(seed, n, k, alpha):
    labels = _labels(seed + 100, n)
    perm, shards = tdata.dirichlet_shards(labels, k, alpha, seed=seed)
    jperm, jshards = jdata.dirichlet_shards(labels, k, alpha, seed=seed)
    assert np.array_equal(perm, jperm)
    assert np.array_equal(shards.offsets, jshards.offsets) and shards.offsets.dtype == np.int32
    assert np.array_equal(shards.sizes, jshards.sizes) and shards.sizes.dtype == np.int32
    assert np.array_equal(np.sort(perm), np.arange(n)) and shards.sizes.min() >= 1


def test_dirichlet_empty_shard_repair_and_error():
    # at alpha 0.01 with as many clients as samples most draws leave
    # clients empty; each takes one sample from the largest shard
    labels = _labels(7, 60)
    rng = np.random.default_rng(3)
    raw = [[] for _ in range(60)]
    for c in np.unique(labels):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        p = rng.dirichlet(np.full(60, 0.01))
        counts = np.floor(p * len(idx)).astype(np.int64)
        frac = p * len(idx) - counts
        counts[np.argsort(-frac)[:len(idx) - int(counts.sum())]] += 1
        for i, part in enumerate(np.split(idx, np.cumsum(counts)[:-1])):
            raw[i].append(part)
    assert min(sum(len(p) for p in parts) for parts in raw) == 0  # the repair is needed
    _, shards = tdata.dirichlet_shards(labels, 60, 0.01, seed=3)
    assert shards.sizes.min() == 1
    for mod in (tdata, jdata):
        with pytest.raises(ValueError, match="n=5 < k=6"):
            mod.dirichlet_shards(_labels(0, 5), 6, 0.3)


@pytest.mark.parametrize("n,k,s", [
    (1000, 10, 0.0), (1000, 10, 1.5), (60, 50, 2.0), (50, 50, 3.0), (12345, 37, 0.7),
])
def test_zipf_shards_are_the_jax_packages(n, k, s):
    got, want = tdata.zipf_shards(n, k, s), jdata.zipf_shards(n, k, s)
    assert np.array_equal(got.offsets, want.offsets) and np.array_equal(got.sizes, want.sizes)
    assert got.sizes.min() >= 1 and got.sizes.sum() == n
    if s == 0.0:
        eq = tdata.contiguous_shards(n, k)
        assert np.array_equal(got.offsets, eq.offsets) and np.array_equal(got.sizes, eq.sizes)


@pytest.mark.parametrize("args,match", [((5, 6, 1.0), "n=5 < k=6"), ((10, 2, -1.0), ">= 0")])
def test_zipf_shards_errors(args, match):
    for mod in (tdata, jdata):
        with pytest.raises(ValueError, match=match):
            mod.zipf_shards(*args)


@pytest.mark.parametrize("spec,want", [("none", None), ("zipf:1.5", 1.5), ("zipf:0", 0.0)])
def test_parse_size_skew(spec, want):
    assert tdata.parse_size_skew(spec) == jdata.parse_size_skew(spec) == want


@pytest.mark.parametrize("spec", ["zipf1", "pareto:1", "zipf:-0.5"])
def test_parse_size_skew_rejects(spec):
    for mod in (tdata, jdata):
        with pytest.raises(ValueError):
            mod.parse_size_skew(spec)


@pytest.mark.parametrize("kw", [
    dict(partition="dirichlet", dirichlet_alpha=0.3),
    dict(partition="dirichlet", dirichlet_alpha=0.1, size_skew="zipf:1.0"),
    dict(size_skew="zipf:2.0"),
])
def test_trainer_partition_is_the_jax_trainers(kw):
    ds = tdata.load("cifar10_hard", synthetic_train=400, synthetic_val=50)
    base = dict(honest_size=8, byz_size=2, attack="classflip", agg="mean", seed=5)
    jt = FedTrainer(JaxFedConfig(**base, **kw), dataset=ds)
    tt = Trainer(FedConfig(**base, **kw), dataset=ds, device="cpu")
    assert np.array_equal(tt.offsets.numpy(), np.asarray(jt.offsets))
    assert np.array_equal(tt.sizes.numpy(), np.asarray(jt.sizes))
    assert np.array_equal(tt.y_train.numpy(), np.asarray(jt.y_train))
    assert np.array_equal(tt.x_train.numpy(), np.asarray(jt.x_train))  # u8 rows, permuted
    if kw.get("partition") == "dirichlet":
        assert not np.array_equal(tt.y_train.numpy(), ds.y_train)


def test_config_rejects_bad_partition_knobs():
    for kw, match in [(dict(partition="iid"), "contiguous' or 'dirichlet"),
                      (dict(dirichlet_alpha=0.0), "dirichlet_alpha must be positive"),
                      (dict(size_skew="zipf"), "'none' or 'zipf:<s>'"),
                      (dict(size_skew="zipf:x"), "must be a float"),
                      (dict(size_skew="zipf:-1"), ">= 0")]:
        with pytest.raises(ValueError, match=match):
            FedConfig(**kw).validate()


def test_partition_titles_and_hash_follow_jax():
    cfg = FedConfig(partition="dirichlet", dirichlet_alpha=0.1, size_skew="zipf:1.5")
    assert tharness.run_title(cfg).endswith("_dir0.1_skewzipf1.5")
    # the default size_skew leaves the hash as before the field existed
    plain = FedConfig()
    fields = {f: getattr(plain, f) for f in plain.__dataclass_fields__}
    assert tharness.config_hash(plain) == tharness.config_hash(FedConfig(**fields))
    assert tharness.config_hash(FedConfig(size_skew="zipf:0")) != tharness.config_hash(plain)


def test_new_cli_flags_set_their_fields():
    args = cli.build_parser().parse_args([
        "--model", "ResNet18", "--dataset", "cifar10", "--resnet-width", "32", "--remat",
        "--partition", "dirichlet", "--dirichlet-alpha", "0.5", "--size-skew", "zipf:1.2",
        "--device", "cpu"])
    cfg = cli.config_from_args(args)
    assert (cfg.model, cfg.dataset, cfg.resnet_width, cfg.remat) == ("ResNet18", "cifar10", 32, True)
    assert (cfg.partition, cfg.dirichlet_alpha, cfg.size_skew) == ("dirichlet", 0.5, "zipf:1.2")
    defaults = cli.config_from_args(cli.build_parser().parse_args(["--device", "cpu"]))
    assert (defaults.resnet_width, defaults.remat, defaults.partition,
            defaults.dirichlet_alpha, defaults.size_skew, defaults.fc_width) == \
        (64, False, "contiguous", 0.3, "none", 1024)
    # as in the JAX CLI, fc_width is a FedConfig field only
    assert not any("--fc-width" in a.option_strings for a in cli.build_parser()._actions)
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--partition", "iid"])


def test_cli_runs_the_cnn_with_a_dirichlet_split_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tdata, "DATA_ROOTS", (str(tmp_path),))
    monkeypatch.setitem(tdata.DATASETS._entries, "cifar10_hard",
                        lambda **_: tdata._synthetic("cifar10_hard", 300, 60, 10, (32, 32, 3),
                                                     tdata.CIFAR10_STATS, label_noise=0.09))
    cli.main(["--device", "cpu", "--model", "CNN", "--dataset", "cifar10_hard", "--agg", "gm2",
              "--attack", "classflip", "--K", "6", "--B", "1", "--rounds", "1", "--interval",
              "2", "--batch-size", "4", "--partition", "dirichlet", "--no-eval-train"])
    out = tmp_path / "CIFAR10_HARD_Air_weight_torch"
    files = os.listdir(out)
    assert files == ["cifar10_hard_K6_B1_CNN_SGD_classflip_gm2_dir0.3"]
    with open(out / files[0], "rb") as f:
        record = pickle.load(f)
    assert record["model"] == "CNN" and len(record["valAccPath"]) == 2
    assert np.isfinite(record["valLossPath"]).all()
