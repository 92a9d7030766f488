"""Data layer: dataset ingestion, client sharding, batch sampling.

Port of ``byzantine_aircomp_tpu/data/datasets.py``:

* the ``Dataset`` container, the numpy IDX reader and the numpy CIFAR-10
  readers (binary batches, then Python pickles; no torchvision, and no
  native parser: the JAX package's own numpy fallback);
* ``mnist``, ``mnist_hard``, ``emnist`` (byclass, 62 classes),
  ``emnist_hard``, ``cifar10`` and ``cifar10_hard``: files where the plain
  sets find them under ``DATA_ROOTS`` (IDX; ``cifar-10-batches-bin`` or
  ``cifar-10-batches-py``), else the synthetic sets; the ``_hard`` sets are
  always synthetic, with 9% label noise, which pins the Bayes ceiling at
  ``1 - 0.09*(C-1)/C``;
* the seeded synthetic fallback, drawn from the same
  ``np.random.default_rng(2021)`` stream, so its arrays are byte-identical
  to the JAX package's;
* the reference's contiguous client shards ``pieces[i] = floor(i*N/K)``
  (``MNIST_Air_weight.py:238-239``), the label-Dirichlet split and the
  Zipf quantity skew, from the same numpy streams as the JAX package's;
* per-client with-replacement batch indices (the reference's
  ``RandomSampler(replacement=True)``, ``:260-269``), computed on the
  device from uniforms drawn with an explicit ``torch.Generator``.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..registry import DATASETS

# normalization stats used by the reference transforms
MNIST_STATS = (0.1307, 0.3081)  # MNIST_Air_weight.py:555
EMNIST_STATS = (0.1736, 0.3317)  # EMNIST_Air_weight.py:563-569
CIFAR10_STATS = (
    (0.4914, 0.4822, 0.4465),
    (0.2470, 0.2435, 0.2616),
)

DATA_ROOTS = ("./dataset", "./data", os.path.expanduser("~/datasets"))


@dataclass
class Dataset:
    """Normalized train/val arrays, fully materialized.

    ``x_train_raw`` carries the 8-bit train pixels unnormalized with
    ``stats``, so the trainer can keep the train set uint8 on the device
    and normalize after the gather; ``x_train`` is the normalized f32 view
    used for eval.
    """

    name: str
    x_train: np.ndarray  # [N, ...] float32, normalized
    y_train: np.ndarray  # [N] int32
    x_val: np.ndarray
    y_val: np.ndarray
    num_classes: int
    source: str  # "disk" or "synthetic"
    x_train_raw: Optional[np.ndarray] = None  # [N, ...] uint8, unnormalized
    stats: Optional[Tuple] = None  # (mean, std) per-dataset normalization

    @property
    def input_shape(self) -> Tuple[int, ...]:
        return self.x_train.shape[1:]


# ---------------------------------------------------------------------------
# raw-format parser


def _read_idx(path: str) -> np.ndarray:
    """IDX file (optionally gzipped) -> uint8 array of its stated dims."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        _, _, ndim = struct.unpack(">HBB", f.read(4))
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find(*relpaths: str) -> Optional[str]:
    for root in DATA_ROOTS:
        for rel in relpaths:
            for cand in (os.path.join(root, rel), os.path.join(root, rel + ".gz")):
                if os.path.exists(cand):
                    return cand
    return None


def _find_dir(name: str) -> Optional[str]:
    for root in DATA_ROOTS:
        cand = os.path.join(root, name)
        if os.path.isdir(cand):
            return cand
    return None


def _load_idx_pair(img_rel, lbl_rel):
    img = _find(*img_rel)
    lbl = _find(*lbl_rel)
    if img is None or lbl is None:
        return None
    return _read_idx(img), _read_idx(lbl)


def _normalize(x_u8: np.ndarray, mean, std) -> np.ndarray:
    m = np.asarray(mean, np.float32)
    s = np.asarray(std, np.float32)
    return ((x_u8.astype(np.float32) / 255.0) - m) / s


# ---------------------------------------------------------------------------
# synthetic fallback (same stream as the JAX package's)


def _synthetic_images(
    rng: np.random.Generator,
    protos: np.ndarray,
    n: int,
    shape: Tuple[int, ...],
    stats,
    label_noise: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Class-conditional images: shared per-class prototypes + pixel noise,
    quantized to uint8 before normalization so the raw-u8 and
    normalized-f32 views agree exactly, like real 8-bit datasets.
    ``label_noise`` resamples a label uniformly over all C classes."""
    num_classes = len(protos)
    y = rng.integers(0, num_classes, size=n).astype(np.int32)
    x = protos[y] + 0.35 * rng.standard_normal((n,) + shape).astype(np.float32)
    if label_noise > 0.0:
        flip = rng.random(n) < label_noise
        y = np.where(
            flip,
            rng.integers(0, num_classes, size=n),
            y,
        ).astype(np.int32)
    u8 = np.round(np.clip(x, 0.0, 1.0) * 255.0).astype(np.uint8)
    mean, std = stats
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    return ((u8.astype(np.float32) / 255.0) - mean) / std, y, u8


def _synthetic(
    name, n_train, n_val, num_classes, shape, stats, label_noise: float = 0.0
) -> Dataset:
    rng = np.random.default_rng(2021)  # reference's fixed seed
    # prototypes are drawn ONCE and shared by train and val
    protos = rng.uniform(0.1, 0.9, size=(num_classes,) + shape).astype(np.float32)
    x_tr, y_tr, u8_tr = _synthetic_images(
        rng, protos, n_train, shape, stats, label_noise
    )
    x_va, y_va, _ = _synthetic_images(
        rng, protos, n_val, shape, stats, label_noise
    )
    return Dataset(
        name, x_tr, y_tr, x_va, y_va, num_classes, "synthetic",
        x_train_raw=u8_tr, stats=stats,
    )


@DATASETS.register("mnist")
def mnist(synthetic_train: int = 60000, synthetic_val: int = 10000, **_) -> Dataset:
    """MNIST from IDX files under ``DATA_ROOTS``, else the synthetic set."""
    pair_tr = _load_idx_pair(
        ("MNIST/raw/train-images-idx3-ubyte", "train-images-idx3-ubyte"),
        ("MNIST/raw/train-labels-idx1-ubyte", "train-labels-idx1-ubyte"),
    )
    pair_va = _load_idx_pair(
        ("MNIST/raw/t10k-images-idx3-ubyte", "t10k-images-idx3-ubyte"),
        ("MNIST/raw/t10k-labels-idx1-ubyte", "t10k-labels-idx1-ubyte"),
    )
    if pair_tr and pair_va:
        m, s = MNIST_STATS
        return Dataset(
            "mnist",
            _normalize(pair_tr[0], m, s),
            pair_tr[1].astype(np.int32),
            _normalize(pair_va[0], m, s),
            pair_va[1].astype(np.int32),
            10,
            "disk",
            x_train_raw=np.ascontiguousarray(pair_tr[0]),
            stats=MNIST_STATS,
        )
    return _synthetic("mnist", synthetic_train, synthetic_val, 10, (28, 28), MNIST_STATS)


@DATASETS.register("mnist_hard")
def mnist_hard(synthetic_train: int = 60000, synthetic_val: int = 10000, **_) -> Dataset:
    """Always-synthetic MNIST-shaped set with a 0.919 accuracy ceiling:
    uniform label resampling with p=0.09 over all 10 classes pins the
    Bayes-optimal val accuracy at 1 - p*9/10, the real-MNIST paper
    figure's operating point.  The accuracy gates run on it."""
    return _synthetic(
        "mnist_hard", synthetic_train, synthetic_val, 10, (28, 28), MNIST_STATS,
        label_noise=0.09,
    )


@DATASETS.register("emnist")
def emnist(synthetic_train: int = 100000, synthetic_val: int = 16000, **_) -> Dataset:
    """EMNIST byclass: 62 classes, 697,932 train samples when on disk
    (reference ``EMNIST_Air_weight.py:539-541``), else the synthetic set."""
    pair_tr = _load_idx_pair(
        ("EMNIST/raw/emnist-byclass-train-images-idx3-ubyte",),
        ("EMNIST/raw/emnist-byclass-train-labels-idx1-ubyte",),
    )
    pair_va = _load_idx_pair(
        ("EMNIST/raw/emnist-byclass-test-images-idx3-ubyte",),
        ("EMNIST/raw/emnist-byclass-test-labels-idx1-ubyte",),
    )
    if pair_tr and pair_va:
        m, s = EMNIST_STATS
        return Dataset(
            "emnist",
            _normalize(pair_tr[0], m, s),
            pair_tr[1].astype(np.int32),
            _normalize(pair_va[0], m, s),
            pair_va[1].astype(np.int32),
            62,
            "disk",
            x_train_raw=np.ascontiguousarray(pair_tr[0]),
            stats=EMNIST_STATS,
        )
    return _synthetic("emnist", synthetic_train, synthetic_val, 62, (28, 28), EMNIST_STATS)


@DATASETS.register("emnist_hard")
def emnist_hard(synthetic_train: int = 100000, synthetic_val: int = 16000, **_) -> Dataset:
    """Always-synthetic EMNIST-shaped set (62 classes) with the
    mnist_hard label noise: ceiling 1 - 0.09*61/62 = 0.911."""
    return _synthetic(
        "emnist_hard", synthetic_train, synthetic_val, 62, (28, 28), EMNIST_STATS,
        label_noise=0.09,
    )


def _read_cifar_bin(path: str):
    """CIFAR-10 binary batch -> (images [N, 3, 32, 32] u8, labels [N] u8),
    or None for a missing or malformed file (record: 1 label byte + 3072
    CHW pixel bytes per row)."""
    try:
        raw = np.fromfile(path, np.uint8)
    except OSError:
        return None
    if raw.size == 0 or raw.size % 3073:
        return None
    rows = raw.reshape(-1, 3073)
    return (
        np.ascontiguousarray(rows[:, 1:]).reshape(-1, 3, 32, 32),
        np.ascontiguousarray(rows[:, 0]),
    )


def _cifar10_from_bin() -> Optional[Dataset]:
    """CIFAR-10 from the binary-batch distribution."""
    root = _find_dir("cifar-10-batches-bin")
    if root is None:
        return None
    train = [
        _read_cifar_bin(os.path.join(root, f"data_batch_{i}.bin"))
        for i in range(1, 6)
    ]
    test = _read_cifar_bin(os.path.join(root, "test_batch.bin"))
    if test is None or any(p is None for p in train):
        return None
    x_tr = np.concatenate([p[0] for p in train]).transpose(0, 2, 3, 1)
    y_tr = np.concatenate([p[1] for p in train])
    x_va = test[0].transpose(0, 2, 3, 1)
    mean, std = CIFAR10_STATS
    return Dataset(
        "cifar10",
        _normalize(x_tr, mean, std),
        y_tr.astype(np.int32),
        _normalize(x_va, mean, std),
        test[1].astype(np.int32),
        10,
        "disk",
        x_train_raw=np.ascontiguousarray(x_tr),
        stats=CIFAR10_STATS,
    )


@DATASETS.register("cifar10")
def cifar10(synthetic_train: int = 50000, synthetic_val: int = 10000, **_) -> Dataset:
    """CIFAR-10 (32x32x3, NHWC) from ``cifar-10-batches-bin``, else from
    ``cifar-10-batches-py``, under ``DATA_ROOTS``; else the synthetic
    50,000 / 10,000 set."""
    from_bin = _cifar10_from_bin()
    if from_bin is not None:
        return from_bin
    root = _find_dir("cifar-10-batches-py")
    if root is not None:
        xs, ys = [], []
        for i in range(1, 6):
            with open(os.path.join(root, f"data_batch_{i}"), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"])
            ys.append(d[b"labels"])
        with open(os.path.join(root, "test_batch"), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x_tr = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        x_va = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        mean, std = CIFAR10_STATS
        return Dataset(
            "cifar10",
            _normalize(x_tr, mean, std),
            np.concatenate(ys).astype(np.int32),
            _normalize(x_va, mean, std),
            np.asarray(d[b"labels"], np.int32),
            10,
            "disk",
            x_train_raw=np.ascontiguousarray(x_tr),
            stats=CIFAR10_STATS,
        )
    return _synthetic(
        "cifar10", synthetic_train, synthetic_val, 10, (32, 32, 3), CIFAR10_STATS
    )


@DATASETS.register("cifar10_hard")
def cifar10_hard(synthetic_train: int = 50000, synthetic_val: int = 10000, **_) -> Dataset:
    """Always-synthetic CIFAR-shaped set with mnist_hard's 0.919 ceiling
    (9% uniform label resampling over the 10 classes)."""
    return _synthetic(
        "cifar10_hard", synthetic_train, synthetic_val, 10, (32, 32, 3),
        CIFAR10_STATS, label_noise=0.09,
    )


def load(name: str, **kw) -> Dataset:
    return DATASETS.get(name)(**kw)


# ---------------------------------------------------------------------------
# client sharding + sampling


@dataclass(frozen=True)
class ClientSharding:
    """Contiguous equal slices: client i owns [offsets[i], offsets[i]+sizes[i])."""

    offsets: np.ndarray  # [K] int32
    sizes: np.ndarray  # [K] int32


def contiguous_shards(n: int, k: int) -> ClientSharding:
    pieces = np.array([(i * n) // k for i in range(k + 1)], dtype=np.int64)
    return ClientSharding(
        offsets=pieces[:-1].astype(np.int32),
        sizes=np.diff(pieces).astype(np.int32),
    )


def dirichlet_shards(
    labels: np.ndarray, k: int, alpha: float, seed: int = 0
) -> Tuple[np.ndarray, ClientSharding]:
    """Label-skewed non-IID partition (Hsu et al. 2019, arXiv:1909.06335):
    each class's samples are split among the K clients with proportions
    drawn from Dirichlet(alpha).  Returns ``(perm, sharding)``: client i
    owns the permuted index range ``[offsets[i], offsets[i] + sizes[i])``,
    so the caller permutes the train arrays once and samples contiguous
    shards as before.  A client left empty by the draw takes one sample
    from the largest shard (the sampler needs nonempty shards)."""
    labels = np.asarray(labels)
    if len(labels) < k:
        raise ValueError(
            f"dirichlet_shards needs >= 1 sample per client "
            f"(n={len(labels)} < k={k})"
        )
    rng = np.random.default_rng(seed)
    per_client = [[] for _ in range(k)]
    for c in np.unique(labels):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        p = rng.dirichlet(np.full(k, float(alpha)))
        counts = np.floor(p * len(idx)).astype(np.int64)
        frac = p * len(idx) - counts
        short = len(idx) - int(counts.sum())
        counts[np.argsort(-frac)[:short]] += 1
        for i, part in enumerate(np.split(idx, np.cumsum(counts)[:-1])):
            per_client[i].append(part)
    shards = [np.concatenate(parts) for parts in per_client]
    for i, s in enumerate(shards):
        if len(s) == 0:
            donor = int(np.argmax([len(t) for t in shards]))
            shards[i], shards[donor] = shards[donor][:1], shards[donor][1:]
    sizes = np.array([len(s) for s in shards], dtype=np.int32)
    offsets = np.concatenate([[0], np.cumsum(sizes[:-1], dtype=np.int64)])
    return np.concatenate(shards), ClientSharding(
        offsets=offsets.astype(np.int32), sizes=sizes
    )


def zipf_shards(n: int, k: int, s: float) -> ClientSharding:
    """Quantity-skewed contiguous cut: client i (1-based) owns a share
    proportional to ``i^-s``, boundaries ``floor(n * W_i / W_k)`` with
    ``W_i = sum_{j<=i} j^-s``; ``s = 0`` is :func:`contiguous_shards`
    exactly.  Every client keeps >= 1 sample (needs ``n >= k``)."""
    if n < k:
        raise ValueError(
            f"zipf_shards needs >= 1 sample per client (n={n} < k={k})"
        )
    if s < 0:
        raise ValueError(f"zipf exponent must be >= 0, got {s}")
    w = np.arange(1, k + 1, dtype=np.float64) ** (-float(s))
    cum = np.concatenate([[0.0], np.cumsum(w)])
    pieces = np.floor(n * cum / cum[-1]).astype(np.int64)
    pieces[-1] = n  # a float round-down at the tail
    for i in range(1, k + 1):  # >= 1 sample per client
        if pieces[i] <= pieces[i - 1]:
            pieces[i] = pieces[i - 1] + 1
    for i in range(k, 0, -1):  # the bumped tail stays inside n
        if pieces[i] > n - (k - i):
            pieces[i] = n - (k - i)
    return ClientSharding(
        offsets=pieces[:-1].astype(np.int32),
        sizes=np.diff(pieces).astype(np.int32),
    )


def parse_size_skew(spec: str) -> Optional[float]:
    """``"none"`` -> None, ``"zipf:<s>"`` -> s (s >= 0)."""
    if spec == "none":
        return None
    if not spec.startswith("zipf:"):
        raise ValueError(f"size_skew must be 'none' or 'zipf:<s>', got {spec!r}")
    s = float(spec.split(":", 1)[1])
    if s < 0:
        raise ValueError(f"zipf exponent must be >= 0, got {s}")
    return s


def sample_client_batch_indices(
    offsets: torch.Tensor,
    sizes: torch.Tensor,
    batch_size: int,
    *,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[K, batch] global indices, uniform with replacement within each
    client's shard.  ``u`` [K, batch] f32 uniforms in [0, 1) may be passed
    in (tests feed the JAX package's draws); otherwise they are drawn from
    ``generator`` on the device of ``offsets``."""
    k = offsets.shape[0]
    if u is None:
        u = torch.rand(
            (k, batch_size), generator=generator, device=offsets.device,
            dtype=torch.float32,
        )
    local = torch.floor(u * sizes[:, None].to(torch.float32)).to(torch.int64)
    local = torch.minimum(local, sizes[:, None].to(torch.int64) - 1)  # u==1.0 guard
    return offsets[:, None].to(torch.int64) + local
