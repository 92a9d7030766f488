"""Data layer: MNIST ingestion, client sharding, batch sampling.

Port of the main-path parts of ``byzantine_aircomp_tpu/data/datasets.py``:

* the ``Dataset`` container and the numpy IDX reader (no torchvision);
* ``mnist``, ``mnist_hard``, ``emnist`` (byclass, 62 classes) and
  ``emnist_hard``: IDX files where the plain sets find them on disk, else
  the synthetic sets; the ``_hard`` sets are always synthetic, with 9%
  label noise, which pins the Bayes ceiling at ``1 - 0.09*(C-1)/C``;
* the seeded synthetic fallback, drawn from the same
  ``np.random.default_rng(2021)`` stream, so its arrays are byte-identical
  to the JAX package's;
* the reference's contiguous client shards ``pieces[i] = floor(i*N/K)``
  (``MNIST_Air_weight.py:238-239``);
* per-client with-replacement batch indices (the reference's
  ``RandomSampler(replacement=True)``, ``:260-269``), computed on the
  device from uniforms drawn with an explicit ``torch.Generator``.
"""

from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..registry import DATASETS

# normalization stats used by the reference transforms
MNIST_STATS = (0.1307, 0.3081)  # MNIST_Air_weight.py:555
EMNIST_STATS = (0.1736, 0.3317)  # EMNIST_Air_weight.py:563-569

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
