"""``--backend ref``: a NumPy oracle training loop (MLP and CNN).

The port's copy of ``byzantine_aircomp_tpu/backends/ref_trainer.py``, over
the port's data layer (:mod:`..data.datasets`, whose ``Dataset`` holds
NumPy arrays) and the port's :class:`..fed.config.FedConfig`; NumPy only,
no torch in the loop and no device.  A loop-style NumPy transcription of
the reference's ``SGD`` round loop (``MNIST_Air_weight.py:226-372``): per
client manual gradients, the same attack/channel/aggregation order, the
same contiguous sharding and with-replacement sampling.  Deliberately
simple and slow: it exists to be obviously correct.

Models: the linear MLP (softmax regression, reference ``:53-62``) and the
CNN (conv5x5/32 + pool -> conv5x5/64 + pool -> fc -> fc, reference
``:63-90``) as explicit im2col NumPy forward/backward.  Both models' flat
parameter layouts are the JAX package's (its flax leaf order: Conv_0/bias,
Conv_0/kernel, Conv_1/bias, Conv_1/kernel, Dense_0/bias, Dense_0/kernel,
Dense_1/bias, Dense_1/kernel), which the port's ``ops/flatten.py`` keeps.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from ..data import datasets as data_lib
from ..fed.config import FedConfig
from . import numpy_ref


def _softmax(z):
    z = z - z.max(axis=1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=1, keepdims=True)


def _ce_loss(logits, y):
    p = _softmax(logits)
    return -np.log(np.maximum(p[np.arange(len(y)), y], 1e-12))


def _xavier_normal_relu(rng, shape, fan_in, fan_out):
    # xavier-normal with relu gain (reference weights_init, :92-95)
    std = np.sqrt(2.0) * np.sqrt(2.0 / (fan_in + fan_out))
    return rng.normal(0.0, std, shape).astype(np.float32)


class _NumpyMLP:
    """Softmax regression (reference MLP, :53-62): flat = [b, w.ravel()],
    the flax FlatSpec leaf order (alphabetical: Dense_0/bias, Dense_0/kernel)
    so oracle and JAX gradients compare on the SAME flat vector."""

    def __init__(self, d_in: int, n_cls: int):
        self.d_in, self.n_cls = d_in, n_cls

    def prepare(self, x):
        return x.reshape(len(x), -1)

    def init(self, rng) -> np.ndarray:
        w = _xavier_normal_relu(rng, (self.d_in, self.n_cls), self.d_in, self.n_cls)
        b = np.full((self.n_cls,), 0.01, np.float32)
        return np.concatenate([b, w.reshape(-1)])

    def _unpack(self, flat):
        n = self.n_cls
        return flat[n:].reshape(self.d_in, n), flat[:n]

    def logits(self, flat, x):
        w, b = self._unpack(flat)
        return x @ w + b

    def grad(self, flat, x, y):
        w, b = self._unpack(flat)
        delta = _softmax(x @ w + b)
        delta[np.arange(len(y)), y] -= 1.0
        delta /= len(y)
        return np.concatenate([delta.sum(axis=0), (x.T @ delta).reshape(-1)])


def _im2col(x: np.ndarray, kh: int, kw: int, pad: int) -> np.ndarray:
    """[B,H,W,C] -> [B,H,W,kh*kw*C] patches (stride 1, SAME-style pad),
    ordered (h, w, c) to match a flax [kh,kw,C,F] kernel reshaped to
    [kh*kw*C, F]."""
    b, h, w, c = x.shape
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    win = np.lib.stride_tricks.sliding_window_view(xp, (kh, kw), axis=(1, 2))
    # win: [B, H, W, C, kh, kw] -> [B, H, W, kh, kw, C]
    win = win.transpose(0, 1, 2, 4, 5, 3)
    return win.reshape(b, h, w, kh * kw * c)


def _col2im(g_patches: np.ndarray, shape, kh: int, kw: int, pad: int) -> np.ndarray:
    """Adjoint of :func:`_im2col`: scatter-add patch gradients back."""
    b, h, w, c = shape
    gp = g_patches.reshape(b, h, w, kh, kw, c)
    out = np.zeros((b, h + 2 * pad, w + 2 * pad, c), np.float32)
    for i in range(kh):
        for j in range(kw):
            out[:, i : i + h, j : j + w, :] += gp[:, :, :, i, j, :]
    return out[:, pad : pad + h, pad : pad + w, :]


def _maxpool2(x: np.ndarray):
    """2x2/2 max pool on [B,H,W,C]; returns (pooled, argmax mask).

    Ties (e.g. relu-zeroed windows) keep the FIRST max in row-major window
    order, matching XLA select_and_scatter."""
    b, h, w, c = x.shape
    win = x.reshape(b, h // 2, 2, w // 2, 2, c)
    pooled = win.max(axis=(2, 4))
    eq = win == pooled[:, :, None, :, None, :]  # [b,h2,i,w2,j,c]
    eqf = eq.transpose(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4, c)
    first = (np.cumsum(eqf, axis=3) == 1) & eqf  # first True along (i,j)
    mask = first.reshape(b, h // 2, w // 2, 2, 2, c).transpose(0, 1, 3, 2, 4, 5)
    return pooled, mask


def _maxpool2_back(g: np.ndarray, mask: np.ndarray) -> np.ndarray:
    b, hh, _, ww, _, c = mask.shape
    return (mask * g[:, :, None, :, None, :]).reshape(b, hh * 2, ww * 2, c)


class _NumpyCNN:
    """Reference CNN (:63-90) in explicit im2col NumPy, NHWC.

    Flat layout mirrors the flax FlatSpec leaf order (dict keys sorted):
    b1, k1[5,5,C,32], b2, k2[5,5,32,64], fb1, fk1[fc_in,W], fb2, fk2[W,n]."""

    def __init__(self, h: int, w: int, c_in: int, n_cls: int, fc_width: int):
        assert h % 4 == 0 and w % 4 == 0, "two 2x2 pools need H, W % 4 == 0"
        self.h, self.w, self.c_in = h, w, c_in
        self.n_cls, self.fc_width = n_cls, fc_width
        self.fc_in = (h // 4) * (w // 4) * 64
        shapes = [
            (32,), (5, 5, c_in, 32),
            (64,), (5, 5, 32, 64),
            (fc_width,), (self.fc_in, fc_width),
            (n_cls,), (fc_width, n_cls),
        ]
        self.shapes = shapes
        self.sizes = [int(np.prod(s)) for s in shapes]
        self.offsets = np.cumsum([0] + self.sizes[:-1]).tolist()

    def prepare(self, x):
        return x if x.ndim == 4 else x[..., None]

    def init(self, rng) -> np.ndarray:
        c = self.c_in
        parts = [
            np.full((32,), 0.01, np.float32),
            _xavier_normal_relu(rng, (5, 5, c, 32), 25 * c, 25 * 32),
            np.full((64,), 0.01, np.float32),
            _xavier_normal_relu(rng, (5, 5, 32, 64), 25 * 32, 25 * 64),
            np.full((self.fc_width,), 0.01, np.float32),
            _xavier_normal_relu(
                rng, (self.fc_in, self.fc_width), self.fc_in, self.fc_width
            ),
            np.full((self.n_cls,), 0.01, np.float32),
            _xavier_normal_relu(
                rng, (self.fc_width, self.n_cls), self.fc_width, self.n_cls
            ),
        ]
        return np.concatenate([p.reshape(-1) for p in parts])

    def _unpack(self, flat):
        return [
            flat[o : o + s].reshape(shape)
            for o, s, shape in zip(self.offsets, self.sizes, self.shapes)
        ]

    def _forward(self, flat, x):
        b1, k1, b2, k2, fb1, fk1, fb2, fk2 = self._unpack(flat)
        b = len(x)
        p1 = _im2col(x, 5, 5, 2)  # [B,H,W,25C]
        z1 = p1 @ k1.reshape(-1, 32) + b1
        a1 = np.maximum(z1, 0.0)
        q1, m1 = _maxpool2(a1)
        p2 = _im2col(q1, 5, 5, 2)
        z2 = p2 @ k2.reshape(-1, 64) + b2
        a2 = np.maximum(z2, 0.0)
        q2, m2 = _maxpool2(a2)
        f = q2.reshape(b, -1)
        z3 = f @ fk1 + fb1
        a3 = np.maximum(z3, 0.0)
        logits = a3 @ fk2 + fb2
        cache = (x, p1, z1, q1, m1, p2, z2, m2, q2, f, z3, a3)
        return logits, cache

    def logits(self, flat, x):
        return self._forward(flat, x)[0]

    def grad(self, flat, x, y):
        _, k1, _, k2, _, fk1, _, fk2 = self._unpack(flat)
        logits, cache = self._forward(flat, x)
        x_, p1, z1, q1, m1, p2, z2, m2, q2, f, z3, a3 = cache
        n = len(y)
        delta = _softmax(logits)
        delta[np.arange(n), y] -= 1.0
        delta /= n  # dL/dlogits, mean CE
        g_fk2 = a3.T @ delta
        g_fb2 = delta.sum(axis=0)
        g_a3 = delta @ fk2.T
        g_z3 = g_a3 * (z3 > 0)
        g_fk1 = f.T @ g_z3
        g_fb1 = g_z3.sum(axis=0)
        g_f = g_z3 @ fk1.T
        g_q2 = g_f.reshape(q2.shape)
        g_a2 = _maxpool2_back(g_q2, m2)
        g_z2 = g_a2 * (z2 > 0)
        g_k2 = p2.reshape(-1, p2.shape[-1]).T @ g_z2.reshape(-1, 64)
        g_b2 = g_z2.sum(axis=(0, 1, 2))
        g_p2 = g_z2 @ k2.reshape(-1, 64).T
        g_q1 = _col2im(g_p2, q1.shape, 5, 5, 2)
        g_a1 = _maxpool2_back(g_q1, m1)
        g_z1 = g_a1 * (z1 > 0)
        g_k1 = p1.reshape(-1, p1.shape[-1]).T @ g_z1.reshape(-1, 32)
        g_b1 = g_z1.sum(axis=(0, 1, 2))
        parts = [
            g_b1, g_k1.reshape(5, 5, self.c_in, 32),
            g_b2, g_k2.reshape(5, 5, 32, 64),
            g_fb1, g_fk1, g_fb2, g_fk2,
        ]
        return np.concatenate([p.reshape(-1) for p in parts]).astype(np.float32)


def _make_model(cfg: FedConfig, ds) -> object:
    sample = ds.x_train[:1]
    n_cls = ds.num_classes
    if cfg.model == "MLP":
        return _NumpyMLP(int(np.prod(sample.shape[1:])), n_cls)
    if cfg.model in ("CNN", "cnn"):
        if sample.ndim == 3:
            h, w, c = sample.shape[1], sample.shape[2], 1
        else:
            h, w, c = sample.shape[1], sample.shape[2], sample.shape[3]
        return _NumpyCNN(h, w, c, n_cls, cfg.fc_width)
    raise KeyError(f"ref backend: unknown model {cfg.model!r} (MLP or CNN)")


def _eval_model(model, flat, x, y, batch: int = 1024):
    losses, correct = 0.0, 0
    for lo in range(0, len(x), batch):
        xb, yb = x[lo : lo + batch], y[lo : lo + batch]
        logits = model.logits(flat, xb)
        losses += float(_ce_loss(logits, yb).sum())
        correct += int((logits.argmax(axis=1) == yb).sum())
    return losses / len(x), correct / len(x)


def run_ref(cfg: FedConfig, log_fn=print, dataset=None) -> Dict:
    if cfg.attack is None:
        cfg.byz_size = 0
    cfg.validate()
    if cfg.fault is not None:
        # the NumPy oracle reproduces the reference line-by-line; the
        # reference has no fault model, so an oracle run with faults on
        # would silently compare against a DIFFERENT program
        raise NotImplementedError(
            "ref backend has no fault-injection path; run --backend torch "
            "or drop --fault"
        )
    _KNOWN_ATTACKS = {
        "classflip", "dataflip", "gradascent", "weightflip", "signflip",
        "alie", "ipm", "gaussian", "minmax", "minsum",
    }
    if cfg.attack is not None and cfg.attack not in _KNOWN_ATTACKS:
        raise KeyError(
            f"ref backend: unknown attack {cfg.attack!r}; known: "
            f"{sorted(_KNOWN_ATTACKS)}"
        )
    # same contract as AttackSpec.param_name
    _PARAM_ATTACKS = {"alie", "ipm", "gaussian", "minmax", "minsum"}
    if cfg.attack_param is not None and cfg.attack not in _PARAM_ATTACKS:
        raise ValueError(
            f"attack {cfg.attack!r} takes no scalar parameter"
        )

    ds = dataset if dataset is not None else data_lib.load(cfg.dataset)
    n_cls = ds.num_classes
    model = _make_model(cfg, ds)
    x_tr = model.prepare(ds.x_train)
    y_tr = ds.y_train
    x_va = model.prepare(ds.x_val)
    y_va = ds.y_val

    k = cfg.node_size
    if cfg.partition == "dirichlet":
        # same derivation (seed, alpha) as the torch trainer, so both
        # backends train on the identical non-IID split
        perm, shards = data_lib.dirichlet_shards(
            y_tr, k, cfg.dirichlet_alpha, seed=cfg.seed
        )
        x_tr = x_tr[perm]
        y_tr = np.asarray(y_tr)[perm]
    else:
        shards = data_lib.contiguous_shards(len(x_tr), k)

    rng = np.random.default_rng(cfg.seed)
    flat = model.init(rng)

    tr = _eval_model(model, flat, x_tr, y_tr) if cfg.eval_train else (0.0, 0.0)
    va = _eval_model(model, flat, x_va, y_va)
    paths: Dict[str, List[float]] = {
        "trainLossPath": [tr[0]],
        "trainAccPath": [tr[1]],
        "valLossPath": [va[0]],
        "valAccPath": [va[1]],
        "variencePath": [],
        "roundsPerSec": [],
    }
    log_fn(f"[ref backend] round 0: val loss={va[0]:.4f} acc={va[1]:.4f}")

    # FedOpt server state (mirrors fed/train.py's optax transforms exactly:
    # sgd-with-trace momentum, adam with bias correction, over the
    # pseudo-gradient delta = w_round_start - aggregate)
    server_m = np.zeros_like(flat)
    server_v = np.zeros_like(flat)
    server_t = 0

    byz0 = cfg.honest_size  # Byzantine clients are the last byz_size rows
    # partial participation: stratified per-iteration draw, mirroring
    # fed/train.py (round(f*H) honest + round(f*B) Byzantine rows; the
    # RNG streams differ across backends as everywhere else — parity on
    # participation configs is distributional, not bitwise)
    part_h, part_b = cfg.participant_counts()
    # client momentum buffer (cfg.client_momentum doc): [K, d], zeros init
    client_m = (
        np.zeros((k, flat.size), np.float32) if cfg.client_momentum else None
    )
    for r in range(cfg.rounds):
        t0 = time.perf_counter()
        for _ in range(cfg.display_interval):
            if cfg.participation < 1.0:
                participants = np.concatenate([
                    rng.permutation(cfg.honest_size)[:part_h],
                    byz0 + rng.permutation(cfg.byz_size)[:part_b],
                ]).astype(np.int64)
            else:
                participants = np.arange(k)
            w_stack = np.empty((len(participants), flat.size), np.float32)
            for row, node in enumerate(participants):
                lo = shards.offsets[node]
                # local_steps > 1 = FedAvg regime (fed/train.py
                # _per_client_weights): E local SGD steps, each on a fresh
                # with-replacement batch; data/gradient attacks apply at
                # every local step; fedprox pulls toward the round start
                w_c = flat
                for _e in range(cfg.local_steps):
                    idx = lo + rng.integers(0, shards.sizes[node], cfg.batch_size)
                    xb, yb = x_tr[idx], y_tr[idx]
                    if node >= byz0 and cfg.attack == "classflip":
                        yb = (n_cls - 1) - yb
                    elif node >= byz0 and cfg.attack == "dataflip":
                        xb = 1.0 - xb
                    g = model.grad(w_c, xb, yb)
                    if node >= byz0 and cfg.attack == "gradascent":
                        g = -g
                    if client_m is not None:
                        # momentum-SGD client step (local_steps == 1 by
                        # validation): m <- beta*m + (1-beta)*(g + wd*w)
                        beta = cfg.client_momentum
                        g_tot = g + cfg.weight_decay * w_c
                        client_m[node] = (
                            beta * client_m[node] + (1.0 - beta) * g_tot
                        )
                        w_c = flat - cfg.gamma * client_m[node]
                        continue
                    if cfg.fedprox_mu:
                        g = g + cfg.fedprox_mu * (w_c - flat)
                    w_c = w_c - cfg.gamma * (g + cfg.weight_decay * w_c)
                w_stack[row] = w_c

            if cfg.attack == "weightflip" and part_b:
                w_stack = numpy_ref.weightflip(w_stack, part_b)
            elif cfg.attack == "signflip" and part_b:
                w_stack[-part_b :] *= -1.0
            elif cfg.attack == "alie" and part_b:
                z = 1.5 if cfg.attack_param is None else cfg.attack_param
                w_stack = numpy_ref.alie(w_stack, part_b, z=z)
            elif cfg.attack == "ipm" and part_b:
                eps = 0.5 if cfg.attack_param is None else cfg.attack_param
                w_stack = numpy_ref.ipm(w_stack, part_b, eps=eps)
            elif cfg.attack == "gaussian" and part_b:
                sigma = 1.0 if cfg.attack_param is None else cfg.attack_param
                w_stack[-part_b :] = sigma * rng.normal(
                    size=(part_b, flat.size)
                ).astype(np.float32)
            elif cfg.attack == "minmax" and part_b:
                w_stack = numpy_ref.minmax(
                    w_stack, part_b, gamma=cfg.attack_param
                )
            elif cfg.attack == "minsum" and part_b:
                w_stack = numpy_ref.minsum(
                    w_stack, part_b, gamma=cfg.attack_param
                )

            # channel-dispatch rule (mirrors ops.aggregators.needs_oma_prepass):
            # gm and signmv run their own over-the-air transmission
            if cfg.noise_var is not None and cfg.agg not in ("gm", "signmv"):
                w_stack = numpy_ref.oma(rng, w_stack, cfg.noise_var)

            # bucketing (fed/train.py's bucketing scope): aggregate the
            # [m/s, d] random-bucket means with the worst-case clean count
            agg_stack, agg_h = w_stack, part_h
            if cfg.bucket_size > 1:
                s_b = cfg.bucket_size
                m_rows = len(w_stack)
                bperm = rng.permutation(m_rows)
                agg_stack = (
                    w_stack[bperm]
                    .reshape(m_rows // s_b, s_b, -1)
                    .mean(axis=1)
                    .astype(np.float32)
                )
                agg_h = m_rows // s_b - part_b

            if cfg.agg == "gm":
                agg_out = numpy_ref.gm(
                    rng,
                    agg_stack,
                    noise_var=cfg.noise_var,
                    guess=flat,
                    maxiter=cfg.agg_maxiter,
                    tol=cfg.agg_tol,
                    p_max=cfg.gm_p_max,
                ).astype(np.float32)
            elif cfg.agg == "gm2":
                agg_out = numpy_ref.gm2(
                    agg_stack, guess=flat, maxiter=cfg.agg_maxiter, tol=cfg.agg_tol
                ).astype(np.float32)
            elif cfg.agg == "mean":
                agg_out = numpy_ref.mean(agg_stack)
            elif cfg.agg == "median":
                agg_out = numpy_ref.median(agg_stack)
            elif cfg.agg == "trimmed_mean":
                agg_out = numpy_ref.trimmed_mean(agg_stack)
            elif cfg.agg in ("krum", "Krum"):
                agg_out = numpy_ref.krum(agg_stack, agg_h).copy()
            elif cfg.agg == "multi_krum":
                agg_out = numpy_ref.multi_krum(agg_stack, agg_h, m=cfg.krum_m)
            elif cfg.agg == "bulyan":
                agg_out = numpy_ref.bulyan(agg_stack, agg_h)
            elif cfg.agg == "cclip":
                agg_out = numpy_ref.centered_clip(
                    agg_stack, guess=flat,
                    clip_tau=cfg.clip_tau, clip_iters=cfg.clip_iters,
                )
            elif cfg.agg == "dnc":
                agg_out = numpy_ref.dnc(
                    agg_stack, agg_h, rng, dnc_iters=cfg.dnc_iters,
                    dnc_sub_dim=cfg.dnc_sub_dim, dnc_c=cfg.dnc_c,
                )
            elif cfg.agg == "signmv":
                agg_out = numpy_ref.sign_majority_vote(
                    agg_stack, guess=flat, noise_var=cfg.noise_var,
                    sign_eta=cfg.sign_eta, rng=rng,
                )
            else:
                raise KeyError(f"ref backend: unknown aggregator {cfg.agg!r}")

            # server optimizer over the pseudo-gradient (FedAvgM / FedAdam;
            # fed/train.py:331-339 with optax.sgd(momentum)/optax.adam)
            if cfg.server_opt == "momentum":
                delta = flat - agg_out
                # optax trace: m <- delta + beta * m; update = -lr * m
                server_m = delta + cfg.server_momentum * server_m
                flat = (flat - cfg.server_lr * server_m).astype(np.float32)
            elif cfg.server_opt == "adam":
                delta = flat - agg_out
                server_t += 1
                b1, b2, eps = 0.9, 0.999, 1e-8
                server_m = b1 * server_m + (1.0 - b1) * delta
                server_v = b2 * server_v + (1.0 - b2) * delta * delta
                mhat = server_m / (1.0 - b1**server_t)
                vhat = server_v / (1.0 - b2**server_t)
                flat = (
                    flat - cfg.server_lr * mhat / (np.sqrt(vhat) + eps)
                ).astype(np.float32)
            else:  # "none": take the aggregate (reference :354-358)
                flat = agg_out

        w_h = w_stack[:part_h]
        variance = float(((w_h - w_h.mean(axis=0)) ** 2).sum(axis=1).mean())
        dt = time.perf_counter() - t0

        tr = _eval_model(model, flat, x_tr, y_tr) if cfg.eval_train else (0.0, 0.0)
        va = _eval_model(model, flat, x_va, y_va)
        paths["trainLossPath"].append(tr[0])
        paths["trainAccPath"].append(tr[1])
        paths["valLossPath"].append(va[0])
        paths["valAccPath"].append(va[1])
        paths["variencePath"].append(variance)
        paths["roundsPerSec"].append(1.0 / dt)
        log_fn(
            f"[ref backend] round {r + 1}/{cfg.rounds}: "
            f"train acc={tr[1]:.4f} val acc={va[1]:.4f}"
        )
    return paths
