"""The port's NumPy referee (``backends/numpy_ref.py``, ``backends/ref_trainer.py``,
``--backend ref``) against the JAX package's on the CPU.

The port's ``numpy_ref`` is the JAX package's program line for line, so
every function gives the same bits on the same inputs; the two
``run_ref`` loops give the same records (the round timings apart) on the
same configs.  The port's torch rules are held against the port's
referee within f32 tolerances (the referee sums in NumPy's order, partly
in f64): the Weiszfeld rules rtol 1e-4, the means atol 1e-6, the median
and krum's row bitwise.
"""

import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from byzantine_aircomp_tpu.backends import numpy_ref as jref
from byzantine_aircomp_tpu.backends.ref_trainer import run_ref as jax_run_ref
from byzantine_aircomp_tpu.data import datasets as jdata
from byzantine_aircomp_tpu.fed.config import FedConfig as JaxFedConfig
from byzantine_aircomp_tpu_torch.backends import numpy_ref as tref
from byzantine_aircomp_tpu_torch.backends.ref_trainer import run_ref
from byzantine_aircomp_tpu_torch.data import datasets as tdata
from byzantine_aircomp_tpu_torch.fed.config import FedConfig
from byzantine_aircomp_tpu_torch.ops import aggregators as tagg

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread for the torch side's small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stack(k, d, seed, spread=1e-3):
    rng = np.random.default_rng(seed)
    base = 0.01 * rng.standard_normal((1, d))
    w = (base + spread * rng.standard_normal((k, d))).astype(np.float32)
    g = (w.mean(axis=0) + spread * rng.standard_normal(d)).astype(np.float32)
    return w, g


K, D, B = 12, 300, 3
W, G = _stack(K, D, seed=3)
W_BAD = W.copy()
W_BAD[-1, 4] = np.nan
EMA = np.abs(np.random.default_rng(1).standard_normal(K)).astype(np.float32)
CUSUM = np.abs(np.random.default_rng(2).standard_normal(K)).astype(np.float32)
DEV = 0.1 + EMA / 2


def _rng():
    return np.random.default_rng(7)


# every public function of numpy_ref, called the same way on both modules
CALLS = {
    "mean": lambda m: m.mean(W),
    "median": lambda m: m.median(W_BAD),
    "trimmed_mean": lambda m: m.trimmed_mean(W, trim_ratio=0.2),
    "krum": lambda m: m.krum(W_BAD, K - B),
    "multi_krum": lambda m: m.multi_krum(W, K - B, m=5),
    "gm2": lambda m: m.gm2(W_BAD, guess=G, maxiter=50, tol=1e-7),
    "oma": lambda m: m.oma(_rng(), W, 1e-2),
    "oma2": lambda m: m.oma2(_rng(), W, p_max=1.0, noise_var=1e-2),
    "gm": lambda m: m.gm(_rng(), W, noise_var=1e-2, guess=G, maxiter=30, tol=1e-3),
    "weightflip": lambda m: m.weightflip(W, B),
    "bulyan": lambda m: m.bulyan(W, K - 2),
    "dnc": lambda m: m.dnc(W, K - B, _rng(), dnc_iters=2, dnc_sub_dim=100),
    "sign_majority_vote": lambda m: m.sign_majority_vote(W_BAD, G, noise_var=1e-2,
                                                         sign_eta=0.01, rng=_rng()),
    "pack_signs": lambda m: m.pack_signs(W_BAD, G),
    "packed_vote_counts": lambda m: m.packed_vote_counts(m.pack_signs(W, G)[0], D),
    "packed_sign_step": lambda m: m.packed_sign_step(W_BAD, G, 0.01),
    "centered_clip": lambda m: m.centered_clip(W_BAD, guess=G),
    "alie": lambda m: m.alie(W, B),
    "ipm": lambda m: m.ipm(W, B),
    "minmax": lambda m: m.minmax(W, B),
    "minsum": lambda m: m.minsum(W, B),
    "bev": lambda m: m.bev(W_BAD, G),
    "defense_client_scores": lambda m: m.defense_client_scores(W_BAD, G),
    "mimic": lambda m: m.mimic(W, B, EMA, CUSUM),
    "under_radar": lambda m: m.under_radar(W, B, 10, EMA, DEV, CUSUM, G),
}


def test_the_calls_cover_every_public_function():
    public = {name for name, fn in inspect.getmembers(tref, inspect.isfunction)
              if fn.__module__ == tref.__name__ and not name.startswith("_")}
    assert public == set(CALLS)


def _flat(out):
    return [np.asarray(x) for x in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("name", sorted(CALLS))
def test_numpy_ref_is_jax_s_bitwise(name):
    got, want = _flat(CALLS[name](tref)), _flat(CALLS[name](jref))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b, equal_nan=True), name


@pytest.mark.parametrize("name,kw,rtol,atol", [
    ("mean", {}, 0, 1e-6),
    ("trimmed_mean", {}, 0, 1e-6),
    ("gm2", dict(maxiter=200, tol=1e-7), 1e-4, 1e-7),
    ("multi_krum", dict(m=5), 0, 1e-6),
    ("bulyan", {}, 0, 1e-6),
    ("cclip", {}, 0, 1e-6),
])
def test_the_torch_rules_match_the_port_s_referee(name, kw, rtol, atol):
    wt, gt = torch.from_numpy(W), torch.from_numpy(G)
    if name == "mean":
        got, want = tagg.mean(wt), tref.mean(W)
    elif name == "trimmed_mean":
        got, want = tagg.trimmed_mean(wt), tref.trimmed_mean(W)
    elif name == "gm2":
        got = tagg.gm2(wt, guess=gt, **kw)
        want = tref.gm2(W, guess=G, **kw)
    elif name == "multi_krum":
        got = tagg.multi_krum(wt, honest_size=K - B, **kw)
        want = tref.multi_krum(W, K - B, **kw)
    elif name == "bulyan":
        got, want = tagg.bulyan(wt, honest_size=K - 2), tref.bulyan(W, K - 2)
    else:
        got = tagg.centered_clip(wt, guess=gt)
        want = tref.centered_clip(W, guess=G)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


def test_the_selections_match_the_port_s_referee_bitwise():
    wt = torch.from_numpy(W_BAD)
    assert np.array_equal(tagg.median(wt).numpy(), tref.median(W_BAD).astype(np.float32),
                          equal_nan=True)
    assert np.array_equal(tagg.krum(wt, honest_size=K - B).numpy(), tref.krum(W_BAD, K - B))


_REF_KW = [
    pytest.param(dict(model="MLP", agg="gm2", attack="classflip", honest_size=6,
                      byz_size=2, agg_maxiter=50), "mnist", id="mlp_gm2_classflip"),
    pytest.param(dict(model="MLP", agg="gm", attack="classflip", noise_var=1e-2,
                      honest_size=8, byz_size=2, agg_maxiter=20, agg_tol=1e-3),
                 "mnist_hard", id="mlp_gm_var_classflip"),
    pytest.param(dict(model="MLP", agg="median", attack="alie", noise_var=1e-2,
                      honest_size=8, byz_size=2, server_opt="adam", server_lr=0.01),
                 "mnist", id="mlp_median_alie_adam"),
    pytest.param(dict(model="CNN", fc_width=32, agg="gm2", attack="classflip",
                      honest_size=3, byz_size=1, agg_maxiter=20), "mnist", id="cnn_gm2"),
]


@pytest.mark.parametrize("kw,dataset", _REF_KW)
def test_run_ref_equals_jax_s(kw, dataset):
    common = dict(rounds=2, display_interval=2, batch_size=8, dataset=dataset,
                  eval_train=kw["model"] == "MLP")
    sizes = dict(synthetic_train=400, synthetic_val=100)
    quiet = lambda *a, **k: None  # noqa: E731
    got = run_ref(FedConfig(**common, **kw), log_fn=quiet,
                  dataset=tdata.load(dataset, **sizes))
    want = jax_run_ref(JaxFedConfig(**common, **kw), log_fn=quiet,
                       dataset=jdata.load(dataset, **sizes))
    assert set(got) == set(want)
    for key in got:
        if key != "roundsPerSec":
            assert got[key] == want[key], key
    assert len(got["valAccPath"]) == 3 and len(got["roundsPerSec"]) == 2


def test_run_ref_keeps_the_jax_refusals():
    ds = tdata.load("mnist", synthetic_train=100, synthetic_val=50)
    with pytest.raises(NotImplementedError, match="no fault-injection path"):
        run_ref(FedConfig(honest_size=4, agg="gm2", fault="chaos"), dataset=ds)
    with pytest.raises(KeyError, match="unknown attack"):
        run_ref(FedConfig(honest_size=4, byz_size=1, attack="signflip@1", agg="gm2"),
                dataset=ds)


_BLOCKED = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "byzantine_aircomp_tpu"):
    sys.modules[name] = None  # any import of them raises
from byzantine_aircomp_tpu_torch import cli
paths = cli.main(sys.argv[1:])
assert len(paths["valAccPath"]) == 2, paths
assert not any(m.split(".")[0] == "jax" and sys.modules[m] is not None for m in sys.modules)
import torch
assert not torch.cuda.is_initialized()
print("ref ok", paths["valAccPath"][-1])
"""


def test_backend_ref_through_the_cli_needs_no_jax_and_no_device(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    argv = ["--backend", "ref", "--agg", "gm2", "--attack", "classflip", "--K", "6",
            "--B", "1", "--rounds", "1", "--interval", "2", "--batch-size", "8",
            "--no-eval-train"]
    proc = subprocess.run([sys.executable, "-c", _BLOCKED, *argv], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[ref backend] round 1/1" in proc.stdout and "ref ok" in proc.stdout
