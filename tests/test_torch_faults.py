"""The port's fault channel (``ops/faults.py``) and the surface that drives
it (config, trainer, harness, CLI) vs the JAX package's, on the CPU.

Draws are JAX's, passed in: ``bernoulli`` masks for dropout, corruption and
the Gilbert-Elliott transitions, ``rayleigh_fade`` for the erasure and
``normal`` for the CSI error, from the key layout of
``faults.apply_transmission`` (corrupt, fade, csi, ge; ge split into
recover and degrade).  The carried state, the counts and the masks agree
bit for bit.  The CSI scale ``exp(-eps)`` agrees within 1 ulp: XLA's and
torch's f32 ``exp`` on the CPU are not correctly rounded, and differ by 1
ulp on 9% of [-5, 5]; the rows it scales, within 2 ulp.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantine_aircomp_tpu.fed import harness as jharness
from byzantine_aircomp_tpu.fed.config import FedConfig as JaxFedConfig
from byzantine_aircomp_tpu.ops import channel as jchannel
from byzantine_aircomp_tpu.ops import faults as jfaults
from byzantine_aircomp_tpu_torch.data import datasets as tdata
from byzantine_aircomp_tpu_torch.fed import harness as tharness
from byzantine_aircomp_tpu_torch.fed.config import FedConfig
from byzantine_aircomp_tpu_torch.fed.train import Trainer
from byzantine_aircomp_tpu_torch.ops import channel as tchannel
from byzantine_aircomp_tpu_torch.ops import faults as tfaults
from byzantine_aircomp_tpu_torch.registry import FAULTS

REPO = Path(__file__).resolve().parents[1]
K, D = 10, 64


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _ulps(a, b):
    """Per-element distance in f32 ulps (same-sign finite values)."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _stack(seed=0):
    rng = np.random.default_rng(seed)
    return (0.01 * rng.standard_normal((K, D))).astype(np.float32)


def test_registered_faults_equal_jax():
    from byzantine_aircomp_tpu.registry import FAULTS as JAX_FAULTS

    assert FAULTS.names() == JAX_FAULTS.names()
    for name in FAULTS.names():
        port = dataclasses.asdict(tfaults.resolve(name))
        assert port == dataclasses.asdict(jfaults.resolve(name)), name


def test_resolve_overrides_and_none():
    assert tfaults.resolve(None) is None
    spec = tfaults.resolve("chaos", {"dropout_prob": 0.3, "corrupt_mode": "inf"})
    assert spec.dropout_prob == 0.3 and spec.corrupt_mode == "inf" and spec.csi_std == 0.2
    with pytest.raises(ValueError, match="require --fault"):
        tfaults.resolve(None, {"dropout_prob": 0.1})
    with pytest.raises(KeyError, match="unknown fault"):
        tfaults.resolve("meteor")


@pytest.mark.parametrize("overrides,match", [
    ({"dropout_prob": 1.5}, "dropout_prob"),
    ({"corrupt_prob": -0.1}, "corrupt_prob"),
    ({"fade_floor": -1.0}, "fade_floor"),
    ({"csi_std": -0.2}, "csi_std"),
    ({"ge_bad_mult": 0.5}, "ge_bad_mult"),
    ({"corrupt_mode": "zero"}, "corrupt_mode"),
    ({"corrupt_size": -1}, "corrupt_size"),
    ({"corrupt_size": 0}, "corrupt_size >= 1"),
])
def test_invalid_specs_rejected_as_jax_does(overrides, match):
    # the JAX package asserts; the port raises ValueError with the meaning
    with pytest.raises(AssertionError, match=match):
        jfaults.resolve("corrupt", overrides)
    with pytest.raises(ValueError, match=match):
        tfaults.resolve("corrupt", overrides)


def test_init_state_matches_jax():
    flat = np.linspace(-1, 1, D).astype(np.float32)
    for name in FAULTS.names():
        jspec, tspec = jfaults.resolve(name), tfaults.resolve(name)
        j_stale, j_ge = jfaults.init_state(jspec, K, jnp.asarray(flat))
        state = tfaults.init_state(tspec, K, torch.from_numpy(flat))
        for want, got in ((j_stale, state.stale), (j_ge, state.ge_bad)):
            if isinstance(want, tuple):
                assert got is None, name
            else:
                assert np.array_equal(np.asarray(want), got.numpy()), name


def test_apply_dropout_replays_the_stale_rows_like_jax():
    spec_j = jfaults.resolve("dropout", {"dropout_prob": 0.4})
    spec_t = tfaults.resolve("dropout", {"dropout_prob": 0.4})
    flat = _stack(1)[0]
    stale_j = jfaults.init_state(spec_j, K, jnp.asarray(flat))[0]
    stale_t = tfaults.init_state(spec_t, K, torch.from_numpy(flat)).stale
    total = 0.0
    for r in range(4):  # the buffer carries across rounds
        w = _stack(10 + r)
        key = jax.random.PRNGKey(r)
        out_j, stale_j, n_j = jfaults.apply_dropout(spec_j, key, jnp.asarray(w), stale_j)
        dropped = _t(jax.random.bernoulli(key, 0.4, (K,)))
        out_t, stale_t, n_t = tfaults.apply_dropout(
            spec_t, torch.from_numpy(w), stale_t, dropped=dropped)
        assert np.array_equal(out_t.numpy(), np.asarray(out_j))
        assert np.array_equal(stale_t.numpy(), np.asarray(stale_j))
        assert float(n_t) == float(n_j)
        total += float(n_t)
    assert total > 0
    # off: identity, no draw
    w = torch.from_numpy(_stack(2))
    same, stale, n = tfaults.apply_dropout(tfaults.resolve("csi"), w, None)
    assert same is w and stale is None and float(n) == 0.0


def _transmission_draws(spec, key, k):
    k_corrupt, k_fade, k_csi, k_ge = jax.random.split(key, 4)
    k_recover, k_degrade = jax.random.split(k_ge)
    return {
        "crash": _t(jax.random.bernoulli(k_corrupt, spec.corrupt_prob, (k,))),
        "fade": tuple(_t(h) for h in jchannel.rayleigh_fade(k_fade, k)),
        "ge_recover": _t(jax.random.bernoulli(k_recover, spec.ge_p_bg, (k,))),
        "ge_degrade": _t(jax.random.bernoulli(k_degrade, spec.ge_p_gb, (k,))),
        "csi_z": _t(jax.random.normal(k_csi, (k,), dtype=jnp.float32)),
    }


@pytest.mark.parametrize("name,overrides", [
    ("deep_fade", {"fade_floor": 0.5}),
    ("csi", {"ge_p_gb": 0.5}),
    ("corrupt", {"corrupt_prob": 0.7, "corrupt_size": 4}),
    ("corrupt", {"corrupt_prob": 0.7, "corrupt_size": 4, "corrupt_mode": "inf"}),
    ("corrupt", {"corrupt_prob": 0.7, "corrupt_size": 4, "corrupt_mode": "saturate"}),
    ("chaos", {"fade_floor": 0.4, "corrupt_prob": 0.8, "corrupt_size": 3, "ge_p_gb": 0.6}),
    ("dropout", {}),
])
def test_apply_transmission_matches_jax_with_its_draws(name, overrides):
    spec_j = jfaults.resolve(name, overrides)
    spec_t = tfaults.resolve(name, overrides)
    ge_j = jnp.zeros(K, bool)
    ge_t = torch.zeros(K, dtype=torch.bool)
    counts = np.zeros(2)
    for r in range(5):  # the Gilbert-Elliott state carries
        w = _stack(20 + r)
        key = jax.random.PRNGKey(100 + r)
        out_j, ge_j, er_j, co_j = jfaults.apply_transmission(spec_j, key, jnp.asarray(w), ge_j)
        out_t, ge_t, er_t, co_t = tfaults.apply_transmission(
            spec_t, torch.from_numpy(w), ge_t, draws=_transmission_draws(spec_j, key, K))
        got, want = out_t.numpy(), np.asarray(out_j)
        fin = np.isfinite(want)
        assert np.array_equal(np.isfinite(got), fin)
        assert np.array_equal(_bits(got[~fin]), _bits(want[~fin]))
        assert _ulps(got[fin], want[fin]).max(initial=0) <= (2 if spec_t.csi_std > 0 else 0)
        assert np.array_equal(ge_t.numpy(), np.asarray(ge_j))
        assert (float(er_t), float(co_t)) == (float(er_j), float(co_j))
        counts += (float(er_t), float(co_t))
    if spec_t.fade_floor > 0:
        assert counts[0] > 0
    if spec_t.corrupt_prob > 0:
        assert counts[1] > 0
        # only the first corrupt_size rows may crash
        assert np.isfinite(out_t.numpy()[spec_t.corrupt_size:]).all() or spec_t.fade_floor > 0
    if spec_t.csi_std > 0:
        assert bool(ge_t.any())


def test_transmission_draws_from_a_generator_are_seeded():
    spec = tfaults.resolve("chaos", {"corrupt_prob": 0.5})
    w = torch.from_numpy(_stack(3))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return tfaults.apply_transmission(spec, w, torch.zeros(K, dtype=torch.bool), generator=g)

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a[0].nan_to_num(7.0), b[0].nan_to_num(7.0))
    assert not torch.equal(a[0].nan_to_num(7.0), c[0].nan_to_num(7.0))


def test_channel_fault_helpers_match_jax():
    key = jax.random.PRNGKey(5)
    h_r, h_i = jchannel.rayleigh_fade(key, 50)
    h_sq = h_r**2 + h_i**2
    got = tchannel.deep_fade_mask(_t(h_sq), 0.3)
    assert np.array_equal(got.numpy(), np.asarray(jchannel.deep_fade_mask(h_sq, 0.3)))
    std = 0.2 * jnp.where(jnp.arange(50) % 3 == 0, 5.0, 1.0)
    want = jchannel.csi_error_scale(key, 50, std)
    z = _t(jax.random.normal(key, (50,), dtype=jnp.float32))
    assert _ulps(tchannel.csi_error_scale(50, _t(std), z=z), want).max() <= 1
    want = jchannel.csi_error_scale(key, 50, 0.2)
    assert _ulps(tchannel.csi_error_scale(50, 0.2, z=z), want).max() <= 1


# ---------------------------------------------------------------------------
# config, title, record, CLI


_RULE_KW = dict(attack="classflip", honest_size=8, byz_size=2)


@pytest.mark.parametrize("kw,match", [
    (dict(dropout_prob=0.1), "require --fault"),
    (dict(corrupt_mode="inf"), "require --fault"),
    (dict(fault="meteor"), "unknown fault"),
    (dict(fault="dropout", dropout_prob=2.0), "dropout_prob"),
    (dict(fault="corrupt", corrupt_size=9), "exceeds the 8 honest"),
    (dict(agg="bulyan", honest_size=6), "K > 4B"),
    (dict(agg="dnc", dnc_iters=5), "dnc removes"),
    (dict(agg="multi_krum", krum_m=11), "krum_m"),
    (dict(agg="multi_krum", krum_m=0), "krum_m"),
    (dict(agg="cclip", clip_tau=0.0), "clip_tau"),
    (dict(agg="cclip", clip_iters=0), "clip_iters"),
    (dict(agg="dnc", dnc_sub_dim=0), "dnc knobs"),
    (dict(agg="dnc", dnc_c=-1.0), "dnc knobs"),
    (dict(agg="mean", sign_bits=8), "only signmv and bev"),
    (dict(agg="bev", sign_bits=1), "sign-eta"),
])
def test_config_rejects_the_new_invalid_settings(kw, match):
    with pytest.raises((ValueError, KeyError), match=match):
        FedConfig(**dict(_RULE_KW, **kw)).validate()


@pytest.mark.parametrize("kw", [
    dict(agg="multi_krum"), dict(agg="multi_krum", krum_m=3), dict(agg="bulyan"),
    dict(agg="cclip"), dict(agg="cclip", clip_tau=0.5, clip_iters=2),
    dict(agg="dnc"), dict(agg="dnc", dnc_iters=2, dnc_sub_dim=100, dnc_c=1.5),
    dict(agg="bev", sign_bits=1, sign_eta=0.01), dict(agg="bev", sign_bits=16),
    dict(agg="signmv", sign_bits=8), dict(agg="gm2", fault="chaos"),
    dict(agg="median", fault="chaos", dropout_prob=0.3, corrupt_mode="inf",
         corrupt_size=2, noise_var=1e-2),
    dict(agg="mean", fault="csi", csi_std=0.5, mark="x"),
])
def test_run_title_suffixes_match_jax(kw):
    kw = dict(_RULE_KW, **kw)
    FedConfig(**kw).validate()
    JaxFedConfig(**kw).validate()
    assert tharness.run_title(FedConfig(**kw)) == jharness.run_title(JaxFedConfig(**kw))


def test_record_keys_with_a_fault_match_jax():
    kw = dict(_RULE_KW, fault="chaos", dropout_prob=0.3)
    paths = {k: [] for k in ("trainLossPath", "trainAccPath", "valLossPath", "valAccPath",
                             "variencePath", "roundsPerSec", "faultDroppedPath",
                             "faultErasedPath", "faultCorruptPath", "effectiveKPath")}
    args = dict(dataset_name="mnist", dataset_size=1, max_feature=1)
    got = tharness.build_record(FedConfig(**kw), paths, **args)
    want = jharness.build_record(JaxFedConfig(**kw), paths, **args)
    assert set(got) == set(want)
    assert got["fault"] == "chaos" and got["faultOverrides"] == {"dropout_prob": 0.3}
    no_fault = tharness.build_record(FedConfig(**_RULE_KW), paths, **args)
    assert "fault" not in no_fault and "effectiveKPath" not in no_fault


_NEW_FLAGS = ("krum_m", "clip_tau", "clip_iters", "dnc_iters", "dnc_sub_dim", "dnc_c",
              "fault", "dropout_prob", "fade_floor", "csi_std", "corrupt_prob",
              "corrupt_mode", "corrupt_size")


def test_cli_flags_mirror_jax():
    from byzantine_aircomp_tpu.cli import build_parser as jax_parser
    from byzantine_aircomp_tpu_torch.cli import build_parser, config_from_args

    ours = build_parser().parse_args([])
    theirs = jax_parser().parse_args([])
    for name in _NEW_FLAGS:
        assert getattr(ours, name) == getattr(theirs, name), name
    argv = ["--agg", "multi_krum", "--krum-m", "3", "--fault", "chaos", "--dropout-prob",
            "0.3", "--corrupt-mode", "inf", "--corrupt-size", "2", "--clip-tau", "0.5",
            "--dnc-c", "2.0", "--K", "10", "--B", "2", "--attack", "classflip"]
    cfg = config_from_args(build_parser().parse_args(argv))
    assert (cfg.agg, cfg.krum_m, cfg.fault, cfg.dropout_prob, cfg.corrupt_mode,
            cfg.corrupt_size, cfg.clip_tau, cfg.dnc_c) == (
        "multi_krum", 3, "chaos", 0.3, "inf", 2, 0.5, 2.0)
    cfg.validate()


# ---------------------------------------------------------------------------
# the trainer under faults


def _tiny_ds():
    return tdata.load("mnist", synthetic_train=1000, synthetic_val=200)


def test_fault_free_run_keeps_four_streams_and_no_fault_paths():
    cfg = FedConfig(honest_size=6, rounds=1, display_interval=2, batch_size=16,
                    agg="mean", eval_train=False)
    tr = Trainer(cfg, dataset=_tiny_ds(), device="cpu")
    gens = tr.iteration_generators(0, 0)
    assert gens.fault is None and tr.fault is None and tr.fault_state is None
    paths = tr.train()
    assert "effectiveKPath" not in paths
    faulty = Trainer(FedConfig(honest_size=6, agg="mean", fault="dropout"),
                     dataset=_tiny_ds(), device="cpu")
    fgens = faulty.iteration_generators(0, 0)
    # streams 0-3 are unchanged by the fault's stream 4
    for a, b in zip(gens[:4], fgens[:4]):
        assert torch.equal(torch.rand(3, generator=a), torch.rand(3, generator=b))
    assert fgens.fault is not None


def test_gm2_survives_dropout_plus_nan_corruption():
    """gm2 under 20% dropout and a client that emits NaN every iteration:
    finite params every round, the counts reduced per round."""
    cfg = FedConfig(honest_size=8, byz_size=2, attack="classflip", agg="gm2", rounds=3,
                    display_interval=3, batch_size=32, eval_train=False, fault="dropout",
                    dropout_prob=0.2, corrupt_prob=1.0, corrupt_mode="nan", corrupt_size=1)
    tr = Trainer(cfg, dataset=_tiny_ds(), device="cpu")
    for r in range(cfg.rounds):
        tr.run_round(r)
        assert torch.isfinite(tr.flat_params).all(), f"round {r}"
        dropped, erased, corrupt, eff_k = tr.last_fault_metrics.tolist()
        assert corrupt == cfg.display_interval  # p=1: one crash per iteration
        assert erased == 0 and 0 < eff_k <= cfg.node_size - 1


@pytest.mark.parametrize("agg,kw", [
    ("mean", {}), ("median", {"noise_var": 1e-2}), ("trimmed_mean", {}),
    ("krum", {}), ("multi_krum", {}), ("bulyan", {}), ("cclip", {}), ("dnc", {}),
    ("bev", {"sign_bits": 1, "sign_eta": 0.01}), ("signmv", {"sign_bits": 16}),
    ("gm", {"noise_var": 1e-2, "agg_maxiter": 20}),
])
def test_every_rule_trains_finite_under_chaos(agg, kw):
    """Every rule under a chaos fault with rates that hit most iterations:
    the degraded rule plus the finite guard keep the params finite, and the
    record's fault paths have one entry per round."""
    cfg = FedConfig(honest_size=8, byz_size=2, attack="classflip", agg=agg, rounds=2,
                    display_interval=3, batch_size=16, eval_train=False, fault="chaos",
                    dropout_prob=0.3, fade_floor=0.3, corrupt_prob=0.5, corrupt_size=2, **kw)
    tr = Trainer(cfg, dataset=_tiny_ds(), device="cpu")
    paths = tr.train()
    assert torch.isfinite(tr.flat_params).all()
    for key in ("faultDroppedPath", "faultErasedPath", "faultCorruptPath", "effectiveKPath"):
        assert len(paths[key]) == cfg.rounds, key
    assert min(paths["effectiveKPath"]) < cfg.node_size
    assert sum(paths["faultErasedPath"]) + sum(paths["faultCorruptPath"]) > 0


def test_fault_run_deterministic_given_seed():
    def run():
        cfg = FedConfig(honest_size=6, rounds=2, display_interval=2, batch_size=16,
                        agg="gm2", eval_train=False, fault="chaos", seed=7)
        tr = Trainer(cfg, dataset=_tiny_ds(), device="cpu")
        return tr.train(), tr.flat_params

    (p1, f1), (p2, f2) = run(), run()
    assert torch.equal(f1, f2) and p1["effectiveKPath"] == p2["effectiveKPath"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env["OMP_NUM_THREADS"] = "2"
    return env


def test_cli_chaos_run_writes_the_fault_record(tmp_path):
    from byzantine_aircomp_tpu.analysis.plots import load_record

    cmd = [sys.executable, "-m", "byzantine_aircomp_tpu_torch", "--device", "cpu",
           "--agg", "trimmed_mean", "--attack", "classflip", "--K", "10", "--B", "2",
           "--rounds", "2", "--interval", "2", "--fault", "chaos", "--fade-floor", "0.3"]
    proc = subprocess.run(cmd, cwd=tmp_path, env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "effK=" in proc.stdout and "erase=" in proc.stdout
    title = "MLP_SGD_classflip_trimmed_mean_faultchaos_fadefloor0.3"
    record = load_record(str(tmp_path / "MNIST_Air_weight_torch" / f"mnist_K10_B2_{title}"))
    assert record["fault"] == "chaos" and record["faultOverrides"] == {"fade_floor": 0.3}
    for key in ("faultDroppedPath", "faultErasedPath", "faultCorruptPath", "effectiveKPath"):
        assert len(record[key]) == 2, key
    assert all(0 < k <= 10 for k in record["effectiveKPath"])
