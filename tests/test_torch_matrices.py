"""The port's offline matrices (``analysis/fault_matrix.py``,
``bits_matrix.py``, ``adaptive_matrix.py``) against the JAX package's on
one small grid each, on the CPU.

The random streams differ by construction (threefry against torch's
Philox), so the bits and adaptive matrices are held with the port's draw
sites (``normals``, ``gammas``) fed the JAX tool's own draws: then every
integer column (detection latency, rungs, transitions, suspicious counts,
recall) and every skip reason equals JAX's, the float columns agree within
1e-4 (the cells round to 5 decimals; the rules' f32 sums may round
differently), and ``assert_smoke`` and the under_radar verdict agree.  The
fault matrix trains the two packages' trainers, whose draws cannot be fed
across, so its cells are held to JAX's schema and survival facts, to the
port trainer's own run of the cell's config bitwise, with the accuracy
within 0.1 of JAX's (the same one-round start, other batches), and its
table and pickle keys to JAX's on the same grid.
"""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantine_aircomp_tpu.analysis import adaptive_matrix as jadapt
from byzantine_aircomp_tpu.analysis import bits_matrix as jbits
from byzantine_aircomp_tpu.analysis import fault_matrix as jfault
from byzantine_aircomp_tpu.data import datasets as jdata
from byzantine_aircomp_tpu_torch.analysis import adaptive_matrix as tadapt
from byzantine_aircomp_tpu_torch.analysis import bits_matrix as tbits
from byzantine_aircomp_tpu_torch.analysis import fault_matrix as tfault
from byzantine_aircomp_tpu_torch.data import datasets as tdata

FLOAT_TOL = 1e-4


def _jax_normals(seed, stream, shape, device):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), stream)
    return torch.from_numpy(np.array(jax.random.normal(key, shape, jnp.float32))).to(device)


def _jax_gammas(seed, stream, alpha, shape, device):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), stream)
    conc = jnp.full(shape[-1:], float(alpha), jnp.float32)
    return torch.from_numpy(np.array(jax.random.gamma(key, conc, shape))).to(device)


@pytest.fixture
def jax_draws(monkeypatch):
    for mod in (tbits, tadapt):
        monkeypatch.setattr(mod, "normals", _jax_normals)
    monkeypatch.setattr(tadapt, "gammas", _jax_gammas)


def _same_cells(got, want):
    assert got.keys() == want.keys()
    for key in want:
        g, w = got[key], want[key]
        assert g.keys() == w.keys(), key
        for col, wv in w.items():
            gv = g[col]
            if isinstance(wv, float) and not isinstance(wv, bool):
                assert gv == pytest.approx(wv, abs=FLOAT_TOL), (key, col)
            else:
                assert gv == wv, (key, col)


# ---------------------------------------------------------------------------
# bits_matrix


BITS_GRID = dict(attacks=["under_radar", "classflip"], bits_list=[1, 32])


@pytest.fixture(scope="module")
def jax_bits():
    return jbits.run_matrix(**BITS_GRID, iters=12, seed=0, log=lambda s: None)


def test_bits_cells_skips_and_verdict_are_jax_s(jax_draws, jax_bits):
    got = tbits.run_matrix(**BITS_GRID, iters=12, seed=0, device="cpu", log=lambda s: None)
    _same_cells(got, jax_bits)
    assert got[("classflip", 1)] == {"skipped": tbits.DATA_LEVEL_SKIP}
    assert tbits.under_radar_verdict(got) == jbits.under_radar_verdict(jax_bits)
    assert tbits.markdown_table(got) == jbits.markdown_table(jax_bits)
    tbits.assert_smoke(got)
    jbits.assert_smoke(jax_bits)


def test_bits_smoke_refuses_what_jax_refuses():
    one_col = {("signflip", 1): {"final_dist": 1.0, "best_dist": 1.0, "flip_frac": 0.0}}
    for mod in (tbits, jbits):
        with pytest.raises(SystemExit, match="1-bit and 32-bit"):
            mod.assert_smoke(one_col)
    bad = {("signflip", 1): {"final_dist": 9.0, "best_dist": 1.0, "flip_frac": 0.0},
           ("signflip", 32): {"final_dist": 1.0, "best_dist": 1.0, "flip_frac": 0.0}}
    for mod in (tbits, jbits):
        with pytest.raises(SystemExit, match="handed this attack a win"):
            mod.assert_smoke(bad)
    with pytest.raises(ValueError, match="unknown sign_bits"):
        tbits.run_matrix(["signflip"], [4], device="cpu")


def test_bits_cli_writes_its_dumps(tmp_path, capsys):
    tbits.main(["--attacks", "signflip", "--bits", "1,32", "--iters", "4", "--device", "cpu",
                "--json", str(tmp_path / "b.json"), "--md", str(tmp_path / "b.md"),
                "--assert-smoke"])
    out = capsys.readouterr()
    assert out.out.count('"kind":"bits_cell"') == 2
    assert "smoke assertions passed" in out.err
    assert (tmp_path / "b.json").read_text().startswith("{")
    assert "bits_matrix" in (tmp_path / "b.md").read_text()


# ---------------------------------------------------------------------------
# adaptive_matrix


ADAPT_GRID = dict(attacks=["under_radar", "classflip", "duty_cycle", "gradascent"],
                  modes=["off", "adaptive"])
ADAPT_KW = dict(iters=20, onset=5, stop=15, seed=0)


@pytest.fixture(scope="module")
def jax_adapt():
    return jadapt.run_matrix(**ADAPT_GRID, **ADAPT_KW, log=lambda s: None)


def test_adaptive_cells_skips_and_smoke_are_jax_s(jax_draws, jax_adapt):
    got = tadapt.run_matrix(**ADAPT_GRID, **ADAPT_KW, device="cpu", log=lambda s: None)
    _same_cells(got, jax_adapt)
    lad = "mean,trimmed_mean,multi_krum"
    assert got[("under_radar", "off", lad)] == {"skipped": tadapt.DEFENSE_AWARE_OFF_SKIP}
    assert got[("classflip", "adaptive", lad)] == {"skipped": tadapt.DATA_LEVEL_SKIP}
    assert tadapt.markdown_table(got) == jadapt.markdown_table(jax_adapt)
    tadapt.assert_smoke(got)
    jadapt.assert_smoke(jax_adapt)


def test_the_cube_and_its_tuned_constants_are_jax_s(jax_draws):
    params = {"defense_z": 5.0, "defense_warmup": 3.0, "defense_up": 2.0,
              "defense_leak": 0.01}
    det, pol = tadapt.tuned_defense_params(params, 3)
    jdet, jpol = jadapt.tuned_defense_params(params, 3)
    assert vars(det) == vars(jdet) and vars(pol) == vars(jpol)
    assert isinstance(pol.up_n, int) and isinstance(det.warmup, int)
    assert tadapt.parse_alphas("iid, 0.3") == jadapt.parse_alphas("iid, 0.3")
    with pytest.raises(ValueError, match="must be positive"):
        tadapt.parse_alphas("0")
    hetero = tadapt.make_hetero(0.1, 0, device="cpu")
    want = jadapt.make_hetero(0.1, jax.random.PRNGKey(0))
    np.testing.assert_allclose(hetero.numpy(), np.asarray(want), rtol=0, atol=1e-7)
    assert tadapt.make_hetero(None, 0) is None
    kw = dict(attacks=["signflip"], modes=["monitor"], ladders=[("mean", "trimmed_mean",
              "multi_krum")], alphas=[("iid", None), ("0.1", 0.1)],
              tuned={"0.1": params}, iters=12, onset=3, stop=9, seed=0,
              log=lambda s: None)
    got = tadapt.run_cube(**kw, device="cpu")
    _same_cells(got, jadapt.run_cube(**kw))
    assert sorted(k[3:] for k in got) == [("alpha=0.1", "default"), ("alpha=0.1", "tuned"),
                                         ("alpha=iid", "default")]
    with pytest.raises(ValueError, match="not in the --alphas sweep"):
        tadapt.run_cube(**dict(kw, tuned={"0.3": params}), device="cpu")


def test_batched_matrix_equals_the_per_cell_loop_and_times_it(tmp_path, capsys):
    """``--batched``: every mode of a family from one pass equals the
    per-cell loop, every column, and the CLI's speedup flags time the loop
    against it."""
    kw = dict(iters=10, onset=2, stop=7, seed=0, log=lambda s: None, device="cpu")
    attacks, modes = ["signflip", "gradascent", "under_radar", "mimic"], list(tadapt.MODES)
    assert (tadapt.run_matrix(attacks, modes, batched=True, **kw)
            == tadapt.run_matrix(attacks, modes, **kw))
    row = tmp_path / "row.json"
    tadapt.main(["--batched", "--device", "cpu", "--attacks", "signflip", "--iters", "8",
                 "--onset", "2", "--stop", "6", "--expect-speedup", "0", "--perf-row",
                 str(row)])
    got = json.loads(row.read_text())
    assert got["metric"] == "matrix_wallclock" and got["platform"] == "cpu"
    assert "wall-clock: eager" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        tadapt.main(["--device", "cpu", "--perf-row", str(row)])  # needs --batched


# ---------------------------------------------------------------------------
# fault_matrix


FAULT_KW = dict(dataset="mnist", honest_size=6, byz_size=2, rounds=1, display_interval=2,
                batch_size=8, gamma=1e-2, noise_var=None, seed=2021, eval_train=False)


@pytest.mark.parametrize("agg,fault,attack", [("gm2", "dropout", "classflip"),
                                              ("trimmed_mean", None, None)])
def test_fault_cells_follow_jax_s_schema(agg, fault, attack):
    from byzantine_aircomp_tpu_torch.fed.config import FedConfig
    from byzantine_aircomp_tpu_torch.fed.train import Trainer

    ds = tdata.load("mnist", synthetic_train=400, synthetic_val=100)
    got = tfault.run_cell(agg, fault, attack, FAULT_KW, ds, "cpu")
    want = jfault.run_cell(agg, fault, attack, FAULT_KW,
                           jdata.load("mnist", synthetic_train=400, synthetic_val=100))
    assert got.keys() == want.keys()
    assert got["finite_all_rounds"] is want["finite_all_rounds"] is True
    assert got["val_acc"] == pytest.approx(want["val_acc"], abs=0.1)
    if fault is not None:
        assert 0 < got["min_effective_k"] <= 8 and got["erased"] == got["corrupt"] == 0.0
    # the cell is the trainer's run of its config, to the bit
    kw = dict(FAULT_KW, agg=agg, fault=fault, attack=attack)
    if attack is None:
        kw["byz_size"] = 0
    t = Trainer(FedConfig(**kw), dataset=ds, device="cpu")
    t.run_round(0)
    loss, acc = t.evaluate("val")
    assert (got["val_loss"], got["val_acc"]) == (round(loss, 4), round(acc, 4))


def test_fault_table_and_pickle_are_jax_s(tmp_path, monkeypatch):
    grid = {("gm2", None, None): {"val_acc": 0.5, "val_loss": 1.0, "finite_all_rounds": True},
            ("gm2", "chaos", None): {"val_acc": 0.25, "val_loss": 2.0,
                                     "finite_all_rounds": False},
            ("mean", None, None): {"val_acc": 0.125, "val_loss": 3.0, "finite_all_rounds": True},
            ("mean", "chaos", None): {"val_acc": 0.0, "val_loss": 4.0,
                                      "finite_all_rounds": True}}
    assert tfault.markdown_table(grid) == jfault.markdown_table(grid)
    assert "0.2500 !" in tfault.markdown_table(grid)
    with pytest.raises(KeyError):
        tfault.run_matrix(["nope"], [None], [None], FAULT_KW, dataset=object(), device="cpu")
    monkeypatch.setattr(tfault, "run_matrix", lambda *a, **k: grid)
    tfault.main(["--out", str(tmp_path / "g.pkl"), "--device", "cpu"])
    with open(tmp_path / "g.pkl", "rb") as f:
        assert sorted(pickle.load(f)) == ["gm2|chaos|none", "gm2|none|none",
                                          "mean|chaos|none", "mean|none|none"]
