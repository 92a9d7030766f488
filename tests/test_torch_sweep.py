"""The port's sweep (``analysis/sweep.py``, ``sweep.py``) and figure tools
(``analysis/plots.py``, ``analysis/trajectory_plot.py``, the figure half of
``tools/reproduce.py``) on the CPU: a 2x2 sweep at K=6, one round, whose
markdown table and JSON lines have the JAX package's format; the paper's
figure and the trajectory plot written as PNGs from port records and from
``docs/trajectories_r05/``; ``--batched`` refused with its reason."""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import pytest
import torch

from byzantine_aircomp_tpu import obs as jobs
from byzantine_aircomp_tpu.analysis import plots as jplots
from byzantine_aircomp_tpu.analysis import sweep as jsweep
from byzantine_aircomp_tpu.analysis import trajectory_plot as jtraj
from byzantine_aircomp_tpu_torch.analysis import plots, sweep, trajectory_plot
from byzantine_aircomp_tpu_torch.data import datasets as tdata
from byzantine_aircomp_tpu_torch.tools import reproduce

REPO = Path(__file__).resolve().parents[1]
PNG = b"\x89PNG\r\n\x1a\n"


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread for the tiny cells' small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg_kw(**kw):
    return dict(dict(dataset="mnist", honest_size=5, byz_size=1, rounds=1,
                     display_interval=2, batch_size=8, eval_train=False, agg_maxiter=20,
                     use_gpu=False), **kw)


def test_a_2x2_sweep_has_the_jax_table_and_lines():
    ds = tdata.load("mnist", synthetic_train=300, synthetic_val=100)
    cells = []
    grid = sweep.run_sweep(["gm2", "median"], [None, "classflip"], _cfg_kw(), dataset=ds,
                           log=lambda s: None,
                           on_cell=lambda a, t, c: cells.append((a, t, c)))
    assert set(grid) == {(a, t) for a in ("gm2", "median") for t in (None, "classflip")}
    for (_, attack), cell in grid.items():
        # the attack-free cells zero the Byzantine count, and say so
        extra = {"effective"} if attack is None else set()
        assert set(cell) == {"val_acc", "val_loss"} | extra and 0.0 <= cell["val_acc"] <= 1.0
    assert sweep.markdown_table(grid) == jsweep.markdown_table(grid)
    table = sweep.markdown_table(grid).splitlines()
    assert table[0] == "| attack \\ agg | gm2 | median |" and table[2].startswith("| none |")
    # the sweep_cell event keys, as the JAX sweep emits them
    port = sweep.obs_lib.make_event("sweep_cell", agg="gm2", attack="none", **grid[("gm2", None)])
    want = jobs.make_event("sweep_cell", agg="gm2", attack="none", **grid[("gm2", None)])
    assert set(port) == set(want) and port["kind"] == "sweep_cell"
    assert [c[:2] for c in cells] == [("gm2", None), ("median", None), ("gm2", "classflip"),
                                      ("median", "classflip")]


def test_sweep_main_prints_one_json_line_per_cell_and_the_table(tmp_path):
    argv = ["--device", "cpu", "--aggs", "mean,krum", "--attacks", "none,signflip",
            "--K", "6", "--B", "1", "--rounds", "2", "--interval", "1", "--batch-size", "8",
            "--dataset", "mnist_hard", "--out", str(tmp_path / "grid.pkl"), "--obs-dir",
            str(tmp_path)]
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        sweep.main(argv)
    lines = [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]
    assert len(lines) == 4
    for ev in lines:
        assert ev["kind"] == "sweep_cell" and ev["v"] == jobs.SCHEMA_VERSION
        assert {"agg", "attack", "val_acc", "val_loss", "rounds_per_sec"} <= set(ev)
        jobs.validate_event(ev)
    assert "| attack \\ agg | krum | mean |" in err.getvalue()
    grid = plots.load_record(str(tmp_path / "grid.pkl"))
    assert sorted(grid) == ["krum|none", "krum|signflip", "mean|none", "mean|signflip"]
    assert len((tmp_path / "sweep.events.jsonl").read_text().splitlines()) == 4


def test_a_batched_sweep_equals_the_eager_per_seed_cells():
    """``--batched``: each cell's seed replicas as the lanes of one batch
    runner equal the eager per-seed cells (JAX
    ``test_sweep_batched_matches_eager``)."""
    ds = tdata.load("mnist", synthetic_train=300, synthetic_val=100)
    kw = _cfg_kw(honest_size=6, byz_size=2, rounds=2, gamma=1e-2, seed=3)
    common = dict(dataset=ds, seeds=2, log=lambda s: None)
    eager = sweep.run_sweep(["mean"], [None, "signflip"], dict(kw), **common)
    batched = sweep.run_sweep(["mean"], [None, "signflip"], dict(kw), batched=True,
                              **common)
    assert eager.keys() == batched.keys()
    for key, cell in eager.items():
        for col in ("val_acc", "val_loss", "val_acc_std"):
            assert cell[col] == batched[key][col], (key, col)


def test_the_sweep_shares_the_run_cli_s_knob_flags():
    import argparse

    from byzantine_aircomp_tpu_torch import cli

    p = argparse.ArgumentParser()
    cli.add_knob_flags(p)
    ours = {s for a in p._actions for s in a.option_strings} - {"-h", "--help"}
    jp = argparse.ArgumentParser()
    from byzantine_aircomp_tpu.cli import add_knob_flags as jax_knobs

    jax_knobs(jp)
    theirs = {s for a in jp._actions for s in a.option_strings} - {"-h", "--help"}
    assert theirs == ours


@pytest.fixture
def small_data(monkeypatch):
    """Every data set a run loads is a small synthetic one."""
    real = tdata.load
    monkeypatch.setattr(tdata, "load", lambda name, **kw: real(
        name, synthetic_train=300, synthetic_val=100))


def _records(tmp_path):
    from byzantine_aircomp_tpu_torch.fed import harness
    from byzantine_aircomp_tpu_torch.fed.config import FedConfig

    for agg, var in (("gm2", None), ("median", 0.01)):
        for attack in ("classflip", "weightflip"):
            harness.run(FedConfig(agg=agg, attack=attack, noise_var=var, honest_size=5,
                                  byz_size=1, rounds=2, display_interval=1, batch_size=8,
                                  eval_train=False, cache_dir=str(tmp_path / "recs"),
                                  quiet=True), device="cpu")
    return plots.find_records(str(tmp_path / "recs"))


def test_the_paper_figure_from_port_records(tmp_path, small_data):
    records = _records(tmp_path)
    assert len(records) == 4
    assert plots.find_records(str(tmp_path / "recs")).keys() == jplots.find_records(
        str(tmp_path / "recs")).keys()
    fig = plots.paper_figure(records, str(tmp_path / "fig.png"))
    assert len(fig.axes) == 4
    assert (tmp_path / "fig.png").read_bytes()[:8] == PNG
    # the JAX package's figure reads the same records into the same panels
    jfig = jplots.paper_figure(records, None)
    for ax, jax_ax in zip(fig.axes, jfig.axes):
        assert len(ax.lines) == len(jax_ax.lines) == 2
        assert ax.get_title() == jax_ax.get_title()
    # the reader, by name
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "byzantine_aircomp_tpu_torch.analysis", "plots",
         "--cache-dir", str(tmp_path / "recs"), "--out", str(tmp_path / "fig2.png")],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "(4 records)" in proc.stdout and (tmp_path / "fig2.png").exists()


def test_the_trajectory_plot_from_the_committed_trajectories(tmp_path):
    traj = REPO / "docs" / "trajectories_r05"
    curves = [f"honest={traj / 'resnet_honest_mean.jsonl'}",
              str(traj / "resnet_signflip_krum.jsonl")]
    out = tmp_path / "traj.png"
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert trajectory_plot.main(["--out", str(out), *curves]) == 0
    assert out.read_bytes()[:8] == PNG
    for path in sorted(traj.glob("*.jsonl")):
        assert trajectory_plot.load_trajectory(str(path)) == jtraj.load_trajectory(str(path))


def test_reproduce_draws_the_figure_from_exactly_its_8_records(tmp_path, monkeypatch,
                                                               small_data):
    monkeypatch.chdir(tmp_path)
    out = io.StringIO()
    with redirect_stdout(out):
        assert reproduce.main(["--device", "cpu", "--rounds", "1", "--interval", "1",
                               "--agg-maxiter", "3", "--cache-dir", "repro", "--dataset",
                               "mnist_hard", "--out", "paper.png"]) == 0
    assert "wrote paper.png (8 records)" in out.getvalue()
    assert (tmp_path / "paper.png").read_bytes()[:8] == PNG
    assert len(os.listdir(tmp_path / "repro")) == 8
