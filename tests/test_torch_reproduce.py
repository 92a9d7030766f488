"""The port's accuracy-gate tool (``tools/reproduce.py``) on the CPU: its
configs are the JAX package's full-schedule parity gates
(``tests/test_parity.py``), its bar is the one stated, and ``--gate`` runs
end to end at a cut schedule (2 rounds of 2 iterations, a small
mnist_hard) and writes its JSON.  The full gate runs on the GPU."""

import json
from pathlib import Path

import pytest

from byzantine_aircomp_tpu.fed.config import FedConfig as JaxFedConfig
from byzantine_aircomp_tpu_torch.tools import reproduce


def test_gate_configs_are_the_jax_parity_gates():
    # tests/test_parity.py::_run_full_schedule and its three callers
    common = dict(rounds=100, display_interval=10, batch_size=50, eval_train=False,
                  agg_maxiter=1000, agg_tol=1e-5)
    want = {
        "gm2_classflip_b5": (dict(honest_size=45, byz_size=5, attack="classflip",
                                  agg="gm2"), 0.88),
        "gm2_weightflip_b10": (dict(honest_size=40, byz_size=10, attack="weightflip",
                                    agg="gm2"), 0.9),
        "gm_var_classflip_b10": (dict(honest_size=40, byz_size=10, attack="classflip",
                                      agg="gm", noise_var=1e-2), 0.8),
    }
    assert [g.name for g in reproduce.GATES] == list(want)
    assert reproduce.GATE_DATA == dict(dataset="mnist_hard", synthetic_train=20000,
                                       synthetic_val=10000)
    assert reproduce.GATE_SEEDS == (2021, 2022, 2023, 2024) and reproduce.TAIL == 5
    for gate in reproduce.GATES:
        fields, floor = want[gate.name]
        assert gate.floor == floor
        cfg = reproduce.gate_config(gate, 2023)
        jcfg = JaxFedConfig(dataset="mnist_hard", seed=2023, **common, **fields)
        for name in list(common) + list(fields) + ["seed", "dataset", "gamma"]:
            assert getattr(cfg, name) == getattr(jcfg, name), (gate.name, name)
        assert cfg.validate() is cfg
    # the AirComp target is the JAX seed-mean recorded in the repo
    with open(Path(__file__).resolve().parents[1] / "docs" / "aircomp_parity_r04.json") as f:
        rec = json.load(f)
    assert reproduce.GATES[2].jax_mean == pytest.approx(rec["seed_mean"]["jax"], abs=1e-9)


@pytest.mark.parametrize("per_seed,ok,tight", [
    ({1: 0.905, 2: 0.903, 3: 0.900, 4: 0.910}, True, True),
    ({1: 0.895, 2: 0.893, 3: 0.890, 4: 0.900}, True, False),
    ({1: 0.885, 2: 0.883, 3: 0.890, 4: 0.890}, False, False),   # mean 0.017 low
    ({1: 0.879, 2: 0.913, 3: 0.910, 4: 0.915}, False, True),    # a seed under 0.88
])
def test_judge_applies_the_bar(per_seed, ok, tight):
    res = reproduce.judge(reproduce.GATES[0], per_seed)
    assert res["pass"] is ok and res["within_0.005"] is tight
    assert res["delta"] == pytest.approx(res["mean"] - reproduce.GATES[0].jax_mean)


def test_gate_cli_runs_cut_on_the_cpu(tmp_path):
    out = tmp_path / "gate.json"
    rc = reproduce.main([
        "--gate", "--device", "cpu", "--rounds", "2", "--interval", "2",
        "--agg-maxiter", "20", "--seeds", "2021", "--synthetic-train", "1000",
        "--synthetic-val", "200", "--out", str(out)])
    res = json.loads(out.read_text())
    assert rc == 1 and res["pass"] is False  # a cut run never passes
    assert res["overrides"] == {"rounds": 2, "display_interval": 2, "agg_maxiter": 20}
    assert res["device"] == "cpu" and set(res["configs"]) == {g.name for g in reproduce.GATES}
    for r in res["configs"].values():
        assert set(r["per_seed"]) == {"2021"} and 0.0 < r["per_seed"]["2021"] <= 1.0
        assert r["seconds"]["2021"] > 0 and {"mean", "delta", "jax_mean", "floor"} <= set(r)


def test_paper_configs_are_the_eight_runs():
    cfgs = reproduce.paper_configs(rounds=3, cache_dir="x")
    assert len(cfgs) == 8
    assert {(c.attack, c.byz_size, c.agg, c.noise_var) for c in cfgs} == {
        (a, b, agg, var) for a in ("classflip", "weightflip") for b in (5, 10)
        for agg, var in (("gm2", None), ("gm", 1e-2))}
    assert all(c.node_size == 50 and c.rounds == 3 for c in cfgs)
