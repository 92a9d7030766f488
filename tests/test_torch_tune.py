"""The port's defense tuner (``byzantine_aircomp_tpu_torch/tune/``) against
the JAX package's on the CPU.

The arithmetic equals JAX's exactly: the spaces' verdicts and error texts,
the candidates (``np.random.default_rng`` in both, so bitwise), the
halving schedule, the survivors, ``fold_pair`` and ``objective_score`` on
the same events.  The tune itself runs on the port's lanes: one
``batch_round_fn`` build per generation, the control lane (candidate 0)
in every generation, the benign twins pinned below their onset, and a
journal resume mid-generation bitwise the uninterrupted tune.
"""

import json

import pytest
import torch

from byzantine_aircomp_tpu.tune import objective as jobjective
from byzantine_aircomp_tpu.tune import space as jspace
from byzantine_aircomp_tpu_torch.data import datasets as tdata
from byzantine_aircomp_tpu_torch.fed.config import FedConfig
from byzantine_aircomp_tpu_torch.tune import objective as tobjective
from byzantine_aircomp_tpu_torch.tune import space as tspace
from byzantine_aircomp_tpu_torch.tune import tuner as ttuner
from byzantine_aircomp_tpu_torch.tune.tuner import BENIGN_PIN, Tuner


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: many small ops (tests/test_torch_dispatch.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the space

BAD_SPACES = [
    {},
    {"gamma": (0.01, 0.1)},
    {"defense_z": (2.0,)},
    {"defense_z": (2.0, 8.0, "lin")},
    {"defense_z": (8.0, 2.0)},
    {"defense_up": (2.5, 4)},
    {"defense_up": (2, 4, "log")},
    {"defense_leak": (0.0, 0.1, "log")},
]


@pytest.mark.parametrize("i", range(len(BAD_SPACES)))
def test_space_verdicts_and_texts_are_jax_s(i):
    space = BAD_SPACES[i]
    with pytest.raises(ValueError) as te:
        tspace.validate_space(space)
    with pytest.raises(ValueError) as je:
        jspace.validate_space(space)
    assert str(te.value) == str(je.value)


def test_the_default_space_and_its_knobs_are_jax_s():
    assert tspace.DEFAULT_SPACE == jspace.DEFAULT_SPACE
    assert tspace.TUNABLE_KNOBS == jspace.TUNABLE_KNOBS
    assert tspace.validate_space(tspace.DEFAULT_SPACE) == jspace.validate_space(
        jspace.DEFAULT_SPACE)
    assert tspace.default_params(tspace.DEFAULT_SPACE) == jspace.default_params(
        jspace.DEFAULT_SPACE)


@pytest.mark.parametrize("n,seed", [(1, 0), (8, 0), (16, 7), (5, 2021)])
def test_candidates_are_jax_s_bitwise(n, seed):
    got = tspace.sample_candidates(tspace.DEFAULT_SPACE, n, seed)
    want = jspace.sample_candidates(jspace.DEFAULT_SPACE, n, seed)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert [type(v) for c in got for v in c.values()] == \
        [type(v) for c in want for v in c.values()]


def test_halving_survivors_and_params_are_jax_s():
    for args in ((8, 3, 8), (3, 2, 2), (16, 4, 1, 3), (5, 1, 4)):
        assert tspace.halving_schedule(*args) == jspace.halving_schedule(*args)
    for scores, keep in (([0.1, 0.9, 0.9, -1.0, 0.5], 3), ([1.0, 1.0, 1.0], 1),
                         ([-2.0, 3.0], 2)):
        assert tspace.survivors(scores, keep) == jspace.survivors(scores, keep)
    with pytest.raises(ValueError, match="eta"):
        tspace.halving_schedule(4, 2, 2, eta=1)
    cfg = FedConfig()
    params = {"defense_up": 3.0, "defense_z": 5}
    out = tspace.apply_params(cfg, params)
    assert out is not cfg and out.defense_up == 3 and isinstance(out.defense_up, int)
    assert out.defense_z == 5.0 and isinstance(out.defense_z, float)


def _canned_pair(k=4, rounds=10):
    attacked = [
        {"kind": "run_start", "k": k, "byz": 2, "byz_ids": [2, 3], "rounds": rounds,
         "attack": "signflip@2"},
        {"kind": "client_flag", "round": 2, "client": 3, "flagged": True},
        {"kind": "client_flag", "round": 5, "client": 1, "flagged": True},
        {"kind": "client_flag", "round": 6, "client": 0, "flagged": False},
    ]
    benign = [
        {"kind": "client_flag", "round": 4, "client": 1, "flagged": True},
        {"kind": "client_flag", "round": 7, "client": 0, "flagged": False},
    ]
    return attacked, benign


def test_fold_pair_and_objective_score_are_jax_s():
    attacked, benign = _canned_pair()
    for kw in (dict(k=4, rounds=10), dict(k=4, rounds=10, ff_penalty=2.0, ttd_weight=1.0)):
        assert tobjective.fold_pair(attacked, benign, **kw) == jobjective.fold_pair(
            attacked, benign, **kw)
    for args in ((None, None, None, 0.0, 8), (1.0, 1.0, 0, 1 / 16, 8), (0.5, 0.25, 9, 0.1, 4),
                 (0.75, None, 3, 0.0, 0)):
        assert tobjective.objective_score(*args) == jobjective.objective_score(*args)
    assert tobjective.benign_flag_rate(benign, 4, 10) == 1 / 40
    assert tobjective.benign_flag_rate(benign, 0, 0) == 0.0


# ------------------------------------------------------------ the tune


def _tiny_cfg(**over):
    kw = dict(honest_size=6, byz_size=2, attack="signflip@1", agg="mean",
              defense="adaptive", forensics="top", forensics_top=8, dataset="mnist_hard",
              batch_size=4, display_interval=1, eval_train=False, rounds=1, seed=2021,
              defense_warmup=1, use_gpu=False)
    kw.update(over)
    return FedConfig(**kw).validate()


_TINY_SPACE = {
    "defense_z": (2.0, 16.0, "log"),
    "defense_up": (2, 4),
    "defense_floor": (0.5, 4.0),
}


@pytest.fixture(scope="module")
def tiny_ds():
    return tdata.load("mnist_hard", synthetic_train=256, synthetic_val=64)


def _tiny_tuner(ds, journal_path=None, **over):
    kw = dict(population=3, generations=2, base_rounds=2, eta=2, seed=0, dataset=ds,
              journal_path=journal_path)
    kw.update(over)
    return Tuner(_tiny_cfg(), _TINY_SPACE, **kw)


def test_the_tuner_refuses_a_base_config_as_jax_s_does(tiny_ds):
    with pytest.raises(ValueError, match="onset"):
        Tuner(_tiny_cfg(attack="signflip"), _TINY_SPACE, dataset=tiny_ds)
    with pytest.raises(ValueError, match="defense"):
        Tuner(_tiny_cfg(defense="off", defense_warmup=5), _TINY_SPACE, dataset=tiny_ds)
    with pytest.raises(ValueError, match="forensics"):
        Tuner(_tiny_cfg(forensics="off"), _TINY_SPACE, dataset=tiny_ds)


@pytest.fixture(scope="module")
def journaled(tiny_ds, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tune") / "tune.journal.jsonl")
    tuner = _tiny_tuner(tiny_ds, journal_path=path)
    result = tuner.run()
    with open(path) as f:
        lines = f.read().splitlines()
    return tuner, result, path, lines


def test_one_build_per_generation_and_the_control_lane(journaled):
    tuner, result, _, lines = journaled
    assert tuner.lowerings == tuner.generations == result["lowerings"] == 2
    assert tuner.candidates == jspace.sample_candidates(_TINY_SPACE, 3, 0)
    plan = tspace.halving_schedule(3, 2, 2, eta=2)
    assert [t["rounds"] for t in tuner.trail] == [r for _, r in plan]
    for t in tuner.trail:
        assert 0 in t["scored"] and 0 in t["survivors"]
        order = tspace.survivors([t["scored"][i]["objective"] for i in t["candidates"]],
                                 len(t["survivors"]))
        assert [t["candidates"][j] for j in order] == t["survivors"]
    assert result["default"]["params"] == tuner.candidates[0]
    assert result["tuned"]["objective"] >= result["default"]["objective"]
    assert result["tuned"]["recall"] is not None and result["tuned"]["recall"] > 0
    ops = [json.loads(ln)["op"] for ln in lines]
    assert ops[0] == "tune_start" and ops[-1] == "tune_done"
    assert ops.count("gen_start") == ops.count("gen_done") == 2


def test_a_benign_twin_never_reaches_its_onset(tiny_ds):
    from byzantine_aircomp_tpu_torch.serve.batch import BatchRunner

    tuner = _tiny_tuner(tiny_ds)
    cfgs = tuner._lane_cfgs(tuner.candidates[0], 3)
    runner = BatchRunner(cfgs, dataset=tiny_ds)
    runner.trainers[1].attack_iter = torch.full_like(runner.trainers[1].attack_iter,
                                                     BENIGN_PIN)
    runner.train()
    attacked, benign = (t.attack_iter.item() for t in runner.trainers)
    assert attacked == 3 and benign == BENIGN_PIN + 3
    # a benign twin's run is its config's run with an onset it never reaches
    import dataclasses

    from byzantine_aircomp_tpu_torch.fed.train import Trainer

    clean = Trainer(dataclasses.replace(cfgs[1], attack="signflip@1000"), dataset=tiny_ds,
                    device="cpu")
    for r in range(3):
        clean.run_round(r)
    assert torch.equal(clean.flat_params, runner.lane_params(1))
    assert not torch.equal(runner.lane_params(0), runner.lane_params(1))


def test_a_resume_mid_generation_is_bitwise(journaled, tiny_ds, tmp_path):
    _, full, _, lines = journaled
    cut = [ln for ln in lines if json.loads(ln)["op"] != "tune_done"
           and not (json.loads(ln)["op"] == "gen_done" and json.loads(ln)["gen"] == 1)]
    killed = str(tmp_path / "killed.jsonl")
    with open(killed, "w") as f:
        f.write("\n".join(cut) + "\n")
    tuner = _tiny_tuner(tiny_ds, journal_path=killed)
    result = tuner.run()
    assert [t["resumed"] for t in tuner.trail] == [True, False]
    assert tuner.lowerings == 1
    assert result["tuned"] == full["tuned"] and result["default"] == full["default"]
    for a, b in zip(result["trail"], full["trail"]):
        assert a["scored"] == b["scored"] and a["survivors"] == b["survivors"]
    # a torn final gen_done replays as "generation not finished"
    keep = [ln for ln in lines if json.loads(ln)["op"] != "tune_done"]
    torn = str(tmp_path / "torn.jsonl")
    with open(torn, "w") as f:
        f.write("\n".join(keep[:-1]) + "\n" + keep[-1][: len(keep[-1]) // 2])
    tuner = _tiny_tuner(tiny_ds, journal_path=torn)
    assert tuner.run()["tuned"] == full["tuned"]
    foreign = str(tmp_path / "foreign.jsonl")
    with open(foreign, "w") as f:
        f.write(lines[0] + "\n")
    with pytest.raises(ValueError, match="different tune configuration"):
        _tiny_tuner(tiny_ds, journal_path=foreign, seed=1).run()


def test_the_tune_cli_gates_one_build_per_generation(tmp_path, capsys):
    out = tmp_path / "tuned.json"
    rc = ttuner.main(["--device", "cpu", "--population", "2", "--generations", "2",
                      "--rounds", "1", "--k", "8", "--b", "2", "--interval", "1",
                      "--batch-size", "4", "--synthetic-train", "256", "--synthetic-val",
                      "64", "--assert-single-lowering", "--out", str(out)])
    assert rc == 0
    art = json.loads(out.read_text())
    assert art["lowerings"] == 2 and art["alpha"] == "iid"
    assert "lowerings=2/2 live generations" in capsys.readouterr().out
