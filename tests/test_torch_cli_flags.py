"""The reference CLI flags of the port (``--opt``, ``--inherit``, ``--mark``,
``--use-gpu``, ``--attack-param``, ``--checkpoint-dir``, ``--weight-decay``,
``--cache-dir``, ``--eval-train/--no-eval-train``) parse into the same
FedConfig fields as the JAX CLI's, and a CLI run resumes on the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from byzantine_aircomp_tpu import cli as jcli
from byzantine_aircomp_tpu.analysis.plots import load_record
from byzantine_aircomp_tpu_torch import cli as tcli

REPO = Path(__file__).resolve().parents[1]

_ARGV = ["--attack", "alie", "--K", "10", "--B", "2", "--attack-param", "2.5",
         "--mark", "trial", "--weight-decay", "0.001", "--cache-dir", "recs",
         "--checkpoint-dir", "ck", "--inherit", "--no-eval-train", "--opt", "SGD"]
_FIELDS = ("attack", "honest_size", "byz_size", "attack_param", "mark", "weight_decay",
           "cache_dir", "checkpoint_dir", "inherit", "eval_train", "opt")


def _port(argv):
    return tcli.config_from_args(tcli.build_parser().parse_args(argv))


def test_new_flags_parse_like_the_jax_cli():
    port = _port(_ARGV + ["--use-gpu", "false"])
    jargs = jcli.build_parser().parse_args(_ARGV)
    want = jcli.config_from_args(jargs, _ARGV)
    for field in _FIELDS:
        assert getattr(port, field) == getattr(want, field), field
    assert port.use_gpu is False
    assert port.validate() is port


@pytest.mark.parametrize("argv,field,value", [
    ([], "eval_train", True),
    (["--eval-train"], "eval_train", True),
    (["--no-eval-train"], "eval_train", False),
    ([], "inherit", False),
    (["--weight-decay", "0.5"], "weight_decay", 0.5),
    (["--attack", "gaussian", "--attack-param", "0.1"], "attack_param", 0.1),
    (["--attack", "signflip@3"], "attack", "signflip@3"),
    (["--mark", "m1"], "mark", "m1"),
    (["--cache-dir", "c"], "cache_dir", "c"),
    (["--checkpoint-dir", "d"], "checkpoint_dir", "d"),
    (["--opt", "SGD"], "opt", "SGD"),
    (["--local-steps", "5"], "local_steps", 5),
    (["--fedprox-mu", "0.01"], "fedprox_mu", 0.01),
    (["--server-opt", "adam"], "server_opt", "adam"),
    (["--server-lr", "0.01"], "server_lr", 0.01),
    (["--server-momentum", "0.8"], "server_momentum", 0.8),
    (["--client-momentum", "0.9"], "client_momentum", 0.9),
    (["--participation", "0.5"], "participation", 0.5),
    (["--bucket-size", "2"], "bucket_size", 2),
    (["--defense", "monitor"], "defense", "monitor"),
    (["--defense-ladder", "mean,median"], "defense_ladder", "mean,median"),
    (["--defense-warmup", "3"], "defense_warmup", 3),
    (["--defense-alpha", "0.2"], "defense_alpha", 0.2),
    (["--defense-drift", "0.4"], "defense_drift", 0.4),
    (["--defense-cusum", "6"], "defense_cusum", 6.0),
    (["--defense-z", "3.5"], "defense_z", 3.5),
    (["--defense-up", "2"], "defense_up", 2),
    (["--defense-down", "10"], "defense_down", 10),
    (["--defense-min-flagged", "2"], "defense_min_flagged", 2),
    (["--defense-floor", "1.2"], "defense_floor", 1.2),
    (["--defense-leak", "0.01"], "defense_leak", 0.01),
    (["--metrics", "on"], "metrics", "on"),
    (["--metrics-port", "9100"], "metrics_port", 9100),
    (["--alerts", "default"], "alerts", "default"),
])
def test_each_flag_reaches_its_field(argv, field, value):
    """Each flag sets its field, as the JAX CLI's does."""
    assert getattr(_port(argv), field) == value
    want = jcli.config_from_args(jcli.build_parser().parse_args(argv), argv)
    assert getattr(want, field) == value


@pytest.mark.parametrize("argv,device", [
    ([], "cuda"),
    (["--device", "cpu"], "cpu"),
    (["--use-gpu", "false"], "cpu"),
    (["--use-gpu", "False", "--device", "cpu"], "cpu"),
    (["--use-gpu", "true"], "cuda"),
    (["--use-gpu", "true", "--device", "cuda"], "cuda"),
])
def test_use_gpu_and_device_pick_the_device(argv, device):
    cfg = _port(argv)
    assert cfg.use_gpu is (device == "cuda")


@pytest.mark.parametrize("argv,match", [
    (["--use-gpu", "false", "--device", "cuda"], "conflicts"),
    (["--use-gpu", "true", "--device", "cpu"], "conflicts"),
    (["--use-gpu", "maybe"], "true or false"),
])
def test_conflicting_device_flags_raise(argv, match):
    with pytest.raises(ValueError, match=match):
        _port(argv)


@pytest.mark.parametrize("argv", [
    ["--opt", "Adam"],
    ["--eval-train", "--no-eval-train"],
])
def test_rejected_by_the_parser(argv):
    with pytest.raises(SystemExit):
        tcli.build_parser().parse_args(argv)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env["OMP_NUM_THREADS"] = "2"
    return env


def test_cli_resume_on_the_cpu(tmp_path):
    """--use-gpu false, a checkpoint per round, then --inherit to round 2:
    the record holds the whole run."""
    base = [sys.executable, "-m", "byzantine_aircomp_tpu_torch", "--use-gpu", "false",
            "--agg", "gm2", "--attack", "signflip@1", "--K", "8", "--B", "2",
            "--interval", "2", "--checkpoint-dir", "ck", "--mark", "res",
            "--no-eval-train", "--cache-dir", "recs"]
    first = subprocess.run(base + ["--rounds", "1"], cwd=tmp_path, env=_env(),
                           capture_output=True, text=True, timeout=300)
    assert first.returncode == 0, first.stderr[-2000:]
    second = subprocess.run(base + ["--rounds", "2", "--inherit"], cwd=tmp_path, env=_env(),
                            capture_output=True, text=True, timeout=300)
    assert second.returncode == 0, second.stderr[-2000:]
    assert "Resumed from checkpoint at round 1" in second.stdout
    assert "[2/2](interval: 2)" in second.stdout and "[1/2]" in second.stdout
    assert len(os.listdir(tmp_path / "ck")) == 1
    record = load_record(str(tmp_path / "recs" / "mnist_K8_B2_MLP_SGD_signflip@1_gm2_res"))
    assert len(record["valAccPath"]) == 3 and len(record["variencePath"]) == 2
    assert record["trainAccPath"] == [0.0, 0.0, 0.0]
