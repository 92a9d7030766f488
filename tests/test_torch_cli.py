"""The port's CLI on the CPU writes a record in the reference schema that the
JAX package's analysis loads, with the same keys as the JAX harness."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from byzantine_aircomp_tpu.analysis.plots import load_record
from byzantine_aircomp_tpu.fed import harness as jharness
from byzantine_aircomp_tpu.fed.config import FedConfig as JaxFedConfig

REPO = Path(__file__).resolve().parents[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    env["OMP_NUM_THREADS"] = "2"
    return env


def test_cli_cpu_run_writes_reference_record(tmp_path):
    cmd = [
        sys.executable, "-m", "byzantine_aircomp_tpu_torch", "--device", "cpu",
        "--agg", "gm2", "--attack", "classflip", "--K", "8", "--B", "2",
        "--rounds", "1", "--interval", "2",
    ]
    proc = subprocess.run(cmd, cwd=tmp_path, env=_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[1/1](interval: 2)" in proc.stdout
    path = tmp_path / "MNIST_Air_weight_torch" / "mnist_K8_B2_MLP_SGD_classflip_gm2"
    record = load_record(str(path))
    want = jharness.build_record(
        JaxFedConfig(),
        {k: [] for k in ("trainLossPath", "trainAccPath", "valLossPath",
                         "valAccPath", "variencePath", "roundsPerSec")},
        dataset_name="mnist", dataset_size=1, max_feature=1,
    )
    assert set(record) == set(want)
    assert (record["honestSize"], record["byzantineSize"]) == (6, 2)
    assert (record["aggregate"], record["attack"]) == ("gm2", "classflip")
    assert len(record["valAccPath"]) == 2 and len(record["variencePath"]) == 1
    assert record["dataSetSize"] == 60000 and record["maxFeature"] == 784


def test_cli_cuda_without_gpu_fails_clearly(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the no-GPU error cannot show")
    proc = subprocess.run(
        [sys.executable, "-m", "byzantine_aircomp_tpu_torch", "--K", "4",
         "--rounds", "1", "--interval", "1"],
        cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr


@pytest.mark.parametrize("args,title", [
    (["--agg", "median", "--var", "1e-2"], "MLP_SGD_classflip_median_0.01"),
    (["--agg", "trimmed_mean", "--var", "1e-2"], "MLP_SGD_classflip_trimmed_mean_0.01"),
    (["--agg", "krum"], "MLP_SGD_classflip_krum"),
    (["--agg", "signmv", "--var", "1e-2", "--sign-bits", "1", "--sign-eta", "0.01"],
     "MLP_SGD_classflip_signmv_0.01_eta0.01_sb1"),
], ids=["median_var", "trimmed_mean_var", "krum", "signmv1_var"])
def test_cli_cpu_drives_each_new_aggregator(tmp_path, args, title):
    cmd = [
        sys.executable, "-m", "byzantine_aircomp_tpu_torch", "--device", "cpu",
        "--attack", "classflip", "--K", "10", "--B", "2", "--rounds", "1",
        "--interval", "2", *args,
    ]
    proc = subprocess.run(cmd, cwd=tmp_path, env=_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    record = load_record(str(tmp_path / "MNIST_Air_weight_torch" / f"mnist_K10_B2_{title}"))
    assert record["aggregate"] == args[1]
    assert len(record["valAccPath"]) == 2 and len(record["variencePath"]) == 1
    assert all(v == v for v in record["valAccPath"] + record["variencePath"])  # no NaN


@pytest.mark.parametrize("kw", [
    dict(agg="signmv", noise_var=1e-2, sign_bits=1, sign_eta=0.01),
    dict(agg="signmv", sign_eta=0.5),
    dict(agg="median", noise_var=1e-2),
    dict(agg="krum"),
])
def test_run_title_matches_jax(kw):
    from byzantine_aircomp_tpu_torch.fed import harness as tharness
    from byzantine_aircomp_tpu_torch.fed.config import FedConfig

    kw = dict(attack="classflip", honest_size=8, byz_size=2, **kw)
    assert tharness.run_title(FedConfig(**kw)) == jharness.run_title(JaxFedConfig(**kw))
