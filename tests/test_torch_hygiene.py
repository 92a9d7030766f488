"""Import hygiene of the port: it must never pull in JAX, flax, optax or the
JAX package, and it must never fall back to the CPU when CUDA was asked
for."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "byzantine_aircomp_tpu_torch"

_CHECK = r"""
import importlib, pkgutil, sys
import byzantine_aircomp_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not m.name.endswith(".__main__")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "byzantine_aircomp_tpu"))
print(len(names), bad)
assert not bad, bad
"""


def test_port_modules_import_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _CHECK], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 15  # every module was imported


_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|byzantine_aircomp_tpu)\b(?!_torch)",
    re.MULTILINE,
)


def test_port_sources_name_no_jax_import():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        hits = _FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path.relative_to(REPO)} imports {hits}"


_BLOCKED = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "byzantine_aircomp_tpu"):
    sys.modules[name] = None  # any import of them raises
from byzantine_aircomp_tpu_torch import analysis
from byzantine_aircomp_tpu_torch.analysis import perf_gate
from byzantine_aircomp_tpu_torch.obs import alerts
for reader in analysis.READERS:
    __import__("byzantine_aircomp_tpu_torch.analysis." + reader)
assert alerts.self_check() == 0 and perf_gate.self_check() == 0
"""


def test_readers_and_alerts_run_with_jax_blocked():
    """The analysis package and the alert engine's self-check run where
    importing JAX or the JAX package fails."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "self-check: ok" in proc.stdout


def test_cuda_request_without_gpu_raises(monkeypatch):
    from byzantine_aircomp_tpu_torch.data import datasets
    from byzantine_aircomp_tpu_torch.device import resolve_device
    from byzantine_aircomp_tpu_torch.fed.config import FedConfig
    from byzantine_aircomp_tpu_torch.fed.train import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    ds = datasets.load("mnist", synthetic_train=40, synthetic_val=10)
    with pytest.raises(RuntimeError, match="is_available"):
        Trainer(FedConfig(honest_size=2), dataset=ds)
    assert resolve_device("cpu").type == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    with pytest.raises(ValueError):
        resolve_device("mps")
