"""The run's last line, its refusals, and what it imports."""

import json
import os
import shutil
import subprocess
import sys

import torch

from gpubench import cells, run

SEED = 2**31 + 4321


def _py(code, cwd, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=600, env=env)


def test_the_result_has_the_five_keys_and_the_checks_last(tiny):
    work, config, cell = tiny("mlp.gm2.k1000.r2")
    result, _ = run.measure(work, config, cell, SEED, 0.05, False, device="cpu")
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(result["metrics"]) == {"rounds_per_s", "dispatch_ms_p90", "peak_mem_gib",
                                      "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(result["checks"]) == set(cell["limits"])


def test_a_traced_result_adds_the_breakdown_and_the_per_layer_metrics(tiny):
    work, config, cell = tiny("mlp.gm2.k1000.r2")
    result, _ = run.measure(work, config, cell, SEED, 0.05, True, device="cpu")
    assert list(result) == ["correct", "attempted", "failed", "breakdown", "metrics", "device",
                            "checks"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(result["device"])
    # the CPU has no device trace and no peak: only the host's readings
    assert set(result["metrics"]) == {"device.idle_pct", "dispatch.host_ms"}


def test_without_a_card_the_run_exits_with_no_result():
    if torch.cuda.is_available():
        return
    p = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "mlp.gm2.k1000.r2",
                        "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                       cwd=cells.ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_the_benchmark_alone_cannot_run(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's files
    has no program to measure: the run fails before any result."""
    shutil.copy(cells.BENCHMARK, tmp_path)
    shutil.copytree(cells.HERE, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _py("import sys; sys.path.insert(0, '.')\n"
            "from gpubench import run, cells\n"
            "w, c, t = cells.cell('mlp.gm2.k1000.r2')\n"
            "c = dict(c, train_size=600, val_size=100)\n"
            "run.measure(w, c, t, 1, 0.01, False, device='cpu')\n"
            "print('RESULT')", tmp_path, env)
    assert p.returncode != 0 and "RESULT" not in p.stdout
    assert "byzantine_aircomp_tpu_torch" in p.stderr


def test_a_run_imports_neither_jax_nor_the_jax_package():
    p = _py("import sys, json; sys.path.insert(0, '.')\n"
            "sys.path.insert(0, 'gpubench/tests')\n"
            "from conftest import tiny_cell\n"
            "from gpubench import run\n"
            "w, c, t = tiny_cell('mlp.gm2.k1000.r2')\n"
            "run.measure(w, c, t, 5, 0.01, True, device='cpu')\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))", cells.ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "byzantine_aircomp_tpu"}
    assert "byzantine_aircomp_tpu_torch" in top


def test_the_reference_imports_nothing_of_either_package():
    p = _py("import sys, json; sys.path.insert(0, '.')\n"
            "import gpubench.reference.follow, gpubench.check\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))", cells.ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "byzantine_aircomp_tpu",
                      "byzantine_aircomp_tpu_torch"}


def test_the_forbidden_modules_are_found_by_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax_lookalike", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    assert run.forbidden_modules() == ["flax"]
