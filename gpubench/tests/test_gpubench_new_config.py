"""A model configuration joins the benchmark as new files and new entries
of ``BENCHMARK.json`` only: the port's ResNet-18 (GroupNorm, flax SAME
padding, ``--remat``), which the harness has never run, added to a copy of
the benchmark from ``fixtures/resnet18/`` (its configuration with an
``init_rules`` rule for the GroupNorm scales and the trainer's ``fed``
keywords, its plain reference, its count, its traffic with its CPU sizes,
and one workload), is found by name and reads ``correct``.  The fixture's
limits are set for the CPU: its sound runs read gaps up to 4.5e-3 (f32
rounding through GroupNorm, and the weights' change a small difference of
large numbers), a half batch 0.37 or more."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from gpubench import cells

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "resnet18"
SEED = 2**31 + 555


def _files(root: Path):
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_model_joins_as_files_and_entries_only(tmp_path):
    shutil.copy(cells.BENCHMARK, tmp_path)
    shutil.copytree(cells.HERE, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _files(tmp_path)
    for src in (FIXTURE / "gpubench").rglob("*"):
        if src.is_file():
            dst = tmp_path / "gpubench" / src.relative_to(FIXTURE / "gpubench")
            assert not dst.exists(), dst
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(src, dst)
    entries = json.loads((FIXTURE / "entries.json").read_text())
    bench = json.loads(cells.BENCHMARK.read_text())
    for key, added in entries.items():
        bench[key] += added
    (tmp_path / cells.BENCHMARK.name).write_text(json.dumps(bench, indent=2))

    after = _files(tmp_path)
    assert {p: after[p] for p in before if p.name != cells.BENCHMARK.name} == {
        p: b for p, b in before.items() if p.name != cells.BENCHMARK.name}
    old = json.loads(before[Path(cells.BENCHMARK.name)])
    new = json.loads(after[Path(cells.BENCHMARK.name)])
    assert {k: v for k, v in new.items() if k not in entries} == {
        k: v for k, v in old.items() if k not in entries}
    assert all(new[k][:len(old[k])] == old[k] for k in entries)

    (name,) = [w["name"] for w in entries["workloads"]]
    code = ("import sys, json; sys.path[:0] = ['.', 'gpubench/tests']\n"
            "from conftest import tiny_cell\n"
            "import gpubench\n"
            "from gpubench import run\n"
            f"w, c, t = tiny_cell({name!r})\n"
            f"result, nums = run.measure(w, c, t, {SEED}, 0.05, False, device='cpu')\n"
            "from byzantine_aircomp_tpu_torch.fed.train import Trainer\n"
            "sound = Trainer._batches\n"
            "Trainer._batches = lambda self, idx: sound(self, idx[:, : idx.shape[1] // 2])\n"
            f"half, _ = run.measure(w, c, t, {SEED}, 0.05, False, device='cpu')\n"
            "print(json.dumps({'file': gpubench.__file__, 'correct': result['correct'],\n"
            "                  'failed': result['failed'], 'nums': nums,\n"
            "                  'half_batch_correct': half['correct']}))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(cells.ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=900, env=env)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert Path(out["file"]).resolve().is_relative_to(tmp_path.resolve())
    assert out["correct"] and out["failed"] == 0, out["nums"]
    # and its limits hold a broken client step: half of each batch left out
    assert not out["half_batch_correct"]
