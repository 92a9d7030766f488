"""The benchmark as data: ``BENCHMARK.json`` names each cell, its
configuration and traffic, and the metrics; each is a file of its own
under this directory, found by its name."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def benchmark() -> dict:
    return json.loads(BENCHMARK.read_text())


def module(kind: str, name: str) -> ModuleType:
    """``gpubench/<kind>/<name>.py`` as a module (a metric's reader, a
    model's or a kernel's count)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    tag = f"gpubench_{kind}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str, bench: dict = None):
    """``(workload, configuration, traffic)`` of the cell ``name``: its
    entry, and the contents of its configuration's and traffic's files."""
    bench = bench or benchmark()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in {BENCHMARK.name}: {sorted(work)}")
    w = work[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((ROOT / cfg["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    return w, config, traffic


def metrics_of(name: str, kind: str, bench: dict = None):
    """The ``end_to_end`` or ``per_layer`` metrics that the cell ``name``
    reports."""
    bench = bench or benchmark()
    return [m for m in bench[kind] if name in m.get("workloads", [name])]


def kernel_counts():
    """The count modules of the port's kernels (those with a ``WRAPPER``)."""
    mods = [module("counts", p.stem) for p in sorted((HERE / "counts").glob("*.py"))
            if p.stem != "__init__"]
    return [m for m in mods if hasattr(m, "WRAPPER")]
