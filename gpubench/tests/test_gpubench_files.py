"""BENCHMARK.json keeps to the contract, and every file it names is found."""

import json
import math
import re

import pytest

from gpubench import cells

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
CONFIGS = [c["name"] for c in BENCH["configs"]]


def test_the_benchmark_has_the_contract_keys_and_no_other():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert BENCH["command"] == ["python3", "gpubench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_bounds_keep_to_the_contract():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", WORKLOADS)) <= set(WORKLOADS)
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("name", WORKLOADS)
def test_every_cell_finds_its_configuration_and_traffic(name):
    work, config, cell = cells.cell(name)
    assert work["chips"] == 1 and len(work["why"]) <= 200
    assert sum(math.prod(shape) for _, shape in config["layout"]) == config["params"]
    for key in ("honest_size", "byz_size", "attack", "agg", "noise_var", "rounds_per_dispatch",
                "check_dispatches", "trace_dispatches", "limits"):
        assert key in cell
    assert cell["limits"] and set(cell["limits"]) <= {
        "var_gap", "step1_gap", "step_gap", "step1_q99"}
    e2e = {m["name"] for m in cells.metrics_of(name, "end_to_end")}
    assert cells.metrics_of(name, "per_layer") and {"setup_s", "rounds_per_s"} <= e2e


@pytest.mark.parametrize("name", CONFIGS)
def test_every_configuration_has_a_file_of_its_own_and_a_count(name):
    entry = {c["name"]: c for c in BENCH["configs"]}[name]
    assert entry["file"].startswith("gpubench/configs/")
    assert sum(c["file"] == entry["file"] for c in BENCH["configs"]) == 1
    assert json.loads((cells.ROOT / entry["file"]).read_text())["name"] == name
    assert callable(cells.module("counts", name).train_flops_per_sample)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(cells.module("metrics", metric).read)


@pytest.mark.parametrize("name", CONFIGS)
def test_the_layout_is_the_ports_flat_vector(name):
    """The configuration's leaves, in order, are the port's flat layout: the
    model built from the keywords that the benchmark's trainer gets
    (``program.make_trainer``), as ``Trainer`` builds it."""
    import torch
    from byzantine_aircomp_tpu_torch.fed.config import FedConfig
    from byzantine_aircomp_tpu_torch.ops.flatten import make_flat_spec
    from byzantine_aircomp_tpu_torch.registry import MODELS

    entry = {c["name"]: c for c in BENCH["configs"]}[name]
    config = json.loads((cells.ROOT / entry["file"]).read_text())
    cfg = FedConfig(model=config["model"], fc_width=config.get("fc_width", 1024),
                    **config.get("fed", {}))
    model = MODELS.get(cfg.model)(
        input_shape=tuple(config["input_shape"]), num_classes=config["num_classes"],
        generator=torch.Generator().manual_seed(0), fc_width=cfg.fc_width,
        width=cfg.resnet_width, remat=cfg.remat)
    spec = make_flat_spec(model)
    assert spec.total == config["params"]
    assert [("/".join(leaf.jax_path), list(leaf.jax_shape)) for leaf in spec.leaves] == [
        (n, list(s)) for n, s in config["layout"]]
