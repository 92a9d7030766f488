"""The yardstick against hand counts."""

import pytest

from gpubench import cells
from gpubench.counts import peak


def _config(name):
    return cells.cell({"mlp-mnist": "mlp.gm2.k1000.r2", "cnn-mnist": "cnn.median-var.k50.r1"}[name])[1]


def test_the_models_widths():
    assert _config("mlp-mnist")["params"] == 7_850
    assert _config("cnn-mnist")["params"] == 3_274_634


def test_the_mlp_needs_two_products_a_sample():
    # forward 784 x 10 multiply-adds and the weight gradient as many; no
    # input gradient of the first (only) layer
    assert cells.module("counts", "mlp-mnist").train_flops_per_sample(
        _config("mlp-mnist")) == 2 * 2 * 784 * 10 == 31_360


def test_the_cnn_needs_82_mflop_a_sample():
    conv0 = 28 * 28 * 32 * 25
    conv1 = 14 * 14 * 64 * 25 * 32
    fc0, fc1 = 3136 * 1024, 1024 * 10
    fwd = conv0 + conv1 + fc0 + fc1
    want = 2 * (2 * fwd + conv1 + fc0 + fc1)
    got = cells.module("counts", "cnn-mnist").train_flops_per_sample(_config("cnn-mnist"))
    assert got == want == 82_049_024


def test_the_kernels_bytes():
    assert cells.module("counts", "weiszfeld_step").step_bytes(1000, 7850) == 4 * (
        1000 * 7850 + 2 * 7850)
    assert cells.module("counts", "aircomp_weiszfeld_step").step_bytes(50, 7850, True) == 4 * (
        50 * 7850 + 2 * 7850 + 2 * 50 + 7851)
    sel = cells.module("counts", "select_columns")
    assert sel.call_bytes(1000, 7850, False) == 4 * (1000 * 7850 + 7850)
    assert sel.call_bytes(50, 3_274_634, True) == 4 * (3 * 50 * 3_274_634 + 3 * 50 + 3_274_634)


@pytest.mark.parametrize("kind,want", [("NVIDIA H100 80GB HBM3", 3.35e12),
                                       ("NVIDIA A100-SXM4-80GB", None)])
def test_the_peak_table(kind, want):
    assert peak(kind, "hbm_bytes_per_s") == want


def test_every_kernel_count_names_the_ports_counter():
    from byzantine_aircomp_tpu_torch.ops import kernels

    wrappers = [m.WRAPPER for m in cells.kernel_counts()]
    assert wrappers and set(wrappers) <= set(kernels.LAUNCHES)
