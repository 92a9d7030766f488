"""The plain reference against the port on the CPU at small sizes, and its
rules against hand-made stacks."""

import math

import pytest
import torch

from gpubench import cells, run
from gpubench.reference import aggregate, draws

SEED = 2**31 + 77
WORKLOADS = [w["name"] for w in cells.benchmark()["workloads"]]


@pytest.mark.parametrize("name", WORKLOADS)
def test_the_reference_follows_the_port(tiny, name):
    work, config, cell = tiny(name)
    result, nums = run.measure(work, config, cell, SEED, 0.05, False, device="cpu")
    assert result["correct"], nums
    assert max(nums.values()) < 1e-4, nums
    assert result["failed"] == 0


def test_median_and_trimmed_mean_of_a_known_stack():
    w = torch.tensor([[5.0, -1.0], [1.0, 0.0], [4.0, 7.0], [2.0, 2.0], [3.0, 1.0]])
    assert aggregate.median(w).tolist() == [3.0, 1.0]
    # b = int(5 * 0.2) = 1: the mean of the middle three
    assert aggregate.trimmed_mean(w, 0.2).tolist() == pytest.approx([3.0, 1.0])


def test_gm2_finds_the_median_of_a_symmetric_stack():
    w = torch.tensor([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]])
    g, steps = aggregate.gm2(w, torch.tensor([3.0, 2.0]), maxiter=1000, tol=1e-7)
    assert torch.linalg.vector_norm(g) < 1e-3 and 1 < steps < 1000


def test_the_channel_adds_the_equalized_noise():
    w = torch.zeros((2, 3))
    terms = (torch.tensor([1.0, 0.0]), torch.tensor([0.0, 2.0]),
             torch.ones((2, 3)), torch.ones((2, 3)))
    # row 0: (1*1 + 0*1) / 1; row 1: (0*1 + 2*1) / 4
    assert aggregate.received(w, terms).tolist() == [[1.0] * 3, [0.5] * 3]


def test_the_stream_seed_is_63_bits_of_the_seed_sequence():
    s = draws.stream_seed(2**31 + 5, 3, 7, 2)
    assert 0 <= s < 2**63 and s != draws.stream_seed(2**31 + 5, 3, 7, 1)


def test_the_variance_is_over_the_honest_rows():
    w = torch.tensor([[0.0, 0.0], [2.0, 0.0], [100.0, 100.0]])
    assert math.isclose(float(aggregate.honest_variance(w, 2)), 1.0)


def test_a_non_finite_weight_fails_every_number():
    from gpubench import check

    layout = [["Dense_0/bias", [2]], ["Dense_0/kernel", [2, 2]]]
    p0 = torch.zeros(6)
    ref = [torch.ones(6)]
    prog = [torch.ones(6)]
    prog[0][3] = math.nan
    nums = check.numbers(layout, p0, prog, [1.0], ref, [1.0])
    assert nums["step1_gap"] == math.inf and nums["step_gap"] == math.inf
    assert nums["step1_q99"] == math.inf
    assert check.numbers(layout, p0, prog, [math.nan], ref, [1.0])["var_gap"] == math.inf


def test_an_init_rule_sizes_a_leaf_that_xavier_cannot():
    """A 1-D leaf that is not a bias (a GroupNorm scale) needs a rule of
    the configuration's ``init_rules``; without one, the error names it."""
    from gpubench import data

    config = {"params": 8, "layout": [["GroupNorm_0/bias", [4]], ["GroupNorm_0/scale", [4]]]}
    with pytest.raises(ValueError, match="GroupNorm_0/scale"):
        data.make_params(config, 1, "cpu")
    p = data.make_params(dict(config, init_rules=[["/scale", 1.0]]), 1, "cpu")
    assert torch.equal(p, torch.tensor([0.01] * 4 + [1.0] * 4))

