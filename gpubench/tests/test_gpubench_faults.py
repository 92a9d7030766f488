"""A run whose timed path is broken underneath comes out not correct, and
so does the control: the reference in TF32, put in the program's place."""

import pytest

from gpubench import calibrate, cells, run

CELLS = [w["name"] for w in cells.benchmark()["workloads"]]
SEED = 2**31 + 1234


def _state_unchanged(monkeypatch):
    """Every iteration returns the weights it was given (its variance as
    the sound iteration reports it)."""
    from byzantine_aircomp_tpu_torch.fed.train import Trainer

    sound = Trainer.iteration

    def unchanged(self, flat_params, *a, **kw):
        return flat_params, sound(self, flat_params, *a, **kw)[1]

    monkeypatch.setattr(Trainer, "iteration", unchanged)


def _half_batch(monkeypatch):
    """Every client's step sees the first half of its batch (the mean over
    the rest)."""
    from byzantine_aircomp_tpu_torch.fed.train import Trainer

    sound = Trainer._batches
    monkeypatch.setattr(Trainer, "_batches",
                        lambda self, idx: sound(self, idx[:, : idx.shape[1] // 2]))


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, name, fault):
    work, config, cell = tiny(name)
    fault(monkeypatch)
    result, nums = run.measure(work, config, cell, SEED, 0.05, False, device="cpu")
    assert not result["correct"], nums
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_in_tf32_is_not_correct(card, name):
    """At the cell's own size, which the card holds."""
    _, config, cell = cells.cell(name)
    nums = calibrate.stand_in_reading(config, cell, SEED, card, tf32=True)
    assert any(nums[n] > limit for n, limit in cell["limits"].items()), nums
