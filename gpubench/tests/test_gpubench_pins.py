"""The inputs, the initial weights and the reference's outputs, pinned bit
for bit: a configuration's code found by name (``inputs/<kind>.py``,
``reference/models/<model>.py``, the ``init_rules`` of ``data.py``) draws
and computes what it drew and computed before it was found so.

The digests (sha256 of each array's bytes) were taken at commit
7c6eac99da41a780049cbd28b848dc8d65970e60, with one CPU thread (a conv's sums
on several threads run in an order that the thread count sets), on an
x86-64 CPU with this file's seed and the cells' CPU sizes.
"""

import hashlib

import numpy as np
import pytest
import torch

from gpubench import data, inputs
from gpubench.reference.follow import follow

SEED = 2**31 + 2024

#: the MNIST-shaped rows are the same for both configurations
ROWS = {
    "x_train": "dde6e61c3710e8fa8dc897b1d02e7278a082a18ffa5682889d52a406694c4e0f",
    "x_train_f32": "5253818584d2fd92916ee1f3c20c39a32113318706032af7221346ebf7bdccd5",
    "y_train": "11c1ee1aa08402f94d3e461dc6d892c7e3209ab79f0948ff25fa05831341c447",
    "x_val": "0728abc4078ffddb2b5da9e2ad443a2fdf87643e7ba5486ce357f883278c6974",
    "y_val": "efc42b7a230c45c7e3ae1c76ab294d661af1722df51dd59898826060b3d313ef",
}
P0 = {
    "mlp-mnist": "55595503b12a04ef8c4c6f1f30b83307cb673403710884f6d6cb73303f312478",
    "cnn-mnist": "543ad4f61fd7b32403e879579a813a6cc89df37b87a0771c2b392becdaa08e16",
}
NO_STEPS = "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855"
#: each cell's (weights after each checked dispatch, variances, solve steps)
FOLLOW = {
    "mlp.gm2.k1000.r2": (
        "dd989f39b837252189f552411211b8915d61ef33b4b7aed9d308e5a590ca5569",
        "ea84c7ee6937ecc9b93acdc79618e2e13bc0a3bd8a85bb13b06fbb86e70601c5",
        "778dce7a5b60d6be392b41900dd35048822ed1b8106c6e649da9660867e9911b"),
    "cnn.median-var.k50.r1": (
        "864299439c0842faa216b4aa3c2de5a3c391dc6a28508ef3672bcc97e20b90b4",
        "701dc5f1dd0c1bc304192ec7b355403f337dad2f244dcea0d69685ea764b9369",
        NO_STEPS),
    "mlp.gm-var.k50.r2": (
        "ab75b17b204c8b87fd4da65de57a28f8b0b2838b0f38e6edc88cf64c8f7f114a",
        "22de44cc5a2fef644d060473414fed2e826b99e83959acf9dd8ee609ccf8a2ba",
        "8e316f303a53cfe00464a112ffbb0b1f57fc0b543e6bfc7f103b29619478b5ad"),
    "mlp.trimmed_mean-var.k1000.r10": (
        "959c59b24801991818d0aef204a0eb25302e515ea33821181c69cbeb67924fd7",
        "85a32744e01827418692775edba6741fa8ba57b33c49fd79c5bc16158d94dc33",
        NO_STEPS),
}


def _digest(a) -> str:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("name", sorted(FOLLOW))
def test_the_parents_inputs_weights_and_reference_outputs(tiny, one_thread, name):
    _, config, cell = tiny(name)
    kind = inputs.of(config)
    rows = kind.make_data(config, SEED, "cpu")
    p0 = data.make_params(config, SEED, "cpu")
    assert {k: _digest(v) for k, v in rows.items()} == ROWS
    assert _digest(p0) == P0[config["name"]]
    ref = follow(config, cell, kind.on_device(rows, "cpu"), p0, SEED, cell["check_dispatches"])
    assert (_digest(torch.stack(ref["params"])),
            _digest(np.asarray(ref["variances"], np.float64)),
            _digest(np.asarray(ref["solve_steps"], np.int64))) == FOLLOW[name]
